"""The port's configs registry and the seven architectures that came with
it (gemma3, qwen2-moe, minicpm3, llava-next, hubert, yi, arctic) against
the JAX package.

Configs are compared field for field with the dtypes mapped; shapes,
cells and ``input_specs`` likewise.  Each arch's SMOKE runs with the
reference's parameters carried across through ``params_from_numpy``,
inputs made by numpy from a seed; the reference runs its jnp oracle
(``attn_backend="ref"``, as its SMOKE configs say).  Bounds at fp32:
logits within 2e-5 (as ``test_torch_lm.py``), the loss within 1e-5 and
its gradients within 1e-4 relative L2 over the whole tree (as
``test_torch_train.py``), greedy tokens identical over a 20-step
rollout (gemma3's window of 8 wraps its ring twice).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import lm as JLM
from repro_torch import configs as TC
from repro_torch.launch import train
from repro_torch.models import lm as TLM
from repro_torch.serving.engine import ServingEngine
from torch_port_helpers import (greedy_rollouts, port_cfg, port_params,
                                tiny_cfg, to_numpy)

TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
NEW_ARCHS = ("gemma3-1b", "qwen2-moe-a2.7b", "minicpm3-4b",
             "llava-next-mistral-7b", "hubert-xlarge", "yi-34b",
             "arctic-480b")
DECODERS = tuple(a for a in NEW_ARCHS if a != "hubert-xlarge")


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rel_l2(got, want) -> float:
    g = torch.cat([x.detach().double().reshape(-1) for x in got])
    w = torch.cat([x.detach().double().reshape(-1) for x in want])
    return float((g - w).norm() / w.norm())


# ----------------------------------------------------------------------
# the registry
# ----------------------------------------------------------------------

def test_registry_lists_the_reference_archs_in_order():
    assert TC.ARCHS == JC.ARCHS
    assert TC.ARCH_MODULES == JC.ARCH_MODULES
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("gpt-5")


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_configs_equal_the_reference(arch):
    assert TC.get_config(arch) == port_cfg(JC.get_config(arch))
    assert TC.get_smoke_config(arch) == port_cfg(JC.get_smoke_config(arch))


def test_cells_and_skips_equal_the_reference():
    got = [(a, n, dataclasses.asdict(s)) for a, n, s in TC.iter_cells()]
    want = [(a, n, dataclasses.asdict(s)) for a, n, s in JC.iter_cells()]
    assert len(got) == 40 and got == want
    for a, n, s in TC.iter_cells():
        assert type(s).__name__ == type(TC.get_shapes(a)[n]).__name__
        assert isinstance(s, (TC.ShapeSpec, TC.SkipSpec))


_DTYPE = {"bfloat16": torch.bfloat16, "int32": torch.int32}


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_input_specs_match_the_reference_on_meta(arch):
    tcfg = TC.get_config(arch)
    for name, spec in TC.get_shapes(arch).items():
        jspec = JC.get_shapes(arch)[name]
        if isinstance(spec, TC.SkipSpec):
            continue
        got = TC.input_specs(tcfg, spec)
        want = JC.input_specs(JC.get_config(arch), jspec)
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape)
            assert t.dtype == _DTYPE[jnp.dtype(want[k].dtype).name]


# ----------------------------------------------------------------------
# every new arch's SMOKE against the reference
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def smoke_models(arch: str):
    cfg = JC.get_smoke_config(arch)
    params = JLM.init_params(cfg, jax.random.key(5))
    return cfg, params, port_cfg(cfg), port_params(cfg, params)


def arch_inputs(cfg, b=2, s=24, seed=6):
    """(reference kwargs, port kwargs) of ``forward``: embeddings for an
    embeddings-mode arch, tokens otherwise."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        e = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    t = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(t)},
            {"tokens": torch.from_numpy(t).long()})


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_matches_jax(arch):
    cfg, params, tcfg, tp = smoke_models(arch)
    jin, tin = arch_inputs(cfg)
    exp, exp_aux = JLM.forward(cfg, params, **jin)
    out, aux = TLM.forward(tcfg, tp, **tin)
    width = cfg.vocab_size if cfg.lm_head else cfg.n_classes
    assert tuple(out.shape) == (2, 24, width)
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    np.testing.assert_allclose(float(aux), float(exp_aux), rtol=1e-5,
                               atol=1e-7)


@functools.lru_cache(maxsize=None)
def reference_loss(arch: str):
    """The reference's lm_loss and gradients on a token batch (tokens for
    every arch, as its train_loop feeds them)."""
    cfg, params, _, _ = smoke_models(arch)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    val, grads = jax.value_and_grad(
        lambda p: JLM.lm_loss(cfg, p, batch))(params)
    return batch, float(val), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    cfg, params, tcfg, _ = smoke_models(arch)
    batch, want, grads = reference_loss(arch)
    tp = port_params(cfg, params)
    for x in leaves(tp):
        x.requires_grad_()
    loss = TLM.lm_loss(tcfg, tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    got = torch.autograd.grad(loss, leaves(tp))
    assert abs(loss.item() - want) <= LOSS_RTOL * abs(want)
    ref = TLM.params_from_numpy(tcfg, grads, device="cpu")
    assert rel_l2(got, leaves(ref)) <= GRAD_RTOL


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_rollout_matches_jax(arch):
    """4 prompt tokens fed one a step, then 16 greedy: logits at every
    step within 2e-5 and the greedy tokens identical."""
    jl, tl, jt, tt = greedy_rollouts(JC.get_smoke_config(arch), steps=20)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    assert jt.shape[1] == 17
    np.testing.assert_array_equal(tt, jt)


def test_gemma3_ring_wraps_and_keeps_window_slots():
    """The sliding layers' caches are rings of ``window`` slots (8 in
    gemma3's SMOKE), the global layer's holds every position."""
    tcfg = TC.get_smoke_config("gemma3-1b")
    layout = TLM.cache_layout(tcfg, 2, 32, torch.float32)
    for spec, entry in zip(tcfg.layer_specs(), layout):
        slots = 8 if spec.mixer == "sliding" else 32
        assert entry["k"][0] == (2, tcfg.n_kv_heads, slots, tcfg.hd)
    assert sum(s.mixer == "sliding" for s in tcfg.layer_specs()) == 7


@pytest.mark.parametrize("arch", DECODERS)
def test_port_prefill_equals_decode(arch):
    """The port's own rollout parity on its own random parameters: the
    last prefill logits equal a decode_step rollout's within 5e-3 (16
    steps: past gemma3's window of 8)."""
    tcfg = TC.get_smoke_config(arch)
    tp = TLM.init_params(tcfg, seed=9, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(10))
    # the rollout is dropless; so is this prefill
    if tcfg.n_experts:
        tcfg = dataclasses.replace(
            tcfg, capacity_factor=tcfg.n_experts / tcfg.top_k)
    logits, _ = TLM.forward(tcfg, tp, toks)
    cache = TLM.init_cache(tcfg, 2, 16, torch.float32, device="cpu")
    for t in range(16):
        lg, cache = TLM.decode_step(tcfg, tp, cache, toks[:, t:t + 1], t)
    np.testing.assert_allclose(to_numpy(lg[:, 0]), to_numpy(logits[:, -1]),
                               rtol=5e-3, atol=5e-3)


def test_init_params_matches_the_reference_tree():
    """Every new arch's parameter tree has the reference's leaves,
    shapes and dtypes (per layer, the groups unstacked)."""
    for arch in NEW_ARCHS:
        cfg, params, tcfg, _ = smoke_models(arch)
        ours = TLM.init_params(tcfg, seed=0, device="cpu")
        want = port_params(cfg, params)
        assert jax.tree.structure(jax.tree.map(lambda x: 0, ours)) == \
            jax.tree.structure(jax.tree.map(lambda x: 0, want)), arch
        for a, b in zip(leaves(ours), leaves(want)):
            assert a.shape == b.shape and a.dtype == b.dtype, arch


# ----------------------------------------------------------------------
# padded expert slots and the final softcap
# ----------------------------------------------------------------------

PADDED = dict(n_experts_padded=6)
SOFTCAP = dict(final_softcap=3.0)


@pytest.mark.parametrize("case", ["padded_experts", "softcap"])
def test_padded_experts_and_softcap_match_jax(case):
    """qwen2-moe's SMOKE with 4 experts in 6 slots (two dead, never
    routed to); tiny with a softcap of 3 (the logits of O(1) are bent
    hard): forward and a 12-step rollout."""
    if case == "padded_experts":
        cfg = dataclasses.replace(JC.get_smoke_config("qwen2-moe-a2.7b"),
                                  **PADDED)
    else:
        cfg = dataclasses.replace(tiny_cfg(), **SOFTCAP)
    params = JLM.init_params(cfg, jax.random.key(3))
    tcfg, tp = port_cfg(cfg), port_params(cfg, params)
    if case == "padded_experts":
        assert tp["layers"][0]["moe"]["w_up"].shape[0] == 6
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    exp, _ = JLM.forward(cfg, params, jnp.asarray(toks))
    out, _ = TLM.forward(tcfg, tp, torch.from_numpy(toks).long())
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    if case == "softcap":
        assert out.dtype == torch.float32
        assert float(out.abs().max()) < 3.0
    jl, tl, jt, tt = greedy_rollouts(cfg, steps=12)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_array_equal(tt, jt)


# ----------------------------------------------------------------------
# what still raises, and the trainer's arch flag
# ----------------------------------------------------------------------

def test_encoder_has_no_decode_step():
    tcfg = TC.get_smoke_config("hubert-xlarge")
    tp = TLM.init_params(tcfg, seed=0, device="cpu")
    cache = TLM.init_cache(tcfg, 1, 8, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="hubert-smoke.*no decode step"):
        TLM.decode_step(tcfg, tp, cache, torch.zeros((1, 1),
                                                     dtype=torch.long), 0)
    with pytest.raises(ValueError, match="hubert-smoke.*no decode step"):
        train.make_serve_step(tcfg, batch=1, max_seq=8, device="cpu")


@pytest.mark.parametrize("field", ["qkv_bias", "qk_norm"])
def test_paged_engine_refuses_what_its_executor_drops(field):
    """The reference's paged executor applies neither the qkv bias nor
    qk-norm; the port's engine refuses such a config."""
    tcfg = dataclasses.replace(port_cfg(tiny_cfg()), **{field: True})
    tp = TLM.init_params(tcfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="qk-norm"):
        ServingEngine(tcfg, tp, device="cpu")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cli_trains_every_new_arch(tmp_path, arch):
    """``python -m repro_torch.launch.train --arch`` takes each arch's
    SMOKE and feeds it tokens (an embeddings-mode arch embeds them)."""
    res = train.main(["--device", "cpu", "--arch", arch, "--steps", "1",
                      "--batch-size", "2", "--seq-len", "8",
                      "--checkpoint-dir", str(tmp_path)])
    assert res["steps"] == 1 and np.isfinite(res["final_loss"])
