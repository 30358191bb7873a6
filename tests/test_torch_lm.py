"""The port's dense-cache path against the JAX package: the attention
layer with and without a cache, ``lm.forward``, ``lm.decode_step``
rollouts, and the step builders of ``launch/train.py``.

Inputs are made by numpy from a seed; the reference's parameters cross
through ``params_from_numpy``.  The reference runs its jnp oracle
(``attn_backend="ref"``) except where a case says ``auto``: there its
flash kernel runs in interpret mode, as the reference's own tests run it
on the CPU.  Tolerances at fp32: 2e-5 on outputs and logits of O(1) (the
serving tier of docs/kernels.md: the two frameworks sum the fp32 matmuls
in other orders, through every layer); greedy tokens identical;
prefill == decode at ``rollout_parity``'s 5e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jgemma
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as tops
from repro_torch.launch.train import make_prefill_step, make_serve_step
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from torch_port_helpers import (PARITY_RTOL, cuda_device,  # noqa: F401
                                greedy_rollouts, port_cfg, port_params,
                                port_rollout_parity, requires_cuda, tiny_cfg,
                                to_numpy, to_torch)

TOL = dict(rtol=2e-5, atol=2e-5)


def jax_cfg(which):
    if which == "tiny":
        return tiny_cfg()
    if which == "tiny_auto":
        return dataclasses.replace(tiny_cfg(), attn_backend="auto")
    if which == "tiny_mqa":
        return dataclasses.replace(tiny_cfg(), n_kv_heads=1)
    return jgemma.SMOKE


def attn_params(seed, d=32, hq=4, hkv=2, hd=16, bias=False, qk_norm=False):
    rng = np.random.default_rng(seed)
    p = {"wq": rng.standard_normal((d, hq * hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, hkv * hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, hkv * hd)) / np.sqrt(d),
         "wo": rng.standard_normal((hq * hd, d)) / np.sqrt(hq * hd)}
    if bias:
        p["bq"] = rng.standard_normal(hq * hd) * 0.1
        p["bk"] = rng.standard_normal(hkv * hd) * 0.1
        p["bv"] = rng.standard_normal(hkv * hd) * 0.1
    if qk_norm:
        p["q_norm"] = 1 + rng.standard_normal(hd) * 0.1
        p["k_norm"] = 1 + rng.standard_normal(hd) * 0.1
    return {k: v.astype(np.float32) for k, v in p.items()}


LAYER_CASES = {
    "plain": dict(),
    "qkv_bias": dict(bias=True),
    "q_norm": dict(qk_norm=True),
    "window": dict(window=5),
    "bidirectional_norope": dict(causal=False, rope_theta=None),
    "query_scale": dict(query_scale=0.3),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_attention_layer_prefill_matches_jax(case):
    kw = dict(LAYER_CASES[case])
    p = attn_params(1, bias=kw.pop("bias", False),
                    qk_norm=kw.pop("qk_norm", False))
    x = np.random.default_rng(2).standard_normal((2, 12, 32)).astype(
        np.float32)
    common = dict(n_heads=4, n_kv_heads=2, head_dim=16,
                  q_norm="q_norm" in p, **kw)
    exp, _ = JL.attention({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), backend="ref", **common)
    out, cache = TL.attention({k: to_torch(v) for k, v in p.items()},
                              to_torch(x), **common)
    assert cache is None
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)


@pytest.mark.parametrize("window,cache_len", [(None, None), (4, None),
                                              (None, 6)])
@pytest.mark.parametrize("bias", [False, True])
def test_attention_layer_decode_matches_jax(bias, window, cache_len):
    """One decode token written at slot 5 of a partly filled cache; the
    port writes in place and returns the same tensors."""
    p = attn_params(3, bias=bias)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    kc = rng.standard_normal((2, 2, 10, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 2, 10, 16)).astype(np.float32)
    kc[:, :, 6:] = vc[:, :, 6:] = 0.0
    common = dict(n_heads=4, n_kv_heads=2, head_dim=16, window=window,
                  cache_pos=5, cache_len=cache_len)
    exp, jc = JL.attention({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), backend="ref",
                           cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                           **common)
    tcache = {"k": to_torch(kc), "v": to_torch(vc)}
    k_before = tcache["k"]
    out, nc = TL.attention({k: to_torch(v) for k, v in p.items()},
                           to_torch(x), cache=tcache, **common)
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    assert nc["k"] is k_before
    np.testing.assert_allclose(to_numpy(nc["k"]), np.asarray(jc["k"]),
                               **TOL)
    np.testing.assert_allclose(to_numpy(nc["v"]), np.asarray(jc["v"]),
                               **TOL)


@pytest.mark.parametrize("which", ["tiny", "tiny_auto", "tiny_mqa",
                                   "gemma_smoke"])
def test_forward_matches_jax(which):
    """S = 128 >= the reference's _PALLAS_MIN_SEQ, so under ``auto`` the
    JAX side runs its flash kernel (interpret mode)."""
    cfg = jax_cfg(which)
    params = JLM.init_params(cfg, jax.random.key(5))
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 128)).astype(np.int32)
    exp, exp_aux = JLM.forward(cfg, params, jnp.asarray(toks))
    out, aux = TLM.forward(port_cfg(cfg), port_params(cfg, params),
                           torch.from_numpy(toks).long())
    assert tuple(out.shape) == (2, 128, cfg.vocab_size)
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    assert float(aux) == float(exp_aux) == 0.0


@pytest.mark.parametrize("which", ["tiny", "tiny_mqa", "gemma_smoke"])
def test_decode_rollout_matches_jax(which):
    """4 prompt tokens fed one a step, then greedy: logits at every step
    within 2e-5 and 17 greedy tokens identical."""
    jl, tl, jt, tt = greedy_rollouts(jax_cfg(which), steps=20)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    assert jt.shape[1] == 17
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("which", ["tiny", "tiny_mqa", "gemma_smoke"])
def test_port_prefill_equals_decode(which):
    """The port's own ``rollout_parity`` (tests/test_models_lm.py): the
    last prefill logits equal a decode_step rollout's, on the port's own
    random parameters."""
    tcfg = port_cfg(jax_cfg(which))
    tp = TLM.init_params(tcfg, seed=9, device="cpu")
    tokens = torch.randint(0, tcfg.vocab_size, (2, 10),
                           generator=torch.Generator().manual_seed(10))
    port_rollout_parity(tcfg, tp, tokens)


def test_untied_head_and_layer_norm_forward_matches_jax():
    cfg = dataclasses.replace(tiny_cfg(), tie_embeddings=False,
                              norm="layer", gated_mlp=False, act="relu")
    params = JLM.init_params(cfg, jax.random.key(11))
    toks = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    exp, _ = JLM.forward(cfg, params, jnp.asarray(toks))
    out, _ = TLM.forward(port_cfg(cfg), port_params(cfg, params),
                         torch.from_numpy(toks).long())
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)


def test_step_builders_on_cpu():
    cfg = jgemma.SMOKE
    tcfg = port_cfg(cfg)
    tp = TLM.init_params(tcfg, seed=13, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(14))
    prefill = make_prefill_step(tcfg, device="cpu")
    logits = prefill(tp, {"tokens": toks})
    torch.testing.assert_close(logits, TLM.forward(tcfg, tp, toks)[0],
                               rtol=0, atol=0)
    assert not logits.requires_grad

    serve = make_serve_step(tcfg, batch=2, max_seq=8,
                            cache_dtype=torch.float32, device="cpu")
    cache = TLM.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    for t in range(6):
        lg, cache = serve(tp, cache, toks[:, t:t + 1], t)
    torch.testing.assert_close(lg[:, 0], logits[:, -1], rtol=PARITY_RTOL,
                               atol=PARITY_RTOL)
    with pytest.raises(ValueError, match="outside the cache"):
        serve(tp, cache, toks[:, :1], 8)
    with pytest.raises(ValueError, match="built for"):
        serve(tp, TLM.init_cache(tcfg, 2, 9, torch.float32, device="cpu"),
              toks[:, :1], 0)


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = port_cfg(jgemma.SMOKE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_prefill_step(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serve_step(tcfg, batch=1, max_seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLM.init_cache(tcfg, 1, 8)


def test_unported_features_raise():
    tcfg = dataclasses.replace(port_cfg(tiny_cfg()), final_softcap=30.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_prefill_step(tcfg, device="cpu")
    sliding = dataclasses.replace(
        port_cfg(tiny_cfg()), pattern=(TLM.BlockSpec("sliding", "dense"),))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TLM.init_cache(sliding, 1, 8, device="cpu")


def test_sdpa_backends_and_mask_on_cpu():
    """Every backend matches the oracles called by name on the CPU; an
    explicit mask takes sdpa_masked there and matches the reference's
    sdpa_ref with the same mask; unknown backends raise."""
    rng = np.random.default_rng(15)
    q = rng.standard_normal((2, 4, 9, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    mask = rng.random((2, 1, 9, 9)) > 0.3
    mask[..., 0] = True
    t = to_torch
    oracle = TA.sdpa_ref(t(q), t(k), t(v), is_causal=True, window=4)
    for backend in TA.BACKENDS:
        torch.testing.assert_close(
            TA.sdpa(t(q), t(k), t(v), is_causal=True, window=4,
                    backend=backend), oracle, rtol=1e-6, atol=1e-6)
    exp = JA.sdpa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      mask=jnp.asarray(mask), is_causal=True)
    out = TA.sdpa(t(q), t(k), t(v), mask=torch.from_numpy(mask),
                  is_causal=True)
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    with pytest.raises(ValueError):
        TA.sdpa(t(q), t(k), t(v), backend="triton")
    with pytest.raises(ValueError):
        TA.decode_attention(t(q[:, :, :1]), t(k), t(v), 5, backend="jnp")
    qd = t(q[:, :, :1])
    oracle = DA.decode_attention_plain(
        qd.reshape(2, 2, 2, 16), t(k), t(v), torch.full((2,), 5),
        scale=16 ** -0.5).reshape(2, 4, 1, 16)
    for backend in TA.BACKENDS:
        torch.testing.assert_close(
            TA.decode_attention(qd, t(k), t(v), 5, backend=backend), oracle,
            rtol=0, atol=0)
    np.testing.assert_array_equal(to_numpy(TA.repeat_kv(t(k), 2)),
                                  np.asarray(JA.repeat_kv(jnp.asarray(k),
                                                          2)))


def _spy_kernels(monkeypatch):
    """Count the calls that reach the flash and decode kernel functions
    behind ``kernels.ops`` (the plain versions run under them on the
    CPU, the kernels on the card)."""
    calls = {"flash": 0, "decode": 0}

    def spy(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tops, "flash_attention_fwd",
                        spy("flash", tops.flash_attention_fwd))
    monkeypatch.setattr(tops, "decode_attention_fwd",
                        spy("decode", tops.decode_attention_fwd))
    return calls


@pytest.mark.parametrize("backend", ["auto", "pallas", "ref"])
def test_every_backend_goes_through_the_kernels(monkeypatch, backend):
    """The config's attn_backend selects nothing: prefill and decode go
    through the kernel functions once per layer whatever it says, so no
    config runs plain attention on the card."""
    tcfg = dataclasses.replace(port_cfg(jgemma.SMOKE), attn_backend=backend)
    tp = TLM.init_params(tcfg, seed=13, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 5),
                         generator=torch.Generator().manual_seed(14))
    calls = _spy_kernels(monkeypatch)
    make_prefill_step(tcfg, device="cpu")(tp, {"tokens": toks})
    assert calls == {"flash": tcfg.n_layers, "decode": 0}
    serve = make_serve_step(tcfg, batch=2, max_seq=8,
                            cache_dtype=torch.float32, device="cpu")
    cache = TLM.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    for t in range(3):
        _, cache = serve(tp, cache, toks[:, t:t + 1], t)
    assert calls == {"flash": tcfg.n_layers, "decode": 3 * tcfg.n_layers}
    with pytest.raises(ValueError, match="backend"):
        make_prefill_step(dataclasses.replace(tcfg, attn_backend="jnp"),
                          device="cpu")(tp, {"tokens": toks})


def _to_device(p, dev):
    if isinstance(p, dict):
        return {k: _to_device(v, dev) for k, v in p.items()}
    if isinstance(p, list):
        return [_to_device(v, dev) for v in p]
    return p.to(dev)


@requires_cuda
def test_cuda_smoke_steps_launch_the_kernels(cuda_device):
    """gemma SMOKE (attn_backend "ref") on the card: the prefill launches
    the flash kernel and each decode step the decode kernel once per
    layer, and both agree with the same steps on the CPU."""
    tcfg = port_cfg(jgemma.SMOKE)
    assert tcfg.attn_backend == "ref"
    toks = torch.randint(0, tcfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(14))
    cpu_params = TLM.init_params(tcfg, seed=13, device="cpu")
    outs = {}
    for dev in ("cpu", cuda_device):
        tp = _to_device(cpu_params, dev)
        flash0, decode0 = FA.counter.launches, DA.decode_counter.launches
        logits = make_prefill_step(tcfg, device=dev)(
            tp, {"tokens": toks.to(dev)})
        serve = make_serve_step(tcfg, batch=2, max_seq=8,
                                cache_dtype=torch.float32, device=dev)
        cache = TLM.init_cache(tcfg, 2, 8, torch.float32, device=dev)
        for t in range(6):
            lg, cache = serve(tp, cache, toks[:, t:t + 1].to(dev), t)
        outs[str(dev)] = (logits.cpu(), lg.cpu())
        launched = (FA.counter.launches - flash0,
                    DA.decode_counter.launches - decode0)
        assert launched == ((0, 0) if dev == "cpu"
                            else (tcfg.n_layers, 6 * tcfg.n_layers))
    for a, b in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)
