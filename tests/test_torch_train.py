"""LM training in the port against the JAX package: ``lm.lm_loss`` and
its gradients, ``launch.train.make_train_step`` against the reference's
step composed without a mesh (``jax.value_and_grad`` of
``repro.models.lm.lm_loss``, then ``clip_by_global_norm``, then
``make_optimizer``'s update: the reference's own ``make_train_step`` is
red even on a one-device mesh, ROADMAP.md C), gradient accumulation,
remat, the foreach updates, restart parity and ``train_loop`` /
``python -m repro_torch.launch.train``.

Inputs come from numpy with a seed, and the reference's parameters cross
through ``params_from_numpy`` (so do its gradients).  Bounds at fp32:
losses and grad norms within 1e-5 relative, gradients and parameters
within 1e-4 relative L2 over the whole tree (the two frameworks sum the
fp32 matmuls in other orders, through every layer and step).  Port
against port (remat, foreach, restart) is exact."""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.configs import get_smoke_config
from repro.models import lm as JLM
from repro.optim.functional import clip_by_global_norm as jclip
from repro.optim.functional import make_optimizer as jmake
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataLoader, SyntheticLMDataset
from repro_torch.kernels import ops as kops
from repro_torch.launch import train
from repro_torch.models import lm as TLM
from repro_torch.optim.functional import make_optimizer as tmake
from torch_port_helpers import (cuda_device, port_cfg,  # noqa: F401
                                port_params, requires_cuda)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ARCHS = ("gemma-2b", "jamba-1.5-large-398b", "rwkv6-1.6b")
# (mask, z_loss) of each lm_loss case
LOSS_CASES = {"plain": (False, 1e-4), "mask": (True, 1e-4),
              "mask_no_z": (True, 0.0), "no_z": (False, 0.0)}


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over every leaf of two port-layout
    trees."""
    g = torch.cat([x.detach().double().reshape(-1) for x in leaves(got)])
    w = torch.cat([x.detach().double().reshape(-1) for x in leaves(want)])
    return float((g - w).norm() / w.norm())


def same_bits(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(leaves(a), leaves(b)))


def batch_np(cfg, b=2, s=16, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["mask"] = (rng.random((b, s)) > 0.3).astype(np.float32)
    return out


def to_port(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference_losses(arch: str):
    """Each LOSS_CASES loss of the reference and its gradient tree: two
    compiles, with and without a mask, ``z_loss`` traced."""
    cfg = get_smoke_config(arch)
    params = JLM.init_params(cfg, jax.random.key(0))
    b = batch_np(cfg, mask=True)
    plain = {k: v for k, v in b.items() if k != "mask"}
    steps = {mask: jax.jit(jax.value_and_grad(
        lambda p, z, batch=(b if mask else plain):
        JLM.lm_loss(cfg, p, batch, z_loss=z))) for mask in (False, True)}
    out = {}
    for name, (mask, z) in LOSS_CASES.items():
        val, grads = steps[mask](params, jnp.float32(z))
        out[name] = (float(val), jax.tree.map(np.asarray, grads))
    return cfg, params, b, out


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch, case):
    cfg, params, b, ref = reference_losses(arch)
    want, grads = ref[case]
    mask, z = LOSS_CASES[case]
    tcfg = port_cfg(cfg)
    tp = port_params(cfg, params)
    for x in leaves(tp):
        x.requires_grad_()
    batch = to_port(b if mask else {k: v for k, v in b.items()
                                    if k != "mask"})
    loss = TLM.lm_loss(tcfg, tp, batch, z_loss=z)
    got = torch.autograd.grad(loss, leaves(tp))
    assert abs(loss.item() - want) <= LOSS_RTOL * abs(want)
    ref = TLM.params_from_numpy(tcfg, grads, device="cpu")
    assert rel_l2(got, leaves(ref)) <= GRAD_RTOL
    if cfg.n_experts:
        # the MoE aux loss is in the loss: without it the values differ
        _, aux = TLM.forward(tcfg, tp, batch["tokens"])
        assert aux.item() > 0


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------

# The reference's Adafactor factors each scan-stacked leaf, norms
# included, over its last two axes and RMS-clips the whole stack of
# layers at once; the port's leaves are per layer.  Its case therefore
# gives the reference the same model as one group of every layer (each
# leaf a stack of one, where both compute the same update).
STEP_CASES = {"gemma_sgd": ("gemma-2b", "sgd", 0.05),
              "gemma_adamw": ("gemma-2b", "adamw", 1e-3),
              "gemma_adafactor": ("gemma-2b", "adafactor", 1e-2),
              "rwkv6_adamw": ("rwkv6-1.6b", "adamw", 1e-3)}


def reference_steps(cfg, params, opt, lr, batches):
    """The reference's step composed without a mesh, jitted: losses,
    grad norms and the final params."""
    init, update = jmake(opt, lr=lr)

    @jax.jit
    def step(p, o, b):
        loss, g = jax.value_and_grad(lambda q: JLM.lm_loss(cfg, q, b))(p)
        g, norm = jclip(g, 1.0)
        p, o = update(g, o, p)
        return p, o, loss, norm

    o, out = init(params), []
    for b in batches:
        params, o, loss, norm = step(params, o, b)
        out.append((float(loss), float(norm)))
    return out, params


def port_state(cfg, params, opt, lr):
    tp = port_params(cfg, params)
    return {"params": tp, "opt": tmake(opt, lr=lr)[0](tp),
            "step": torch.zeros((), dtype=torch.int32)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_three_train_steps_match_the_composed_reference(case):
    arch, opt, lr = STEP_CASES[case]
    cfg = get_smoke_config(arch)
    if opt == "adafactor":
        cfg = dataclasses.replace(
            cfg, pattern=cfg.pattern * cfg.n_groups + cfg.tail)
        assert cfg.n_groups == 1
    params = JLM.init_params(cfg, jax.random.key(1))
    batches = [batch_np(cfg, seed=s) for s in range(3)]
    want, want_params = reference_steps(cfg, params, opt, lr, batches)
    step = train.make_train_step(port_cfg(cfg), optimizer=opt, lr=lr,
                                 device="cpu")
    state = port_state(cfg, params, opt, lr)
    for b, (loss, norm) in zip(batches, want):
        state, m = step(state, to_port(b))
        assert abs(float(m["loss"]) - loss) <= LOSS_RTOL * abs(loss)
        assert abs(float(m["grad_norm"]) - norm) <= LOSS_RTOL * abs(norm)
    assert int(state["step"]) == 3
    ref = TLM.params_from_numpy(port_cfg(cfg),
                                jax.tree.map(np.asarray, want_params),
                                device="cpu")
    assert rel_l2(state["params"], ref) <= GRAD_RTOL


def gemma_state(seed=0, opt="adamw", lr=1e-3, **fields):
    cfg = dataclasses.replace(port_cfg(get_smoke_config("gemma-2b")),
                              **fields)
    return cfg, train.init_train_state(cfg, optimizer=opt, lr=lr,
                                       seed=seed, device="cpu")


def test_train_step_updates_the_state_in_place():
    cfg, state = gemma_state()
    ids = [id(x) for x in leaves(state)]
    ptrs = [x.data_ptr() for x in leaves(state)]
    before = [x.clone() for x in leaves(state["params"])]
    step = train.make_train_step(cfg, lr=1e-3, device="cpu")
    out, _ = step(state, to_port(batch_np(cfg)))
    assert out is state
    assert [id(x) for x in leaves(out)] == ids
    assert [x.data_ptr() for x in leaves(out)] == ptrs
    assert not any(torch.equal(a, b)
                   for a, b in zip(before, leaves(state["params"]))
                   if a.dim() == 2)
    assert int(state["opt"]["step"]) == 1 and int(state["step"]) == 1
    assert not any(x.requires_grad for x in leaves(state))


def test_accumulated_microbatches_match_the_full_batch():
    b = to_port(batch_np(get_smoke_config("gemma-2b"), b=4, seed=3))
    runs = []
    for accum in (1, 2):
        cfg, state = gemma_state()
        step = train.make_train_step(cfg, lr=1e-3, accum_steps=accum,
                                     device="cpu")
        losses = [float(step(state, b)[1]["loss"]) for _ in range(2)]
        runs.append((losses, state["params"]))
    (l1, p1), (l2, p2) = runs
    np.testing.assert_allclose(l2, l1, rtol=LOSS_RTOL)
    assert rel_l2(p2, p1) <= GRAD_RTOL


def test_accumulation_refuses_a_batch_that_does_not_split():
    cfg, state = gemma_state()
    step = train.make_train_step(cfg, accum_steps=3, device="cpu")
    with pytest.raises(ValueError, match="3 microbatches"):
        step(state, to_port(batch_np(cfg, b=4)))


def counting(monkeypatch, name):
    calls = []
    fn = getattr(kops, name)

    def wrapped(*a, **k):
        calls.append(1)
        return fn(*a, **k)
    monkeypatch.setattr(kops, name, wrapped)
    return calls


@pytest.mark.parametrize("arch,kernel", [("gemma-2b", "flash_attention_fwd"),
                                         ("jamba-1.5-large-398b",
                                          "mamba_scan_fwd")])
def test_remat_gives_the_same_grads_and_runs_the_forward_twice(
        monkeypatch, arch, kernel):
    cfg = get_smoke_config(arch)
    params = JLM.init_params(cfg, jax.random.key(2))
    b = to_port(batch_np(cfg, seed=4))
    calls = counting(monkeypatch, kernel)
    n = sum(s.mixer == ("attn" if "flash" in kernel else "mamba")
            for s in port_cfg(cfg).layer_specs())
    grads = {}
    for remat in ("none", "full"):
        tcfg = dataclasses.replace(port_cfg(cfg), remat=remat)
        tp = port_params(cfg, params)
        for x in leaves(tp):
            x.requires_grad_()
        calls.clear()
        loss = TLM.lm_loss(tcfg, tp, b)
        grads[remat] = torch.autograd.grad(loss, leaves(tp))
        assert len(calls) == n * (2 if remat == "full" else 1)
        with torch.no_grad():          # inference runs each layer once
            calls.clear()
            TLM.forward(tcfg, tp, b["tokens"])
            assert len(calls) == n
    assert all(torch.equal(a, c)
               for a, c in zip(grads["none"], grads["full"]))


@pytest.mark.parametrize("opt,kw", [("adamw", {}),
                                    ("sgd", {"momentum": 0.9}),
                                    ("adafactor", {})])
def test_foreach_matches_the_per_leaf_update(opt, kw):
    b = [to_port(batch_np(get_smoke_config("gemma-2b"), seed=s))
         for s in range(2)]
    states = []
    for foreach in (False, True):
        cfg = port_cfg(get_smoke_config("gemma-2b"))
        params = TLM.init_params(cfg, seed=5, device="cpu")
        state = {"params": params,
                 "opt": tmake(opt, lr=1e-2, **kw)[0](params),
                 "step": torch.zeros((), dtype=torch.int32)}
        step = train.make_train_step(cfg, optimizer=opt, lr=1e-2,
                                     foreach=foreach, opt_kwargs=kw,
                                     device="cpu")
        for x in b:
            step(state, x)
        states.append(state)
    assert same_bits(states[0], states[1])


def test_save_restore_continue_equals_an_uninterrupted_run(tmp_path):
    cfg = port_cfg(get_smoke_config("gemma-2b"))
    b = [to_port(batch_np(get_smoke_config("gemma-2b"), seed=s))
         for s in range(4)]
    step = train.make_train_step(cfg, lr=1e-3, device="cpu")
    _, whole = gemma_state(seed=7)
    whole_losses = [float(step(whole, x)[1]["loss"]) for x in b]

    _, first = gemma_state(seed=7)
    losses = [float(step(first, x)[1]["loss"]) for x in b[:2]]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(first, 2)
    mgr.wait()
    _, like = gemma_state(seed=8)
    resumed = mgr.restore_latest(like)
    assert same_bits(resumed, first)
    losses += [float(step(resumed, x)[1]["loss"]) for x in b[2:]]
    assert losses == whole_losses
    assert int(resumed["step"]) == 4
    assert same_bits(resumed, whole)


def test_train_loop_restart_runs_the_remaining_steps(tmp_path):
    cfg = port_cfg(get_smoke_config("gemma-2b"))
    kw = dict(batch_size=4, seq_len=16, optimizer="adamw", lr=1e-3,
              checkpoint_dir=str(tmp_path), checkpoint_every=3,
              log_every=100, device="cpu")
    first = train.train_loop(cfg, steps=7, **kw)
    assert first["steps"] == 7 and len(first["losses"]) == 7
    assert CheckpointManager(str(tmp_path)).all_steps() == [3, 6, 7]
    second = train.train_loop(cfg, steps=10, **kw)
    assert second["steps"] == 3 and len(second["losses"]) == 3
    assert all(np.isfinite(second["losses"] + second["grad_norms"]))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [7, 9, 10]
    _, like = gemma_state()
    assert int(mgr.restore_latest(like)["step"]) == 10
    # a restarted run replays the data from the start of epoch 0, as the
    # reference's does: its first batch is the first run's first batch
    loader = DataLoader(SyntheticLMDataset(cfg.vocab_size, 16, size=1 << 20,
                                           seed=0),
                        batch_size=4, shuffle=True, num_workers=2, seed=0,
                        drop_last=True)
    with torch.no_grad(), rt.default_device("cpu"):
        tokens, labels = next(iter(loader))
        _, state = gemma_state(opt="adamw")
        restored = mgr.restore(7, state)
        loss = TLM.lm_loss(cfg, restored["params"],
                           {"tokens": tokens.data, "labels": labels.data})
    assert abs(float(loss) - second["losses"][0]) <= 1e-6 * float(loss)


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    res = train.main(["--device", "cpu", "--size", "2m", "--steps", "3",
                      "--batch-size", "2", "--seq-len", "16",
                      "--checkpoint-dir", str(tmp_path)])
    assert res["steps"] == 3 and np.isfinite(res["final_loss"])
    out = capsys.readouterr().out
    assert "training gpt-2m: 4L d=128 vocab=2048 on cpu" in out
    assert "done: 3 steps" in out
    # resumed: nothing left to run
    assert train.main(["--device", "cpu", "--size", "2m", "--steps", "3",
                       "--checkpoint-dir", str(tmp_path)])["steps"] == 0


def test_cli_as_a_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--size", "2m", "--steps", "3", "--checkpoint-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "done: 3 steps" in out.stdout


def test_cli_arch_takes_the_ported_smoke_configs(tmp_path):
    res = train.main(["--device", "cpu", "--arch", "rwkv6-1.6b", "--steps",
                      "1", "--batch-size", "2", "--seq-len", "8",
                      "--checkpoint-dir", str(tmp_path)])
    assert res["steps"] == 1
    # every arch of the registry is ported; a name outside it is refused
    from repro import configs as jconfigs
    assert list(train.ARCHS) == jconfigs.ARCHS
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--arch", "gpt-5"])


def test_entry_points_need_cuda_unless_cpu_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1", "--checkpoint-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
    cfg = port_cfg(get_smoke_config("gemma-2b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.make_train_step(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train_loop(cfg, steps=1, batch_size=2, seq_len=8)


def test_cli_keeps_the_reference_sizes():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from examples import train_lm
    assert train.SIZES == train_lm.SIZES
    from repro.configs import ARCHS as JARCHS
    assert list(train.ARCHS) == JARCHS


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------

@requires_cuda
def test_cuda_pinned_batches_equal_the_unpinned_ones():
    ds = SyntheticLMDataset(256000, 128, size=64, seed=3)
    runs = []
    for pin in (False, True):
        dl = DataLoader(ds, batch_size=4, shuffle=True, seed=0,
                        num_workers=2, pin_memory=pin)
        runs.append([(t.data.cpu(), l.data.cpu()) for t, l in dl])
        if pin:
            assert dl.staging.copies == 2 * len(dl)
            assert dl.staging.all_pinned
            assert dl.staging.streams and torch.cuda.default_stream(
            ).stream_id not in dl.staging.streams
    assert len(runs[0]) == len(runs[1]) == 16
    for (a, b), (c, d) in zip(*runs):
        assert torch.equal(a, c) and torch.equal(b, d)
