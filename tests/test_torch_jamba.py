"""The port's jamba path against the JAX package: the Mamba scan's plain
version and its autograd wrapper, ``layers.mamba`` with and without a
cache, the GShard ``layers.moe``, ``lm.forward`` and ``lm.decode_step``
rollouts of jamba configs, the ``cast_params`` rule, and the cache check
of ``make_serve_step``.

Inputs are made by numpy from a seed; the reference's parameters cross
through ``params_from_numpy``.  The reference runs its step-loop oracle
``_ssm_scan_ref``, or under ``"pallas"`` its Mamba kernel in interpret
mode, as its own tests run it on the CPU.  Tolerances at fp32: 2e-5 on
scan outputs, states, layer outputs, aux losses and logits of O(1) (the
serving tier of docs/kernels.md: the two frameworks sum the fp32
products in other orders); greedy tokens identical; prefill == decode at
``rollout_parity``'s 5e-3.  Cases that hold the CUDA kernel against its
plain version need the card and skip elsewhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import jamba_1_5_large_398b as jjamba
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch.configs import jamba_1_5_large_398b as tjamba
from repro_torch.kernels import mamba as MB
from repro_torch.kernels import ops as tops
from repro_torch.launch.train import make_prefill_step, make_serve_step
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from torch_port_helpers import (cuda_device, greedy_rollouts,  # noqa: F401
                                port_cfg, port_params, port_rollout_parity,
                                requires_cuda, to_numpy, to_torch)

TOL = dict(rtol=2e-5, atol=2e-5)

# the reference's own kernel-test shapes (tests/test_kernels.py::
# TestMambaScan), the last one ragged against its 64-step chunks
SCAN_SHAPES = [(2, 96, 256, 16), (1, 64, 512, 16), (1, 128, 640, 8),
               (1, 130, 128, 16)]


def scan_inputs(seed, shape, state=False):
    """The reference tests' distribution: x, B, C ~ N(0, 0.5^2), dt =
    softplus(N(0, 1)) * 0.1, A = -exp(N(0, 1)), D = 1; an initial state ~
    N(0, 0.5^2) when asked for."""
    b, s, di, n = shape
    rng = np.random.default_rng(seed)

    def normal(*sh, scale=1.0):
        return (rng.standard_normal(sh) * scale).astype(np.float32)

    x = normal(b, s, di, scale=0.5)
    dt = (np.log1p(np.exp(normal(b, s, di))) * 0.1).astype(np.float32)
    bm, cm = normal(b, s, n, scale=0.5), normal(b, s, n, scale=0.5)
    a = -np.exp(normal(di, n))
    d = np.ones((di,), np.float32)
    h0 = normal(b, di, n, scale=0.5) if state else None
    return x, dt, bm, cm, a, d, h0


def port_scan(x, dt, bm, cm, a, d, h0=None):
    y, h = MB.mamba_scan_plain(*(to_torch(v) for v in (x, dt, bm, cm, a, d)),
                               None if h0 is None else to_torch(h0))
    return to_numpy(y), to_numpy(h)


@pytest.mark.parametrize("oracle", ["ref", "pallas"])
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_scan_plain_matches_jax(shape, oracle):
    """``ref.mamba_scan`` (the step-loop oracle) and ``ops.mamba_scan``
    (the Pallas kernel in interpret mode)."""
    args = scan_inputs(1, shape)[:6]
    y, _ = port_scan(*args)
    fn = jref.mamba_scan if oracle == "ref" else jops.mamba_scan
    exp = fn(*(jnp.asarray(v) for v in args))
    np.testing.assert_allclose(y, np.asarray(exp), **TOL)


def reference_decode_step(x, dt, bm, cm, a, d, h):
    """The reference's decode recurrence for one token
    (repro/models/layers.py:517-524), in jnp."""
    dA = jnp.exp(dt[:, 0, :, None] * a)
    h = dA * h + (dt[:, 0] * x[:, 0])[..., None] * bm[:, 0, None, :]
    y = jnp.einsum("bdn,bn->bd", h, cm[:, 0])[:, None] + x * d
    return y, h


def test_scan_state_continuity():
    """A sweep split at step 37 (the first part's final state handed to
    the second) equals the whole sweep, and so do single steps from the
    state against the reference's decode recurrence: outputs and final
    state within 2e-5."""
    x, dt, bm, cm, a, d, h0 = scan_inputs(2, (2, 80, 96, 16), state=True)
    y, h = port_scan(x, dt, bm, cm, a, d, h0)
    sl = [np.s_[:, :37], np.s_[:, 37:]]
    y1, h1 = port_scan(*(v[sl[0]] for v in (x, dt, bm, cm)), a, d, h0)
    y2, h2 = port_scan(*(v[sl[1]] for v in (x, dt, bm, cm)), a, d, h1)
    np.testing.assert_allclose(np.concatenate([y1, y2], 1), y, **TOL)
    np.testing.assert_allclose(h2, h, **TOL)
    jh = jnp.asarray(h0)
    for t in range(3):
        step = [v[:, t:t + 1] for v in (x, dt, bm, cm)]
        ys, hs = port_scan(*step, a, d, np.asarray(jh))
        ey, jh = reference_decode_step(*(jnp.asarray(v) for v in step),
                                       jnp.asarray(a), jnp.asarray(d), jh)
        np.testing.assert_allclose(ys, np.asarray(ey), **TOL)
        np.testing.assert_allclose(hs, np.asarray(jh), **TOL)


def test_scan_plain_takes_strided_projections():
    """B and C as column views of one (B, S, R + 2N) tensor, as the layer
    passes them, give the result of contiguous copies exactly."""
    x, dt, _, _, a, d, h0 = scan_inputs(3, (2, 20, 64, 16), state=True)
    proj = torch.randn((2, 20, 8 + 32),
                       generator=torch.Generator().manual_seed(4))
    bm, cm = proj[..., 8:24], proj[..., 24:]
    args = [to_torch(x), to_torch(dt)]
    tail = [to_torch(a), to_torch(d), to_torch(h0)]
    y1, h1 = tops.mamba_scan(*args, bm, cm, *tail)
    y2, h2 = tops.mamba_scan(*args, bm.contiguous(), cm.contiguous(), *tail)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(h1, h2, rtol=0, atol=0)


def test_scan_gradients_match_jax():
    """Gradients of ``ops.mamba_scan`` (backward recomputes through the
    plain version) against ``jax.grad`` of the oracle for all six inputs,
    with a random cotangent on y (tests/test_kernels.py::TestMambaScan::
    test_grads shape).  1e-4: the gradients sum 48 steps of fp32 products
    in two orders."""
    shape = (1, 48, 128, 16)
    args = scan_inputs(5, shape)[:6]
    g_y = np.random.default_rng(6).standard_normal(shape[:3]).astype(
        np.float32)
    exp = jax.grad(lambda *v: jnp.sum(jref.mamba_scan(*v) * g_y),
                   argnums=tuple(range(6)))(*(jnp.asarray(v) for v in args))
    ins = [to_torch(v).requires_grad_() for v in args]
    y, _ = tops.mamba_scan(*ins)
    (y * to_torch(g_y)).sum().backward()
    for t, e in zip(ins, exp):
        np.testing.assert_allclose(to_numpy(t.grad), np.asarray(e),
                                   rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# layers.mamba
# ----------------------------------------------------------------------

def mamba_block_params(seed, d=32, n=16):
    """The reference's ``mamba_init`` (fp32) with a random conv bias, D
    and norm, so that a dropped term shows."""
    p = jax.tree.map(np.asarray, JL.mamba_init(jax.random.key(seed), d,
                                               d_state=n,
                                               dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "D", "norm"):
        p[name] = rng.uniform(0.5, 1.5, p[name].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_mamba_layer_prefill_and_decode_match_jax(backend):
    """``layers.mamba`` without a cache (S=12), then one decode token
    against a random cache: outputs and both new cache entries within
    2e-5; the port's cache is updated in place and returned as it is."""
    p = mamba_block_params(7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: to_torch(v) for k, v in p.items()}
    exp, jc = JL.mamba(jp, jnp.asarray(x), d_state=16, backend=backend)
    out, tc = TL.mamba(tp, to_torch(x), d_state=16, backend=backend)
    assert jc is None and tc is None
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)

    x1 = rng.standard_normal((2, 1, 32)).astype(np.float32)
    cache = {"conv": rng.standard_normal((2, 3, 64)).astype(np.float32),
             "ssm": (rng.standard_normal((2, 64, 16)) * 0.5).astype(
                 np.float32)}
    exp, jc = JL.mamba(jp, jnp.asarray(x1), d_state=16, backend=backend,
                       cache={k: jnp.asarray(v) for k, v in cache.items()})
    tcache = {k: to_torch(v) for k, v in cache.items()}
    before = dict(tcache)
    out, tc = TL.mamba(tp, to_torch(x1), d_state=16, backend=backend,
                       cache=tcache)
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    for name in cache:
        assert tc[name] is before[name]
        np.testing.assert_allclose(to_numpy(tc[name]), np.asarray(jc[name]),
                                   **TOL)


def test_mamba_layer_decode_continues_prefill():
    """The port's layer: a prefill of 9 tokens, then 3 decode steps from
    a cache that starts at zeros and sees the 9 tokens one by one, equal
    the prefill of all 12 tokens at its last 3 positions (2e-5)."""
    p = {k: to_torch(v) for k, v in mamba_block_params(9).items()}
    x = torch.randn((2, 12, 32), generator=torch.Generator().manual_seed(10))
    full, _ = TL.mamba(p, x)
    cache = {"conv": torch.zeros((2, 3, 64)),
             "ssm": torch.zeros((2, 64, 16))}
    outs = [TL.mamba(p, x[:, t:t + 1], cache=cache)[0] for t in range(12)]
    torch.testing.assert_close(torch.cat(outs, 1), full, **TOL)


# ----------------------------------------------------------------------
# layers.moe
# ----------------------------------------------------------------------

MOE_CASES = {
    # name: (tokens (B, S), moe_init / moe keyword arguments, group env)
    "drops_cf0.5": ((2, 16), dict(capacity_factor=0.5), None),
    "drops_cf1.25": ((2, 16), dict(capacity_factor=1.25), None),
    "dropless": ((2, 16), dict(capacity_factor=2.0), None),
    "four_groups": ((4, 16), dict(capacity_factor=1.25), "16"),
    "one_group_env0": ((4, 16), dict(capacity_factor=1.25), "0"),
    "uneven_groups": ((3, 10), dict(capacity_factor=1.25), "8"),
    "shared_experts": ((2, 16), dict(capacity_factor=1.25, n_shared=2),
                       None),
    "padded_slots": ((2, 16), dict(capacity_factor=1.25, n_padded=6),
                     None),
    "top1_ungated": ((2, 16), dict(capacity_factor=1.0, top_k=1,
                                   gated=False), None),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_matches_jax(case, monkeypatch):
    """``layers.moe`` against the reference's on the reference's fp32
    params (4 experts of 48, top-2 unless stated): outputs and the Switch
    aux loss within 2e-5.  Drops (capacity factors 0.5 and 1.25, where
    some (token, choice) pairs lose their slot), dropless, several groups
    through REPRO_MOE_GROUP_TOKENS (4 of 16 tokens, one for "0", and 30
    tokens in groups of 8 rounded down to a divisor, 3 of 10), shared
    experts, dead padded slots, and top-1 without a gate."""
    (b, s), kw, env = MOE_CASES[case]
    if env is not None:
        monkeypatch.setenv("REPRO_MOE_GROUP_TOKENS", env)
    top_k = kw.get("top_k", 2)
    n_padded = kw.get("n_padded")
    jp = JL.moe_init(jax.random.key(11), 32, 48, 4, jnp.float32,
                     gated=kw.get("gated", True),
                     n_shared=kw.get("n_shared", 0), n_padded=n_padded)
    x = np.random.default_rng(12).standard_normal((b, s, 32)).astype(
        np.float32)
    run = dict(top_k=top_k, n_experts=4,
               capacity_factor=kw["capacity_factor"], n_padded=n_padded)
    exp, exp_aux = JL.moe(jp, jnp.asarray(x), **run)
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a)), jp)
    out, aux = TL.moe(tp, to_torch(x), **run)
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    np.testing.assert_allclose(float(aux), float(exp_aux), **TOL)
    assert aux.dtype == torch.float32 and float(aux) > 0.0


def test_moe_top_k_breaks_ties_as_jax():
    """Equal probabilities: the lower expert index wins, as in
    ``jax.lax.top_k``."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.0, 0.5, 0.0, 0.5], [0.4, 0.2, 0.4, 0.0]],
                     np.float32)
    vals, idx = TL._top_k(to_torch(probs), 2)
    ev, ei = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ei))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ev))


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

def jamba_cfg(which):
    if which == "smoke":
        return jjamba.SMOKE
    # every kind of block in 4 layers, d_state 8, under "pallas"
    pattern = tuple(JLM.BlockSpec(mixer=("attn" if i == 2 else "mamba"),
                                  ffn=("moe" if i % 2 else "dense"))
                    for i in range(4))
    return dataclasses.replace(jjamba.SMOKE, name="jamba-tiny4",
                               n_layers=4, pattern=pattern,
                               mamba_d_state=8, attn_backend="pallas")


@pytest.mark.parametrize("which", ["smoke", "tiny4"])
def test_forward_matches_jax(which):
    """jamba SMOKE (8 layers, 4 experts, capacity factor 1.25, so some
    tokens are dropped) and a 4-layer pattern with d_state 8 under
    "pallas" (the JAX side runs its Mamba kernel in interpret mode), at
    (2, 64): logits and the summed aux loss within 2e-5."""
    cfg = jamba_cfg(which)
    params = JLM.init_params(cfg, jax.random.key(13))
    toks = np.random.default_rng(14).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    exp, exp_aux = JLM.forward(cfg, params, jnp.asarray(toks))
    out, aux = TLM.forward(port_cfg(cfg), port_params(cfg, params),
                           torch.from_numpy(toks).long())
    assert tuple(out.shape) == (2, 64, cfg.vocab_size)
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    np.testing.assert_allclose(float(aux), float(exp_aux), **TOL)
    assert float(aux) > 0.0


@pytest.mark.parametrize("which", ["smoke", "tiny4"])
def test_decode_rollout_matches_jax(which):
    """4 prompt tokens fed one a step, then greedy: logits at every step
    within 2e-5 and 13 greedy tokens identical."""
    jl, tl, jt, tt = greedy_rollouts(jamba_cfg(which), steps=16)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    assert jt.shape[1] == 13
    np.testing.assert_array_equal(tt, jt)


def test_rollout_with_bf16_cache_matches_jax():
    """fp32 weights served from a bf16 cache: the reference returns the
    conv rows in the activation dtype (its concat promotes them to fp32),
    so the port holds them in fp32 (held in bf16 they moved the logits by
    2e-2); the ssm state is fp32 in both.  2e-5, identical greedy tokens.
    The config is jamba SMOKE's mamba/dense and mamba/moe blocks, twice,
    without its attn layer: bf16 keys round fp32 values that the two
    frameworks compute 1e-7 apart, and a value at a rounding boundary
    lands one bf16 step away; the next test bounds that case."""
    pattern = (JLM.BlockSpec("mamba", "dense"), JLM.BlockSpec("mamba", "moe"))
    cfg = dataclasses.replace(jjamba.SMOKE, name="jamba-mamba4",
                              n_layers=4, pattern=pattern)
    jl, tl, jt, tt = greedy_rollouts(cfg, steps=10, cache_dtype="bfloat16")
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_array_equal(tt, jt)


def test_rollout_with_bf16_kv_cache_matches_jax():
    """jamba SMOKE with its attn layer, fp32 weights and a bf16 cache: 4
    prompt tokens fed one a step, then 6 greedy.

    The two frameworks compute each fp32 key and value 1e-7 apart, so an
    element near a bf16 rounding boundary is stored one bf16 step (2^-8
    to 2^-7 of its size) away from the reference's.  The test holds the
    KV caches to exactly that: every element equal or one step apart,
    and fewer than 1% apart.  One such key element, of size about 1,
    moves its attention logit by |q_j| 2^-8 / sqrt(head_dim), and through
    the softmax, the out projection and the last three layers SMOKE's
    logits (RMS about 1) by 3.4e-4 over these steps (PyTorch 2 against
    JAX on the CPU).  So the logits are held at 1e-3, about three times
    that and 1e-3 of their RMS, and the greedy tokens must be
    identical."""
    cfg = jjamba.SMOKE
    tcfg = port_cfg(cfg)
    attn = [b.mixer for b in tcfg.layer_specs()].index("attn")
    params = JLM.init_params(cfg, jax.random.key(7))
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 4)).astype(np.int32)
    step = jax.jit(lambda p, c, t, pos: JLM.decode_step(cfg, p, c, t, pos))
    jc = JLM.init_cache(cfg, 2, 16, jnp.bfloat16)
    tp = port_params(cfg, params)
    tc = TLM.init_cache(tcfg, 2, 16, torch.bfloat16, device="cpu")
    j_tok = toks[:, :1]
    j_out, t_out = [], []
    for pos in range(10):
        jl, jc = step(params, jc, jnp.asarray(j_tok), jnp.int32(pos))
        tl, tc = TLM.decode_step(tcfg, tp, tc,
                                 torch.tensor(j_tok, dtype=torch.long), pos)
        np.testing.assert_allclose(to_numpy(tl), np.asarray(jl),
                                   rtol=0, atol=1e-3)
        j_out.append(np.asarray(jnp.argmax(jl[:, -1], -1)))
        t_out.append(tl[:, -1].argmax(-1).numpy())
        j_tok = toks[:, pos + 1:pos + 2] if pos + 1 < 4 else j_out[-1][:, None]
    np.testing.assert_array_equal(np.stack(t_out[3:]), np.stack(j_out[3:]))
    for kv in ("k", "v"):
        want = np.asarray(jc["groups"][attn][kv][0].astype(jnp.float32))
        got = to_numpy(tc[attn][kv]).reshape(want.shape)
        apart = got != want
        assert apart.mean() < 0.01
        assert np.all(np.abs(got - want)[apart]
                      <= np.abs(want)[apart] * 2.0 ** -7)


@pytest.mark.parametrize("which", ["smoke", "tiny4"])
def test_port_prefill_equals_decode(which):
    """At a dropless capacity factor (E / k, the reference's
    ``test_jamba_hybrid_pattern`` does the same) the last prefill logits
    equal a decode rollout's."""
    cfg = dataclasses.replace(jamba_cfg(which), capacity_factor=2.0)
    tcfg = port_cfg(cfg)
    tp = TLM.init_params(tcfg, seed=15, device="cpu")
    tokens = torch.randint(0, tcfg.vocab_size, (2, 10),
                           generator=torch.Generator().manual_seed(16))
    port_rollout_parity(tcfg, tp, tokens)


def test_configs_equal_the_reference():
    """The port's CONFIG and SMOKE carry the reference's fields, and the
    first 5 layers of CONFIG (the one-card cut) hold every kind of
    block."""
    assert port_cfg(jjamba.CONFIG) == tjamba.CONFIG
    assert port_cfg(jjamba.SMOKE) == tjamba.SMOKE
    cut = dataclasses.replace(tjamba.CONFIG, n_layers=5)
    assert [(b.mixer, b.ffn) for b in cut.layer_specs()] == [
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("mamba", "moe"), ("attn", "dense")]


def tree_meta(tree):
    if isinstance(tree, dict):
        return {k: tree_meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_meta(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


def test_cast_params_gives_init_params_dtypes():
    """``cast_params(init_params(fp32), bf16)`` has the shapes and dtypes
    of ``init_params(bf16)`` leaf for leaf, and those are the reference's
    ``init_params`` ones: mamba's dt_bias, A_log, D and norm and the MoE
    router stay fp32; experts, conv and projections take bf16."""
    jcfg16 = dataclasses.replace(jjamba.SMOKE, param_dtype=jnp.bfloat16)
    tcfg32, tcfg16 = port_cfg(jjamba.SMOKE), port_cfg(jcfg16)
    cast = TLM.cast_params(TLM.init_params(tcfg32, seed=0, device="cpu"),
                           torch.bfloat16)
    native = TLM.init_params(tcfg16, seed=0, device="cpu")
    ref = port_params(jcfg16, JLM.init_params(jcfg16, jax.random.key(0)))
    assert tree_meta(cast) == tree_meta(native) == tree_meta(ref)
    mb, moe = cast["layers"][1]["mamba"], cast["layers"][1]["moe"]
    for leaf in ("dt_bias", "A_log", "D", "norm"):
        assert mb[leaf].dtype == torch.float32
    assert moe["router"].dtype == torch.float32
    assert mb["conv_w"].dtype == moe["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("backend", ["auto", "pallas", "ref"])
def test_every_backend_goes_through_the_mamba_kernel(monkeypatch, backend):
    """The config's attn_backend selects nothing: prefill and every
    decode step reach the Mamba kernel function once per mamba layer
    (from a zero state in prefill, the cached one in decode), so no
    config runs the plain scan on the card."""
    tcfg = dataclasses.replace(port_cfg(jjamba.SMOKE), attn_backend=backend)
    n_mamba = sum(b.mixer == "mamba" for b in tcfg.layer_specs())
    tp = TLM.init_params(tcfg, seed=17, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 5),
                         generator=torch.Generator().manual_seed(18))
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[6] if len(args) > 6 else kwargs.get("h0"))
        return MB.mamba_scan_fwd(*args, **kwargs)

    monkeypatch.setattr(tops, "mamba_scan_fwd", spy)
    make_prefill_step(tcfg, device="cpu")(tp, {"tokens": toks})
    assert len(calls) == n_mamba == 7
    assert all(h0 is None for h0 in calls)
    serve = make_serve_step(tcfg, batch=2, max_seq=8,
                            cache_dtype=torch.float32, device="cpu")
    cache = TLM.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    for t in range(3):
        _, cache = serve(tp, cache, toks[:, t:t + 1], t)
    assert len(calls) == 4 * n_mamba
    assert all(h0 is not None for h0 in calls[n_mamba:])


def test_serve_step_rejects_a_wrong_mamba_cache():
    tcfg = port_cfg(jjamba.SMOKE)
    tp = TLM.init_params(tcfg, seed=19, device="cpu")
    serve = make_serve_step(tcfg, batch=2, max_seq=8,
                            cache_dtype=torch.bfloat16, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.long)
    good = TLM.init_cache(tcfg, 2, 8, torch.bfloat16, device="cpu")
    assert good[0]["conv"].dtype == torch.float32        # param_dtype
    assert good[0]["ssm"].dtype == torch.float32
    assert good[4]["k"].dtype == torch.bfloat16          # cache_dtype
    serve(tp, good, tok, 0)
    missing = [dict(c) for c in good]
    del missing[0]["ssm"]
    bf16_conv = [dict(c, conv=c["conv"].bfloat16()) if "conv" in c else c
                 for c in good]
    bf16_ssm = [dict(c, ssm=c["ssm"].bfloat16()) if "ssm" in c else c
                for c in good]
    for bad in (TLM.init_cache(tcfg, 3, 8, torch.bfloat16, device="cpu"),
                missing, bf16_conv, bf16_ssm, good[:5]):
        with pytest.raises(ValueError, match="built for"):
            serve(tp, bad, tok, 0)
    with pytest.raises(ValueError, match="outside"):
        serve(tp, good, tok, 8)


def test_paged_engine_refuses_moe_blocks():
    """The reference's paged executor applies ``mlp`` FFNs only, so it
    serves an attn/moe model with its MoE layers skipped; the port's
    engine refuses such a model instead of serving a different one."""
    from repro_torch.serving.engine import ServingEngine
    tcfg = dataclasses.replace(port_cfg(jjamba.SMOKE), n_layers=2,
                               pattern=(TLM.BlockSpec("attn", "moe"),))
    tp = TLM.init_params(tcfg, seed=23, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        ServingEngine(tcfg, tp, page_size=4, num_pages=16, device="cpu")


def test_scan_wrapper_refuses_other_devices():
    # a device with no route (meta has one: the dry run's shapes)
    with FakeTensorMode():
        x = torch.zeros((1, 4, 32), device="xla")
        bc = torch.zeros((1, 4, 16), device="xla")
    with pytest.raises(ValueError, match="unsupported device"):
        MB.mamba_scan_fwd(x, x, bc, bc, torch.zeros((32, 16)),
                          torch.zeros(32))


def test_kernel_attributes_refuse_unknown_dtype_or_state_size():
    """Refused before any library is built, so the CPU says so too."""
    with pytest.raises(ValueError, match="no kernel"):
        MB.mamba_kernel_attributes(torch.float16, 16)
    with pytest.raises(ValueError, match="no kernel"):
        MB.mamba_kernel_attributes(torch.float32, 12)


def test_waves_of_the_prefill_grid():
    """ceil(Di / 128) x B blocks over blocks an SM x SMs: the jamba
    prefill row's 512 blocks are 0.97 of a wave of 4 blocks on 132
    SMs."""
    attrs = {"threads": 128, "blocks_per_sm": 4, "sms": 132}
    assert MB.waves(attrs, 4, 16384) == 512 / 528
    assert MB.waves(attrs, 2, 300) == 6 / 528


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_copy_keeps_values_and_aligns_rows(dtype):
    """An operand whose base pointer and rows are not 16-byte aligned is
    copied into rows padded to whole 16-byte pieces; its values stay."""
    base = torch.arange(2 * 5 * 301, dtype=torch.float32).to(dtype)
    x = base.view(2, 5, 301)[..., 1:]             # (2, 5, 300), offset 1
    assert not MB._aligned(x, 300)
    p = MB._padded(x)
    assert p.shape == x.shape and torch.equal(p, x)
    piece = 16 // p.element_size()
    assert p.stride(1) == -(-300 // piece) * piece
    assert MB._aligned(p, -(-300 // piece) * piece)
    assert MB._aligned(MB.dense_aligned(x[..., :16]), 16)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

def card_scan_args(dev, dt_, shape, state, seed=20, bc_offset=5,
                   x_offset=0):
    """Inputs of ``scan_inputs`` on the card: B and C column views of one
    (B, S, bc_offset + 2N) projection, as the layer passes them (a
    misaligned base pointer at bc_offset 5), x and dt views at element
    ``x_offset`` of wider rows."""
    b, s, di, n = shape
    x, dt, bm, cm, a, d, h0 = scan_inputs(seed, shape, state=state)
    proj = torch.from_numpy(np.concatenate(
        [np.zeros((b, s, bc_offset), np.float32), bm, cm], -1)).to(dev, dt_)

    def wide(v):
        buf = torch.zeros((b, s, di + x_offset), device=dev, dtype=dt_)
        buf[..., x_offset:] = to_torch(v).to(dev, dt_)
        return buf[..., x_offset:]
    return [wide(x), wide(dt), proj[..., bc_offset:bc_offset + n],
            proj[..., bc_offset + n:], to_torch(a).to(dev),
            to_torch(d).to(dev),
            None if h0 is None else to_torch(h0).to(dev)]


def assert_scan_close(args, dtype):
    """One launch; y at the kernel tier (fp32 1e-5, bf16 1e-2 + 1e-2
    |ref|), the final state fp32 within 1e-5."""
    before = MB.counter.launches
    y, h = MB.mamba_scan_fwd(*args)
    torch.cuda.synchronize()
    assert MB.counter.launches == before + 1
    ref_y, ref_h = MB.mamba_scan_plain(*args)
    assert y.dtype == args[0].dtype and h.dtype == torch.float32
    assert y.is_contiguous() and y.shape == args[0].shape
    if dtype == "float32":
        torch.testing.assert_close(y, ref_y, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(y.float(), ref_y.float(), rtol=1e-2,
                                   atol=1e-2)
    torch.testing.assert_close(h, ref_h, rtol=0, atol=1e-5)
    return y, h


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("n", [8, 16])
def test_cuda_mamba_kernel_matches_plain(cuda_device, n, state, dtype):
    """The kernel against its plain version on the card, (B, S, Di) =
    (2, 200, 300): S not a multiple of the kernel's 16-step chunk, Di not
    a multiple of its 128-channel block (and, in bf16, rows that are not
    whole 16-byte pieces: copied into padded rows), B and C column views
    of one (B, S, R + 2N) projection at a misaligned base pointer, as the
    layer passes them (copied).  fp32 within 1e-5 (the kernel tier); bf16
    elementwise within 1e-2 + 1e-2 |ref| (both round the same fp32 sum
    once); the final state fp32 within 1e-5."""
    assert_scan_close(card_scan_args(cuda_device, getattr(torch, dtype),
                                     (2, 200, 300, n), state), dtype)


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("n", [8, 16])
def test_cuda_mamba_single_step_matches_plain(cuda_device, n, state, dtype):
    """S = 1, the kernel's single-step path (every decode step): B = 8,
    Di = 300, B and C column views of one projection, at the tiers
    above."""
    assert_scan_close(card_scan_args(cuda_device, getattr(torch, dtype),
                                     (8, 1, 300, n), state), dtype)


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 1])
def test_cuda_mamba_kernel_at_a_rank_shard(cuda_device, s, dtype):
    """A rank's channel shard of jamba-1.5-large at model = 2 (Di = 8192
    of 16384, N = 16) from a state, B and C column views of the rank's
    whole (B, S, 512 + 2N) projection, as the meshed layer passes them:
    a prefill piece (S = 64) and a decode step (S = 1), at the tiers
    above."""
    assert_scan_close(card_scan_args(cuda_device, getattr(torch, dtype),
                                     (2, s, 8192, 16), True,
                                     bc_offset=512), dtype)


@requires_cuda
@pytest.mark.parametrize("s", [2, 15, 16, 17, 47])
def test_cuda_mamba_chunk_edges_match_plain(cuda_device, s):
    """S around the 16-step chunk (one short of it, equal, one over, one
    short of three), bf16, N = 16, from a state."""
    assert_scan_close(card_scan_args(cuda_device, torch.bfloat16,
                                     (2, s, 128, 16), True), "bfloat16")


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mamba_misaligned_operands_match_plain(cuda_device, dtype):
    """x and dt one element into wider rows (a misaligned base pointer:
    copied into aligned rows), B and C aligned strided views of one
    projection (read in place, R = 512 as the layer's), and the same
    at S = 1."""
    dt_ = getattr(torch, dtype)
    for s in (70, 1):
        args = card_scan_args(cuda_device, dt_, (2, s, 256, 16), True,
                              bc_offset=512, x_offset=1)
        assert args[0].data_ptr() % 16 != 0
        assert args[2].data_ptr() % 16 == 0 and not args[2].is_contiguous()
        assert_scan_close(args, dtype)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [8, 16])
def test_cuda_mamba_kernel_attributes(cuda_device, dtype, n):
    """No spill, at most 128 registers, and at least 4 blocks of 128
    threads an SM (16 warps: the prefill row's 512 blocks in one
    wave)."""
    attrs = MB.mamba_kernel_attributes(dtype, n)
    assert attrs["spill_bytes"] == 0
    assert attrs["registers"] <= 128
    assert attrs["blocks_per_sm"] >= 4
    assert attrs["threads"] == 128
    assert attrs["chunk_steps"] == 16


@requires_cuda
@pytest.mark.parametrize("s", [1, 200])
def test_cuda_mamba_kernel_gives_equal_bits_twice(cuda_device, s):
    """Two runs on the same inputs give the same bits (no atomics, a
    fixed reduction order)."""
    args = card_scan_args(cuda_device, torch.bfloat16, (2, s, 300, 16),
                          True)
    y1, h1 = MB.mamba_scan_fwd(*args)
    y2, h2 = MB.mamba_scan_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@requires_cuda
def test_cuda_smoke_launches_the_mamba_kernel(cuda_device):
    """jamba SMOKE (attn_backend "ref") on the card: the prefill and each
    decode step launch the Mamba kernel once per mamba layer, and agree
    with the same steps on the CPU (1e-4: cuBLAS and the CPU sum the
    matmuls in other orders)."""
    tcfg = tjamba.SMOKE
    assert tcfg.attn_backend == "ref"
    n_mamba = sum(b.mixer == "mamba" for b in tcfg.layer_specs())
    toks = torch.randint(0, tcfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(21))
    cpu_params = TLM.init_params(tcfg, seed=22, device="cpu")
    outs = {}
    for dev in ("cpu", cuda_device):
        tp = TLM.params_to(cpu_params, dev)
        before = MB.counter.launches
        logits = make_prefill_step(tcfg, device=dev)(
            tp, {"tokens": toks.to(dev)})
        serve = make_serve_step(tcfg, batch=2, max_seq=8,
                                cache_dtype=torch.float32, device=dev)
        cache = TLM.init_cache(tcfg, 2, 8, torch.float32, device=dev)
        for t in range(6):
            lg, cache = serve(tp, cache, toks[:, t:t + 1].to(dev), t)
        outs[str(dev)] = (logits.cpu(), lg.cpu())
        launched = MB.counter.launches - before
        assert launched == (0 if dev == "cpu" else 7 * n_mamba)
    for a, b in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)
