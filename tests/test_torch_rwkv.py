"""The port's rwkv6 path against the JAX package: the WKV6 plain version
and its autograd wrapper, ``layers.rwkv6`` with and without a cache,
``lm.forward`` and ``lm.decode_step`` rollouts of rwkv6 configs, the
``cast_params`` rule, and the cache check of ``make_serve_step``.

Inputs are made by numpy from a seed; the reference's parameters cross
through ``params_from_numpy``.  The reference runs its lax.scan oracles,
or under ``"pallas"`` its WKV6 kernel in interpret mode, as its own tests
run it on the CPU.  Tolerances at fp32: 2e-5 on scan outputs, states,
layer outputs and logits of O(1) (the serving tier of docs/kernels.md:
the two frameworks sum the fp32 products in other orders); greedy tokens
identical; prefill == decode at ``rollout_parity``'s 5e-3.  Cases that
hold the CUDA kernel against its plain version need the card and skip
elsewhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import gemma_2b as jgemma
from repro.configs import rwkv6_1_6b as jrwkv
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch.configs import rwkv6_1_6b as trwkv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rwkv6 as RW
from repro_torch.launch.train import make_prefill_step, make_serve_step
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from torch_port_helpers import (cuda_device, greedy_rollouts,  # noqa: F401
                                port_cfg, port_params, port_rollout_parity,
                                requires_cuda, to_numpy, to_torch)

TOL = dict(rtol=2e-5, atol=2e-5)

# the reference's own kernel-test shapes (tests/test_kernels.py::TestRWKV6)
SCAN_SHAPES = [(2, 3, 128, 64), (1, 2, 96, 32), (1, 1, 64, 128)]


def scan_inputs(seed, shape, state=False):
    """The reference tests' distribution: r/k/v ~ N(0, 0.5^2), decays
    sigmoid(N(0, 1)) * 0.5 + 0.45, bonus ~ N(0, 0.1^2); an initial state
    ~ N(0, 0.5^2) when asked for."""
    b, h, s, d = shape
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal(shape).astype(np.float32) * 0.5
               for _ in range(3))
    w = (0.45 + 0.5 / (1 + np.exp(-rng.standard_normal(shape)))).astype(
        np.float32)
    u = (rng.standard_normal((h, d)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, d, d)) * 0.5).astype(np.float32) \
        if state else None
    return r, k, v, w, u, s0


def model_inputs(seed, shape, state=False):
    """``scan_inputs`` with the decays rwkv6-1.6b's layers give:
    exp(-exp(-6 + N(0, 0.5^2))) rounded to bf16 (``layers.rwkv6`` rounds
    them to the activation dtype), many of them exactly 1.0, so that the
    state grows over the sweep instead of decaying."""
    r, k, v, _, u, s0 = scan_inputs(seed, shape, state)
    rng = np.random.default_rng(seed + 1000)
    w = np.exp(-np.exp(-6.0 + 0.5 * rng.standard_normal(shape)))
    w = torch.from_numpy(w.astype(np.float32)).bfloat16().float().numpy()
    return r, k, v, w, u, s0


def scan_float64(r, k, v, w, u, s0=None):
    """The plain version's step loop in float64, on the inputs' device:
    the oracle that measures how far each fp32 evaluation is from the
    exact recurrence."""
    r, k, v, w, u = (x.double() for x in (r, k, v, w, u))
    b, h, s, d = r.shape
    state = (torch.zeros((b, h, d, d), dtype=torch.float64, device=r.device)
             if s0 is None else s0.double())
    outs = []
    for t in range(s):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        outs.append(torch.einsum("bhd,bhde->bhe", r[:, :, t],
                                 state + u[None, :, :, None] * kv))
        state = w[:, :, t, :, None] * state + kv
    return torch.stack(outs, dim=2), state


def port_scan(r, k, v, w, u, s0=None):
    out, st = RW.rwkv6_scan_plain(*(to_torch(a) for a in (r, k, v, w, u)),
                                  None if s0 is None else to_torch(s0))
    return to_numpy(out), to_numpy(st)


def head_views(a, **to):
    """(B, H, S, D) as the layer hands it to the kernel: a transposed view
    of a contiguous (B, S, H, D) tensor."""
    return to_torch(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).to(
        **to).transpose(1, 2)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_scan_plain_matches_jax_oracle(shape):
    """Without a state: ``_wkv6_ref`` (``repro.kernels.ref.rwkv6_scan``)."""
    r, k, v, w, u, _ = scan_inputs(1, shape)
    out, st = port_scan(r, k, v, w, u)
    eo, es = jref.rwkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)))
    np.testing.assert_allclose(out, np.asarray(eo), **TOL)
    np.testing.assert_allclose(st, np.asarray(es), **TOL)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_scan_plain_matches_jax_pallas(shape):
    """The reference's Pallas WKV6 kernel in interpret mode."""
    r, k, v, w, u, _ = scan_inputs(2, shape)
    out, st = port_scan(r, k, v, w, u)
    eo, es = jops.rwkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)))
    np.testing.assert_allclose(out, np.asarray(eo), **TOL)
    np.testing.assert_allclose(st, np.asarray(es), **TOL)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_scan_plain_with_state_matches_jax(shape):
    """From a random initial state: ``_wkv6_ref_with_state``, the
    reference's decode path; also through ``ops.rwkv6_scan``."""
    r, k, v, w, u, s0 = scan_inputs(3, shape, state=True)
    out, st = port_scan(r, k, v, w, u, s0)
    eo, es = JL._wkv6_ref_with_state(
        *(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    np.testing.assert_allclose(out, np.asarray(eo), **TOL)
    np.testing.assert_allclose(st, np.asarray(es), **TOL)
    o2, s2 = tops.rwkv6_scan(*(head_views(a) for a in (r, k, v, w)),
                             to_torch(u), to_torch(s0))
    np.testing.assert_allclose(to_numpy(o2), out, rtol=0, atol=0)
    np.testing.assert_allclose(to_numpy(s2), st, rtol=0, atol=0)


def test_scan_plain_matches_jax_oracle_at_model_decays():
    """S = 1024 at the model's decays (``model_inputs``), fp32, from a
    state: the plain version against ``_wkv6_ref_with_state``.  With
    decays of 1.0 nothing damps the rounding of 1024 steps, and the
    outputs reach ~70, so this is the long-reduction tier, 2e-3 absolute
    (docs/kernels.md); the two sum in other orders, and each sits a few
    1e-5 from a float64 evaluation of the same loop."""
    r, k, v, w, u, s0 = model_inputs(30, (1, 2, 1024, 64), state=True)
    assert (w == 1.0).mean() > 0.05
    out, st = port_scan(r, k, v, w, u, s0)
    eo, es = JL._wkv6_ref_with_state(
        *(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    assert np.abs(out).max() > 20
    np.testing.assert_allclose(out, np.asarray(eo), rtol=0, atol=2e-3)
    np.testing.assert_allclose(st, np.asarray(es), rtol=0, atol=2e-3)


def test_scan_wrapper_copies_misaligned_operands_densely():
    """``dense_aligned`` gives a contiguous, 16-byte aligned tensor equal
    to its input: a new one for a view at an odd offset (``contiguous``
    keeps that offset) or with other strides, the input itself when it
    already is one; ``_aligned`` tells them apart."""
    base = torch.arange(2 * 3 * 5 * 64 + 1, dtype=torch.float32)
    odd = base[1:].view(2, 3, 5, 64)
    assert odd.is_contiguous() and not RW._aligned(odd)
    fixed = RW.dense_aligned(odd)
    assert fixed.data_ptr() % 16 == 0 and RW._aligned(fixed)
    assert torch.equal(fixed, odd)
    view = head_views(np.zeros((2, 3, 5, 64), np.float32))
    assert RW._aligned(view) and not view.is_contiguous()
    assert RW.dense_aligned(view).is_contiguous()
    dense = RW.dense_aligned(fixed)
    assert dense is fixed
    wide = torch.zeros((2, 5, 3 * 64 + 1))[..., :3 * 64]
    wide = wide.unflatten(-1, (3, 64)).transpose(1, 2)
    assert not RW._aligned(wide)


def test_kernel_attributes_refuse_other_head_sizes():
    with pytest.raises(ValueError, match="no kernel"):
        RW.rwkv6_kernel_attributes(torch.float32, 48)
    with pytest.raises(ValueError, match="no kernel"):
        RW.rwkv6_kernel_attributes(torch.float16, 64)


def test_scan_gradients_match_jax():
    """Gradients of ``ops.rwkv6_scan`` (backward recomputes through the
    plain version) against ``jax.grad`` of the oracle, for r, k, v, w
    and u, with random cotangents on the output and the final state
    (tests/test_kernels.py::TestRWKV6::test_grads shape).  1e-4: the
    gradients sum 64 steps of fp32 products in two orders."""
    shape = (1, 2, 64, 32)
    r, k, v, w, u, _ = scan_inputs(4, shape)
    rng = np.random.default_rng(5)
    g_out = rng.standard_normal(shape).astype(np.float32)
    g_st = rng.standard_normal((1, 2, 32, 32)).astype(np.float32)

    def jloss(*a):
        out, st = jref.rwkv6_scan(*a)
        return jnp.sum(out * g_out) + jnp.sum(st * g_st)

    exp = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (r, k, v, w, u)))
    ins = [to_torch(a).requires_grad_() for a in (r, k, v, w, u)]
    out, st = tops.rwkv6_scan(*ins)
    loss = (out * to_torch(g_out)).sum() + (st * to_torch(g_st)).sum()
    loss.backward()
    for t, e in zip(ins, exp):
        np.testing.assert_allclose(to_numpy(t.grad), np.asarray(e),
                                   rtol=1e-4, atol=1e-4)


def rwkv_block_params(seed, d=64, hd=32):
    """The reference's ``rwkv6_init`` (fp32) with its constant token-shift
    mixes replaced by uniform draws, so that a swapped mix shows."""
    p = jax.tree.map(np.asarray, JL.rwkv6_init(jax.random.key(seed), d,
                                               head_dim=hd,
                                               dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "cm_mu_k"):
        p[name] = rng.uniform(0, 1, d).astype(np.float32)
    return p


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_rwkv6_layer_prefill_and_decode_match_jax(backend):
    """``layers.rwkv6`` without a cache (S=12), then one decode token
    against a random cache: outputs and every new cache entry within
    2e-5; the port's cache is updated in place and returned as it is."""
    p = rwkv_block_params(6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: to_torch(v) for k, v in p.items()}
    exp, jc = JL.rwkv6(jp, jnp.asarray(x), head_dim=32, backend=backend)
    out, tc = TL.rwkv6(tp, to_torch(x), head_dim=32, backend=backend)
    assert jc is None and tc is None
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)

    x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
    cache = {"wkv": (rng.standard_normal((2, 2, 32, 32)) * 0.5).astype(
                 np.float32),
             "shift": rng.standard_normal((2, 1, 64)).astype(np.float32),
             "cm_shift": rng.standard_normal((2, 1, 64)).astype(np.float32)}
    exp, jc = JL.rwkv6(jp, jnp.asarray(x1), head_dim=32, backend=backend,
                       cache={k: jnp.asarray(v) for k, v in cache.items()})
    tcache = {k: to_torch(v) for k, v in cache.items()}
    before = dict(tcache)
    out, tc = TL.rwkv6(tp, to_torch(x1), head_dim=32, backend=backend,
                       cache=tcache)
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    for name in cache:
        assert tc[name] is before[name]
        np.testing.assert_allclose(to_numpy(tc[name]), np.asarray(jc[name]),
                                   **TOL)


def test_bf16_decay_rounds_as_the_reference(monkeypatch):
    """The decays reach the kernel rounded to the activation dtype, as
    ``w.astype(x.dtype)`` in the reference: at bf16, decay_base -6 gives
    exp(-exp(-6)) = 0.99752 -> 0.99609375, and -6.5 gives exactly 1.0."""
    p = {k: to_torch(v).to(torch.bfloat16) if v.ndim == 2 or
         k.startswith(("mu", "cm_mu")) else to_torch(v)
         for k, v in rwkv_block_params(8).items()}
    p["decay_a"] = torch.zeros_like(p["decay_a"])
    p["decay_base"] = torch.cat([torch.full((32,), -6.0),
                                 torch.full((32,), -6.5)])
    x = torch.randn((1, 3, 64), generator=torch.Generator().manual_seed(9)
                    ).to(torch.bfloat16)
    seen = []

    def spy(r, k, v, w, u, state0=None):
        seen.append(w)
        return RW.rwkv6_scan_plain(r, k, v, w, u, state0)

    monkeypatch.setattr(tops, "rwkv6_scan_fwd", spy)
    TL.rwkv6(p, x, head_dim=32)
    (w,) = seen
    assert w.dtype == torch.bfloat16
    assert torch.all(w[0, 0] == 0.99609375) and torch.all(w[0, 1] == 1.0)


def rwkv_cfg(which):
    if which == "smoke":
        return jrwkv.SMOKE
    cfg = dataclasses.replace(jrwkv.SMOKE, name="rwkv6-hd64", d_model=128,
                              vocab_size=96)
    cfg = dataclasses.replace(cfg, rwkv_head_dim=64, attn_backend="auto")
    if which == "hd64_pallas":
        cfg = dataclasses.replace(cfg, attn_backend="pallas")
    return cfg


@pytest.mark.parametrize("which", ["smoke", "hd64", "hd64_pallas"])
def test_forward_matches_jax(which):
    """rwkv6 SMOKE (head 32) and a 2-layer fp32 config with head 64, at
    S=128; under "pallas" the JAX side runs its WKV6 kernel in interpret
    mode."""
    cfg = rwkv_cfg(which)
    params = JLM.init_params(cfg, jax.random.key(10))
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 128)).astype(np.int32)
    exp, _ = JLM.forward(cfg, params, jnp.asarray(toks))
    out, aux = TLM.forward(port_cfg(cfg), port_params(cfg, params),
                           torch.from_numpy(toks).long())
    assert tuple(out.shape) == (2, 128, cfg.vocab_size)
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("which", ["smoke", "hd64"])
def test_decode_rollout_matches_jax(which):
    """4 prompt tokens fed one a step, then greedy: logits at every step
    within 2e-5 and 13 greedy tokens identical."""
    jl, tl, jt, tt = greedy_rollouts(rwkv_cfg(which), steps=16)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    assert jt.shape[1] == 13
    np.testing.assert_array_equal(tt, jt)


def test_rollout_with_bf16_cache_matches_jax():
    """fp32 weights served from a bf16 cache: the reference returns the
    token-shift rows in the activation dtype, so its logits are the fp32
    ones; the port holds those rows in fp32 too (rounding them to the
    cache's bf16 moved the logits by up to 4e-3).  2e-5, and identical
    greedy tokens."""
    jl, tl, jt, tt = greedy_rollouts(rwkv_cfg("hd64"), steps=10,
                                     cache_dtype="bfloat16")
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_array_equal(tt, jt)


def test_rwkv_serve_step_has_no_position_limit():
    """An rwkv state holds no positions: steps past ``max_seq`` give the
    logits of an unbounded rollout (the reference has no limit either);
    a negative position is still refused."""
    tcfg = port_cfg(jrwkv.SMOKE)
    tp = TLM.init_params(tcfg, seed=20, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(21))
    logits = []
    for max_seq in (2, 16):
        serve = make_serve_step(tcfg, batch=2, max_seq=max_seq,
                                cache_dtype=torch.float32, device="cpu")
        cache = TLM.init_cache(tcfg, 2, max_seq, torch.float32,
                               device="cpu")
        for t in range(6):
            lg, cache = serve(tp, cache, toks[:, t:t + 1], t)
        logits.append(lg)
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="outside"):
        serve(tp, cache, toks[:, :1], -1)


@pytest.mark.parametrize("which", ["smoke", "hd64"])
def test_port_prefill_equals_decode(which):
    tcfg = port_cfg(rwkv_cfg(which))
    tp = TLM.init_params(tcfg, seed=12, device="cpu")
    tokens = torch.randint(0, tcfg.vocab_size, (2, 10),
                           generator=torch.Generator().manual_seed(13))
    port_rollout_parity(tcfg, tp, tokens)


@pytest.mark.parametrize("backend", ["auto", "pallas", "ref"])
def test_every_backend_goes_through_the_wkv6_kernel(monkeypatch, backend):
    """The config's attn_backend selects nothing: prefill and every
    decode step reach the WKV6 kernel function once per layer, so no
    config runs plain WKV6 on the card."""
    tcfg = dataclasses.replace(port_cfg(jrwkv.SMOKE), attn_backend=backend)
    tp = TLM.init_params(tcfg, seed=14, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 5),
                         generator=torch.Generator().manual_seed(15))
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[5] if len(args) > 5 else kwargs.get("state0"))
        return RW.rwkv6_scan_fwd(*args, **kwargs)

    monkeypatch.setattr(tops, "rwkv6_scan_fwd", spy)
    make_prefill_step(tcfg, device="cpu")(tp, {"tokens": toks})
    assert len(calls) == tcfg.n_layers
    assert all(s0 is None for s0 in calls)
    serve = make_serve_step(tcfg, batch=2, max_seq=8,
                            cache_dtype=torch.float32, device="cpu")
    cache = TLM.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    for t in range(3):
        _, cache = serve(tp, cache, toks[:, t:t + 1], t)
    assert len(calls) == 4 * tcfg.n_layers
    assert all(s0 is not None for s0 in calls[tcfg.n_layers:])
    with pytest.raises(ValueError, match="backend"):
        make_prefill_step(dataclasses.replace(tcfg, attn_backend="jnp"),
                          device="cpu")(tp, {"tokens": toks})


def dtype_tree(tree):
    if isinstance(tree, dict):
        return {k: dtype_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [dtype_tree(v) for v in tree]
    return tree.dtype


@pytest.mark.parametrize("family", ["rwkv6", "gemma"])
def test_cast_params_gives_init_params_dtypes(family):
    """``cast_params(init_params(fp32), bf16)`` has the dtypes of
    ``init_params(bf16)`` leaf for leaf, and those are the reference's
    ``init_params`` dtypes (rwkv6: 1-D token-shift mixes in bf16, bonus
    and decay_base fp32)."""
    jcfg = jrwkv.SMOKE if family == "rwkv6" else jgemma.SMOKE
    jcfg16 = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16)
    tcfg32, tcfg16 = port_cfg(jcfg), port_cfg(jcfg16)
    cast = TLM.cast_params(TLM.init_params(tcfg32, seed=0, device="cpu"),
                           torch.bfloat16)
    native = TLM.init_params(tcfg16, seed=0, device="cpu")
    ref = port_params(jcfg16, JLM.init_params(jcfg16, jax.random.key(0)))
    assert dtype_tree(cast) == dtype_tree(native) == dtype_tree(ref)
    if family == "rwkv6":
        blk = cast["layers"][0]["rwkv"]
        assert blk["mu_r"].dtype == blk["cm_mu_k"].dtype == torch.bfloat16
        assert blk["bonus"].dtype == blk["decay_base"].dtype == torch.float32


def test_serve_step_rejects_a_wrong_rwkv_cache():
    tcfg = port_cfg(jrwkv.SMOKE)
    tp = TLM.init_params(tcfg, seed=16, device="cpu")
    serve = make_serve_step(tcfg, batch=2, max_seq=8,
                            cache_dtype=torch.float32, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.long)
    good = TLM.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    serve(tp, good, tok, 0)
    missing = [dict(c) for c in good]
    del missing[0]["cm_shift"]
    # the shift rows follow the activations (fp32 here), not cache_dtype
    bf16_shift = [dict(c, shift=c["shift"].bfloat16()) for c in good]
    gemma_like = TLM.init_cache(port_cfg(jgemma.SMOKE), 2, 8, torch.float32,
                                device="cpu")
    for bad in (TLM.init_cache(tcfg, 3, 8, torch.float32, device="cpu"),
                bf16_shift, good[:1], missing, gemma_like):
        with pytest.raises(ValueError, match="built for"):
            serve(tp, bad, tok, 0)


def test_scan_wrapper_refuses_other_devices():
    # a device with no route (meta has one: the dry run's shapes)
    with FakeTensorMode():
        r = torch.zeros((1, 2, 4, 32), device="xla")
        u = torch.zeros((2, 32), device="xla")
    with pytest.raises(ValueError, match="unsupported device"):
        RW.rwkv6_scan_fwd(r, r, r, r, u)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_cuda_wkv6_kernel_matches_plain(cuda_device, d, state, dtype):
    """The kernel against its plain version on the card, (B, H, S) =
    (2, 3, 200): S not a multiple of the kernel's 32-step chunk, r/k/v/w
    transposed views as the layer passes them.  fp32 within 1e-5 (the
    kernel tier); bf16 elementwise within 1e-2 + 1e-2 |ref| (both round
    the same fp32 sum once; a tie can fall one bf16 step apart)."""
    r, k, v, w, u, s0 = scan_inputs(17, (2, 3, 200, d), state=state)
    dt = getattr(torch, dtype)
    args = [head_views(a, device=cuda_device, dtype=dt)
            for a in (r, k, v, w)]
    args += [to_torch(u).to(cuda_device),
             None if s0 is None else to_torch(s0).to(cuda_device)]
    before = RW.counter.launches
    out, st = RW.rwkv6_scan_fwd(*args)
    torch.cuda.synchronize()
    assert RW.counter.launches == before + 1
    ref_out, ref_st = RW.rwkv6_scan_plain(*args)
    assert out.dtype == dt and st.dtype == torch.float32
    if dtype == "float32":
        torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref_out.float(), rtol=1e-2,
                                   atol=1e-2)
    torch.testing.assert_close(st, ref_st, rtol=0, atol=1e-5)


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 1])
@pytest.mark.parametrize("heads", [16, 8])
def test_cuda_wkv6_kernel_at_a_rank_shard(cuda_device, heads, s, dtype):
    """A rank's heads of rwkv6-1.6b at model = 2 and 4 (16 and 8 of 32
    heads of 64) from a state, r/k/v/w transposed views as the meshed
    layer passes them: a prefill piece (S = 64) and a decode step
    (S = 1), at the tiers above."""
    r, k, v, w, u, s0 = scan_inputs(23, (2, heads, s, 64), state=True)
    dt = getattr(torch, dtype)
    args = [head_views(a, device=cuda_device, dtype=dt)
            for a in (r, k, v, w)]
    args += [to_torch(u).to(cuda_device), to_torch(s0).to(cuda_device)]
    before = RW.counter.launches
    out, st = RW.rwkv6_scan_fwd(*args)
    torch.cuda.synchronize()
    assert RW.counter.launches == before + 1
    ref_out, ref_st = RW.rwkv6_scan_plain(*args)
    if dtype == "float32":
        torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref_out.float(), rtol=1e-2,
                                   atol=1e-2)
    torch.testing.assert_close(st, ref_st, rtol=0, atol=1e-5)


@requires_cuda
def test_cuda_wkv6_kernel_takes_mixed_layouts(cuda_device):
    """r/k/v/w with different strides (contiguous, and transposed views)
    give the plain version's result within 1e-5 at fp32."""
    r, k, v, w, u, s0 = scan_inputs(22, (2, 4, 40, 64), state=True)
    args = [to_torch(r).to(cuda_device),
            head_views(k, device=cuda_device), to_torch(v).to(cuda_device),
            head_views(w, device=cuda_device), to_torch(u).to(cuda_device),
            to_torch(s0).to(cuda_device)]
    out, st = RW.rwkv6_scan_fwd(*args)
    ref_out, ref_st = RW.rwkv6_scan_plain(*args)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    torch.testing.assert_close(st, ref_st, rtol=0, atol=1e-5)


@requires_cuda
def test_cuda_smoke_launches_the_wkv6_kernel(cuda_device):
    """rwkv6 SMOKE (attn_backend "ref") on the card: the prefill and each
    decode step launch the WKV6 kernel once per layer, and agree with the
    same steps on the CPU."""
    tcfg = trwkv.SMOKE
    assert tcfg.attn_backend == "ref"
    toks = torch.randint(0, tcfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(18))
    cpu_params = TLM.init_params(tcfg, seed=19, device="cpu")
    outs = {}
    for dev in ("cpu", cuda_device):
        tp = TLM.params_to(cpu_params, dev)
        before = RW.counter.launches
        logits = make_prefill_step(tcfg, device=dev)(
            tp, {"tokens": toks.to(dev)})
        serve = make_serve_step(tcfg, batch=2, max_seq=8,
                                cache_dtype=torch.float32, device=dev)
        cache = TLM.init_cache(tcfg, 2, 8, torch.float32, device=dev)
        for t in range(6):
            lg, cache = serve(tp, cache, toks[:, t:t + 1].to(dev), t)
        outs[str(dev)] = (logits.cpu(), lg.cpu())
        launched = RW.counter.launches - before
        assert launched == (0 if dev == "cpu" else 7 * tcfg.n_layers)
    for a, b in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


# the kernel stages 32 steps a chunk: a single step (which takes the
# kernel's single-step layout, as every decode step does), a chunk less and
# more one step, several chunks with a tail, and the prefill length
MODEL_S = (1, 31, 33, 200, 1024)


def within_float64_error(got, ref, exact, what):
    """|got - ref| <= 1e-5 + 2 * max|ref - exact|: two fp32 evaluations
    of the recurrence that sum in other orders each sit within their own
    rounding error of the exact value; the plain version's is measured
    against the float64 loop on these inputs (at the model's decays it
    grows to a few 1e-5 by S = 200, where 1e-5 alone would not hold the
    plain version to itself), and the kernel may carry as much."""
    tol = 1e-5 + 2 * (ref.double() - exact).abs().max().item()
    err = (got.double() - ref.double()).abs().max().item()
    assert err <= tol, f"{what}: {err} > {tol}"


def card_args(arrays, device, dtype):
    r, k, v, w, u, s0 = arrays
    args = [head_views(a, device=device, dtype=dtype) for a in (r, k, v, w)]
    return args + [to_torch(u).to(device),
                   None if s0 is None else to_torch(s0).to(device)]


@requires_cuda
@pytest.mark.parametrize("s", MODEL_S)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_cuda_wkv6_kernel_at_model_decays(cuda_device, d, state, dtype, s):
    """The kernel against its plain version at the model's decays
    (``model_inputs``), one launch a call.  Out: fp32 within
    ``within_float64_error``; bf16 elementwise within 1e-2 + 1e-2 |ref|
    (both round one fp32 sum once; a tie can fall one bf16 step apart).
    The final state is fp32 for both dtypes: ``within_float64_error``."""
    dt = getattr(torch, dtype)
    args = card_args(model_inputs(23, (2, 3, s, d), state), cuda_device, dt)
    before = RW.counter.launches
    out, st = RW.rwkv6_scan_fwd(*args)
    torch.cuda.synchronize()
    assert RW.counter.launches == before + 1
    ref_out, ref_st = RW.rwkv6_scan_plain(*args)
    exact_out, exact_st = scan_float64(*args)
    assert out.dtype == dt and tuple(out.shape) == (2, 3, s, d)
    if dtype == "float32":
        within_float64_error(out, ref_out, exact_out, "out")
    else:
        torch.testing.assert_close(out.float(), ref_out.float(), rtol=1e-2,
                                   atol=1e-2)
    within_float64_error(st, ref_st, exact_st, "state")


@requires_cuda
def test_cuda_wkv6_kernel_gives_equal_bits_on_two_runs(cuda_device):
    """At the rwkv_prefill shape (B=4, H=32, S=1024, D=64, bf16): the
    shuffle tree and the step order are fixed, so two runs give the same
    bits, out and state."""
    args = card_args(model_inputs(25, (4, 32, 1024, 64)), cuda_device,
                     torch.bfloat16)
    out1, st1 = RW.rwkv6_scan_fwd(*args)
    out2, st2 = RW.rwkv6_scan_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2) and torch.equal(st1, st2)


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_wkv6_kernel_copies_misaligned_views(cuda_device, dtype):
    """r at an odd element offset (contiguous, not 16-byte aligned), k
    with a row stride that is no multiple of 16 bytes, and state0 at an
    odd offset: the wrapper copies them and launches the kernel once,
    which matches the plain version as ``test_cuda_wkv6_kernel_matches_
    plain`` does (fp32 1e-5; bf16 1e-2 + 1e-2 |ref|)."""
    b, h, s, d = 2, 3, 40, 64
    dt = getattr(torch, dtype)
    r, k, v, w, u, s0 = scan_inputs(26, (b, h, s, d), state=True)
    args = card_args((r, k, v, w, u, s0), cuda_device, dt)
    flat = torch.empty(b * h * s * d + 1, dtype=dt, device=cuda_device)
    args[0] = flat[1:].view(b, h, s, d).copy_(args[0])
    wide = torch.empty((b, s, h * d + 8 // args[1].element_size()),
                       dtype=dt, device=cuda_device)[..., :h * d]
    args[1] = wide.unflatten(-1, (h, d)).transpose(1, 2).copy_(args[1])
    flat0 = torch.empty(b * h * d * d + 1, device=cuda_device)
    args[5] = flat0[1:].view(b, h, d, d).copy_(args[5])
    assert not RW._aligned(args[0]) and not RW._aligned(args[1])
    assert args[5].data_ptr() % 16 != 0
    before = RW.counter.launches
    out, st = RW.rwkv6_scan_fwd(*args)
    torch.cuda.synchronize()
    assert RW.counter.launches == before + 1
    ref_out, ref_st = RW.rwkv6_scan_plain(*args)
    if dtype == "float32":
        torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref_out.float(), rtol=1e-2,
                                   atol=1e-2)
    torch.testing.assert_close(st, ref_st, rtol=0, atol=1e-5)


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_cuda_wkv6_kernel_attributes(cuda_device, d, dtype):
    """Four state columns a thread in 16 parts (D/4 x 16 threads: 256 at
    D = 64) and no spill at every D; at D <= 64 two blocks share an SM,
    so a decode step of B*H = 256 blocks runs in one wave."""
    attrs = RW.rwkv6_kernel_attributes(getattr(torch, dtype), d)
    assert attrs["cols"] == 4 and attrs["parts"] == 16
    assert attrs["threads"] == 4 * d and attrs["spill_bytes"] == 0
    assert attrs["chunk_steps"] == 32
    assert attrs["blocks_per_sm"] >= (2 if d <= 64 else 1)
