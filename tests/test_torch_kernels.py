"""Port kernels against the JAX package: paged attention, the Gumbel
perturbation, flash attention and contiguous-cache decode attention.

On the CPU the port's wrappers run their plain PyTorch versions; they
are held against ``repro.kernels.ref.paged_attention`` (the jnp oracle)
and ``repro.kernels.ops.paged_attention`` (the Pallas kernel in
interpret mode, as tests/test_kernels.py runs it) on the same numpy
inputs, at the 1e-5 kernel tier of docs/kernels.md.  The port is given
the reference's own codes and scales for quantized pools.  Cases that
hold the CUDA / Triton kernels against the plain versions need the card
and skip elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serving import quant as jquant
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import _noise
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as TA
from repro_torch.kernels import _build
from torch_port_helpers import cuda_device, flash_attention_tf32, \
    requires_cuda, strided_operands, tf32_round, to_numpy, \
    to_torch  # noqa: F401  (cuda_device is the fixture requires_cuda uses)

TOL = dict(rtol=1e-5, atol=1e-5)


def paged_case(seed, hd, kv_dtype, hq=4, hkv=2, ps=4, n_pages=24):
    """A mixed batch: a prefill chunk (slot 0), a fresh prefill start
    (slot 1), decode tokens (slot 2) and one padding token (seg -1)."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((n_pages, ps, hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, hkv, hd)).astype(np.float32)
    q = rng.standard_normal((7, hq, hd)).astype(np.float32)
    tables = rng.permutation(n_pages)[:12].reshape(3, 4).astype(np.int32)
    seg = np.array([0, 0, 1, 2, 2, 2, -1], np.int32)
    pos = np.array([3, 4, 0, 10, 14, 15, 0], np.int32)
    ksc = vsc = None
    if kv_dtype != "fp32":
        kp, ksc = (np.asarray(a) for a in jquant.quantize(jnp.asarray(kp),
                                                          kv_dtype))
        vp, vsc = (np.asarray(a) for a in jquant.quantize(jnp.asarray(vp),
                                                          kv_dtype))
    return q, kp, vp, ksc, vsc, tables, seg, pos


def port_paged(q, kp, vp, ksc, vsc, tables, seg, pos, window):
    t = lambda a: None if a is None else to_torch(a)  # noqa: E731
    return to_numpy(tops.paged_attention(
        t(q), t(kp), t(vp), t(tables), t(seg), t(pos), window=window,
        k_scale=t(ksc), v_scale=t(vsc)))


@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8_e4m3"])
def test_paged_plain_matches_jax_ref_and_pallas(kv_dtype, window, hd):
    q, kp, vp, ksc, vsc, tables, seg, pos = paged_case(1, hd, kv_dtype)
    out = port_paged(q, kp, vp, ksc, vsc, tables, seg, pos, window)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    args = (j(q), j(kp), j(vp), j(tables), j(seg), j(pos))
    kw = dict(window=window, k_scale=j(ksc), v_scale=j(vsc))
    live = seg >= 0
    exp_ref = np.asarray(jref.paged_attention(*args, **kw))
    np.testing.assert_allclose(out[live], exp_ref[live], **TOL)
    exp_pallas = np.asarray(jops.paged_attention(*args, **kw))
    np.testing.assert_allclose(out[live], exp_pallas[live], **TOL)


def test_paged_ragged_tables_and_shared_prefix():
    """Ragged live-page counts and two slots sharing prefix pages (the
    reference's own cases, test_kernels.py:166-207)."""
    rng = np.random.default_rng(2)
    kp = rng.standard_normal((40, 8, 2, 16)).astype(np.float32)
    vp = rng.standard_normal((40, 8, 2, 16)).astype(np.float32)
    q = rng.standard_normal((4, 8, 16)).astype(np.float32)
    tables = np.zeros((4, 4), np.int32)
    tables[0, :1] = [5]
    tables[1, :4] = [7, 9, 11, 13]
    tables[2, :3] = [7, 9, 2]              # shares slot 1's first pages
    tables[3, :1] = [17]
    seg = np.array([0, 1, 2, 3], np.int32)
    pos = np.array([2, 29, 20, 0], np.int32)
    out = port_paged(q, kp, vp, None, None, tables, seg, pos, None)
    exp = np.asarray(jref.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(seg), jnp.asarray(pos)))
    np.testing.assert_allclose(out, exp, **TOL)


def test_model_paged_attention_is_the_wrapper():
    q, kp, vp, ksc, vsc, tables, seg, pos = paged_case(3, 16, "int8")
    t = to_torch
    a = TA.paged_attention(t(q), t(kp), t(vp), t(tables), t(seg), t(pos),
                           k_scale=t(ksc), v_scale=t(vsc))
    b = DA.paged_attention_plain(
        t(q).reshape(7, 2, 2, 16), t(kp), t(vp), t(tables), t(seg), t(pos),
        scale=16 ** -0.5, k_scale=t(ksc), v_scale=t(vsc)).reshape(7, 4, 16)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert TA.paged_attention is tops.paged_attention
    assert TA.select_paged_backend("ref", sharded=False) == "ref"
    with pytest.raises(ValueError):
        TA.select_paged_backend("jnp", sharded=False)
    # a sharded engine attends through the same wrapper: no pinned path
    assert TA.select_paged_backend("auto", sharded=True) == "auto"
    with pytest.raises(ValueError):
        TA.select_paged_backend("jnp", sharded=True)


def test_gumbel_plain_matches_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((6, 333)) * 3).astype(np.float32)
    logits[0, :10] = np.finfo(np.float32).min      # filtered-out lanes
    u = rng.uniform(1e-20, 1.0, (6, 333)).astype(np.float32)
    exp = np.asarray(jops.gumbel_perturb(jnp.asarray(logits),
                                         jnp.asarray(u)))
    out = to_numpy(tops.gumbel_perturb(to_torch(logits), to_torch(u)))
    # 1e-6 relative to the O(1) perturbed values: the two frameworks'
    # fp32 logs differ in the last bits, so values near 0 get the same
    # 1e-6 as an absolute floor
    np.testing.assert_allclose(out, exp, rtol=1e-6, atol=1e-6)


def _keyed_case(seed=6, rows=5, vocab=777):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
    logits[1, :20] = np.finfo(np.float32).min      # filtered-out lanes
    # seeds and positions past 32 bits and negative: the hash takes their
    # low 32 bits
    seeds = np.array([0, 7, -3, 2 ** 40 + 5, 2 ** 32 - 1][:rows], np.int64)
    pos = np.array([0, 100, 2 ** 33 + 9, 17, 4095][:rows], np.int64)
    return logits, seeds, pos


def test_gumbel_keyed_plain_is_the_uniform_composition():
    """The keyed plain version is the uniform one over the position-keyed
    uniforms, bit for bit."""
    logits, seeds, pos = (to_torch(a) for a in _keyed_case())
    out = tops.gumbel_perturb_keyed_plain(logits, seeds, pos)
    u = _noise.position_uniforms(seeds, pos, logits.shape[1])
    assert torch.equal(out, tops.gumbel_perturb_plain(logits, u))
    assert torch.equal(tops.gumbel_perturb_keyed(logits, seeds, pos), out)


def test_gumbel_keyed_matches_jax_given_the_same_uniforms():
    """Fed the keyed version's uniforms, the reference's perturbation
    (its Pallas fused_elementwise kernel in interpret mode) agrees at the
    1e-5 kernel tier."""
    logits, seeds, pos = _keyed_case()
    u = _noise.position_uniforms(to_torch(seeds), to_torch(pos),
                                 logits.shape[1])
    exp = np.asarray(jops.gumbel_perturb(jnp.asarray(logits),
                                         jnp.asarray(to_numpy(u))))
    out = to_numpy(tops.gumbel_perturb_keyed(
        to_torch(logits), to_torch(seeds), to_torch(pos)))
    np.testing.assert_allclose(out, exp, rtol=1e-5, atol=1e-5)


def _hash32_uint32(x):
    """The keyed kernel's hash in native uint32 arithmetic: products and
    sums wrap mod 2**32, shifts are logical."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(_noise.MUL1)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(_noise.MUL2)
    return x ^ (x >> np.uint32(16))


def test_gumbel_keyed_uint32_hash_reproduces_the_uniforms():
    """What the Triton kernel computes in registers (one wrapping uint32
    product where the torch version splits it into 16-bit halves, the
    keys' low 32 bits) gives the torch version's uniforms bit for bit."""
    _, seeds, pos = _keyed_case()
    vocab = 70000
    s = (seeds & 0xFFFFFFFF).astype(np.uint32)
    p = (pos & 0xFFFFFFFF).astype(np.uint32)
    with np.errstate(over="ignore"):
        row = _hash32_uint32(_hash32_uint32(s ^ np.uint32(_noise.SEED_SALT))
                             ^ p)
        lane = _hash32_uint32(np.arange(vocab, dtype=np.uint32)
                              + np.uint32(_noise.LANE_SALT))
        bits = _hash32_uint32(row[:, None] ^ lane[None, :])
    u = ((bits >> np.uint32(9)).astype(np.float32) + np.float32(0.5)) * \
        np.float32(1.0 / (1 << 23))
    u = np.maximum(u, np.float32(_noise.MIN_UNIFORM))
    exp = _noise.position_uniforms(to_torch(seeds), to_torch(pos), vocab)
    np.testing.assert_array_equal(u, exp.numpy())


def test_gumbel_keyed_refuses_bad_operands():
    x = torch.zeros((2, 4))
    keys = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError):
        tops.gumbel_perturb_keyed(x, keys[:1], keys)
    with pytest.raises(ValueError):
        tops.gumbel_perturb_keyed(x[0], keys, keys)
    with pytest.raises(ValueError):
        tops.gumbel_perturb_keyed(x.to("meta"), keys.to("meta"),
                                  keys.to("meta"))


def test_wrappers_refuse_other_devices():
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError):
        tops.gumbel_perturb(x, x)
    with pytest.raises(ValueError):
        tops.gumbel_perturb(torch.zeros(2, 4), torch.zeros(2, 5))


# ----------------------------------------------------------------------
# flash attention and contiguous-cache decode attention
# ----------------------------------------------------------------------

def flash_case(seed, b=2, hq=4, hkv=2, sq=64, skv=64, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, hd)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, hd)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, hd)).astype(np.float32)
    return q, k, v


# (hq, hkv, sq, skv, causal, window, scale); the JAX kernel runs in
# interpret mode, which needs Sq and Skv within one 128 block or
# multiples of it (a ragged last block reads out of bounds there)
FLASH_CASES = {
    "causal_gqa": (4, 2, 64, 64, True, None, None),
    "bidirectional": (4, 2, 64, 64, False, None, None),
    "window": (4, 2, 64, 64, True, 9, None),
    "mqa": (4, 1, 64, 64, True, None, None),
    "mha_window_nocausal": (2, 2, 48, 48, False, 7, None),
    "sq_lt_skv": (4, 2, 32, 96, True, None, None),
    "sq_lt_skv_window": (4, 1, 32, 96, True, 40, None),
    "custom_scale": (4, 2, 64, 64, True, None, 0.37),
    "multi_block": (2, 1, 128, 256, True, 100, None),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax_pallas(case):
    hq, hkv, sq, skv, causal, window, scale = FLASH_CASES[case]
    q, k, v = flash_case(6, hq=hq, hkv=hkv, sq=sq, skv=skv)
    exp = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, window=window))
    out = to_numpy(tops.flash_attention(to_torch(q), to_torch(k),
                                        to_torch(v), causal=causal,
                                        scale=scale, window=window))
    np.testing.assert_allclose(out, exp, **TOL)
    ref = np.asarray(jref.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, window=window))
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("case", ["causal_gqa", "sq_lt_skv_window", "mqa"])
def test_flash_gradients_match_jax(case):
    """The autograd.Function's backward (autograd through the plain
    version) against ``jax.grad`` through the reference's custom_vjp; the
    cotangent is a fixed random tensor.  fp32, 1e-5 as for the forward:
    both differentiate the same fp32 math."""
    import jax
    hq, hkv, sq, skv, causal, window, scale = FLASH_CASES[case]
    q, k, v = flash_case(7, hq=hq, hkv=hkv, sq=sq, skv=skv)
    w = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(jops.flash_attention(q_, k_, v_, causal=causal,
                                            scale=scale, window=window)
                       * jnp.asarray(w))

    exp = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    tq, tk, tv = (to_torch(a).requires_grad_() for a in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, causal=causal, scale=scale,
                               window=window)
    (out * to_torch(w)).sum().backward()
    for ours, ref in zip((tq.grad, tk.grad, tv.grad), exp):
        np.testing.assert_allclose(to_numpy(ours), np.asarray(ref), **TOL)


# The fp32 flash kernel's arithmetic on the CPU: 3xTF32 products
# (``matmul_tf32``) at the card test's fp32 shapes that the JAX kernel
# takes in interpret mode (Sq and Skv within 128 or multiples of it):
# (b, hq, hkv, sq, skv, causal, window)
TF32_SHAPES = {"decode_like": (1, 4, 4, 1, 77, True, None),
               "gemma_prefill": (1, 8, 1, 1024, 1024, True, None),
               "jamba_grouping": (1, 16, 2, 512, 512, True, None)}


def tf32_case(shape, hd):
    b, hq, hkv, sq, skv, causal, window = TF32_SHAPES[shape]
    rng = np.random.default_rng(hd + sq)
    q = rng.standard_normal((b, hq, sq, hd)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, hd)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, hd)).astype(np.float32)
    exp = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    kw = dict(causal=causal, scale=hd ** -0.5, window=window)
    return (to_torch(q), to_torch(k), to_torch(v)), kw, exp


def test_tf32_round_is_to_nearest_ties_away():
    """10 mantissa bits kept; a tie (half a TF32 unit) rounds away from
    zero, as cvt.rna does; values already TF32 stay."""
    u = 2.0 ** -10  # a TF32 unit at 1
    x = torch.tensor([1 + u / 2, -(1 + u / 2), 1 + u / 2 - 2 ** -23,
                      1 + u / 4, 3 * u, 1.0, 0.0])
    np.testing.assert_array_equal(
        tf32_round(x).numpy(),
        np.float32([1 + u, -(1 + u), 1, 1, 3 * u, 1, 0]))


@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("shape", sorted(TF32_SHAPES))
def test_flash_3xtf32_matches_jax_pallas(shape, hd):
    """Three TF32 products hold the fp32 tier (1e-5) against the JAX
    kernel, so the fp32 flash kernel can run on the tensor cores."""
    (q, k, v), kw, exp = tf32_case(shape, hd)
    out = flash_attention_tf32(q, k, v, **kw).numpy()
    np.testing.assert_allclose(out, exp, **TOL)


def test_flash_tf32_big_term_alone_misses_the_tier():
    """TF32 alone (11 significant bits an operand) misses 1e-5 at
    head_dim 256 by far: why the kernel takes three products."""
    (q, k, v), kw, exp = tf32_case("jamba_grouping", 256)
    err = np.abs(flash_attention_tf32(q, k, v, terms=1, **kw).numpy()
                 - exp).max()
    assert err > 10 * TOL["atol"]


def decode_case(seed, b=3, hq=4, hkv=2, smax=40, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, 1, hd)).astype(np.float32)
    kc = rng.standard_normal((b, hkv, smax, hd)).astype(np.float32)
    vc = rng.standard_normal((b, hkv, smax, hd)).astype(np.float32)
    return q, kc, vc


@pytest.mark.parametrize("hkv", [1, 2])
@pytest.mark.parametrize("lens,window", [
    ((5, 40, 17), None), ((5, 40, 17), 8), ((1, 2, 39), 3), (23, None),
    (40, 12)])
def test_decode_plain_matches_jax(lens, window, hkv):
    q, kc, vc = decode_case(9, hkv=hkv)
    jl = jnp.asarray(np.asarray(lens, np.int32))
    tl = torch.tensor(lens, dtype=torch.int32) if isinstance(lens, tuple) \
        else lens
    args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jl)
    out = to_numpy(tops.decode_attention(to_torch(q), to_torch(kc),
                                         to_torch(vc), tl, window=window))
    np.testing.assert_allclose(
        out, np.asarray(jops.decode_attention(*args, window=window)), **TOL)
    np.testing.assert_allclose(
        out, np.asarray(jref.decode_attention(*args, window=window)), **TOL)


def test_decode_wrapper_shapes_and_refusals():
    q, kc, vc = decode_case(10)
    t = to_torch
    a = tops.decode_attention(t(q), t(kc), t(vc), torch.tensor([7]))
    b = tops.decode_attention(t(q), t(kc), t(vc), 7)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tuple(a.shape) == q.shape
    with pytest.raises(ValueError, match="one query per row"):
        tops.decode_attention(t(q).expand(3, 4, 2, 16), t(kc), t(vc), 7)
    # a device with no route (meta has one: the dry run's shapes)
    with FakeTensorMode():
        other = torch.zeros((1, 2, 2, 16), device="xla")
        other3 = torch.zeros((2, 2, 16), device="xla")
    with pytest.raises(ValueError):
        DA.decode_attention_fwd(other, other, other, torch.ones(1),
                                scale=1.0)
    with pytest.raises(ValueError):
        FA.flash_attention_fwd(other3, other3, other3, causal=True,
                               scale=1.0)


# ----------------------------------------------------------------------
# on the card: each kernel against its plain version
# ----------------------------------------------------------------------

@requires_cuda
@pytest.mark.parametrize("hd", [16, 128, 256])
@pytest.mark.parametrize("kv_dtype", ["fp32", "bf16", "int8", "fp8_e4m3"])
def test_cuda_paged_kernel_matches_plain(cuda_device, kv_dtype, hd):
    q, kp, vp, ksc, vsc, tables, seg, pos = paged_case(
        5, hd, "fp32" if kv_dtype == "bf16" else kv_dtype, hq=8, hkv=1)
    dev = cuda_device
    t = lambda a: None if a is None else to_torch(a).to(dev)  # noqa: E731
    qq = t(q)
    kk, vv = t(kp), t(vp)
    if kv_dtype == "bf16":
        qq, kk, vv = (x.to(torch.bfloat16) for x in (qq, kk, vv))
    before = DA.counter.launches
    out = tops.paged_attention(qq, kk, vv, t(tables), t(seg), t(pos),
                               k_scale=t(ksc), v_scale=t(vsc), window=6)
    torch.cuda.synchronize()
    assert DA.counter.launches == before + 1
    exp = DA.paged_attention_plain(
        qq.reshape(7, 1, 8, hd), kk, vv, t(tables), t(seg), t(pos),
        scale=hd ** -0.5, k_scale=t(ksc), v_scale=t(vsc),
        window=6).reshape(7, 8, hd)
    live = torch.as_tensor(seg >= 0, device=dev)
    tol = 3e-2 if kv_dtype == "bf16" else 1e-5
    torch.testing.assert_close(out[live].float(), exp[live].float(),
                               rtol=tol, atol=tol)


@requires_cuda
def test_triton_gumbel_kernel_matches_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    logits = torch.randn((48, 256000), generator=g, device=cuda_device)
    u = torch.rand((48, 256000), generator=g,
                   device=cuda_device).clamp(1e-20, 1 - 1e-7)
    before = tops.gumbel_counter.launches
    out = tops.gumbel_perturb(logits, u)
    assert tops.gumbel_counter.launches == before + 1
    torch.testing.assert_close(out, tops.gumbel_perturb_plain(logits, u),
                               rtol=1e-5, atol=1e-4)


@requires_cuda
@pytest.mark.parametrize("shape", [(48, 256000), (1, 1000), (1, 256001),
                                   (3, 1000), (3, 256001)])
def test_triton_gumbel_keyed_kernel_matches_plain(cuda_device, shape):
    """The keyed kernel against its plain composition at serving's
    sampling shape and at ragged tile edges: within chip_smoke.py's
    GUMBEL_TOL (1e-4: fp32 logs of values up to ~20), the same sampled
    token (argmax) in every row, one launch counted."""
    rows, vocab = shape
    g = torch.Generator(device=cuda_device).manual_seed(1)
    logits = torch.randn(shape, generator=g, device=cuda_device) * 3.0
    seeds = torch.arange(rows, device=cuda_device) * 7919 - 3
    pos = torch.arange(rows, device=cuda_device) + 2 ** 33
    before = tops.gumbel_counter.launches
    out = tops.gumbel_perturb_keyed(logits, seeds, pos)
    torch.cuda.synchronize()
    assert tops.gumbel_counter.launches == before + 1
    ref = tops.gumbel_perturb_keyed_plain(logits, seeds, pos)
    assert bool(torch.isfinite(out).all())
    assert (out - ref).abs().max().item() <= 1e-4
    assert torch.equal(out.argmax(-1), ref.argmax(-1))


# fp32 tolerances: the kernel and the plain version sum in other orders;
# 1e-5 as the reference's kernel tier, 2e-3 for the long reductions
# (Skv >= 1024).  bf16: 1e-2 + 1e-2 |ref| (assert_close's atol and rtol)
# on O(1) outputs, where one bf16 rounding of the output is 4e-3.
def _cuda_tol(dtype, skv):
    if dtype == torch.bfloat16:
        return 1e-2
    return 2e-3 if skv >= 1024 else 1e-5


def test_flash_kernel_attributes_refuse_unknown_kernels():
    """Checked before the library is built, so it runs on the CPU."""
    with pytest.raises(ValueError, match="no kernel"):
        FA.kernel_attributes(torch.float16, 64)
    with pytest.raises(ValueError, match="no kernel"):
        FA.kernel_attributes(torch.bfloat16, 96)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("shape", [
    # (b, hq, hkv, sq, skv, causal, window)
    (2, 8, 1, 200, 200, True, None),
    (1, 4, 2, 70, 333, True, 50),
    (2, 2, 2, 65, 130, False, None),
    (1, 4, 4, 1, 77, True, None),
    # gemma-2b prefill's grouping and length (8 query heads over 1)
    (1, 8, 1, 1024, 1024, True, None),
    # jamba's grouping (16 query heads over 2)
    (1, 16, 2, 512, 512, True, None),
    # queries at an offset; a window whose edge crosses key tiles
    (1, 4, 1, 300, 1000, True, 129),
])
def test_cuda_flash_kernel_matches_plain(cuda_device, shape, hd, dtype):
    b, hq, hkv, sq, skv, causal, window = shape
    g = torch.Generator(device=cuda_device).manual_seed(hd + sq)
    q = torch.randn((b, hq, sq, hd), generator=g, device=cuda_device)
    k = torch.randn((b, hkv, skv, hd), generator=g, device=cuda_device)
    v = torch.randn((b, hkv, skv, hd), generator=g, device=cuda_device)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    before = FA.counter.launches
    out = tops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.counter.launches == before + 1
    exp = FA.flash_attention_plain(
        q.reshape(b * hq, sq, hd), k.reshape(b * hkv, skv, hd),
        v.reshape(b * hkv, skv, hd), causal=causal, scale=hd ** -0.5,
        window=window).reshape(b, hq, sq, hd)
    tol = _cuda_tol(dtype, skv)
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 129])
def test_cuda_flash_kernel_is_deterministic(cuda_device, window, dtype):
    """No atomics: two calls on the same inputs agree bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
               for shape in ((8, 300, 256), (1, 1000, 256), (1, 1000, 256)))
    kw = dict(causal=True, scale=256 ** -0.5, window=window)
    first = FA.flash_attention_fwd(q, k, v, **kw)
    second = FA.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_cuda_flash_kernel_attributes(cuda_device, hd, dtype):
    attrs = FA.kernel_attributes(dtype, hd)
    assert attrs["variant"] == ("mma" if dtype == torch.bfloat16
                                else "tf32x3")
    assert 0 < attrs["registers"] <= 255
    assert attrs["blocks_per_sm"] >= 1
    assert attrs["smem_bytes"] <= 232448
    assert attrs["spill_bytes"] == 0
    if dtype == torch.bfloat16:
        # the tile choice of the source note: 32-key ring stages from
        # head_dim 128 keep every instantiation free of spills and two
        # blocks an SM at gemma's and jamba's head dims
        assert attrs["key_tile"] == (32 if hd >= 128 else 64)
        if hd in (128, 256):
            assert attrs["blocks_per_sm"] >= 2
    else:
        # 32-key stages, 8 warps: the two of a row group split D
        assert attrs["key_tile"] == 32 and attrs["threads"] == 256


# Decode cases on the card, in keys a split (KS, each variant's constant:
# the kernel's attributes give it): B = 6 rows over 2 KV heads; (Smax,
# window, lengths).  Smax is not a multiple of KS; the lengths sit at the
# split edges (KS - 1, KS, KS + 1, 2 KS) and at Smax.  A window of 1.5 KS
# puts a split edge inside each long row's window; a window of 3 KS is
# longer than most rows.  The last case's grid has one split (Smax = KS,
# no combine) and a length past Smax, which the kernel clips.
def decode_card_case(case, ks):
    smax = 4 * ks + 37
    return {
        "split_edges": (smax, None, [1, ks - 1, ks, ks + 1, 2 * ks, smax]),
        "window_crosses_split": (smax, ks + ks // 2,
                                 [1, ks, ks + ks // 2 + 3, 2 * ks + 5,
                                  smax - 1, smax]),
        "window_over_len": (smax, 3 * ks,
                            [1, ks - 1, ks + 1, 2 * ks, 3 * ks - 1, smax]),
        "one_split": (ks, None, [1, ks // 2, ks - 1, ks, ks + 9, 3]),
    }[case]


DECODE_CARD_CASES = ("split_edges", "window_crosses_split",
                     "window_over_len", "one_split")


def decode_card_inputs(dev, case, g_heads, hd, dtype, b=6, hkv=2):
    """q (B, Hkv*G, 1, D), caches, lengths and window of a card case, with
    KS read from the attributes of the dtype's kernel."""
    ks = DA.decode_kernel_attributes(dtype, hd)["split_keys"]
    smax, window, lens = decode_card_case(case, ks)
    gen = torch.Generator(device=dev).manual_seed(hd + g_heads)
    q = torch.randn((b, hkv * g_heads, 1, hd), generator=gen,
                    device=dev).to(dtype)
    kc = torch.randn((b, hkv, smax, hd), generator=gen, device=dev).to(dtype)
    vc = torch.randn((b, hkv, smax, hd), generator=gen, device=dev).to(dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kc, vc, lens, window, ks


# query heads a block of each variant: bf16 an m16 tile, fp32 a chunk of 8
DECODE_BLOCK_HEADS = {torch.bfloat16: 16, torch.float32: 8}


def decode_launch_record(dtype, b, hkv, g, splits):
    """The C entry's record of a call over (B*Hkv, splits, ceil(G /
    heads)) main blocks: a combine of one block (a warp) a row only when
    the grid has more than one split."""
    main = splits * b * hkv * -(-g // DECODE_BLOCK_HEADS[dtype])
    if splits == 1:
        return {"device_launches": 1, "main_blocks": main,
                "combine_blocks": 0}
    return {"device_launches": 2, "main_blocks": main,
            "combine_blocks": b * hkv * g}


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("g_heads", [1, 3, 8, 12, 16, 24])
@pytest.mark.parametrize("case", DECODE_CARD_CASES)
def test_cuda_decode_kernel_matches_plain(cuda_device, case, g_heads, hd,
                                          dtype):
    q, kc, vc, lens, window, _ = decode_card_inputs(cuda_device, case,
                                                    g_heads, hd, dtype)
    b, hkv, smax = kc.shape[0], kc.shape[1], kc.shape[2]
    before = DA.decode_counter.launches
    out = tops.decode_attention(q, kc, vc, lens, window=window)
    torch.cuda.synchronize()
    assert DA.decode_counter.launches == before + 1
    exp = DA.decode_attention_plain(
        q.reshape(b, hkv, g_heads, hd), kc, vc, lens, scale=hd ** -0.5,
        window=window).reshape(b, hkv * g_heads, 1, hd)
    tol = _cuda_tol(dtype, smax)
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g_heads", [3, 24])
@pytest.mark.parametrize("case", DECODE_CARD_CASES)
def test_cuda_decode_kernel_launches_match_grid(cuda_device, case, g_heads,
                                                dtype):
    """The C entry's record of a call: (B*Hkv, ceil(span / KS), ceil(G /
    heads)) main blocks with span = min(Smax, window), heads 16 for bf16
    and 8 for fp32, and a combine of one block a row only when that grid
    has more than one split."""
    q, kc, vc, lens, window, ks = decode_card_inputs(cuda_device, case,
                                                     g_heads, 128, dtype)
    b, hkv, smax = kc.shape[0], kc.shape[1], kc.shape[2]
    DA.decode_attention_fwd(q.reshape(b, hkv, g_heads, 128), kc, vc, lens,
                            scale=0.1, window=window)
    splits = -(-min(smax, window or smax) // ks)
    assert DA.decode_last_launch() == decode_launch_record(
        dtype, b, hkv, g_heads, splits)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_kernel_takes_a_wide_batch(cuda_device, dtype):
    """B*Hkv = 65544 (row, KV head) pairs, more than a grid's y or z
    holds, with two splits a row so that the combine runs too."""
    b, hkv, g, d = 8193, 8, 2, 16
    smax = DA.decode_kernel_attributes(dtype, d)["split_keys"] + 22
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q = torch.randn((b, hkv, g, d), generator=gen,
                    device=cuda_device).to(dtype)
    kc, vc = (torch.randn((b, hkv, smax, d), generator=gen,
                          device=cuda_device).to(dtype) for _ in range(2))
    lens = torch.randint(1, smax + 1, (b,), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    out = DA.decode_attention_fwd(q, kc, vc, lens, scale=d ** -0.5)
    exp = DA.decode_attention_plain(q, kc, vc, lens, scale=d ** -0.5)
    tol = _cuda_tol(dtype, smax)
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)
    assert DA.decode_last_launch() == decode_launch_record(dtype, b, hkv, g,
                                                           2)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_kernel_refuses_too_many_splits(cuda_device, dtype):
    """More than 65535 splits of KS keys (the grid's y) is refused with a
    clear error before anything launches."""
    ks = DA.decode_kernel_attributes(dtype, 16)["split_keys"]
    smax = 65535 * ks + 1
    q = torch.zeros((1, 1, 1, 16), dtype=dtype, device=cuda_device)
    kc = torch.zeros((1, 1, smax, 16), dtype=dtype, device=cuda_device)
    lens = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    before = DA.decode_counter.launches
    with pytest.raises(ValueError, match="65535"):
        DA.decode_attention_fwd(q, kc, kc, lens, scale=0.25)
    assert DA.decode_counter.launches == before


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 300])
def test_cuda_decode_kernel_is_deterministic(cuda_device, window, dtype):
    """No atomics: the splits are merged in split order, so two calls on
    the same inputs agree bit for bit; a row of length 0 gives zeros."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.randn((8, 1, 8, 256), generator=gen,
                    device=cuda_device).to(dtype)
    kc, vc = (torch.randn((8, 1, 2048, 256), generator=gen,
                          device=cuda_device).to(dtype) for _ in range(2))
    lens = torch.tensor([0, 1, 127, 128, 129, 700, 2047, 2048],
                        dtype=torch.int32, device=cuda_device)
    kw = dict(scale=256 ** -0.5, window=window)
    first = DA.decode_attention_fwd(q, kc, vc, lens, **kw)
    second = DA.decode_attention_fwd(q, kc, vc, lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert not bool(first[0].any())


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_cuda_decode_kernel_attributes(cuda_device, hd, dtype):
    attrs = DA.decode_kernel_attributes(dtype, hd)
    assert attrs["variant"] == DA.decode_variant(dtype)
    assert 0 < attrs["registers"] <= 255
    assert attrs["blocks_per_sm"] >= 1
    assert attrs["smem_bytes"] <= 232448
    assert attrs["split_keys"] % attrs["key_tile"] == 0
    if dtype == torch.bfloat16:
        assert attrs["variant"] == "mma" and attrs["spill_bytes"] == 0
    else:
        assert attrs["variant"] == "simt"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", ["odd_offset", "transposed", "sliced"])
def test_dense_aligned_copies_strided_operands(view, dtype):
    """What the attention wrappers do to q, k and v before a launch: an
    operand that is not contiguous or not 16-byte aligned comes back as a
    contiguous, 16-byte aligned copy of the same values; one that is both
    comes back as itself, uncopied."""
    x = torch.randn((3, 2, 5, 16)).to(dtype)
    if view == "sliced":
        y = torch.randn((3, 2, 5, 24)).to(dtype)[..., 4:20].copy_(x)
    else:
        y = strided_operands(x)[view == "transposed"]
    assert not (y.is_contiguous() and y.data_ptr() % 16 == 0)
    z = _build.dense_aligned(y)
    assert z.is_contiguous() and z.data_ptr() % 16 == 0
    assert torch.equal(z, x)
    assert _build.dense_aligned(z) is z


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernel_copies_strided_operands(cuda_device, dtype):
    """q, k and v at an odd element offset or transposed: the wrapper
    copies them and gives the contiguous call's bits, one launch each."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
               for shape in ((4, 70, 64), (2, 90, 64), (2, 90, 64)))
    kw = dict(causal=True, scale=0.125, window=None)
    want = FA.flash_attention_fwd(q, k, v, **kw)
    for view in range(2):
        args = [strided_operands(x)[view] for x in (q, k, v)]
        before = FA.counter.launches
        got = FA.flash_attention_fwd(*args, **kw)
        assert FA.counter.launches == before + 1
        assert got.is_contiguous() and torch.equal(got, want)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_kernel_copies_strided_operands(cuda_device, dtype):
    """q and both caches at an odd element offset or transposed: the
    wrapper copies them and gives the contiguous call's bits."""
    q, kc, vc, lens, window, _ = decode_card_inputs(cuda_device,
                                                    "split_edges", 4, 64,
                                                    dtype)
    q = q.reshape(q.shape[0], 2, 4, 64)
    want = DA.decode_attention_fwd(q, kc, vc, lens, scale=0.125)
    for view in range(2):
        args = [strided_operands(x)[view] for x in (q, kc, vc)]
        before = DA.decode_counter.launches
        got = DA.decode_attention_fwd(*args, lens, scale=0.125)
        assert DA.decode_counter.launches == before + 1
        assert got.is_contiguous() and torch.equal(got, want)


def test_decode_kernel_attributes_refuse_unknown_kernels():
    """Checked before the library is built, so it runs on the CPU."""
    with pytest.raises(ValueError, match="no kernel"):
        DA.decode_kernel_attributes(torch.float16, 64)
    with pytest.raises(ValueError, match="no kernel"):
        DA.decode_kernel_attributes(torch.bfloat16, 96)
    assert DA.decode_variant(torch.bfloat16) == "mma"
    assert DA.decode_variant(torch.float32) == "simt"
