"""The port's mixed attention (a flat token batch against per-slot
contiguous caches, kernel B2) against the JAX package.

On the CPU the port's wrappers run the plain version; it is held against
``repro.models.attention.mixed_attention(backend="ref")`` (the jnp
oracle) and ``repro.kernels.ops.mixed_attention`` (the Pallas kernel in
interpret mode, as tests/test_serving.py runs it) on the same numpy
inputs: 2e-5 at these small serving shapes in fp32 (docs/kernels.md),
3e-2 (the bf16 tier) in bf16.  Every case holds padding tokens.  The
positions stay below the cache length: a token with no visible key (only
possible when its position is past the cache under a window) gives zeros
from the Pallas and CUDA kernels and a uniform average of V from the jnp
oracle and the plain version, so the two references disagree there.
Cases that hold the CUDA kernel against its plain version need the card
and skip elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as JA
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as TA
from torch_port_helpers import cuda_device, requires_cuda, to_numpy, \
    to_torch  # noqa: F401  (cuda_device is the fixture requires_cuda uses)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def mixed_case(seed, g, hd, hkv=2, s=3, l=32):
    """A mixed batch over 3 slots: a prefill chunk (slot 0), a fresh
    prefill start (slot 1), decode tokens (slot 2) and two padding tokens
    (seg -1), as tests/test_serving.py's case."""
    rng = np.random.default_rng(seed)
    kc = rng.standard_normal((s, hkv, l, hd)).astype(np.float32)
    vc = rng.standard_normal((s, hkv, l, hd)).astype(np.float32)
    q = rng.standard_normal((9, hkv * g, hd)).astype(np.float32)
    seg = np.array([0, 0, 0, 1, 2, 2, 2, -1, -1], np.int32)
    pos = np.array([3, 4, 5, 0, 10, 11, 31, 0, 0], np.int32)
    return q, kc, vc, seg, pos


@pytest.mark.parametrize("g,hd", [(1, 16), (2, 32), (4, 64), (4, 16),
                                  (1, 64), (2, 16)])
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixed_plain_matches_jax_oracle_and_pallas(dtype, window, g, hd):
    q, kc, vc, seg, pos = mixed_case(g * 100 + hd, g, hd)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype))
                  for a in (q, kc, vc))
    tq, tk, tv = (to_torch(np.asarray(a)) for a in (jq, jk, jv))
    live = seg >= 0
    port = to_numpy(TA.mixed_attention(tq, tk, tv, to_torch(seg),
                                       to_torch(pos), window=window))
    assert port.shape == q.shape
    tol = TOL[dtype]
    oracle = np.asarray(JA.mixed_attention(
        jq, jk, jv, jnp.asarray(seg), jnp.asarray(pos), window=window,
        backend="ref").astype(jnp.float32))
    np.testing.assert_allclose(port[live], oracle[live], rtol=tol, atol=tol)
    pallas = np.asarray(jops.mixed_attention(
        jq, jk, jv, jnp.asarray(seg), jnp.asarray(pos),
        window=window).astype(jnp.float32))
    np.testing.assert_allclose(port[live], pallas[live], rtol=tol, atol=tol)


def test_padding_rows_read_slot_zero():
    """A padding token (seg < 0) reads slot 0, as the reference's clip
    does, so its (discarded) output equals the oracle's too."""
    q, kc, vc, seg, pos = mixed_case(7, 2, 16)
    out = to_numpy(tops.mixed_attention(to_torch(q), to_torch(kc),
                                        to_torch(vc), to_torch(seg),
                                        to_torch(pos)))
    exp = np.asarray(JA.mixed_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(seg),
        jnp.asarray(pos), backend="ref"))
    np.testing.assert_allclose(out, exp, rtol=2e-5, atol=2e-5)


def test_paged_equals_gathered_mixed_attention():
    """The port's paged attention over pages == its mixed attention over
    the explicitly gathered per-slot caches (the reference's
    tests/test_kernels.py:209-227), and the paged plain version is the
    mixed one after its gather (bitwise)."""
    rng = np.random.default_rng(80)
    n_pages, ps, hkv, d, hq, s, p = 20, 4, 2, 16, 4, 3, 3
    kp = rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32)
    q = rng.standard_normal((5, hq, d)).astype(np.float32)
    tables = rng.permutation(n_pages)[:s * p].reshape(s, p).astype(np.int32)
    seg = np.array([0, 1, 1, 2, -1], np.int32)
    pos = np.array([4, 7, 8, 11, 0], np.int32)
    gidx = (tables[:, :, None] * ps + np.arange(ps)).reshape(s, p * ps)
    kc = kp.reshape(-1, hkv, d)[gidx].transpose(0, 2, 1, 3)
    vc = vp.reshape(-1, hkv, d)[gidx].transpose(0, 2, 1, 3)
    t = to_torch
    paged = TA.paged_attention(t(q), t(kp), t(vp), t(tables), t(seg),
                               t(pos))
    mixed = TA.mixed_attention(t(q), t(kc), t(vc), t(seg), t(pos))
    torch.testing.assert_close(paged, mixed, rtol=1e-5, atol=1e-5)
    direct = DA.mixed_attention_plain(
        t(q).reshape(5, hkv, 2, d), t(kc), t(vc), t(seg), t(pos),
        scale=d ** -0.5).reshape(5, hq, d)
    torch.testing.assert_close(paged, direct, rtol=0, atol=0)


def test_bf16_queries_over_fp32_caches():
    """bf16 q over fp32 caches (what ``gather`` gives from an int8/fp8
    pool): the logits are fp32 of the bf16 queries, the output is bf16,
    and it agrees with the fp32 oracle at the bf16 tier."""
    q, kc, vc, seg, pos = mixed_case(9, 4, 32)
    qb = to_torch(q).to(torch.bfloat16)
    out = tops.mixed_attention(qb, to_torch(kc), to_torch(vc),
                               to_torch(seg), to_torch(pos))
    assert out.dtype == torch.bfloat16
    exp = np.asarray(JA.mixed_attention(
        jnp.asarray(to_numpy(qb)), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(seg), jnp.asarray(pos), backend="ref"))
    live = seg >= 0
    np.testing.assert_allclose(to_numpy(out)[live], exp[live], rtol=3e-2,
                               atol=3e-2)


def test_every_backend_goes_through_the_wrapper(monkeypatch):
    calls = []
    real = DA.mixed_attention_plain

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(DA, "mixed_attention_plain", spy)
    q, kc, vc, seg, pos = mixed_case(3, 2, 16)
    t = to_torch
    for backend in ("auto", "pallas", "ref"):
        TA.mixed_attention(t(q), t(kc), t(vc), t(seg), t(pos),
                           backend=backend)
    assert len(calls) == 3
    with pytest.raises(ValueError):
        TA.mixed_attention(t(q), t(kc), t(vc), t(seg), t(pos),
                           backend="jnp")


def test_wrapper_refuses_other_devices():
    meta = torch.zeros((2, 1, 2, 16), device="meta")
    seg = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        DA.mixed_attention_fwd(meta, meta, meta, seg, seg, scale=1.0)


# ----------------------------------------------------------------------
# on the card: the kernel against its plain version
# ----------------------------------------------------------------------

@requires_cuda
@pytest.mark.parametrize("hd", [16, 32, 128, 256])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("pair", ["fp32", "bf16", "bf16_over_fp32"])
def test_cuda_mixed_kernel_matches_plain(cuda_device, pair, window, hd):
    g, hkv, s, l = 8 if hd == 256 else 2, 1 if hd == 256 else 4, 3, 700
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(hd)
    q = torch.randn((9, hkv, g, hd), generator=gen, device=dev)
    kc = torch.randn((s, hkv, l, hd), generator=gen, device=dev)
    vc = torch.randn((s, hkv, l, hd), generator=gen, device=dev)
    if pair != "fp32":
        q = q.to(torch.bfloat16)
    if pair == "bf16":
        kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    seg = torch.tensor([0, 0, 0, 1, 2, 2, 2, -1, -1], dtype=torch.int32,
                       device=dev)
    pos = torch.tensor([3, 4, 5, 0, 10, 511, 699, 0, 0], dtype=torch.int32,
                       device=dev)
    before = DA.mixed_counter.launches
    out = DA.mixed_attention_fwd(q, kc, vc, seg, pos, scale=hd ** -0.5,
                                 window=window)
    torch.cuda.synchronize()
    assert DA.mixed_counter.launches == before + 1
    exp = DA.mixed_attention_plain(q, kc, vc, seg, pos, scale=hd ** -0.5,
                                   window=window)
    tol = 1e-2 if pair != "fp32" else 1e-5
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


@requires_cuda
def test_cuda_mixed_kernel_refuses_unsupported_pairs(cuda_device):
    x = torch.zeros((2, 1, 2, 16), device=cuda_device)
    seg = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        DA.mixed_attention_fwd(x, x.to(torch.bfloat16),
                               x.to(torch.bfloat16), seg, seg, scale=1.0)
    with pytest.raises(ValueError):
        DA.mixed_attention_fwd(torch.zeros((2, 1, 2, 24), device=cuda_device),
                               torch.zeros((2, 1, 4, 24), device=cuda_device),
                               torch.zeros((2, 1, 4, 24), device=cuda_device),
                               seg, seg, scale=1.0)
