"""The decode kernels' split-KV decomposition, on the CPU.

``decode_attention_split_plain`` cuts each row's live keys into splits of
``split_keys``, computes each split's (m, l, O) and merges them in split
order, as the kernel's blocks and its combine do.  It is held against the
port's ``decode_attention_plain`` and against the JAX package's
``decode_attention_fwd`` (the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it) on the same numpy inputs, at small sizes:
fp32 at the 1e-5 kernel tier of docs/kernels.md (the two sum in other
orders), bf16 at 1e-2 + 1e-2 |ref| against the plain version, which rounds
the normalised probabilities where the splits round the unnormalised ones
(about one bf16 rounding of the O(1) outputs).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as DA
from torch_port_helpers import to_numpy, to_torch

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def case(seed, lens, smax, hd, hkv=2, g=3):
    """q (B, Hkv*G, 1, D), caches (B, Hkv, Smax, D) and (B,) lengths."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    q = rng.standard_normal((b, hkv * g, 1, hd)).astype(np.float32)
    kc = rng.standard_normal((b, hkv, smax, hd)).astype(np.float32)
    vc = rng.standard_normal((b, hkv, smax, hd)).astype(np.float32)
    return q, kc, vc, np.asarray(lens, np.int32)


def split_plain(q, kc, vc, lens, split_keys, window, dtype=torch.float32):
    b, hq, _, d = q.shape
    hkv = kc.shape[1]
    out = DA.decode_attention_split_plain(
        to_torch(q).reshape(b, hkv, hq // hkv, d).to(dtype),
        to_torch(kc).to(dtype), to_torch(vc).to(dtype),
        torch.from_numpy(lens), split_keys, scale=d ** -0.5, window=window)
    return out.reshape(b, hq, 1, d)


# (lengths, window, Smax): lengths at the split edges of 8- and 16-key
# splits and at Smax; windows that put a split edge inside the live range
# or exceed the length; an Smax that is no multiple of the split
@pytest.mark.parametrize("split_keys", [8, 16])
@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("lens,window,smax", [
    ((1, 7, 8, 9, 16, 40), None, 40),
    ((5, 40, 17, 33), 12, 40),
    ((3, 50, 99, 100), 30, 100),
    ((2, 60, 97), 70, 97),
    ((100, 64, 65), None, 100)])
def test_split_plain_matches_plain_and_jax(lens, window, smax, hd,
                                           split_keys):
    q, kc, vc, lens = case(hd + smax, lens, smax, hd)
    out = to_numpy(split_plain(q, kc, vc, lens, split_keys, window))
    b, hq, _, d = q.shape
    hkv = kc.shape[1]
    plain = DA.decode_attention_plain(
        to_torch(q).reshape(b, hkv, hq // hkv, d), to_torch(kc),
        to_torch(vc), torch.from_numpy(lens), scale=d ** -0.5,
        window=window)
    np.testing.assert_allclose(out, to_numpy(plain).reshape(out.shape),
                               **TOL)
    jax_out = jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.asarray(lens),
                                    window=window)
    np.testing.assert_allclose(out, np.asarray(jax_out), **TOL)


def test_split_plain_zero_and_clipped_lengths_match_pallas():
    """A row with no live key gives zeros, as the Pallas kernel does (the
    jnp oracle averages V there instead); a length past Smax is clipped."""
    q, kc, vc, lens = case(3, (0, 45, 17), 40, 16)
    out = to_numpy(split_plain(q, kc, vc, lens, 8, None))
    assert not out[0].any()
    jax_out = jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.asarray(lens))
    np.testing.assert_allclose(out, np.asarray(jax_out), **TOL)


@pytest.mark.parametrize("window", [None, 20])
def test_split_plain_bf16_matches_plain(window):
    q, kc, vc, lens = case(4, (1, 9, 40, 33), 40, 32, g=8)
    out = split_plain(q, kc, vc, lens, 8, window, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    b, hq, _, d = q.shape
    plain = DA.decode_attention_plain(
        to_torch(q).reshape(b, 2, hq // 2, d).bfloat16(),
        to_torch(kc).bfloat16(), to_torch(vc).bfloat16(),
        torch.from_numpy(lens), scale=d ** -0.5, window=window)
    torch.testing.assert_close(out.float(),
                               plain.reshape(out.shape).float(), **BF16_TOL)


def fp32_split_keys() -> int:
    """The fp32 decode kernel's keys a split, ``kSimtSplitKeys`` in
    csrc/decode_attention.cu, read from the source (no card here)."""
    src = (Path(DA.__file__).parent / "csrc" / "decode_attention.cu")
    return int(re.search(r"kSimtSplitKeys = (\d+);",
                         src.read_text()).group(1))


# lengths 0, 1, at a split's edges (KS - 1, KS, KS + 1) and Smax; no
# window, a window that puts a split edge inside the live keys, and one
# longer than every length.  Smax is a multiple of the JAX kernel's
# 256-key block, which its interpret mode needs (ROADMAP.md, queue C).
@pytest.mark.parametrize("window", [None, "1.5 KS", "3 KS"])
def test_split_plain_at_the_fp32_split_matches_pallas(window):
    """The fp32 kernel's decomposition (natural-unit (m, l), expf) at its
    own split size against the JAX package's Pallas kernel."""
    ks = fp32_split_keys()
    window = {None: None, "1.5 KS": ks + ks // 2, "3 KS": 3 * ks}[window]
    smax = 256 * -(-2 * ks // 256)
    q, kc, vc, lens = case(21, (0, 1, ks - 1, ks, ks + 1, smax), smax, 32)
    out = to_numpy(split_plain(q, kc, vc, lens, ks, window))
    assert not out[0].any()
    jax_out = jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.asarray(lens),
                                    window=window)
    np.testing.assert_allclose(out, np.asarray(jax_out), **TOL)
