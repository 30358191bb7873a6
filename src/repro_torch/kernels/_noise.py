"""The port's position-keyed sampling noise, in plain PyTorch.

The uniforms of a sampled token are a counter-based hash of ``(seed,
absolute position, vocab lane)``, so they depend on nothing else (not
the row's place in the batch, not the device).  The hash is written in
int64 torch ops that hold 32-bit values, which gives the same bits on
the CPU and on CUDA; the keyed Gumbel kernel
(``kernels.ops.gumbel_perturb_keyed``) computes the same integers in
native ``uint32`` arithmetic in registers.  ``serving/sampling.py``
re-exports :func:`position_uniforms`.
"""

from __future__ import annotations

import torch

MIN_UNIFORM = 1e-20
_M32 = 0xFFFFFFFF
# the hash's constants, shared with the keyed Gumbel kernel
SEED_SALT = 0x9E3779B9
LANE_SALT = 0x632BE5AB
MUL1 = 0x7FEB352D
MUL2 = 0x846CA68B


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) without
    overflowing int64: split ``c`` into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xor-shift / multiply rounds) over
    int64 tensors holding values in [0, 2**32)."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, MUL1)
    x = x ^ (x >> 15)
    x = _mul32(x, MUL2)
    x = x ^ (x >> 16)
    return x


def position_uniforms(seeds: torch.Tensor, positions: torch.Tensor,
                      vocab: int) -> torch.Tensor:
    """(R,) seeds × (R,) absolute positions -> (R, V) fp32 uniforms in
    [MIN_UNIFORM, 1): lane j of row r is a hash of ``h(h(seed ^
    SEED_SALT) ^ position) ^ h(j + LANE_SALT)``."""
    dev = seeds.device
    s = seeds.long() & _M32
    p = positions.long() & _M32
    row = _hash32(_hash32(s ^ SEED_SALT) ^ p)                       # (R,)
    lane = _hash32(torch.arange(vocab, device=dev, dtype=torch.int64)
                   + LANE_SALT)                                     # (V,)
    bits = _hash32(row[:, None] ^ lane[None, :])
    # 23 bits, so (k + 0.5) / 2**23 is exact in fp32 and stays below 1
    u = ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))
    return torch.clamp(u, min=MIN_UNIFORM)
