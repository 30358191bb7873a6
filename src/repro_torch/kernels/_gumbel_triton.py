"""Triton kernels of :func:`repro_torch.kernels.ops.gumbel_perturb` and
:func:`repro_torch.kernels.ops.gumbel_perturb_keyed`.

Imported only by the launching functions, at their first call: this
module imports ``triton`` at the top, and machines without Triton (the
CPU test runs) never import it.
"""

import triton
import triton.language as tl

from . import _noise

BLOCK = 4096
# the keyed kernel's tile: rows x lanes
ROWS, LANES = 4, 1024

# the hash's constants as constexprs (a Triton kernel reads no other
# globals); each is cast to uint32 where it is used, since Triton may type
# a literal of 2**31 or more as int64
SEED_SALT = tl.constexpr(_noise.SEED_SALT)
LANE_SALT = tl.constexpr(_noise.LANE_SALT)
MUL1 = tl.constexpr(_noise.MUL1)
MUL2 = tl.constexpr(_noise.MUL2)
MIN_UNIFORM = tl.constexpr(_noise.MIN_UNIFORM)


@triton.jit
def gumbel_perturb_kernel(x_ptr, u_ptr, o_ptr, n, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    u = tl.load(u_ptr + offs, mask=mask, other=0.5)
    tl.store(o_ptr + offs, x + -tl.log(-tl.log(u)), mask=mask)


@triton.jit
def _hash32(x):
    """``_noise._hash32`` on uint32 values: shifts are logical and the
    products wrap mod 2**32."""
    x = x ^ (x >> 16)
    x = x * tl.cast(MUL1, tl.uint32)
    x = x ^ (x >> 15)
    x = x * tl.cast(MUL2, tl.uint32)
    x = x ^ (x >> 16)
    return x


# R is not specialized: a serving step's row count varies (1 to S * (K +
# 1)), and a specialization of R == 1 or R % 16 == 0 would compile the
# kernel again inside a serving run
@triton.jit(do_not_specialize=["R"])
def gumbel_keyed_kernel(x_ptr, seed_ptr, pos_ptr, o_ptr, R, V,
                        ROWS: tl.constexpr, LANES: tl.constexpr):
    lanes = tl.program_id(0) * LANES + tl.arange(0, LANES)
    rows = tl.program_id(1) * ROWS + tl.arange(0, ROWS)
    lane_ok = lanes < V
    row_ok = rows < R
    # each row's hash once, each lane's once for all the tile's rows
    s = tl.load(seed_ptr + rows, mask=row_ok, other=0)
    p = tl.load(pos_ptr + rows, mask=row_ok, other=0)
    s = (s & 0xFFFFFFFF).to(tl.uint32)
    p = (p & 0xFFFFFFFF).to(tl.uint32)
    row = _hash32(_hash32(s ^ tl.cast(SEED_SALT, tl.uint32)) ^ p)
    lane = _hash32(lanes.to(tl.uint32) + tl.cast(LANE_SALT, tl.uint32))
    bits = _hash32(row[:, None] ^ lane[None, :])
    # 23 bits: (k + 0.5) * 2**-23 is exact in fp32, as in _noise
    u = ((bits >> 9).to(tl.float32) + 0.5) * (1.0 / 8388608.0)
    u = tl.maximum(u, MIN_UNIFORM)
    offs = rows[:, None].to(tl.int64) * V + lanes[None, :]
    mask = row_ok[:, None] & lane_ok[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    tl.store(o_ptr + offs, x + -tl.log(-tl.log(u)), mask=mask)


def launch(x, u, out) -> None:
    n = x.numel()
    grid = (triton.cdiv(n, BLOCK),)
    gumbel_perturb_kernel[grid](x, u, out, n, BLOCK=BLOCK, num_warps=8)


def launch_keyed(x, seeds, positions, out) -> None:
    r, v = x.shape
    grid = (triton.cdiv(v, LANES), triton.cdiv(r, ROWS))
    gumbel_keyed_kernel[grid](x, seeds, positions, out, r, v, ROWS=ROWS,
                              LANES=LANES, num_warps=8)
