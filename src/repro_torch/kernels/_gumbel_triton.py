"""Triton kernel of :func:`repro_torch.kernels.ops.gumbel_perturb`.

Imported only by the launching function, at its first call: this module
imports ``triton`` at the top, and machines without Triton (the CPU test
runs) never import it.
"""

import triton
import triton.language as tl

BLOCK = 4096


@triton.jit
def gumbel_perturb_kernel(x_ptr, u_ptr, o_ptr, n, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    u = tl.load(u_ptr + offs, mask=mask, other=0.5)
    tl.store(o_ptr + offs, x + -tl.log(-tl.log(u)), mask=mask)


def launch(x, u, out) -> None:
    n = x.numel()
    grid = (triton.cdiv(n, BLOCK),)
    gumbel_perturb_kernel[grid](x, u, out, n, BLOCK=BLOCK, num_warps=8)
