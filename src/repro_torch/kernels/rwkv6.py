"""WKV6 recurrence (RWKV-6 time mix): the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ``repro/kernels/rwkv6.py::rwkv6_scan_fwd`` (the Pallas
``_rwkv6_kernel``) and of the reference's lax.scan oracles
``_wkv6_ref`` / ``_wkv6_ref_with_state`` (``repro/models/layers.py``),
which both of the reference's call sites compute, in their (B, H, S, D)
layout.  The kernel is hand-written CUDA C++ for ``sm_90a`` in
``csrc/rwkv6.cu``.

Source note.  On the H100 the recurrence is bound by operations: 5 fp32
operations per state element per step (the bonus term is a per-step
scalar, ``v_j * sum_i r_i u_i k_i``) against 5 rows of D inputs and
outputs, and the state math is fp32 whatever the input type, so its
bound is set by the 67 TFLOP/s fp32 peak (0.040 ms for the rwkv6-1.6b
prefill row, B=4, H=32, S=1024, D=64).  The steps are serial and B*H is
about one (batch, head) per SM, so the kernel spreads each head's state
over a whole SM: one block per (batch, head), each thread holding 4
columns x D/16 rows of the state in registers, so that each row value
it loads serves four columns (a column group's 16 parts sit in adjacent
lanes, and a batch of steps' partial sums is reduced by one fixed
shuffle reduce-scatter); the steps' rows staged by ``cp.async`` a
32-step chunk ahead and converted to fp32 once in shared memory, laid
out so that a thread's 16-byte loads hit distinct banks; the states and
each chunk's outputs pass through shared memory as coalesced 16-byte
accesses.  A single step (S = 1, every decode step) is bound by the
state's bytes instead, so it takes another layout in the same kernel:
the state in its memory order straight from and to global memory, and
only the column sums cross threads.  What is left is the issue of each serial step: loads,
shuffles and loop take a third of its instructions, and two warps a
scheduler hide their latency only in part (the source note of
``csrc/rwkv6.cu`` has the reckoning).  TPU-isms of the Pallas kernel
that were dropped:

  * the 128-lane padding of D, with ``w`` padded with ones
    (``repro/kernels/ops.py:209-227``): the kernel is templated on D
    (32, 64, 128);
  * the sequential chunk grid that carries the state in VMEM scratch, and
    its tail guard: a block sweeps exactly S steps;
  * ``u`` broadcast to (B*H, D): the kernel indexes the (H, D) bonus by
    head;
  * the (B*H, S, D) relayout: the kernel reads r/k/v/w through their
    strides, so the layer's transposed views of its (B, S, H*D)
    projections are not copied, and it writes ``out`` into a (B, S, H, D)
    buffer, which the layer reads back as (B, S, H*D) without a copy;
  * no initial state: the kernel takes an optional ``state0``, so decode
    runs through it too (the reference's decode ran the jnp oracle).

:func:`rwkv6_scan_fwd` launches the kernel for CUDA tensors and raises
when it cannot; it takes :func:`rwkv6_scan_plain` only for tensors on
the CPU.  There is no ``try`` that falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import (Q_CODES, LaunchCounter, check_operands, dense_aligned,
                     launch_op, load_library)

HEAD_SIZES = (32, 64, 128)     # head sizes the kernel instantiates

counter = LaunchCounter("rwkv6_scan")


def _lib() -> ctypes.CDLL:
    lib = load_library("repro_rwkv6")
    if lib.repro_rwkv6_scan.argtypes is None:
        strides = [ctypes.c_longlong] * 3
        lib.repro_rwkv6_scan.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + strides
            + [ctypes.c_void_p] * 3 + strides + [ctypes.c_void_p]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.repro_rwkv6_attrs.argtypes = ([ctypes.c_int] * 2
                                          + [ctypes.POINTER(ctypes.c_int)])
        for fn in (lib.repro_rwkv6_scan, lib.repro_rwkv6_attrs):
            fn.restype = ctypes.c_int
    return lib


def rwkv6_kernel_attributes(dtype: torch.dtype, d: int) -> dict:
    """The resources of the kernel that :func:`rwkv6_scan_fwd` launches
    for this dtype and head size on the current card: registers and local
    (spill) bytes a thread, dynamic shared bytes a block (the kernel has
    no static shared memory), blocks an SM holds, threads a block, the
    steps a staged chunk holds, the state columns a thread holds and the
    parts a column group is spread over."""
    if dtype not in Q_CODES or d not in HEAD_SIZES:
        raise ValueError(f"rwkv6_kernel_attributes: no kernel for {dtype}, "
                         f"head size {d}")
    vals = (ctypes.c_int * 8)()
    err = _lib().repro_rwkv6_attrs(Q_CODES[dtype], d, vals)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan attributes failed (code {err})")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "blocks_per_sm", "threads", "chunk_steps", "cols",
                     "parts"), vals))


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     state0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference oracles' step loop: r/k/v/w (B, H, S, D), u (H, D)
    fp32, state0 (B, H, D, D) fp32 or None (zeros).  Everything in fp32;
    returns (out (B, H, S, D) in r's dtype, final state (B, H, D, D)
    fp32).  Differentiable in r, k, v, w and u (the backward of
    ``ops.rwkv6_scan`` recomputes through it)."""
    b, h, s, d = r.shape
    uu = u.float()[None, :, :, None]                        # (1, H, D, 1)
    state = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float())
    r32, k32, v32, w32 = (x.float() for x in (r, k, v, w))
    outs = []
    for t in range(s):
        kv = k32[:, :, t, :, None] * v32[:, :, t, None, :]  # (B, H, Dk, Dv)
        outs.append(torch.einsum("bhd,bhde->bhe", r32[:, :, t],
                                 state + uu * kv))
        state = w32[:, :, t, :, None] * state + kv
    out = (torch.stack(outs, dim=2) if outs
           else torch.zeros_like(r32))
    return out.to(r.dtype), state


def _aligned(x: torch.Tensor) -> bool:
    """The base pointer and the (b, h, t) strides of a (B, H, S, D) view
    with a unit last stride are multiples of 16 bytes: the kernel copies
    rows in 16-byte pieces."""
    return x.data_ptr() % 16 == 0 and all(
        st * x.element_size() % 16 == 0 for st in x.stride()[:3])


def rwkv6_scan_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   state0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B, H, S, D), one dtype (fp32 or bf16), any strides; u:
    (H, D) fp32, contiguous; state0: (B, H, D, D) fp32, contiguous, or
    None (zero initial state).
    Returns (out (B, H, S, D) in r's dtype, final state (B, H, D, D)
    fp32, a new tensor).  On CUDA ``out`` is a transposed view of a
    contiguous (B, S, H, D) tensor.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    on the current stream, or raise.  The kernel reads r/k/v/w through
    one set of strides with a unit last stride and 16-byte aligned rows;
    inputs that do not share such strides, or are not so aligned, are
    copied into new contiguous tensors first (a copy, never the plain
    version).  ``meta`` tensors (the dry run) are checked as CUDA ones
    and get the outputs' shapes and dtypes from the operator's shape
    function; :func:`rwkv6_cost` is its cost."""
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, state0)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"rwkv6_scan_fwd: unsupported device {r.device}")
    if any(x.device != r.device for x in (k, v, w)):
        raise ValueError("rwkv6_scan_fwd: all operands must be on one "
                         "device")
    if r.ndim != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"rwkv6_scan_fwd: r/k/v/w must share one (B, H, "
                         f"S, D) shape, got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}")
    b, h, s, d = r.shape
    if d not in HEAD_SIZES:
        raise ValueError(f"rwkv6_scan_fwd: head size {d} is not "
                         f"instantiated (have {HEAD_SIZES})")
    if r.dtype not in Q_CODES or any(x.dtype != r.dtype for x in (k, v, w)):
        raise TypeError(f"rwkv6_scan_fwd: r/k/v/w dtypes {r.dtype}/"
                        f"{k.dtype}/{v.dtype}/{w.dtype} unsupported (one of "
                        f"float32, bfloat16 for all four)")
    if u.dtype != torch.float32 or tuple(u.shape) != (h, d):
        raise ValueError(f"rwkv6_scan_fwd: u must be ({h}, {d}) float32, "
                         f"got {tuple(u.shape)} {u.dtype}")
    tensors = [u]
    if state0 is not None:
        if state0.dtype != torch.float32 or \
                tuple(state0.shape) != (b, h, d, d):
            raise ValueError(f"rwkv6_scan_fwd: state0 must be ({b}, {h}, "
                             f"{d}, {d}) float32, got {tuple(state0.shape)} "
                             f"{state0.dtype}")
        tensors.append(state0)
    for x in tensors:
        if x.device != r.device:
            raise ValueError("rwkv6_scan_fwd: all operands must be on one "
                             "device")
    out, state = _rwkv6_launch(r, k, v, w, u, state0)
    return out.transpose(1, 2), state


@launch_op("rwkv6_scan")
def _rwkv6_launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  state0: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch of :func:`rwkv6_scan_fwd` as one operator (its shape
    function below): ``out`` is returned as the contiguous (B, S, H, D)
    tensor the kernel writes, which the wrapper views as (B, H, S, D)."""
    b, h, s, d = r.shape
    if r.stride(-1) != 1 or any(x.stride() != r.stride() for x in (k, v, w)) \
            or not all(_aligned(x) for x in (r, k, v, w)):
        r, k, v, w = (dense_aligned(x) for x in (r, k, v, w))
    tensors = [u] if state0 is None else [u, state0]
    check_operands("rwkv6_scan_fwd", r, tensors)
    if state0 is not None:
        state0 = dense_aligned(state0)
    buf = torch.empty((b, s, h, d), dtype=r.dtype, device=r.device)
    out = buf.transpose(1, 2)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return buf, state
    lib = _lib()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.repro_rwkv6_scan(
        Q_CODES[r.dtype], d, r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), *r.stride()[:3], u.data_ptr(),
        None if state0 is None else state0.data_ptr(), out.data_ptr(),
        *out.stride()[:3], state.data_ptr(), b, h, s, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed (code {err})")
    counter.bump()
    return buf, state


@_rwkv6_launch.register_fake
def _(r, k, v, w, u, state0):
    b, h, s, d = r.shape
    return (torch.empty((b, s, h, d), dtype=r.dtype, device=r.device),
            torch.empty((b, h, d, d), dtype=torch.float32, device=r.device))


@_rwkv6_launch.register_cost
def rwkv6_cost(r, k, v, w, u, state0):
    """(FLOPs, bytes) of one launch: the product of r with each step's
    (D, D) state, 2·D² for every head and step (the state updates are
    elementwise and count 0); r, k, v, w, u (and state0) read, the output
    and the final state written once."""
    b, h, s, d = r.shape
    nbytes = (5 * b * h * s * d * r.element_size() + h * d * 4
              + (1 if state0 is None else 2) * b * h * d * d * 4)
    return 2 * b * h * s * d * d, nbytes
