"""Mamba selective scan: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of ``repro/kernels/mamba.py::mamba_scan_fwd`` (the Pallas
``_mamba_kernel``) and of the reference's step loop ``_ssm_scan_ref``
(``repro/models/layers.py``, re-exported as ``repro/kernels/ref.py::
mamba_scan``), with an optional initial state and the final state
returned.  The kernel is hand-written CUDA C++ for ``sm_90a`` in
``csrc/mamba.cu``.

Source note.  On the H100 the scan's bytes (x and dt in, y out: 0.120 ms
at the jamba-1.5-large prefill row, B=4, S=1024, Di=16384, N=16, bf16)
and its 7 fp32 operations a state element a step (0.112 ms) are not what
sets its pace, nor quite its one exponential a state element a step
(0.26 ms on the SFUs): the issue of each step's instructions is.  So the
kernel spends as few instructions as it can on each state element: one
thread a channel holds its N states and A row in registers (no shuffles;
each B and C value loaded once for N states), the exponential of bf16
rows is ``ex2.approx`` of ``dt * A * log2 e`` (one FMUL, one MUFU; fp32
rows keep an exact ``expf``), and a chunk of steps' x, dt, B and C is
staged by ``cp.async`` into shared memory a chunk ahead and converted
once to fp32; y leaves through a shared tile as 16-byte stores.  A
single step (S = 1, every decode step) takes its own path in the same
kernel: operands straight from global memory, no barrier.  TPU-isms of
the Pallas kernel that were dropped:

  * the transposed (N, Di_blk) state, N on sublanes and channels on the
    128 lanes, with ``block_di=512``: a thread owns a channel;
  * the sequential chunk grid (``chunk=64``) carrying the state in VMEM
    scratch, which also had no tail guard (ROADMAP.md B6): one block
    sweeps exactly S steps and never touches t >= S;
  * ``A.T`` and ``D`` relaid out by the wrapper: the kernel reads the
    (Di, N) and (Di,) fp32 arrays as they are;
  * no initial or final state: the kernel takes ``h0`` and returns the
    final state, so decode runs through it too (the reference's decode
    ran a jnp recurrence, ``layers.py:517-524``).

B and C are read through their strides, so the layer's column slices of
its (B, S, R + 2N) projection are not copied.  For S > 1 the kernel
copies rows in 16-byte pieces: an operand whose base pointer or rows are
not 16-byte aligned, or whose rows (x, dt) are not whole pieces, is
copied first (into rows padded to whole pieces), as the WKV6 wrapper
does.

:func:`mamba_scan_fwd` launches the kernel for CUDA tensors and raises
when it cannot; it takes :func:`mamba_scan_plain` only for tensors on the
CPU.  There is no ``try`` that falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import (Q_CODES, LaunchCounter, check_operands, dense_aligned,
                     launch_op, load_library)

STATE_SIZES = (8, 16)     # d_state values the kernel instantiates
# the exponential each dtype's kernel evaluates (csrc/mamba.cu)
EXP = {torch.bfloat16: "ex2.approx.ftz", torch.float32: "expf"}

counter = LaunchCounter("mamba_scan")


def _lib() -> ctypes.CDLL:
    lib = load_library("repro_mamba")
    fn = lib.repro_mamba_scan
    if fn.argtypes is None:
        strides = [ctypes.c_longlong] * 2
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + strides
                       + [ctypes.c_void_p] + strides + [ctypes.c_void_p]
                       + strides + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_mamba_attrs.argtypes = ([ctypes.c_int] * 2
                                          + [ctypes.POINTER(ctypes.c_int)])
        lib.repro_mamba_attrs.restype = ctypes.c_int
    return lib


ATTRIBUTES = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm",
              "threads", "chunk_steps", "sms")


def mamba_kernel_attributes(dtype: torch.dtype, n: int) -> dict:
    """The resources of the kernel that :func:`mamba_scan_fwd` launches
    for this dtype and state size on the current card: registers and
    local (spill) bytes a thread, dynamic shared bytes a block (the
    kernel has no static shared memory), blocks an SM holds, threads (one
    a channel) a block, the steps a staged chunk holds, and the card's
    SMs."""
    if dtype not in Q_CODES or n not in STATE_SIZES:
        raise ValueError(f"mamba_kernel_attributes: no kernel for {dtype}, "
                         f"state size {n}")
    vals = (ctypes.c_int * len(ATTRIBUTES))()
    err = _lib().repro_mamba_attrs(Q_CODES[dtype], n, vals)
    if err != 0:
        raise RuntimeError(f"mamba_scan attributes failed (code {err})")
    return dict(zip(ATTRIBUTES, vals))


def waves(attrs: dict, b: int, di: int) -> float:
    """The waves of blocks a (B, *, Di) call runs in: its grid of
    ceil(Di / threads) x B blocks over what the card holds at once."""
    blocks = -(-di // attrs["threads"]) * b
    return blocks / (attrs["blocks_per_sm"] * attrs["sms"])


def mamba_scan_plain(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                     C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                     h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's step loop in fp32: x/dt (B, S, Di), B/C (B, S, N),
    A (Di, N), D (Di,), h0 (B, Di, N) or None (zeros).  Returns (y (B, S,
    Di) in x's dtype, rounded once from ``sum_n h C + D x`` in fp32 as the
    Pallas kernel rounds it; final state (B, Di, N) fp32).

    It loops over the steps and never holds the reference's (B, S, Di, N)
    ``dA`` and ``dBx``, only one step's (B, Di, N).  Differentiable in
    every input but ``h0`` (the backward of ``ops.mamba_scan`` recomputes
    through it)."""
    b, s, di = x.shape
    a = A.float()
    h = (torch.zeros((b, di, a.shape[-1]), dtype=torch.float32,
                     device=x.device)
         if h0 is None else h0.to(torch.float32, copy=True))
    x32, dt32, b32, c32 = (t.float() for t in (x, dt, B, C))
    dx = dt32 * x32
    ys = []
    for t in range(s):
        h = (torch.exp(dt32[:, t, :, None] * a) * h
             + dx[:, t, :, None] * b32[:, t, None, :])
        ys.append(torch.einsum("bdn,bn->bd", h, c32[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(x32)
    return (y + D.float() * x32).to(x.dtype), h


def _aligned(t: torch.Tensor, row: int) -> bool:
    """A (B, S, *) operand with a unit last stride whose base pointer and
    (b, t) strides are multiples of 16 bytes, and whose rows of ``row``
    elements are whole 16-byte pieces: the kernel stages it in 16-byte
    pieces."""
    item = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and row * item % 16 == 0
            and all(st * item % 16 == 0 for st in t.stride()[:2]))


def _padded(t: torch.Tensor) -> torch.Tensor:
    """A (B, S, Di) operand copied into new (B, S, Di') memory whose rows
    are padded with zeros to whole 16-byte pieces; returned as the (B, S,
    Di) view of it."""
    b, s, di = t.shape
    piece = 16 // t.element_size()
    out = t.new_zeros((b, s, -(-di // piece) * piece))[..., :di]
    out.copy_(t)
    return out


def mamba_scan_fwd(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/dt: (B, S, Di), B/C: (B, S, N), one dtype (fp32 or bf16), any
    strides; A: (Di, N) and D: (Di,) fp32, contiguous; h0: (B, Di, N)
    fp32, contiguous, or None (zero initial state).
    Returns (y (B, S, Di) in x's dtype, contiguous; final state (B, Di,
    N) fp32, a new tensor).

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    on the current stream, or raise.  The kernel reads x and dt through
    one set of strides and B and C through their own, each with a unit
    last stride; operands without one are made contiguous first.
    ``meta`` tensors (the dry run) are checked as CUDA ones and get the
    outputs' shapes and dtypes from the operator's shape function;
    :func:`mamba_cost` is its cost."""
    if x.device.type == "cpu":
        return mamba_scan_plain(x, dt, B, C, A, D, h0)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"mamba_scan_fwd: unsupported device {x.device}")
    if any(t.device != x.device for t in (dt, B, C)):
        raise ValueError("mamba_scan_fwd: all operands must be on one "
                         "device")
    if x.ndim != 3 or dt.shape != x.shape or B.ndim != 3 or \
            C.shape != B.shape or B.shape[:2] != x.shape[:2]:
        raise ValueError(f"mamba_scan_fwd: x/dt must be (B, S, Di) and "
                         f"B/C (B, S, N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, s, di = x.shape
    n = B.shape[-1]
    if n not in STATE_SIZES:
        raise ValueError(f"mamba_scan_fwd: state size {n} is not "
                         f"instantiated (have {STATE_SIZES})")
    if x.dtype not in Q_CODES or any(t.dtype != x.dtype
                                     for t in (dt, B, C)):
        raise TypeError(f"mamba_scan_fwd: x/dt/B/C dtypes {x.dtype}/"
                        f"{dt.dtype}/{B.dtype}/{C.dtype} unsupported (one "
                        f"of float32, bfloat16 for all four)")
    if A.dtype != torch.float32 or tuple(A.shape) != (di, n) or \
            D.dtype != torch.float32 or tuple(D.shape) != (di,):
        raise ValueError(f"mamba_scan_fwd: A must be ({di}, {n}) and D "
                         f"({di},) float32, got {tuple(A.shape)} {A.dtype}"
                         f", {tuple(D.shape)} {D.dtype}")
    tensors = [A, D]
    if h0 is not None:
        if h0.dtype != torch.float32 or tuple(h0.shape) != (b, di, n):
            raise ValueError(f"mamba_scan_fwd: h0 must be ({b}, {di}, {n})"
                             f" float32, got {tuple(h0.shape)} {h0.dtype}")
        tensors.append(h0)
    for t in tensors:
        if t.device != x.device:
            raise ValueError("mamba_scan_fwd: all operands must be on one "
                             "device")
    return _mamba_launch(x, dt, B, C, A, D, h0)


@launch_op("mamba_scan")
def _mamba_launch(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                  h0: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch of :func:`mamba_scan_fwd` as one operator (its shape
    function below)."""
    b, s, di = x.shape
    n = B.shape[-1]
    if x.stride(-1) != 1 or dt.stride() != x.stride() or (
            s > 1 and not (_aligned(x, di) and _aligned(dt, di))):
        x, dt = _padded(x), _padded(dt)
    if s > 1:
        B, C = (t if _aligned(t, n) else dense_aligned(t) for t in (B, C))
    else:
        B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (B, C))
    check_operands("mamba_scan_fwd", x, [A, D] if h0 is None else [A, D, h0])
    A = dense_aligned(A)
    if h0 is not None:
        h0 = dense_aligned(h0)
    y = torch.empty((b, s, di), dtype=x.dtype, device=x.device)
    h = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    if b * di == 0:
        return y, h
    fn = _lib().repro_mamba_scan
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(Q_CODES[x.dtype], n, x.data_ptr(), dt.data_ptr(),
             *x.stride()[:2], B.data_ptr(), *B.stride()[:2], C.data_ptr(),
             *C.stride()[:2], A.data_ptr(), D.data_ptr(),
             None if h0 is None else h0.data_ptr(), y.data_ptr(),
             h.data_ptr(), b, s, di, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed (code {err})")
    counter.bump()
    return y, h


@_mamba_launch.register_fake
def _(x, dt, B, C, A, D, h0):
    b, _, di = x.shape
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty((b, di, B.shape[-1]), dtype=torch.float32,
                        device=x.device))


@_mamba_launch.register_cost
def mamba_cost(x, dt, B, C, A, D, h0):
    """(FLOPs, bytes) of one launch: the product of each step's states
    with C, 2·N for every channel and step (the state updates are
    elementwise and count 0); x, dt, B, C, A, D (and h0) read, y and the
    final state written once."""
    b, s, di = x.shape
    n = B.shape[-1]
    nbytes = ((3 * b * s * di + 2 * b * s * n) * x.element_size()
              + (di * n + di) * 4 + (1 if h0 is None else 2) * b * di * n * 4)
    return 2 * b * s * di * n, nbytes
