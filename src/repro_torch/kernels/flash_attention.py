"""Flash attention forward: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention_fwd``
(the Pallas ``_flash_kernel``).  The kernel is hand-written CUDA C++ for
``sm_90a`` in ``csrc/flash_attention.cu``: two kernels behind one C
entry, both on the tensor cores (``mma.sync`` tiles fed by ``ldmatrix``
from a two-stage ``cp.async`` ring of K/V tiles, the softmax in
registers, one block per query tile and head).  bf16 runs m16n8k16 bf16
products (``"mma"``); fp32, the parity path, m16n8k8 TF32 products in
3xTF32 (``"tf32x3"``: each operand split into a TF32 big part and a
TF32 remainder, three products accumulated in fp32), which holds the
fp32 tier where TF32 alone would not.  The source note says what bounds
it on the H100 (operations) and which TPU-isms were dropped (lane
padding, the ``(block_q, 128)`` VMEM scratch, the sequential KV grid
that carries the softmax state).  :func:`kernel_attributes` reports each instantiation's
registers, spills, shared memory and blocks per SM.

:func:`flash_attention_fwd` launches the kernel for CUDA tensors and
raises when it cannot; it takes :func:`flash_attention_plain` only for
tensors on the CPU.  There is no ``try`` that falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import (HEAD_DIMS, Q_CODES, LaunchCounter, check_operands,
                     dense_aligned, launch_op, load_library)

counter = LaunchCounter("flash_attention")


def _lib() -> ctypes.CDLL:
    lib = load_library("repro_flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        attrs = lib.repro_flash_attention_attrs
        attrs.argtypes = [ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int)]
        attrs.restype = ctypes.c_int
    return lib


def kernel_attributes(dtype: torch.dtype, head_dim: int) -> dict:
    """The resources of the kernel that :func:`flash_attention_fwd`
    launches for ``dtype`` and ``head_dim`` on the current card: its
    variant (:func:`variant`), registers and local (spill) bytes a
    thread, dynamic shared bytes and threads a block, blocks an SM holds,
    keys a tile."""
    if dtype not in Q_CODES or head_dim not in HEAD_DIMS:
        raise ValueError(f"kernel_attributes: no kernel for {dtype}, "
                         f"head_dim {head_dim}")
    vals = (ctypes.c_int * 6)()
    err = _lib().repro_flash_attention_attrs(Q_CODES[dtype], head_dim, vals)
    if err != 0:
        raise RuntimeError(f"flash_attention attributes failed (code {err})")
    return {"variant": variant(dtype), "registers": vals[0],
            "spill_bytes": vals[1],
            "smem_bytes": vals[2], "blocks_per_sm": vals[3],
            "threads": vals[4], "key_tile": vals[5]}


def variant(dtype: torch.dtype) -> str:
    """The flash kernel a dtype runs: ``"mma"`` (bf16) or ``"tf32x3"``
    (fp32)."""
    return "mma" if dtype == torch.bfloat16 else "tf32x3"


def visible_mask(q_len: int, kv_len: int, causal: bool,
                 window: Optional[int], device) -> torch.Tensor:
    """(q_len, kv_len) bool: query i sits at position i + kv_len - q_len
    and sees key j when j <= its position (causal) and j > its position
    - window (sliding)."""
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    k_pos = torch.arange(kv_len, device=device)[None, :]
    ok = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window is not None:
        ok = ok & (k_pos > q_pos - window)
    return ok


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool, scale: float,
                          window: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in its layouts, as the reference oracle
    ``sdpa_ref`` computes it (``repro/models/attention.py:50-75``): q
    (B*Hq, Sq, D), k/v (B*Hkv, Skv, D), query head bh reading kv head
    bh // (Hq/Hkv); the queries are the last Sq positions.  fp32 logits
    masked to finfo(float32).min, fp32 softmax, probabilities cast to q's
    dtype before the PV product.  Differentiable (the backward of
    ``ops.flash_attention`` recomputes through it)."""
    bhq, sq, _ = q.shape
    bhkv, skv, _ = k.shape
    group = bhq // bhkv
    if group != 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    ok = visible_mask(sq, skv, causal, window, q.device)
    logits = torch.where(ok[None], logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bqk,bkd->bqd", probs, v.to(q.dtype))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, scale: float,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B*Hq, Sq, D); k/v: (B*Hkv, Skv, D), all of one dtype (fp32 or
    bf16); Hq a multiple of Hkv.  Returns (B*Hq, Sq, D) in q's dtype.

    Every query must see at least one key (Sq <= Skv when causal): a
    fully masked row gives zeros from the kernel and a uniform average
    from the plain version, as the Pallas kernel and the jnp oracle
    differ.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    on the current stream (through the ``repro_torch::flash_attention``
    operator), or raise; q, k or v not contiguous or not 16-byte aligned
    is copied first (``dense_aligned``).  ``meta`` tensors (the dry run)
    are checked as CUDA ones and get the output's shape and dtype from
    the operator's shape function; :func:`flash_cost` is its cost."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    bhq, sq, d = q.shape
    bhkv, skv, d_k = k.shape
    if d_k != d or v.shape != k.shape or bhkv == 0 or bhq % bhkv:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)} / {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {d} is not "
                         f"instantiated (have {HEAD_DIMS})")
    if q.dtype not in Q_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: q/k/v dtypes {q.dtype}/"
                        f"{k.dtype}/{v.dtype} unsupported (one of float32, "
                        f"bfloat16 for all three)")
    return _flash_launch(q, k, v, float(scale), bool(causal),
                         int(window) if window else 0)


@launch_op("flash_attention")
def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, causal: bool, window: int) -> torch.Tensor:
    """The launch, as one operator: a graph traced by
    ``repro_torch.compile`` keeps it as one node (its shape function
    below), which launches the kernel, counted, on every call."""
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    q, k, v = (dense_aligned(x) for x in (q, k, v))
    check_operands("flash_attention_fwd", q, (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _lib().repro_flash_attention
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(Q_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), bhq, bhkv, sq, skv, scale, int(causal), window,
             stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(code {err})")
    counter.bump()
    return out


@_flash_launch.register_fake
def _(q, k, v, scale, causal, window):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def visible_pairs(q_len: int, kv_len: int, causal: bool,
                  window: Optional[int]) -> int:
    """The (query, key) pairs :func:`visible_mask` lets through, counted
    without making the mask."""
    pos = torch.arange(kv_len - q_len, kv_len, dtype=torch.int64)
    hi = pos if causal else torch.full_like(pos, kv_len - 1)
    lo = (pos - window + 1).clamp(min=0) if window else torch.zeros_like(pos)
    return int((hi - lo + 1).clamp(min=0).sum())


@_flash_launch.register_cost
def flash_cost(q, k, v, scale, causal, window):
    """(FLOPs, bytes) of one launch: QK^T and PV, 2·D each for every
    visible (query, key) pair of every query head; q, k, v read and the
    output written once."""
    bhq, sq, d = q.shape
    pairs = visible_pairs(sq, k.shape[1], causal, window or None)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return 4 * bhq * pairs * d, nbytes
