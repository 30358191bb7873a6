"""Paged attention over the physical KV page pool: the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of ``repro/kernels/decode_attention.py::paged_attention_fwd``
(the Pallas ``_paged_kernel``).  The kernel is hand-written CUDA C++ for
``sm_90a`` in ``csrc/paged_attention.cu``; its source note says what
bounds it on the H100 (bytes) and which TPU-isms were dropped (lane
padding, the ``d % 128`` rule, the ``(g, 128)`` VMEM scratch,
``pages_per_tile``, buffer donation).

:func:`paged_attention_fwd` launches the kernel for CUDA tensors and
raises when it cannot; it takes :func:`paged_attention_plain` only for
tensors on the CPU.  There is no ``try`` that falls back.

The contiguous-cache kernels of the reference module
(``decode_attention_fwd``, ``mixed_attention_fwd``) are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import LaunchCounter, load_library

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_SMEM = 232448          # bytes of shared memory one block may use

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}

counter = LaunchCounter("paged_attention")


def _lib() -> ctypes.CDLL:
    lib = load_library("repro_paged_attention", ["paged_attention.cu"])
    fn = lib.repro_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (or load the cached build of) the kernel library."""
    _lib()


def smem_bytes(g: int, d: int, ps: int) -> int:
    return 4 * (2 * ps * d + 2 * g * d + g * ps + 3 * g)


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, tables: torch.Tensor,
                          seg_ids: torch.Tensor, positions: torch.Tensor, *,
                          scale: float, window: Optional[int] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Gather-then-attend version of the kernel, same arguments and
    layouts: q (T, Hkv, G, D); pages (N, ps, Hkv, D); scales (N, ps, Hkv)
    fp32 or None; tables (S, P); seg_ids/positions (T,).  Returns
    (T, Hkv, G, D) in q's dtype.  Mirrors the reference oracle
    (``repro.models.attention.paged_attention`` with the ref backend):
    dequantize to q's dtype, gather each token's slot row, fp32 logits
    masked to finfo(float32).min, fp32 softmax, probabilities cast to
    q's dtype before the PV product."""
    t, hkv, g, d = q.shape
    n, ps = k_pages.shape[0], k_pages.shape[1]
    s, p = tables.shape
    if k_scale is not None:
        k_pages = (k_pages.float() * k_scale[..., None]).to(q.dtype)
        v_pages = (v_pages.float() * v_scale[..., None]).to(q.dtype)
    slot = seg_ids.long().clamp(0, s - 1)
    gidx = (tables.long()[:, :, None] * ps
            + torch.arange(ps, device=q.device)).reshape(s, p * ps)
    rows = gidx[slot]                                       # (T, L)
    k = k_pages.reshape(n * ps, hkv, d)[rows]               # (T, L, Hkv, D)
    v = v_pages.reshape(n * ps, hkv, d)[rows]
    logits = torch.einsum("thgd,tlhd->thgl", q.float(), k.float()) * scale
    k_pos = torch.arange(p * ps, device=q.device)[None, :]
    pos = positions.long()[:, None]
    valid = k_pos <= pos
    if window is not None:
        valid = valid & (k_pos > pos - window)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("thgl,tlhd->thgd", probs, v.to(q.dtype))


def paged_attention_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, tables: torch.Tensor,
                        seg_ids: torch.Tensor, positions: torch.Tensor, *,
                        scale: float, window: Optional[int] = None,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q: (T, Hkv, G, D) per-token query heads grouped by KV head;
    k_pages/v_pages: (N, ps, Hkv, D) the physical pool; tables (S, P)
    int32; seg_ids/positions (T,) int32; k_scale/v_scale (N, ps, Hkv)
    fp32 for an int8/fp8 pool.  Returns (T, Hkv, G, D) in q's dtype.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    on the current stream, or raise."""
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, tables, seg_ids, positions, scale=scale,
            window=window, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_fwd: unsupported device "
                         f"{q.device}")
    t, hkv, g, d = q.shape
    n, ps, hkv_p, d_p = k_pages.shape
    s, p = tables.shape
    if (hkv_p, d_p) != (hkv, d) or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention_fwd: q {tuple(q.shape)} does "
                         f"not match pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention_fwd: head_dim {d} is not "
                         f"instantiated (have {HEAD_DIMS})")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"paged_attention_fwd: q dtype {q.dtype} "
                        f"unsupported")
    if k_pages.dtype not in _KV_CODES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_attention_fwd: pool dtype {k_pages.dtype}"
                        f"/{v_pages.dtype} unsupported")
    quantized = k_pages.dtype in (torch.int8, torch.float8_e4m3fn)
    if quantized != (k_scale is not None) or \
            (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention_fwd: scales are required for "
                         "an int8/fp8 pool and only for one")
    if not quantized and k_pages.dtype != q.dtype:
        raise TypeError("paged_attention_fwd: an unquantized pool must "
                        "have q's dtype")
    if smem_bytes(g, d, ps) > MAX_SMEM:
        raise ValueError(f"paged_attention_fwd: page_size {ps} x head_dim "
                         f"{d} needs more shared memory than a block has")
    tensors = [q, k_pages, v_pages, tables, seg_ids, positions]
    if quantized:
        tensors += [k_scale, v_scale]
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or tuple(sc.shape) != (n, ps, hkv):
                raise ValueError("paged_attention_fwd: scales must be "
                                 "(N, ps, Hkv) float32")
    for x in tensors:
        if x.device != q.device:
            raise ValueError("paged_attention_fwd: all operands must be "
                             "on one device")
        if not x.is_contiguous():
            raise ValueError("paged_attention_fwd: operands must be "
                             "contiguous")
    for x in (tables, seg_ids, positions):
        if x.dtype != torch.int32:
            raise TypeError("paged_attention_fwd: tables, seg_ids and "
                            "positions must be int32")
    if seg_ids.shape != (t,) or positions.shape != (t,):
        raise ValueError("paged_attention_fwd: seg_ids/positions must "
                         "be (T,)")
    out = torch.empty_like(q)
    if t == 0:
        return out
    fn = _lib().repro_paged_attention
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_Q_CODES[q.dtype], _KV_CODES[k_pages.dtype], d,
             q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_scale.data_ptr() if quantized else None,
             v_scale.data_ptr() if quantized else None,
             tables.data_ptr(), seg_ids.data_ptr(), positions.data_ptr(),
             out.data_ptr(), t, hkv, g, ps, s, p, float(scale),
             int(window) if window else 0, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed "
                           f"(code {err})")
    counter.bump()
    return out
