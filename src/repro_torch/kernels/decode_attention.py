"""Decode-time attention kernels: their wrappers and plain PyTorch
versions.

Counterpart of ``repro/kernels/decode_attention.py``:

  * :func:`paged_attention_fwd` (the Pallas ``_paged_kernel``): a flat
    mixed prefill/decode batch against the physical KV page pool, CUDA C++
    in ``csrc/paged_attention.cu``: a pre-pass builds the work list of
    query tiles and their key splits, the main kernel runs them, a combine
    merges the splits; the main kernel runs bf16 queries on the tensor
    cores (variant ``"mma"``) and fp32 queries on the CUDA cores
    (``"simt"``);
  * :func:`decode_attention_fwd` (the Pallas ``_decode_kernel``): one
    query per row against a contiguous ``(B, Hkv, Smax, D)`` cache, CUDA
    C++ in ``csrc/decode_attention.cu``: split-KV over each row's live
    keys and a combine that merges the splits, bf16 on the tensor cores
    (variant ``"mma"``), fp32 on the CUDA cores (``"simt"``);
  * :func:`mixed_attention_fwd` (the Pallas ``_mixed_kernel``): a flat
    mixed prefill/decode batch against per-slot contiguous caches
    ``(S, Hkv, L, D)`` chosen by segment ids (the gathered-cache path:
    ``PagedKVCache.gather`` then attention), CUDA C++ in
    ``csrc/mixed_attention.cu``: the paged kernel's pre-pass, query tiles
    and key splits over contiguous caches, and a combine; the main kernel
    runs bf16 q over bf16 caches on the bf16 tensor cores (variant
    ``"mma"``) and the fp32-cache pairs on the tensor cores in 3xTF32
    (``"tf32x3"``).

The kernels are hand-written for ``sm_90a``; each source note says what
bounds it on the H100 (bytes) and which TPU-isms were dropped (lane
padding, the ``d % 128`` rule, the ``(g, 128)`` VMEM scratch, the
sequential KV grid, scalar prefetch, ``pages_per_tile``, buffer
donation).

Each wrapper launches its kernel for CUDA tensors and raises when it
cannot; it takes the plain version only for tensors on the CPU.  There
is no ``try`` that falls back.  A query (and, but for the paged pools, a
cache) that is not contiguous or not 16-byte aligned is copied first
(``dense_aligned``); the paged pools are single-owner and are never
copied, so they must come dense and aligned.  The paged plain version
gathers the pool into per-slot caches and reduces to
:func:`mixed_attention_plain`, as the reference's
``_paged_attention_ref`` reduces to ``mixed_attention``: the two plain
versions are one oracle.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import (HEAD_DIMS, Q_CODES, LaunchCounter, check_operands,
                     dense_aligned, launch_op, load_library)

NEG_INF = -1e30

# the columns of a tile descriptor of the paged kernel's work list, as its
# pre-pass writes them
TILE_FIELDS = ("first", "count", "slot", "lo", "hi", "splits", "min_pos",
               "max_pos")

_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}

counter = LaunchCounter("paged_attention")
# what the last paged call launched, as its C entry reports it
_launched = (ctypes.c_int * 4)()
decode_counter = LaunchCounter("decode_attention")
# what the last decode call launched, as its C entry reports it
_decode_launched = (ctypes.c_int * 3)()
mixed_counter = LaunchCounter("mixed_attention")
# what the last mixed call launched, as its C entry reports it
_mixed_launched = (ctypes.c_int * 4)()


def _lib() -> ctypes.CDLL:
    lib = load_library("repro_paged_attention")
    fn = lib.repro_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 11
                       + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_int),
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        tiling_fn = lib.repro_paged_tiling
        tiling_fn.argtypes = ([ctypes.c_int] * 3
                              + [ctypes.POINTER(ctypes.c_int)])
        tiling_fn.restype = None
        ws = lib.repro_paged_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 6
        ws.restype = ctypes.c_longlong
        tiles = lib.repro_paged_tiles
        tiles.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                          + [ctypes.c_void_p])
        tiles.restype = ctypes.c_int
        attrs = lib.repro_paged_attention_attrs
        attrs.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        attrs.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def tiling(g: int, p_pages: int, ps: int) -> dict:
    """The paged kernel's work list for G query heads a KV head against a
    table of ``p_pages`` pages of ``ps``, as its source fixes it: the
    tokens a tile holds at most (64 rows / G), the keys a split holds, and
    the most splits a tile can have."""
    vals = (ctypes.c_int * 3)()
    _lib().repro_paged_tiling(g, p_pages, ps, vals)
    return {"tile_tokens": vals[0], "split_keys": vals[1],
            "max_splits": vals[2]}


@functools.lru_cache(maxsize=256)
def _workspace_bytes(t, hkv, g, d, p_pages, ps) -> int:
    return int(_lib().repro_paged_workspace_bytes(t, hkv, g, d, p_pages,
                                                  ps))


def last_launch() -> dict:
    """What the last CUDA call of :func:`paged_attention_fwd` launched, as
    its C entry reports it: device launches, and the thread blocks of the
    pre-pass, the main kernel and the combine (0 when it was not
    launched)."""
    return dict(zip(("device_launches", "prepass_blocks", "main_blocks",
                     "combine_blocks"), _launched))


def paged_tiles_plain(seg_ids: torch.Tensor, positions: torch.Tensor,
                      tables_shape, ps: int, tile_tokens: int,
                      split_keys: int, window: Optional[int] = None
                      ) -> torch.Tensor:
    """The paged kernel's work list, as its pre-pass builds it: (n_tiles,
    8) int32, one row per query tile with the columns of
    :data:`TILE_FIELDS`.  A tile is a maximal run of consecutive tokens
    with the same clipped slot ``clip(seg, 0, S-1)``, cut every
    ``tile_tokens`` tokens; its key range is [lo, hi) with lo = max(0,
    min_pos - window + 1) (0 without a window) and hi = min(max_pos + 1,
    P * ps) (never below lo); splits = max(1, ceil((hi - lo) /
    split_keys))."""
    s, p = tables_shape
    slots = seg_ids.long().clamp(0, s - 1).tolist()
    pos = positions.tolist()
    rows, i, t = [], 0, len(slots)
    while i < t:
        n = 1
        while n < tile_tokens and i + n < t and slots[i + n] == slots[i]:
            n += 1
        lo_pos, hi_pos = min(pos[i:i + n]), max(pos[i:i + n])
        lo = max(0, lo_pos - window + 1) if window else 0
        hi = max(lo, min(hi_pos + 1, p * ps))
        splits = max(1, -(-(hi - lo) // split_keys))
        rows.append([i, n, slots[i], lo, hi, splits, lo_pos, hi_pos])
        i += n
    return torch.tensor(rows, dtype=torch.int32).reshape(-1,
                                                          len(TILE_FIELDS))


def paged_tiles(seg_ids: torch.Tensor, positions: torch.Tensor,
                tables_shape, ps: int, g: int,
                window: Optional[int] = None) -> torch.Tensor:
    """The paged kernel's work list for G query heads a KV head, built by
    its pre-pass on the card: :func:`paged_tiles_plain` at
    :func:`tiling`'s tile tokens and split keys.  It reads the tile count
    back, so it syncs: a check, not part of the kernel's call.  CUDA
    tensors only."""
    t = seg_ids.shape[0]
    s, p = tables_shape
    ws = torch.empty(_workspace_bytes(t, 0, g, 0, p, ps) // 4,
                     dtype=torch.int32, device=seg_ids.device)
    if t == 0:
        return ws[:0].reshape(0, len(TILE_FIELDS))
    err = _lib().repro_paged_tiles(
        seg_ids.data_ptr(), positions.data_ptr(), ws.data_ptr(), t, s, p,
        ps, g, int(window) if window else 0,
        torch.cuda.current_stream(seg_ids.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention pre-pass launch failed "
                           f"(code {err})")
    n = int(ws[0].item())
    return ws[2:2 + n * len(TILE_FIELDS)].reshape(n, len(TILE_FIELDS))


def variant(q_dtype: torch.dtype) -> str:
    """The main kernel a q dtype runs: ``"mma"`` (bf16, tensor cores) or
    ``"simt"`` (fp32, CUDA cores); both over the same work list."""
    return "mma" if q_dtype == torch.bfloat16 else "simt"


def kernel_attributes(q_dtype: torch.dtype, pool_dtype: torch.dtype,
                      head_dim: int) -> dict:
    """The resources of the main kernel that :func:`paged_attention_fwd`
    launches for these dtypes and head_dim on the current card: its
    variant (``"mma"``: bf16 q on the tensor cores, ``"simt"``: fp32 q on
    the CUDA cores), registers and local (spill) bytes a thread, dynamic
    shared bytes and threads a block, blocks an SM holds, keys a tile."""
    if q_dtype not in Q_CODES or pool_dtype not in _KV_CODES or \
            head_dim not in HEAD_DIMS:
        raise ValueError(f"kernel_attributes: no kernel for {q_dtype} q, "
                         f"{pool_dtype} pool, head_dim {head_dim}")
    vals = (ctypes.c_int * 6)()
    err = _lib().repro_paged_attention_attrs(
        Q_CODES[q_dtype], _KV_CODES[pool_dtype], head_dim, vals)
    if err != 0:
        raise RuntimeError(f"paged_attention attributes failed (code "
                           f"{err})")
    return {"variant": variant(q_dtype), "registers": vals[0],
            "spill_bytes": vals[1], "smem_bytes": vals[2],
            "blocks_per_sm": vals[3], "threads": vals[4],
            "key_tile": vals[5]}


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, tables: torch.Tensor,
                          seg_ids: torch.Tensor, positions: torch.Tensor, *,
                          scale: float, window: Optional[int] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          return_lse: bool = False):
    """Gather-then-attend version of the kernel, same arguments and
    layouts: q (T, Hkv, G, D); pages (N, ps, Hkv, D); scales (N, ps, Hkv)
    fp32 or None; tables (S, P); seg_ids/positions (T,).  Returns
    (T, Hkv, G, D) in q's dtype, and with ``return_lse`` also the (T,
    Hkv, G) fp32 log-sum-exp of each row's visible scaled logits (-inf
    where none is visible).  Mirrors the reference oracle
    (``repro.models.attention.paged_attention`` with the ref backend):
    dequantize to q's dtype, gather every slot's pages into a contiguous
    (S, Hkv, P*ps, D) cache, then :func:`mixed_attention_plain`."""
    n, ps, hkv, d = k_pages.shape
    s, p = tables.shape
    if k_scale is not None:
        k_pages = (k_pages.float() * k_scale[..., None]).to(q.dtype)
        v_pages = (v_pages.float() * v_scale[..., None]).to(q.dtype)
    gidx = (tables.long()[:, :, None] * ps
            + torch.arange(ps, device=q.device)).reshape(s, p * ps)
    k_cache = k_pages.reshape(n * ps, hkv, d)[gidx].transpose(1, 2)
    v_cache = v_pages.reshape(n * ps, hkv, d)[gidx].transpose(1, 2)
    return mixed_attention_plain(q, k_cache, v_cache, seg_ids, positions,
                                 scale=scale, window=window,
                                 return_lse=return_lse)


def paged_attention_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, tables: torch.Tensor,
                        seg_ids: torch.Tensor, positions: torch.Tensor, *,
                        scale: float, window: Optional[int] = None,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        return_lse: bool = False):
    """q: (T, Hkv, G, D) per-token query heads grouped by KV head;
    k_pages/v_pages: (N, ps, Hkv, D) the physical pool; tables (S, P)
    int32; seg_ids/positions (T,) int32; k_scale/v_scale (N, ps, Hkv)
    fp32 for an int8/fp8 pool.  Returns (T, Hkv, G, D) in q's dtype;
    with ``return_lse`` the pair (out, lse), lse (T, Hkv, G) fp32 the
    natural log-sum-exp of each row's visible scaled logits (-inf for a
    row that sees no key), written where the kernel holds each row's max
    and sum (the one-split end of the main kernel, or the combine).  A
    call without it launches the same kernels and writes the same bits.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    on the current stream, or raise: three device launches under one C
    call (the pre-pass that builds the work list of query tiles and key
    splits on the card, the main kernel over it, and the combine of the
    splits; two when the table allows one split), the main kernel on the
    tensor cores for bf16 q and on the CUDA cores for fp32 q (which takes
    an fp32, int8 or fp8 pool, at any page size); :func:`last_launch`
    reads what the last call launched.  ``counter`` counts calls.  It
    reads nothing back to the host.  The launch is the operator
    ``repro_torch::paged_attention``, so ``repro_torch.compile`` traces
    it as one node."""
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, tables, seg_ids, positions, scale=scale,
            window=window, k_scale=k_scale, v_scale=v_scale,
            return_lse=return_lse)
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
    if q.dtype not in Q_CODES:
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
    tensors = [q, k_pages, v_pages, tables, seg_ids, positions]
    if quantized:
        tensors += [k_scale, v_scale]
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or tuple(sc.shape) != (n, ps, hkv):
                raise ValueError("paged_attention_fwd: scales must be "
                                 "(N, ps, Hkv) float32")
    for x in tensors:
        if x.device != q.device:
            raise ValueError("paged_attention_fwd: all operands must be on "
                             "one device")
    for x in (tables, seg_ids, positions):
        if x.dtype != torch.int32:
            raise TypeError("paged_attention_fwd: tables, seg_ids and "
                            "positions must be int32")
    if seg_ids.shape != (t,) or positions.shape != (t,):
        raise ValueError("paged_attention_fwd: seg_ids/positions must "
                         "be (T,)")
    out, lse = _paged_launch(q, k_pages, v_pages, k_scale, v_scale, tables,
                             seg_ids, positions, float(scale),
                             int(window) if window else 0, bool(return_lse))
    return (out, lse) if return_lse else out


@launch_op("paged_attention")
def _paged_launch(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, k_scale: Optional[torch.Tensor],
                  v_scale: Optional[torch.Tensor], tables: torch.Tensor,
                  seg_ids: torch.Tensor, positions: torch.Tensor,
                  scale: float, window: int, with_lse: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch of :func:`paged_attention_fwd` as one operator (its
    shape function below); ``lse`` is (T, Hkv, G) fp32 when ``with_lse``,
    else empty.  The pools and scales are single-owner and never copied:
    they must come dense and 16-byte aligned."""
    t, hkv, g, d = q.shape
    n, ps = k_pages.shape[:2]
    s, p = tables.shape
    q = dense_aligned(q)
    check_operands("paged_attention_fwd", q,
                   [x for x in (q, k_pages, v_pages, k_scale, v_scale,
                                tables, seg_ids, positions)
                    if x is not None])
    if any(x.data_ptr() % 16 for x in (k_pages, v_pages)):
        raise ValueError("paged_attention_fwd: the pages must be 16-byte "
                         "aligned (the kernel copies rows in 16-byte "
                         "cp.async chunks)")
    out = torch.empty_like(q)
    lse = torch.empty((t, hkv, g) if with_lse else (0,),
                      dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    work = torch.empty(_workspace_bytes(t, hkv, g, d, p, ps),
                       dtype=torch.uint8, device=q.device)
    fn = _lib().repro_paged_attention
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(Q_CODES[q.dtype], _KV_CODES[k_pages.dtype], d,
             q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             None if k_scale is None else k_scale.data_ptr(),
             None if v_scale is None else v_scale.data_ptr(),
             tables.data_ptr(), seg_ids.data_ptr(), positions.data_ptr(),
             out.data_ptr(), lse.data_ptr() if with_lse else None,
             work.data_ptr(), t, hkv, g, ps, s, p, scale, window,
             _launched, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed "
                           f"(code {err})")
    counter.bump()
    return out, lse


@_paged_launch.register_fake
def _(q, k_pages, v_pages, k_scale, v_scale, tables, seg_ids, positions,
      scale, window, with_lse):
    t, hkv, g, _ = q.shape
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty((t, hkv, g) if with_lse else (0,),
                        dtype=torch.float32, device=q.device))


# ----------------------------------------------------------------------
# contiguous-cache decode attention
# ----------------------------------------------------------------------

def _decode_lib() -> ctypes.CDLL:
    lib = load_library("repro_decode_attention")
    fn = lib.repro_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_int),
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        ws = lib.repro_decode_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 7
        ws.restype = ctypes.c_longlong
        attrs = lib.repro_decode_attention_attrs
        attrs.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
        attrs.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _decode_workspace_bytes(code, b, hkv, g, d, smax, window) -> int:
    return int(_decode_lib().repro_decode_workspace_bytes(code, b, hkv, g, d,
                                                          smax, window))


def decode_variant(dtype: torch.dtype) -> str:
    """The decode kernel a dtype runs: ``"mma"`` (bf16, tensor cores) or
    ``"simt"`` (fp32, CUDA cores); both split the live keys."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def decode_last_launch() -> dict:
    """What the last CUDA call of :func:`decode_attention_fwd` launched, as
    its C entry reports it: device launches, and the thread blocks of the
    main kernel and of the combine (0 when it was not launched)."""
    return dict(zip(("device_launches", "main_blocks", "combine_blocks"),
                    _decode_launched))


def decode_kernel_attributes(dtype: torch.dtype, head_dim: int) -> dict:
    """The resources of the kernel that :func:`decode_attention_fwd`
    launches for this dtype and head_dim on the current card: its variant,
    registers and local (spill) bytes a thread, dynamic shared bytes and
    threads a block, blocks an SM holds, keys a tile (a warp's tile for
    "simt", a ring stage for "mma") and keys a split."""
    if dtype not in Q_CODES or head_dim not in HEAD_DIMS:
        raise ValueError(f"decode_kernel_attributes: no kernel for {dtype}, "
                         f"head_dim {head_dim}")
    vals = (ctypes.c_int * 7)()
    err = _decode_lib().repro_decode_attention_attrs(Q_CODES[dtype],
                                                     head_dim, vals)
    if err != 0:
        raise RuntimeError(f"decode_attention attributes failed (code "
                           f"{err})")
    return {"variant": decode_variant(dtype), "registers": vals[0],
            "spill_bytes": vals[1], "smem_bytes": vals[2],
            "blocks_per_sm": vals[3], "threads": vals[4],
            "key_tile": vals[5], "split_keys": vals[6]}


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len: torch.Tensor,
                           *, scale: float, window: Optional[int] = None,
                           return_lse: bool = False):
    """The reference oracle's math (``repro/models/attention.py:322-335``)
    in the kernel's layouts: q (B, Hkv, G, D); caches (B, Hkv, Smax, D);
    cache_len (B,).  fp32 logits masked to finfo(float32).min outside
    ``max(len - window, 0) <= k_pos < len``, fp32 softmax, probabilities
    cast to q's dtype before the PV product.  Returns (B, Hkv, G, D), and
    with ``return_lse`` also the (B, Hkv, G) fp32 ``logsumexp`` of the
    visible scaled logits, -inf for a row with none (length 0)."""
    smax = k_cache.shape[2]
    logits = torch.einsum("bhgd,bhkd->bhgk", q.float(),
                          k_cache.float()) * scale
    pos = torch.arange(smax, device=q.device)[None, :]
    clen = cache_len.long()[:, None]
    valid = pos < clen
    if window is not None:
        valid = valid & (pos >= (clen - window).clamp(min=0))
    masked = torch.where(valid[:, None, None, :], logits,
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(masked, dim=-1).to(q.dtype)
    out = torch.einsum("bhgk,bhkd->bhgd", probs, v_cache.to(q.dtype))
    if not return_lse:
        return out
    lse = torch.logsumexp(torch.where(valid[:, None, None, :], logits,
                                      float("-inf")), dim=-1)
    return out, lse


def decode_attention_split_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 cache_len: torch.Tensor, split_keys: int,
                                 *, scale: float,
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """The kernels' split decomposition in plain PyTorch, same arguments and
    layouts as :func:`decode_attention_plain`: row b's live keys [lo, len)
    (len = clip(cache_len[b], 0, Smax), lo = max(0, len - window), 0
    without a window) are cut into splits of ``split_keys``; each split
    gives its fp32 (m, l, O) as the Pallas kernel's online softmax does
    (scores masked at -1e30, probabilities rounded to q's dtype before the
    PV product), and the splits are merged in split order: m = max m_s,
    O = sum_s exp(m_s - m) O_s / max(sum_s exp(m_s - m) l_s, 1e-30).  A
    row with no live key gives zeros, as the kernels do."""
    b, hkv, g, d = q.shape
    smax = k_cache.shape[2]
    out = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=q.device)
    for i, n in enumerate(cache_len.tolist()):
        n = max(0, min(int(n), smax))
        lo = max(0, n - window) if window else 0
        m = torch.full((hkv, g, 1), NEG_INF, device=q.device)
        l = torch.zeros((hkv, g, 1), device=q.device)
        acc = torch.zeros((hkv, g, d), device=q.device)
        for k0 in range(lo, n, split_keys):
            k1 = min(n, k0 + split_keys)
            s = torch.einsum("hgd,hkd->hgk", q[i].float(),
                             k_cache[i, :, k0:k1].float()) * scale
            m_s = s.amax(-1, keepdim=True)
            p = torch.exp(s - m_s)
            o_s = torch.einsum("hgk,hkd->hgd", p.to(q.dtype).float(),
                               v_cache[i, :, k0:k1].to(q.dtype).float())
            m_new = torch.maximum(m, m_s)
            a, a_s = torch.exp(m - m_new), torch.exp(m_s - m_new)
            l = a * l + a_s * p.sum(-1, keepdim=True)
            acc = a * acc + a_s * o_s
            m = m_new
        out[i] = acc / l.clamp(min=1e-30)
    return out.to(q.dtype)


def decode_attention_fwd(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                         scale: float, window: Optional[int] = None,
                         return_lse: bool = False):
    """q: (B, Hkv, G, D) query heads grouped by KV head; k_cache/v_cache:
    (B, Hkv, Smax, D) in q's dtype (fp32 or bf16); cache_len: (B,) int32,
    each row's live length.  Returns (B, Hkv, G, D) in q's dtype; with
    ``return_lse`` the pair (out, lse), lse (B, Hkv, G) fp32 the natural
    log-sum-exp of each row's visible scaled logits, written where the
    kernel holds the row's max and sum (the main kernel for a row of one
    split, else the combine); a call without it writes the same output
    bits.

    A row with length 0 gives zeros from the kernel and a uniform
    average from the plain version (as the Pallas kernel and the jnp
    oracle differ), and an lse of -inf from both, so that a merge of
    partials (``models.attention.merge_attention_partials``) gives it no
    weight: the meshed decode step's ranks that hold no live slot.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    on the current stream, or raise: bf16 runs the tensor-core variant,
    fp32 the CUDA-core one, each split-KV over the live keys (two device
    launches, the main kernel and the combine of the splits, one when
    ``min(Smax, window)`` fits one split of the variant's size);
    :func:`decode_last_launch` reads what the last call launched.
    ``decode_counter`` counts calls.  Neither reads anything back to the
    host.  ``meta`` tensors (the dry run) are checked as CUDA ones and
    get the outputs' shapes and dtypes from the operator's shape
    function; :func:`decode_cost` is its cost."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      scale=scale, window=window,
                                      return_lse=return_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention_fwd: unsupported device "
                         f"{q.device}")
    b, hkv, g, d = q.shape
    if k_cache.ndim != 4 or tuple(k_cache.shape[:2]) != (b, hkv) or \
            k_cache.shape[3] != d or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention_fwd: q {tuple(q.shape)} does "
                         f"not match caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention_fwd: head_dim {d} is not "
                         f"instantiated (have {HEAD_DIMS})")
    if q.dtype not in Q_CODES or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention_fwd: q/k/v dtypes {q.dtype}/"
                        f"{k_cache.dtype}/{v_cache.dtype} unsupported (one "
                        f"of float32, bfloat16 for all three)")
    if cache_len.dtype != torch.int32 or tuple(cache_len.shape) != (b,):
        raise TypeError("decode_attention_fwd: cache_len must be (B,) "
                        "int32")
    out, lse = _decode_launch(q, k_cache, v_cache, cache_len, float(scale),
                              int(window) if window else 0,
                              bool(return_lse))
    return (out, lse) if return_lse else out


@launch_op("decode_attention")
def _decode_launch(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, cache_len: torch.Tensor,
                   scale: float, win: int, with_lse: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch of :func:`decode_attention_fwd` as one operator (its
    shape function below); ``lse`` is (B, Hkv, G) fp32 when
    ``with_lse``, else empty."""
    b, hkv, g, d = q.shape
    q, k_cache, v_cache = (dense_aligned(x) for x in (q, k_cache, v_cache))
    check_operands("decode_attention_fwd", q,
                   (q, k_cache, v_cache, cache_len))
    out = torch.empty_like(q)
    lse = torch.empty((b, hkv, g) if with_lse else (0,),
                      dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    smax = k_cache.shape[2]
    work = None
    nbytes = _decode_workspace_bytes(Q_CODES[q.dtype], b, hkv, g, d, smax,
                                     win)
    if nbytes:
        work = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    fn = _decode_lib().repro_decode_attention
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(Q_CODES[q.dtype], d, q.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
             lse.data_ptr() if with_lse else None,
             None if work is None else work.data_ptr(), b, hkv, g, smax,
             scale, win, _decode_launched, stream)
    if err == -2:
        raise ValueError(f"decode_attention_fwd: min(Smax, window) = "
                         f"{min(smax, win or smax)} keys or G = {g} heads "
                         f"need more than 65535 splits or head blocks")
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed "
                           f"(code {err})")
    decode_counter.bump()
    return out, lse


@_decode_launch.register_fake
def _(q, k_cache, v_cache, cache_len, scale, win, with_lse):
    b, hkv, g, _ = q.shape
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty((b, hkv, g) if with_lse else (0,),
                        dtype=torch.float32, device=q.device))


@_decode_launch.register_cost
def decode_cost(q, k_cache, v_cache, cache_len, scale, win, with_lse):
    """(FLOPs, bytes) of one launch with every row's cache full:
    ``min(Smax, window)`` live keys a row (the dry run decodes at the
    last position, where that is exact; a shorter cache does less).
    Scores and PV, 2·D each for every live key of every query head; q
    read, the output (and lse) written, the lengths and the live keys
    and values read once."""
    b, hkv, g, d = q.shape
    smax = k_cache.shape[2]
    live = min(smax, win) if win else smax
    nbytes = (2 * q.numel() * q.element_size() + 4 * b
              + 2 * b * live * hkv * d * k_cache.element_size()
              + (4 * b * hkv * g if with_lse else 0))
    return 4 * b * hkv * g * d * live, nbytes


# ----------------------------------------------------------------------
# mixed attention over per-slot contiguous caches (the gathered path)
# ----------------------------------------------------------------------

# (q dtype, cache dtype) pairs the kernel instantiates: what the gathered
# path produces (an fp32 or bf16 pool in its own dtype, and bf16 queries
# over the fp32 caches that ``gather`` dequantizes an int8/fp8 pool to)
MIXED_PAIRS = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32))


def _mixed_lib() -> ctypes.CDLL:
    lib = load_library("repro_mixed_attention")
    fn = lib.repro_mixed_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_int),
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        tiling_fn = lib.repro_mixed_tiling
        tiling_fn.argtypes = [ctypes.c_int] * 2 + [
            ctypes.POINTER(ctypes.c_int)]
        tiling_fn.restype = None
        ws = lib.repro_mixed_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 5
        ws.restype = ctypes.c_longlong
        tiles = lib.repro_mixed_tiles
        tiles.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                          + [ctypes.c_void_p])
        tiles.restype = ctypes.c_int
        attrs = lib.repro_mixed_attention_attrs
        attrs.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        attrs.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def mixed_tiling(g: int, seq_len: int) -> dict:
    """The mixed kernel's work list for G query heads a KV head over
    caches of ``seq_len`` keys a slot, as its source fixes it: the tokens
    a tile holds at most (64 rows / G), the keys a split holds, and the
    most splits a tile can have.  Its plain version is
    :func:`paged_tiles_plain` with a table of one page of ``seq_len``."""
    vals = (ctypes.c_int * 3)()
    _mixed_lib().repro_mixed_tiling(g, seq_len, vals)
    return {"tile_tokens": vals[0], "split_keys": vals[1],
            "max_splits": vals[2]}


@functools.lru_cache(maxsize=256)
def _mixed_workspace_bytes(t, hkv, g, d, seq_len) -> int:
    return int(_mixed_lib().repro_mixed_workspace_bytes(t, hkv, g, d,
                                                        seq_len))


def mixed_tiles(seg_ids: torch.Tensor, positions: torch.Tensor,
                n_slots: int, seq_len: int, g: int,
                window: Optional[int] = None) -> torch.Tensor:
    """The mixed kernel's work list for G query heads a KV head, built by
    its pre-pass on the card: :func:`paged_tiles_plain` over a
    table of ``(n_slots, 1)`` pages of ``seq_len`` at
    :func:`mixed_tiling`'s tile tokens and split keys.  It reads the tile
    count back, so it syncs: a check, not part of the kernel's call.
    CUDA tensors only."""
    t = seg_ids.shape[0]
    ws = torch.empty(_mixed_workspace_bytes(t, 0, g, 0, seq_len) // 4,
                     dtype=torch.int32, device=seg_ids.device)
    if t == 0:
        return ws[:0].reshape(0, len(TILE_FIELDS))
    err = _mixed_lib().repro_mixed_tiles(
        seg_ids.data_ptr(), positions.data_ptr(), ws.data_ptr(), t,
        n_slots, seq_len, g, int(window) if window else 0,
        torch.cuda.current_stream(seg_ids.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mixed_attention pre-pass launch failed "
                           f"(code {err})")
    n = int(ws[0].item())
    return ws[2:2 + n * len(TILE_FIELDS)].reshape(n, len(TILE_FIELDS))


def mixed_variant(q_dtype: torch.dtype, cache_dtype: torch.dtype) -> str:
    """The main kernel a (q, cache) dtype pair runs over the shared work
    list: ``"mma"`` (bf16 over bf16, bf16 tensor cores) or ``"tf32x3"``
    (fp32 caches under fp32 or bf16 q, tensor cores in 3xTF32)."""
    return ("mma" if q_dtype == cache_dtype == torch.bfloat16
            else "tf32x3")


def mixed_last_launch() -> dict:
    """What the last CUDA call of :func:`mixed_attention_fwd` launched, as
    its C entry reports it: device launches (3, or 2 when the caches fit
    one split), and the thread blocks of the pre-pass, the main kernel and
    the combine (0 when it was not launched)."""
    return dict(zip(("device_launches", "prepass_blocks", "main_blocks",
                     "combine_blocks"), _mixed_launched))


def mixed_kernel_attributes(q_dtype: torch.dtype, cache_dtype: torch.dtype,
                            head_dim: int) -> dict:
    """The resources of the main kernel that :func:`mixed_attention_fwd`
    launches for this (q, cache) dtype pair and head_dim on the current
    card: its variant, registers and local (spill) bytes a thread, dynamic
    shared bytes and threads a block, blocks an SM holds, keys a tile."""
    if (q_dtype, cache_dtype) not in MIXED_PAIRS or \
            head_dim not in HEAD_DIMS:
        raise ValueError(f"mixed_kernel_attributes: no kernel for "
                         f"{q_dtype} q, {cache_dtype} caches, head_dim "
                         f"{head_dim}")
    vals = (ctypes.c_int * 6)()
    err = _mixed_lib().repro_mixed_attention_attrs(
        Q_CODES[q_dtype], Q_CODES[cache_dtype], head_dim, vals)
    if err != 0:
        raise RuntimeError(f"mixed_attention attributes failed (code "
                           f"{err})")
    return {"variant": mixed_variant(q_dtype, cache_dtype),
            "registers": vals[0], "spill_bytes": vals[1],
            "smem_bytes": vals[2], "blocks_per_sm": vals[3],
            "threads": vals[4], "key_tile": vals[5]}


def mixed_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, seg_ids: torch.Tensor,
                          positions: torch.Tensor, *, scale: float,
                          window: Optional[int] = None,
                          return_lse: bool = False):
    """The reference's jnp path (``repro/models/attention.py:185-200``) in
    the kernel's layouts: q (T, Hkv, G, D); caches (S, Hkv, L, D);
    seg_ids/positions (T,).  Each token takes its slot's rows
    (``clip(seg, 0, S-1)``), fp32 logits masked to finfo(float32).min
    outside ``pos - window < k_pos <= pos``, fp32 softmax, probabilities
    cast to q's dtype, then the PV product in the promoted dtype of q and
    the caches.  Returns (T, Hkv, G, D) in q's dtype.  A token with no
    visible key (``pos >= L`` under a window, or ``pos < 0``) averages V
    uniformly here and gives zeros from the kernel, as the oracle and the
    Pallas kernel differ.  With ``return_lse`` also the (T, Hkv, G) fp32
    ``logsumexp`` of the visible scaled logits, -inf where none is
    visible (the weight such a row gets in
    ``models.attention.merge_attention_partials``)."""
    s, l = k_cache.shape[0], k_cache.shape[2]
    slot = seg_ids.long().clamp(0, s - 1)
    k = k_cache[slot]                                       # (T, Hkv, L, D)
    v = v_cache[slot]
    logits = torch.einsum("thgd,thld->thgl", q.float(), k.float()) * scale
    k_pos = torch.arange(l, device=q.device)[None, :]
    pos = positions.long()[:, None]
    valid = k_pos <= pos
    if window is not None:
        valid = valid & (k_pos > pos - window)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    ct = torch.promote_types(q.dtype, v.dtype)
    out = torch.einsum("thgl,thld->thgd", probs.to(ct),
                       v.to(ct)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(torch.where(valid[:, None, None, :], logits,
                                      float("-inf")), dim=-1)
    return out, lse


def mixed_attention_fwd(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, seg_ids: torch.Tensor,
                        positions: torch.Tensor, *, scale: float,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (T, Hkv, G, D) per-token query heads grouped by KV head;
    k_cache/v_cache: (S, Hkv, L, D) per-slot contiguous caches, fp32 or
    q's dtype (:data:`MIXED_PAIRS`); seg_ids/positions: (T,) int32, the
    slot (< 0: padding, whose output the caller discards) and absolute
    position of each token.  Token t attends its slot's keys at
    ``pos - window < k_pos <= pos``.  Returns (T, Hkv, G, D) in q's
    dtype.  Inference only.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    on the current stream, or raise: three device launches under one C
    call (the pre-pass that builds the work list of query tiles and key
    splits on the card, the main kernel over it, and the combine of the
    splits; two when L fits one split), the main kernel on the bf16
    tensor cores for bf16 q over bf16 caches (variant ``"mma"``) and in
    3xTF32 on the tensor cores for the fp32-cache pairs (``"tf32x3"``);
    :func:`mixed_last_launch` reads what the last call launched.
    ``mixed_counter`` counts calls.  Neither reads anything back to the
    host."""
    if q.device.type == "cpu":
        return mixed_attention_plain(q, k_cache, v_cache, seg_ids,
                                     positions, scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"mixed_attention_fwd: unsupported device "
                         f"{q.device}")
    t, hkv, g, d = q.shape
    if k_cache.ndim != 4 or k_cache.shape[1] != hkv or \
            k_cache.shape[3] != d or v_cache.shape != k_cache.shape:
        raise ValueError(f"mixed_attention_fwd: q {tuple(q.shape)} does "
                         f"not match caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)}")
    s, _, l, _ = k_cache.shape
    if s == 0 or l == 0:
        raise ValueError("mixed_attention_fwd: the caches hold no slot or "
                         "no key")
    if d not in HEAD_DIMS:
        raise ValueError(f"mixed_attention_fwd: head_dim {d} is not "
                         f"instantiated (have {HEAD_DIMS})")
    if (q.dtype, k_cache.dtype) not in MIXED_PAIRS or \
            v_cache.dtype != k_cache.dtype:
        raise TypeError(f"mixed_attention_fwd: q/k/v dtypes {q.dtype}/"
                        f"{k_cache.dtype}/{v_cache.dtype} unsupported (have "
                        f"{MIXED_PAIRS})")
    for x in (seg_ids, positions):
        if x.dtype != torch.int32 or tuple(x.shape) != (t,):
            raise TypeError("mixed_attention_fwd: seg_ids and positions "
                            "must be (T,) int32")
    return _mixed_launch(q, k_cache, v_cache, seg_ids, positions,
                         float(scale), int(window) if window else 0)


@launch_op("mixed_attention")
def _mixed_launch(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, seg_ids: torch.Tensor,
                  positions: torch.Tensor, scale: float,
                  window: int) -> torch.Tensor:
    """The launch of :func:`mixed_attention_fwd` as one operator (its
    shape function below)."""
    t, hkv, g, d = q.shape
    s, _, l, _ = k_cache.shape
    q, k_cache, v_cache = (dense_aligned(x) for x in (q, k_cache, v_cache))
    check_operands("mixed_attention_fwd", q,
                   (q, k_cache, v_cache, seg_ids, positions))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    work = torch.empty(_mixed_workspace_bytes(t, hkv, g, d, l),
                       dtype=torch.uint8, device=q.device)
    fn = _mixed_lib().repro_mixed_attention
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(Q_CODES[q.dtype], Q_CODES[k_cache.dtype], d,
             q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             seg_ids.data_ptr(), positions.data_ptr(), out.data_ptr(),
             work.data_ptr(), t, hkv, g, s, l, scale, window,
             _mixed_launched, stream)
    if err != 0:
        raise RuntimeError(f"mixed_attention kernel launch failed "
                           f"(code {err})")
    mixed_counter.bump()
    return out


@_mixed_launch.register_fake
def _(q, k_cache, v_cache, seg_ids, positions, scale, window):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)
