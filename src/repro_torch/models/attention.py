"""Attention computation layer, in PyTorch.

Counterpart of ``repro/models/attention.py`` for the serving and
dense-cache paths: :func:`sdpa` (prefill / ``lm.forward``), its oracle
:func:`sdpa_ref`, :func:`decode_attention` (``lm.decode_step``),
:func:`paged_attention` (the serving executor) and
:func:`mixed_attention` (a flat token batch against per-slot contiguous
caches: the gathered-cache path, ``serving.kv_cache.PagedKVCache.gather``
then attention).

``backend`` (the config's ``attn_backend``: ``"auto"``, ``"pallas"`` or
``"ref"``) is validated and then selects nothing, as in the paged path:
every call goes through the kernel wrapper of ``kernels.ops``, which
launches the CUDA kernel for CUDA tensors and takes its plain version
only for CPU tensors.  So no config puts plain attention on the card.
The oracles stay callable by name: :func:`sdpa_ref` here and
``kernels.decode_attention.decode_attention_plain`` /
``mixed_attention_plain`` / ``paged_attention_plain``.  Unlike the
reference there is no ``try``/``except`` around a kernel: a kernel that
cannot run raises.  Two TPU-isms of the reference are re-derived:

  * ``_PALLAS_MIN_SEQ = 128`` sent short sequences to the jnp path, a TPU
    tiling trade-off.  Here :func:`sdpa` calls the kernel for every Sq,
    so no plain path runs on the card;
  * the ``d % 128`` rule of the paged path, under which the reference
    falls back from the paged kernel to a gather and ``mixed_attention``
    for lane-unaligned head_dims: the CUDA paged kernel takes every
    instantiated head_dim and raises on any other, so
    :func:`paged_attention` never gathers, and the mixed kernel is
    reached through :func:`mixed_attention` itself.

An explicit ``mask`` goes to :func:`sdpa_masked` on every device: torch
ops (scores, the mask, an fp32 softmax, PV), as the reference computes
that case in XLA through ``sdpa_ref`` and not in a Pallas kernel, so no
kernel of the table stands behind it.

Head widths: the kernels are instantiated at ``kernels._build.
HEAD_DIMS`` with one width for q, k and v.  :func:`sdpa` and
:func:`decode_attention` zero-pad any other width (hubert's 80), and a v
narrower than q/k (MLA's 96 / 64), to the next instantiated width and
cut the output back (:func:`padded_call`); the wrappers below them still
raise on a width they cannot launch.

The reference's ``_build_mask`` is ``kernels.flash_attention.
visible_mask``.  :func:`context_sdpa` is its context-parallel attention
(each model rank its slice of the queries, K/V all-gathered along the
sequence) through the flash kernel; :func:`sdpa` takes it for the
sequence pieces the attention layer hands it under a mesh scope
(``distributed/act_sharding.py``: the context fallback, and under
``REPRO_SEQ_SHARD=1`` the rank's rows of a layer whose heads do not
divide ``model``).  The reference takes that branch
only under ``REPRO_SEQ_SHARD=1``, because without it GSPMD partitions
the sequence-sharded attention itself; the port has no partitioner, so
the branch follows the layout ``constrain`` gave q, k and v.
:func:`merge_attention_partials` merges attention over disjoint key
sets by their log-sum-exps: the sharded serving executor's
context-parallel KV and the meshed decode step's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed import act_sharding as AS
from ..distributed import collectives as C
from ..kernels import flash_attention as FA
from ..kernels._build import HEAD_DIMS
from ..kernels import ops as kops

paged_attention = kops.paged_attention


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, Hkv, S, D) -> (B, Hkv*n_rep, S, D)."""
    if n_rep == 1:
        return k
    b, h, s, d = k.shape
    return k[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


BACKENDS = ("auto", "pallas", "ref")


def _check_backend(who: str, backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown {who} backend {backend!r} "
                         f"(one of {BACKENDS})")


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: Optional[torch.Tensor] = None, is_causal: bool = False,
             scale: Optional[float] = None,
             window: Optional[int] = None) -> torch.Tensor:
    """Plain oracle.  q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D).  fp32
    logits, masked to finfo(float32).min (a bool ``mask``) or offset (a
    float one), fp32 softmax, probabilities cast to q's dtype."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if hkv != hq:
        k = repeat_kv(k, hq // hkv)
        v = repeat_kv(v, hq // hkv)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if is_causal or window is not None:
        visible = FA.visible_mask(sq, k.shape[2], is_causal, window,
                                  q.device)
        logits = torch.where(visible, logits, torch.finfo(torch.float32).min)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits,
                                 torch.finfo(torch.float32).min)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.to(q.dtype))


def sdpa_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor, is_causal: bool = False,
                scale: Optional[float] = None,
                window: Optional[int] = None) -> torch.Tensor:
    """Attention under an explicit ``mask`` (bool: True is visible; float:
    added to the logits), broadcastable to (B, Hq, Sq, Skv), on any
    device, with :func:`sdpa_ref`'s arithmetic: fp32 logits, masked to
    finfo(float32).min, fp32 softmax, probabilities cast to q's dtype.
    The query heads of one KV head are taken as one (G * Sq)-row matrix,
    so K and V are never repeated per query head.  Differentiable."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g * sq, d).float()
    logits = (torch.matmul(qg, k.float().transpose(-1, -2)) * scale
              ).reshape(b, hkv, g, sq, skv)
    low = torch.finfo(torch.float32).min
    if is_causal or window is not None:
        visible = FA.visible_mask(sq, skv, is_causal, window, q.device)
        logits = torch.where(visible, logits, low)
    mask = mask.reshape((1,) * (4 - mask.dim()) + tuple(mask.shape))
    if mask.shape[1] == 1:
        mask = mask.unsqueeze(2)           # one mask for every head
    else:
        mask = mask.reshape(mask.shape[0], hkv, g, *mask.shape[2:])
    if mask.dtype == torch.bool:
        logits = torch.where(mask, logits, low)
    else:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs.reshape(b, hkv, g * sq, skv), v.to(q.dtype))
    return out.reshape(b, hq, sq, d)


def padded_width(d_qk: int, d_v: int) -> Optional[int]:
    """The head width the kernels run q/k of width ``d_qk`` and v of
    width ``d_v`` at: None when both are one instantiated width (no
    padding), else the least instantiated width that holds both (hubert's
    80 -> 128, MLA's 96 / 64 -> 128).  Raises when none does."""
    if d_qk == d_v and d_qk in HEAD_DIMS:
        return None
    for w in HEAD_DIMS:
        if w >= max(d_qk, d_v):
            return w
    raise ValueError(f"attention: head widths q/k {d_qk}, v {d_v} exceed "
                     f"every instantiated width {HEAD_DIMS}")


def _pad_to(x: torch.Tensor, width: int) -> torch.Tensor:
    return F.pad(x, (0, width - x.shape[-1]))


def padded_call(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: Optional[float], **kw) -> torch.Tensor:
    """``fn(q, k, v, scale=scale, **kw)`` (a kernel wrapper of
    ``kernels.ops``) at an instantiated head width.  When q/k or v is not
    one (:func:`padded_width`), all three are zero-padded to it, the
    kernel runs with the caller's scale (default ``d_qk ** -0.5``, never
    the padded width's), and the output is cut to v's width.  Exact:
    zero columns add nothing to q.k, and the zero v columns are cut off.
    The port's counterpart of the reference's 128-lane ``_pad_last``
    (``repro/kernels/ops.py:63-66``), which pads every width not a
    multiple of 128; here only the widths the kernels lack are padded.
    Differentiable (padding and slicing are autograd ops)."""
    d_qk, d_v = q.shape[-1], v.shape[-1]
    if k.shape[-1] != d_qk:
        raise ValueError(f"attention: q width {d_qk} != k width "
                         f"{k.shape[-1]}")
    scale = scale if scale is not None else d_qk ** -0.5
    width = padded_width(d_qk, d_v)
    if width is None:
        return fn(q, k, v, scale=scale, **kw)
    out = fn(_pad_to(q, width), _pad_to(k, width), _pad_to(v, width),
             scale=scale, **kw)
    return out[..., :d_v]


def context_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: Optional[float], causal: bool,
                 window: Optional[int]) -> torch.Tensor:
    """Context-parallel attention in an SPMD mesh scope (the reference's
    ``context_sdpa``, ``repro/models/attention.py:78``): q, k and v are
    this rank's pieces (B, H, S/n, D) of the sequence over the ``model``
    axis's n ranks, rank i holding positions [i S/n, (i+1) S/n).  K and V
    are all-gathered along the sequence (their gradients summed over the
    ranks and sliced back); the rank's queries attend through the flash
    kernel, which aligns its Sq queries to the last Sq keys: passing the
    first (i+1) S/n gathered keys with ``causal=True`` gives the global
    causal mask, and a window counts back from the same positions.
    Non-causal attention takes every key, with no window (a window
    without causality would need keys past the slice, which no config
    has)."""
    if not causal and window is not None:
        raise ValueError("context_sdpa: a window without causal masking is "
                         "not supported")
    group = AS.model_group()
    kg = C.gather(k, group, 2)
    vg = C.gather(v, group, 2)
    if causal:
        end = (AS.model_rank() + 1) * q.shape[2]
        kg, vg = kg[:, :, :end], vg[:, :, :end]
    return padded_call(kops.flash_attention, q, kg, vg, scale,
                       causal=causal, window=window)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None, is_causal: bool = False,
         scale: Optional[float] = None, window: Optional[int] = None,
         backend: str = "auto") -> torch.Tensor:
    """Scaled dot-product attention, q (B, Hq, Sq, D) against k (B, Hkv,
    Skv, D) and v (B, Hkv, Skv, Dv), the queries being the last Sq
    positions, through the flash kernel (differentiable) for every
    backend; a width the kernel lacks, or Dv != D, is padded
    (:func:`padded_call`).  Returns (B, Hq, Sq, Dv).  An explicit
    ``mask`` takes :func:`sdpa_masked` (torch ops, on every device).
    Sequence pieces under a mesh scope (``act_sharding.
    sequence_pieces``) take :func:`context_sdpa`."""
    _check_backend("sdpa", backend)
    if mask is None and AS.seq_pieces():
        return context_sdpa(q, k, v, scale, is_causal, window)
    if mask is None:
        return padded_call(kops.flash_attention, q, k, v, scale,
                           causal=is_causal, window=window)
    return sdpa_masked(q, k, v, mask, is_causal, scale, window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     scale: Optional[float] = None,
                     window: Optional[int] = None,
                     backend: str = "auto", return_lse: bool = False):
    """Single-position decode through the decode kernel for every
    backend: q (B, Hq, 1, D) against a k (B, Hkv, Smax, D) and v (B,
    Hkv, Smax, Dv) cache filled up to ``cache_len`` (a host int or a
    (B,) tensor); keys at ``max(len - window, 0) <= k_pos < len`` are
    visible.  A width the kernel lacks, or Dv != D, is padded
    (:func:`padded_call`).  Returns (B, Hq, 1, Dv), and with
    ``return_lse`` also the (B, Hq, 1) fp32 log-sum-exp of each row's
    visible scaled logits."""
    _check_backend("decode_attention", backend)
    if not return_lse:
        return padded_call(
            lambda q_, k_, v_, scale: kops.decode_attention(
                q_, k_, v_, cache_len, scale=scale, window=window),
            q, k_cache, v_cache, scale)
    lse = []

    def call(q_, k_, v_, scale):
        out, row_lse = kops.decode_attention(
            q_, k_, v_, cache_len, scale=scale, window=window,
            return_lse=True)
        lse.append(row_lse)
        return out

    out = padded_call(call, q, k_cache, v_cache, scale)
    return out, lse[0]


def mixed_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, seg_ids, positions,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    backend: str = "auto") -> torch.Tensor:
    """Attention for a flat token batch mixing prefill chunks and decode
    tokens, against per-slot contiguous caches, through the mixed kernel
    for every backend.

    q: (T, Hq, D), one query per scheduled token; k_cache/v_cache:
    (S, Hkv, L, D), per-slot contiguous K/V (gathered from pages, already
    holding this step's keys); seg_ids: (T,) slot of each token (< 0 is
    padding, whose output the caller discards); positions: (T,) absolute
    position of each token.  Token t attends slot seg_ids[t]'s keys at
    positions <= positions[t] (and > positions[t] - window), its own
    included.  Returns (T, Hq, D) in q's dtype."""
    _check_backend("mixed_attention", backend)
    return kops.mixed_attention(q, k_cache, v_cache, seg_ids, positions,
                                scale=scale, window=window)


def merge_attention_partials(outs, lses) -> torch.Tensor:
    """Attention over a union of disjoint key sets from its parts: each
    ``outs[i]`` (..., D) is the attention output over key set i and
    ``lses[i]`` (...) fp32 the natural log-sum-exp of that set's visible
    scaled logits (-inf where the set holds no visible key, as the paged
    kernel's ``return_lse`` gives it).  Returns the output over all the
    keys in ``outs[0]``'s dtype: each part weighted by ``exp(lse_i -
    max_j lse_j)``, in fp32, then normalised; a row no part sees gives
    zeros.  Torch ops, no kernel: the context-parallel executor merges
    its model ranks' partials with it."""
    lse = torch.stack([x.float() for x in lses])             # (n, ...)
    top = lse.max(dim=0).values
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lse - top)                                 # 0 for -inf
    num = sum(wi[..., None] * o.float() for wi, o in zip(w, outs))
    den = w.sum(dim=0).clamp_min(torch.finfo(torch.float32).tiny)
    return (num / den[..., None]).to(outs[0].dtype)


def select_paged_backend(requested: str, *, sharded: bool) -> str:
    """The config's ``attn_backend``, validated and returned as given,
    whether or not the engine is sharded: the tensor's device decides the
    path (module docstring).  The reference pins its jnp path under a
    replica axis or a mesh; the port's replicated step attends every
    replica's pages in one paged-kernel launch (their page ids are
    global), and a meshed rank attends its own shard of the pool through
    the same kernel (``serving.executor``), so nothing is pinned."""
    del sharded
    _check_backend("paged attention", requested)
    return requested
