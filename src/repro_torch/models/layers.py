"""Functional LM building blocks in PyTorch (params are plain dicts).

Counterpart of ``repro/models/layers.py``: attention (GQA, sliding
window, qkv bias, qk-norm), MLA, the dense FFN, the GShard MoE, the
Mamba mixer and the RWKV-6 block.  Layouts are the
reference's: linear weights are stored ``(in, out)`` and applied as
``x @ W``; norm weights and statistics are fp32.

Under a mesh scope (``distributed/act_sharding.py``) every layer runs the
rank's part of it (attention heads, MLP columns, experts or their hidden
columns, mamba channels, rwkv heads) on the leaves
``act_sharding.use_params`` prepared, as the layer plan it returned
says, and calls ``constrain`` where the reference does.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import act_sharding as AS
from ..distributed import collectives as C
from ..kernels import ops as kops
from . import attention as A

Params = Dict[str, torch.Tensor]

# ----------------------------------------------------------------------
# init helpers (explicit generator and device)
# ----------------------------------------------------------------------

# Each block's init passes every leaf through ``keep(name, leaf)`` as
# soon as it is drawn, before the next is drawn: ``lm.init_params`` cuts a
# rank's piece there (``launch.train.init_pieces``).
Keep = Callable[[str, torch.Tensor], torch.Tensor]


def whole(name: str, leaf: torch.Tensor) -> torch.Tensor:
    """The ``keep`` that keeps every leaf whole."""
    return leaf



def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def attn_init(gen: torch.Generator, d_model: int, n_heads: int,
              n_kv_heads: int, head_dim: int, dtype, device,
              qkv_bias: bool = False, keep: Keep = whole) -> Params:
    def dense(name, i, o):
        return keep(name, dense_init(gen, i, o, dtype, device))

    p = {
        "wq": dense("wq", d_model, n_heads * head_dim),
        "wk": dense("wk", d_model, n_kv_heads * head_dim),
        "wv": dense("wv", d_model, n_kv_heads * head_dim),
        "wo": dense("wo", n_heads * head_dim, d_model),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
            p[name] = keep(name, torch.zeros(width * head_dim, dtype=dtype,
                                             device=device))
    return p


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype, device,
             gated: bool = True, keep: Keep = whole) -> Params:
    p = {"w_up": keep("w_up", dense_init(gen, d_model, d_ff, dtype, device)),
         "w_down": keep("w_down", dense_init(gen, d_ff, d_model, dtype,
                                             device))}
    if gated:
        p["w_gate"] = keep("w_gate", dense_init(gen, d_model, d_ff, dtype,
                                                device))
    return p


# ----------------------------------------------------------------------
# norms (fp32 statistics)
# ----------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (offset + weight.float())).to(x.dtype)


def rms_norm_split(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """:func:`rms_norm` of a tensor whose last dimension the ``model``
    ranks split: ``x`` and ``weight`` are the rank's channels, and the
    mean square is over every rank's (the squares' sum reduced over
    ``model``, its gradient too)."""
    x32 = x.float()
    sq = AS.sum_over_model(x32.square().sum(dim=-1, keepdim=True))
    y = x32 * torch.rsqrt(sq / (x.shape[-1] * AS.model_size()) + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float = 1e-5
               ) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps) * weight
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


# ----------------------------------------------------------------------
# rotary embeddings (split-half layout)
# ----------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """(D/2,) fp32 inverse frequencies, computed on the CPU and moved to
    ``device`` once per (head_dim, theta, device): a scalar made on the
    card is a blocking host-to-device copy, which would stall every
    layer of every step."""
    return _rope_freqs(head_dim, float(theta), torch.device(device or "cpu"))


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    return freqs.to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, H, S, D), positions: (S,) or (B, S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (D/2,)
    angles = positions[..., None].float() * freqs            # (..., S, D/2)
    if angles.ndim == 2:
        angles = angles[None, None]
    else:
        angles = angles[:, None]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention block (prefill and contiguous-cache decode)
# ----------------------------------------------------------------------


def attention(p: Params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int,
              head_dim: int, causal: bool = True,
              window: Optional[int] = None,
              rope_theta: Optional[float] = 10000.0,
              positions: Optional[torch.Tensor] = None,
              query_scale: Optional[float] = None,
              cache: Optional[Params] = None,
              cache_pos: Optional[int] = None,
              cache_len=None,
              abs_pos_arg: Optional[int] = None,
              q_norm: bool = False,
              backend: str = "auto",
              plan: str = "one",
              seq: bool = False,
              fill: Optional[Params] = None,
              fill_split: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, S, D).  Without ``cache``: causal/windowed self-attention
    over the S positions (``sdpa``, the flash kernel).  With ``cache``
    ({"k", "v"}: (B, Hkv, Smax, hd)): decode.  K/V are written at slot
    ``cache_pos`` and the queries attend ``cache_len`` slots (default
    ``cache_pos + S``) with ``decode_attention``.  Keys are stored roped
    at their absolute positions.

    The write is in place: the cache tensors are single-owner and the
    returned ``new_cache`` holds the same tensors.  This is the port's
    counterpart of the reference's ``dynamic_update_slice`` under
    ``make_serve_step``'s cache donation (``launch/train.py:208``).
    ``cache_pos`` (and ``abs_pos_arg``) are host ints: the port has no
    jit, so positions need no device value and nothing syncs with the
    device.  ``plan``: how a rank of a mesh runs the layer
    (``act_sharding.LayerPlan.attn``); ``"one"`` outside a mesh.
    ``seq``: ``x`` is the rank's rows of a sequence-sharded stream, and
    so is the output (the ``"heads"`` plan gathers the sequence first and
    reduce-scatters its output; the ``"rows"`` plan attends its rows'
    queries against every rank's keys through ``context_sdpa``).

    ``fill`` (a prefill, without ``cache``): the layer's cache entries,
    into which the keys and values of the S positions are written as S
    decode steps from position 0 would leave them (the last ``ring``
    positions at slot ``p % ring`` for a sliding layer, whose prefill has
    a ``window``); ``fill_split`` is the dimension ``model`` splits of
    them (``LayerPlan.cache_split``)."""
    if plan == "heads":
        x = AS.copy_to_model(x, seq)
    b, s, _ = x.shape
    if plan == "whole" and cache is None and AS.context_parallel(n_heads,
                                                                 s):
        plan = "context"
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # this rank's heads (every head outside a scope)
    hq, hkv = q.shape[-1] // head_dim, k.shape[-1] // head_dim
    q = q.reshape(b, s, hq, head_dim).transpose(1, 2)
    k = k.reshape(b, s, hkv, head_dim).transpose(1, 2)
    v = v.reshape(b, s, hkv, head_dim).transpose(1, 2)

    if positions is None:
        start = 0
        if cache is not None and cache_pos is not None:
            start = cache_pos if abs_pos_arg is None else abs_pos_arg
        elif plan == "rows":
            start = AS.model_rank() * s
        positions = torch.arange(start, start + s, device=x.device)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if q_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if fill is not None:
        if plan == "rows":
            k_all = C.all_gather_cat(k, AS.model_group(), 2)
            v_all = C.all_gather_cat(v, AS.model_group(), 2)
        else:
            k_all, v_all = k, v
        _fill_kv(fill, k_all, v_all, fill_split, window is not None)
    if plan == "heads" and hkv > 1 and hkv != n_kv_heads // AS.model_size():
        # whole K/V heads beside this rank's query heads: the KV head of
        # each (gemma's one KV head is shared as it is)
        first = AS.model_rank() * hq
        kv_of = (first + torch.arange(hq, device=x.device)) // (
            n_heads // n_kv_heads)
        k, v = k[:, kv_of], v[:, kv_of]

    scale = query_scale if query_scale is not None else head_dim ** -0.5

    if cache is None and plan == "rows":
        # (q, k and v are already in bhsd's layout: the sequence over
        # model)
        with AS.sequence_pieces():
            out = A.sdpa(q, k, v, is_causal=causal, window=window,
                         scale=scale, backend=backend)
        new_cache = None
    elif cache is None:
        # the reference constrains q/k/v before RoPE and qk-norm; both act
        # on each position alone, so the layout change commutes with them
        have = 1 if plan == "heads" else None
        q = AS.constrain(q, "bhsd", heads=n_heads, have=have)
        if plan != "heads" or n_kv_heads % AS.model_size() == 0:
            # (K/V computed whole for the rank's query heads stay whole)
            k = AS.constrain(k, "bhsd", heads=n_kv_heads, have=have)
            v = AS.constrain(v, "bhsd", heads=n_kv_heads, have=have)
        with AS.sequence_pieces(plan == "context"):
            out = A.sdpa(q, k, v, is_causal=causal, window=window,
                         scale=scale, backend=backend)
        out = AS.constrain(out, "bhsd", heads=n_heads,
                           have=2 if plan == "context" else have)
        if plan == "context":
            out = C.gather_whole(out, AS.model_group(), 2)
        new_cache = None
    elif plan == "context":
        out = _context_decode(q, k, v, cache, cache_pos, cache_len,
                              scale, window, backend)
        new_cache = cache
    else:
        k_cache, v_cache = cache["k"], cache["v"]
        k_cache[:, :, cache_pos:cache_pos + s] = k.to(k_cache.dtype)
        v_cache[:, :, cache_pos:cache_pos + s] = v.to(v_cache.dtype)
        clen = cache_pos + s if cache_len is None else cache_len
        out = A.decode_attention(q, k_cache, v_cache, cache_len=clen,
                                 scale=scale, window=window,
                                 backend=backend)
        new_cache = {"k": k_cache, "v": v_cache}

    out = out.transpose(1, 2).reshape(b, s, hq * head_dim) @ p["wo"]
    if plan == "heads":
        out = AS.reduce_from_model(out, seq)
    return out, new_cache


def _write_span(dst: torch.Tensor, src: torch.Tensor, dim: int, pos: int,
                lo: int) -> None:
    """Write ``src``'s positions [pos, pos + n) along ``dim`` into
    ``dst`` (cast to its dtype), which holds slots [lo, lo +
    dst.shape[dim]); positions outside them are skipped."""
    a = max(pos, lo)
    z = min(pos + src.shape[dim], lo + dst.shape[dim])
    if a < z:
        dst.narrow(dim, a - lo, z - a).copy_(src.narrow(dim, a - pos,
                                                        z - a))


def _fill_kv(cache: Params, k: torch.Tensor, v: torch.Tensor,
             split: Optional[int], ring: bool) -> None:
    """Write a prefill's keys and values (B, H, S, D) of positions [0,
    S) into the layer's cache (B, Hc, Lc, D) as S decode steps would:
    position p at slot p, or for a ``ring`` of n slots the last n
    positions at slot ``p % n``.  ``split`` (a mesh): the cache holds the
    rank's KV heads (1; ``k`` holds them, or every head, of which the
    rank's are taken) or its slots [r Lc, (r + 1) Lc) of the n = m Lc
    (2)."""
    k_cache, v_cache = cache["k"], cache["v"]
    n_loc = k_cache.shape[2]
    if split == 1 and k.shape[1] != k_cache.shape[1]:
        lo = AS.model_rank() * k_cache.shape[1]
        k = k[:, lo:lo + k_cache.shape[1]]
        v = v[:, lo:lo + k_cache.shape[1]]
    n = n_loc * (AS.model_size() if split == 2 else 1)
    s = k.shape[2]
    if s > n and not ring:
        raise ValueError(f"attention: a prefill of {s} positions does not "
                         f"fit the cache's {n}")
    lo = AS.model_rank() * n_loc if split == 2 else 0
    pos = max(0, s - n)
    while pos < s:
        slot = pos % n
        run = min(s - pos, n - slot)          # up to the ring's wrap
        _write_span(k_cache, k[:, :, pos:pos + run], 2, slot, lo)
        _write_span(v_cache, v[:, :, pos:pos + run], 2, slot, lo)
        pos += run


def _context_decode(q, k, v, cache, cache_pos: int, cache_len, scale,
                    window, backend) -> torch.Tensor:
    """Decode against a cache whose slots are split over ``model``: this
    rank holds slots [r L, (r + 1) L) of every KV head.  The step's K/V
    go to the rank that holds slot ``cache_pos``; each rank attends its
    live slots and the ranks' partials are merged
    (:func:`_merged_decode`)."""
    s = q.shape[2]
    k_cache, v_cache = cache["k"], cache["v"]
    n_loc = k_cache.shape[2]
    off = AS.model_rank() * n_loc
    _write_span(k_cache, k, 2, cache_pos, off)
    _write_span(v_cache, v, 2, cache_pos, off)
    clen = cache_pos + s if cache_len is None else cache_len
    live = min(max(clen - off, 0), n_loc)
    return _merged_decode(q, k_cache, v_cache, live, scale, window, backend)


def _merged_decode(q, k, v, live: int, scale, window,
                   backend) -> torch.Tensor:
    """Decode attention of ``q`` over this rank's first ``live`` slots of
    ``k`` / ``v`` (its slots of a cache split over ``model``), merged
    with the other ranks' partials by their log-sum-exps (the decode
    kernel's ``return_lse``, ``models.attention.
    merge_attention_partials``).  A rank with no live slot gives zeros
    and a log-sum-exp of -inf, which weighs nothing."""
    if live > 0:
        out, lse = A.decode_attention(q, k, v, cache_len=live, scale=scale,
                                      window=window, backend=backend,
                                      return_lse=True)
    else:
        out = torch.zeros(q.shape[:-1] + v.shape[-1:], dtype=q.dtype,
                          device=q.device)
        lse = torch.full(q.shape[:-1], float("-inf"), device=q.device)
    group = AS.model_group()
    AS.count_merge()
    return A.merge_attention_partials(C.all_gather(out.contiguous(), group),
                                      C.all_gather(lse.contiguous(), group))


# ----------------------------------------------------------------------
# MLA: multi-head latent attention (MiniCPM3 / DeepSeek-V2)
# ----------------------------------------------------------------------


def mla_init(gen: torch.Generator, d_model: int, n_heads: int, *,
             q_lora_rank: int, kv_lora_rank: int, nope_dim: int,
             rope_dim: int, v_dim: int, dtype, device,
             keep: Keep = whole) -> Params:
    """The reference's shapes and per-leaf dtypes
    (``repro/models/layers.py:186-199``): the projections in ``dtype``,
    ``q_norm`` and ``kv_norm`` ones in fp32."""
    def dense(name, i, o):
        return keep(name, dense_init(gen, i, o, dtype, device))

    def ones(name, n):
        return keep(name, torch.ones(n, dtype=torch.float32, device=device))

    return {
        "wq_a": dense("wq_a", d_model, q_lora_rank),
        "wq_b": dense("wq_b", q_lora_rank, n_heads * (nope_dim + rope_dim)),
        "wkv_a": dense("wkv_a", d_model, kv_lora_rank + rope_dim),
        "wkv_b": dense("wkv_b", kv_lora_rank, n_heads * (nope_dim + v_dim)),
        "q_norm": ones("q_norm", q_lora_rank),
        "kv_norm": ones("kv_norm", kv_lora_rank),
        "wo": dense("wo", n_heads * v_dim, d_model),
    }


def mla_attention(p: Params, x: torch.Tensor, *, n_heads: int,
                  nope_dim: int, rope_dim: int, v_dim: int,
                  kv_lora_rank: int, causal: bool = True,
                  rope_theta: float = 10000.0,
                  cache: Optional[Params] = None,
                  cache_pos: Optional[int] = None,
                  backend: str = "auto",
                  fill: Optional[Params] = None,
                  plan: str = "one",
                  fill_split: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Latent-compressed attention (``repro/models/layers.py:202-265``).
    x: (B, S, D).  Queries go ``wq_a -> q_norm -> wq_b``; the keys and
    values come from the latent ``c_kv`` (``kv_lora_rank`` wide, through
    ``kv_norm``), expanded per head through ``wkv_b``, with one roped
    key part ``k_rope`` shared by every head.  Scale ``(nope + rope) **
    -0.5``.

    With ``cache`` ({"c_kv": (B, Smax, rank), "k_rope": (B, 1, Smax,
    rope)}, the only per-token state: MLA's memory saving) the step's
    latent and roped key are written in place at ``cache_pos`` and the
    queries attend the first ``cache_pos + S`` positions, the latent of
    each expanded again as the reference does (the absorbed form is not
    taken).  q and k are ``nope + rope`` wide and v ``v_dim``: the
    attention wrappers pad them to one instantiated width.  ``fill`` (a
    prefill, without ``cache``): the layer's cache, into which the S
    positions' latents and roped keys are written.

    On a mesh the layer runs whole on every rank (``plan`` ``"whole"``),
    except against a cache whose slots are split over ``model``: rank r
    holds slots [r L, (r + 1) L) of ``c_kv`` and ``k_rope``.  A prefill
    (``fill_split`` set) writes the rank's slots; a decode step
    (``plan`` ``"context"``) writes the step's entries where the rank
    holds their slot, expands and attends the rank's live slots, and
    merges the ranks' partials (:func:`_merged_decode`)."""
    b, s, _ = x.shape
    qd = nope_dim + rope_dim

    cq = rms_norm(x @ p["wq_a"], p["q_norm"])
    q = (cq @ p["wq_b"]).reshape(b, s, n_heads, qd).transpose(1, 2)
    q_nope, q_rope = q[..., :nope_dim], q[..., nope_dim:]

    kv_a = x @ p["wkv_a"]                               # (B, S, rank+rope)
    c_kv = rms_norm(kv_a[..., :kv_lora_rank], p["kv_norm"])
    k_rope = kv_a[..., kv_lora_rank:]                   # shared by heads

    start = 0 if cache is None else cache_pos
    positions = torch.arange(start, start + s, device=x.device)
    q_rope = apply_rope(q_rope, positions, rope_theta)
    k_rope = apply_rope(k_rope[:, None], positions, rope_theta)  # (B,1,S,r)

    if fill is not None:
        lo = _slots_from(fill, fill_split is not None)
        n = fill["c_kv"].shape[1] * (AS.model_size()
                                     if fill_split is not None else 1)
        if s > n:
            raise ValueError(f"mla_attention: a prefill of {s} positions "
                             f"does not fit the cache's {n}")
        _write_span(fill["c_kv"], c_kv, 1, 0, lo)
        _write_span(fill["k_rope"], k_rope, 2, 0, lo)
    if cache is not None:
        lo = _slots_from(cache, plan == "context")
        _write_span(cache["c_kv"], c_kv, 1, cache_pos, lo)
        _write_span(cache["k_rope"], k_rope, 2, cache_pos, lo)
        # the rank's live slots (every slot up to the step's own, on one
        # process)
        kv_len = min(max(cache_pos + s - lo, 0), cache["c_kv"].shape[1])
        # the cache's entries are read in the activation dtype, as the
        # reference's dynamic_update_slice result meets x's weights
        c_kv = cache["c_kv"][:, :kv_len].to(x.dtype)
        k_rope = cache["k_rope"][:, :, :kv_len].to(x.dtype)
    else:
        kv_len = s

    # the latent expanded to per-head K_nope and V
    kv = (c_kv @ p["wkv_b"]).reshape(b, kv_len, n_heads, nope_dim + v_dim)
    k_nope = kv[..., :nope_dim].transpose(1, 2)
    v = kv[..., nope_dim:].transpose(1, 2)
    k = torch.cat([k_nope, k_rope.expand(b, n_heads, kv_len, rope_dim)],
                  dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    scale = qd ** -0.5

    if cache is None:
        out = A.sdpa(qfull, k, v, is_causal=causal, scale=scale,
                     backend=backend)
    elif plan == "context":
        out = _merged_decode(qfull, k, v, kv_len, scale, None, backend)
    else:
        out = A.decode_attention(qfull, k, v, cache_len=kv_len, scale=scale,
                                 backend=backend)
    out = out.transpose(1, 2).reshape(b, s, n_heads * v_dim)
    return out @ p["wo"], cache


def _slots_from(cache: Params, split: bool) -> int:
    """The first slot of an MLA cache this rank holds: r L of a cache
    whose L slots a rank are split over ``model`` (``split``), else 0."""
    return AS.model_rank() * cache["c_kv"].shape[1] if split else 0


# ----------------------------------------------------------------------
# FFN
# ----------------------------------------------------------------------


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


def mlp(p: Params, x: torch.Tensor, activation: str = "silu",
        split: bool = False, seq: bool = False) -> torch.Tensor:
    """The dense FFN.  With ``split`` (a mesh's layer plan), this rank's
    hidden columns (``w_up``/``w_gate`` by columns, ``w_down`` by rows)
    and the partial outputs summed over ``model``.  ``seq``: ``x`` is the
    rank's rows of a sequence-sharded stream, and so is the output (split,
    the rows are gathered first and the partial outputs reduce-scattered
    back to them; else the rank runs its rows)."""
    if split:
        x = AS.copy_to_model(x, seq)
    up = x @ p["w_up"]
    if "w_gate" in p:
        h = _act(x @ p["w_gate"], activation) * up
    else:
        h = _act(up, activation)
    if seq and not split:
        # the rank's rows: btf's layout under REPRO_SEQ_SHARD (a no-op).
        # A hidden over the whole sequence keeps the plan's layout: the
        # spec's without the switch, and under it the departure that
        # act_sharding's docstring records
        h = AS.constrain(h, "btf", have=1)
    out = h @ p["w_down"]
    return AS.reduce_from_model(out, seq) if split else out


# ----------------------------------------------------------------------
# MoE: GShard-style capacity dispatch
# ----------------------------------------------------------------------


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype, device, gated: bool = True, n_shared: int = 0,
             d_ff_shared: Optional[int] = None,
             n_padded: Optional[int] = None, keep: Keep = whole) -> Params:
    """The reference's shapes and per-leaf dtypes
    (``repro/models/layers.py:302-326``): the router (D, E) in fp32, the
    (slots, in, out) expert weights and the shared MLP in ``dtype``.
    Each expert is drawn on its own and written into the stacked weight,
    so the fp32 draw of a whole (slots, in, out) weight is never held."""
    n_slots = n_padded or n_experts     # padded slots never receive tokens

    def experts(name, i, o):
        w = torch.empty((n_slots, i, o), dtype=dtype, device=device)
        for e in range(n_slots):
            w[e] = dense_init(gen, i, o, dtype, device)
        return keep(name, w)

    p = {"router": keep("router", dense_init(gen, d_model, n_experts,
                                             torch.float32, device)),
         "w_up": experts("w_up", d_model, d_ff),
         "w_down": experts("w_down", d_ff, d_model)}
    if gated:
        p["w_gate"] = experts("w_gate", d_model, d_ff)
    if n_shared:
        p["shared"] = mlp_init(gen, d_model, d_ff_shared or d_ff * n_shared,
                               dtype, device, gated=gated,
                               keep=lambda n, t: keep(f"shared/{n}", t))
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal values (``torch.topk`` promises no order on
    ties; a stable descending sort keeps it)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(p: Params, x: torch.Tensor, *, top_k: int, n_experts: int,
        capacity_factor: float = 1.25, activation: str = "silu",
        n_padded: Optional[int] = None, plan: str = "one",
        shared_split: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style grouped token-choice top-k with per-group capacity
    (``repro/models/layers.py:329-420``).  Returns (output (B, S, D),
    Switch aux loss, an fp32 scalar).

    Tokens are split into G groups and each group routes on its own with
    capacity ``C = min(max(1, int(cf * Tg * k / E)), Tg)``; a (token,
    choice) past its expert's capacity, in token-major then choice order,
    is dropped.  The group count follows the reference's rule: groups of
    ``REPRO_MOE_GROUP_TOKENS`` tokens (default 1024; 0 for one group),
    then the largest count that divides the tokens, over the tokens the
    rank holds (in a mesh scope its data shard's: the reference's groups
    per data shard); the balance loss's means run over every data
    shard's groups, as the reference's do.  One-hots and gates
    are in x's dtype, router logits and probabilities in fp32.  As in the
    reference every expert runs on its (G, C) slots, so each call reads
    every expert's weights; dead padded slots (``n_padded``) are never
    routed to.

    ``plan`` (a mesh's ``LayerPlan.moe``): ``"experts"``, the rank holds
    ``E / model`` experts and runs them on its rows of the dispatched
    tokens, and their outputs are gathered whole along E; ``"hidden"``,
    the rank holds every expert's share of the hidden columns, and the
    experts' partial outputs are summed over ``model``.  Either way the
    router, top-k, dispatch and combine run whole on every rank of a
    model group (they hold the same tokens), so the router's gradient is
    whole on every rank beside the aux loss's; the dispatched tokens'
    gradient, each rank's part, is summed over ``model``.
    ``shared_split``: the shared expert runs split as the dense MLP."""
    b, s, d = x.shape
    t = b * s
    tgt = int(os.environ.get("REPRO_MOE_GROUP_TOKENS", "1024"))
    g = t // tgt if 0 < tgt < t else 1
    while t % g:
        g -= 1
    tg = t // g
    xt = x.reshape(g, tg, d)

    probs = torch.softmax(xt.float() @ p["router"], dim=-1)   # (G, Tg, E)
    e_slots = n_padded or n_experts
    if e_slots != n_experts:
        probs = F.pad(probs, (0, e_slots - n_experts))
    gate_vals, gate_idx = _top_k(probs, top_k)                # (G, Tg, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    capacity = min(max(1, int(capacity_factor * tg * top_k / n_experts)),
                   tg)

    # position of each (token, choice) in its expert's queue, per group
    onehot = F.one_hot(gate_idx, e_slots)                     # (G,Tg,k,E)
    flat = onehot.reshape(g, tg * top_k, e_slots)
    pos = ((flat.cumsum(1) - flat).reshape(g, tg, top_k, e_slots)
           * onehot).sum(-1)                                  # (G, Tg, k)
    kept = pos < capacity

    # dispatch / combine (G, Tg, E, C); a slot one-hot is all zeros past
    # the capacity, as jax.nn.one_hot is
    slot = pos[..., None] == torch.arange(capacity, device=x.device)
    disp = (onehot.to(x.dtype)[..., None] * slot.to(x.dtype)[..., None, :]
            * kept[..., None, None].to(x.dtype))             # (G,Tg,k,E,C)
    dispatch = disp.sum(2)
    combine = (disp * gate_vals[..., None, None].to(x.dtype)).sum(2)

    split = plan in ("experts", "hidden")
    e_have = 1 if plan == "experts" else None     # E split over model
    f_have = 3 if plan == "hidden" else None      # F split over model
    xd = AS.copy_to_model(xt) if split else xt
    if plan == "experts":
        lo, hi = AS.model_slice(e_slots)
        dispatch = dispatch[:, :, lo:hi]
    e_loc = dispatch.shape[2]

    # the two einsums are profiled as one range, read by chip_smoke.py
    def constrain(t, kind, have):
        # t is expert-major, (E, G, C, .); the reference's layout is
        # (G, E, C, .): viewed as that, constrained, viewed back
        return AS.constrain(t.movedim(1, 0), kind, experts=e_slots,
                            have=have).movedim(0, 1)

    with torch.profiler.record_function("moe_dispatch_combine"):
        expert_in = constrain(torch.einsum("gtec,gtd->egcd", dispatch, xd),
                              "gecd", e_have).reshape(e_loc, g * capacity, d)
    up = expert_in @ p["w_up"]                                # (E, GC, F)
    if "w_gate" in p:
        h = _act(expert_in @ p["w_gate"], activation) * up
    else:
        h = _act(up, activation)
    h = constrain(h.view(e_loc, g, capacity, -1), "gecf",
                  e_have or f_have).reshape(e_loc, g * capacity, -1)
    expert_out = (h @ p["w_down"]).reshape(e_loc, g, capacity, d)
    if plan == "hidden":
        expert_out = AS.reduce_from_model(expert_out)
    expert_out = constrain(expert_out, "gecd", e_have)
    if plan == "experts":
        # every rank combines every expert's output: gathered whole, the
        # backward takes the rank's experts' slice
        expert_out = C.gather_whole(expert_out, AS.model_group(), 0)
    with torch.profiler.record_function("moe_dispatch_combine"):
        yt = torch.einsum("gtec,egcd->gtd", combine, expert_out)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    density = onehot.sum(2).float().mean((0, 1))              # (E,)
    router_prob = probs.mean((0, 1))
    mesh = AS.spmd()
    if mesh is not None and mesh.data_size > 1:
        # the reference's means run over every data shard's groups
        for group in AS.data_groups():
            density = C.all_reduce_sum(density.clone(), group)
            router_prob = C.reduce_both(router_prob, group)
        density = density / mesh.data_size
        router_prob = router_prob / mesh.data_size
    aux = 0.01 * n_experts * torch.sum(
        density[:n_experts] * router_prob[:n_experts])

    y = yt.reshape(b, s, d)
    if "shared" in p:
        y = y + mlp(p["shared"], x, activation, shared_split)
    return y, aux


# ----------------------------------------------------------------------
# Mamba (selective SSM): Jamba's mixer
# ----------------------------------------------------------------------


def mamba_init(gen: torch.Generator, d_model: int, *, d_state: int = 16,
               d_conv: int = 4, expand: int = 2, dtype=torch.bfloat16,
               device=None, keep: Keep = whole) -> Params:
    """The reference's shapes and per-leaf dtypes
    (``repro/models/layers.py:425-447``): projections, ``conv_w`` and
    ``conv_b`` in ``dtype``; ``dt_bias``, ``A_log``, ``D`` and ``norm``
    in fp32."""
    d_inner = expand * d_model
    dt_rank = max(1, d_model // 16)
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((d_conv, d_inner), generator=gen, **f32)
    dt_init = torch.rand((d_inner,), generator=gen, **f32) * 0.1
    # a dict display evaluates in order: each leaf is kept before the
    # next is drawn
    return {
        "in_proj": keep("in_proj", dense_init(gen, d_model, 2 * d_inner,
                                              dtype, device)),
        "conv_w": keep("conv_w", (conv_w / math.sqrt(d_conv)).to(dtype)),
        "conv_b": keep("conv_b", torch.zeros((d_inner,), dtype=dtype,
                                             device=device)),
        "x_proj": keep("x_proj", dense_init(gen, d_inner,
                                            dt_rank + 2 * d_state, dtype,
                                            device)),
        "dt_proj": keep("dt_proj", dense_init(gen, dt_rank, d_inner, dtype,
                                              device)),
        "dt_bias": keep("dt_bias", torch.log(torch.expm1(
            dt_init.clamp(1e-3, 0.1)))),
        "A_log": keep("A_log", torch.log(torch.arange(
            1, d_state + 1, **f32)).expand(d_inner, d_state).contiguous()),
        "D": keep("D", torch.ones((d_inner,), **f32)),
        "out_proj": keep("out_proj", dense_init(gen, d_inner, d_model,
                                                dtype, device)),
        "norm": keep("norm", torch.ones((d_inner,), **f32)),
    }


def mamba(p: Params, x: torch.Tensor, *, d_state: int = 16,
          d_conv: int = 4, expand: int = 2,
          cache: Optional[Params] = None, backend: str = "auto",
          plan: str = "one", seq: bool = False
          ) -> Tuple[torch.Tensor, Optional[Params]]:
    """The Mamba mixer (``repro/models/layers.py:473-535``; pre-norm by
    the caller, which adds the residual).  x: (B, S, D).

    Without ``cache``: prefill from a zero state.  With ``cache``
    ({"conv": (B, d_conv - 1, Di) in the activation dtype, "ssm": (B, Di,
    N) fp32}): the sequence continues from it, and the cache is updated in
    place (the reference returns a new one); the returned cache holds the
    same tensors.  The causal depthwise conv is a sum of d_conv shifted
    slices accumulated in fp32 and rounded once, as the reference's
    einsum over the windows is (no cuDNN convolution, so no TF32 either).
    The scan is ``kernels.ops.mamba_scan`` in prefill and in decode, from
    the cached state; ``backend`` is validated and selects nothing.

    ``plan == "channels"`` (a mesh's ``LayerPlan.mixer``): the rank runs
    its channels of d_inner.  ``in_proj`` comes whole and the rank takes
    its x and z columns; the per-channel leaves, ``dt_proj``, ``A_log``
    and the cache come as the rank's channels; ``x_proj`` as its rows,
    whose partial product is summed over ``model`` (dt's low rank, B and
    C whole on every rank); the gated norm's mean square is over every
    rank's channels; ``out_proj``'s partial product is reduced.  With
    ``seq`` (that plan on a sequence-sharded stream) ``x`` is the rank's
    rows: gathered whole along the sequence first, and the partial output
    reduce-scattered back to the rows."""
    A._check_backend("mamba", backend)
    split = plan == "channels"
    if split:
        x = AS.copy_to_model(x, seq)
    b, s, d = x.shape
    dt_rank = max(1, d // 16)

    if split:
        w = p["in_proj"]                                  # (D, 2 Di) whole
        lo, hi = AS.model_slice(w.shape[1] // 2)
        xi = x @ w[:, lo:hi]
        z = x @ w[:, w.shape[1] // 2 + lo:w.shape[1] // 2 + hi]
    else:
        xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)       # (B, S, Di)
    prev = (cache["conv"] if cache is not None else
            xi.new_zeros((b, d_conv - 1, xi.shape[-1])))
    pad = torch.cat([prev.to(xi.dtype), xi], dim=1)      # (B, K-1+S, Di)
    pad32, w = pad.float(), p["conv_w"].float()
    acc = pad32[:, :s] * w[0]
    for k in range(1, d_conv):
        acc = acc + pad32[:, k:k + s] * w[k]
    xc = F.silu(acc.to(x.dtype) + p["conv_b"])

    proj = xc @ p["x_proj"]                               # (B, S, R+2N)
    if split:
        proj = AS.sum_over_model(proj)
    dt = F.softplus(proj[..., :dt_rank] @ p["dt_proj"]
                    + p["dt_bias"].to(x.dtype))           # (B, S, Di)
    bm = proj[..., dt_rank:dt_rank + d_state]   # views: the kernel reads
    cm = proj[..., dt_rank + d_state:]          # them through their strides
    y, h = kops.mamba_scan(xc, dt, bm, cm, -torch.exp(p["A_log"]), p["D"],
                           cache["ssm"] if cache is not None else None)

    y = (rms_norm_split(y, p["norm"]) if split
         else rms_norm(y, p["norm"])) * F.silu(z)
    out = y @ p["out_proj"]
    if split:
        out = AS.reduce_from_model(out, seq)
    if cache is None:
        return out, None
    cache["conv"].copy_(pad[:, pad.shape[1] - (d_conv - 1):])
    cache["ssm"].copy_(h)
    return out, cache


# ----------------------------------------------------------------------
# RWKV-6 ("Finch"): data-dependent decay linear attention
# ----------------------------------------------------------------------


def rwkv6_init(gen: torch.Generator, d_model: int, *, head_dim: int = 64,
               lora_r: int = 64, dtype=torch.bfloat16, device=None,
               keep: Keep = whole) -> Params:
    """The reference's shapes and per-leaf dtypes
    (``repro/models/layers.py:540-569``): the token-shift mixes ``mu_*``
    and ``cm_mu_k`` (1-D) and every matrix in ``dtype``; ``decay_base``,
    ``bonus`` (H, head_dim) and ``ln_out`` in fp32."""
    n_heads = d_model // head_dim
    d_cm = int(3.5 * d_model)

    def mu(name):
        return keep(name, torch.full((d_model,), 0.5, dtype=dtype,
                                     device=device))

    def dense(name, i, o):
        return keep(name, dense_init(gen, i, o, dtype, device))

    return {
        "mu_r": mu("mu_r"), "mu_k": mu("mu_k"), "mu_v": mu("mu_v"),
        "mu_w": mu("mu_w"), "mu_g": mu("mu_g"),
        "w_r": dense("w_r", d_model, d_model),
        "w_k": dense("w_k", d_model, d_model),
        "w_v": dense("w_v", d_model, d_model),
        "w_g": dense("w_g", d_model, d_model),
        "w_o": dense("w_o", d_model, d_model),
        # data-dependent decay LoRA: w_t = exp(-exp(base + lora(x)))
        "decay_base": keep("decay_base", torch.full(
            (d_model,), -6.0, dtype=torch.float32, device=device)),
        "decay_a": dense("decay_a", d_model, lora_r),
        "decay_b": dense("decay_b", lora_r, d_model),
        "bonus": keep("bonus", torch.randn(
            (n_heads, head_dim), generator=gen, dtype=torch.float32,
            device=device) * 0.02),
        "ln_out": keep("ln_out", torch.ones((d_model,), dtype=torch.float32,
                                            device=device)),
        # channel mix (the FFN half of the block)
        "cm_mu_k": mu("cm_mu_k"),
        "cm_k": dense("cm_k", d_model, d_cm),
        "cm_v": dense("cm_v", d_cm, d_model),
        "cm_r": dense("cm_r", d_model, d_model),
    }


def _token_shift(x: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x[t-1] along dim 1: zeros, or ``prev`` (B, 1, D) read in x's
    dtype, at t=0."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _shift_row(row: torch.Tensor, d: int) -> torch.Tensor:
    """A cached token-shift row (B, 1, D) read whole: a row ``cache_specs``
    splits over ``model`` is gathered."""
    if row.shape[-1] == d:
        return row
    return C.all_gather_cat(row, AS.model_group(), 2)


def _keep_row(row: torch.Tensor, last: torch.Tensor) -> None:
    """Write ``last`` (B, 1, D) into the cached row: the rank's slice of it
    where the row is split over ``model``."""
    if row.shape[-1] != last.shape[-1]:
        lo, hi = AS.model_slice(last.shape[-1])
        last = last[..., lo:hi]
    row.copy_(last)


def rwkv6(p: Params, x: torch.Tensor, *, head_dim: int = 64,
          cache: Optional[Params] = None, backend: str = "auto",
          plan: str = "one", cm_split: bool = False
          ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Time mix + channel mix of the RWKV-6 block (pre-norm applied by the
    caller; the caller adds the residual).  x: (B, S, D).

    Without ``cache``: prefill from a zero state.  With ``cache``
    ({"wkv": (B, H, hd, hd) fp32, "shift", "cm_shift": (B, 1, D)}): the
    sequence continues from it, and the cache is updated in place (the
    reference returns a new one): each entry is read before it is
    overwritten, and the returned cache holds the same tensors.  The
    shift rows are kept in the activation dtype (the reference returns
    them as ``x[:, -1:]``), whatever the cache's dtype.

    The decays are rounded to x's dtype before the recurrence, as the
    reference does (``w.astype(x.dtype)``); at bf16 this maps every
    ``w_log`` below about -6.24 to a decay of exactly 1.0.  ``backend``
    is validated and selects nothing: every call, prefill and decode,
    goes through ``kernels.ops.rwkv6_scan``.

    ``plan == "channels"`` (a mesh's ``LayerPlan.mixer``): the rank runs
    its heads.  ``w_r``/``w_k``/``w_v``/``w_g`` and ``decay_b`` come as
    its channels' columns, ``bonus``, ``decay_base``, ``ln_out`` and the
    ``wkv`` state as its heads, ``w_o`` as its rows (the partial product
    reduced over ``model``); ``ln_out``'s mean square is over every
    rank's channels.  ``cm_split``: the channel mix's ``cm_k`` columns and
    ``cm_v`` rows are the rank's (its partial product reduced);
    ``cm_r`` is whole.  Token-shift rows the cache splits over ``model``
    are gathered to read and sliced to write."""
    A._check_backend("rwkv6", backend)
    b, s, d = x.shape
    split = plan == "channels"

    prev = _shift_row(cache["shift"], d) if cache is not None else None
    # the time mix feeds the rank's own heads: its gradient is summed
    xt = AS.copy_to_model(x) if split else x
    xs = _token_shift(xt, prev)

    def mix(mu):
        return xt + (xs - xt) * mu

    r = mix(p["mu_r"]) @ p["w_r"]
    k = mix(p["mu_k"]) @ p["w_k"]
    v = mix(p["mu_v"]) @ p["w_v"]
    g = F.silu(mix(p["mu_g"]) @ p["w_g"])
    w_log = p["decay_base"] + (torch.tanh(mix(p["mu_w"]) @ p["decay_a"])
                               @ p["decay_b"]).float()
    w = torch.exp(-torch.exp(w_log))                     # (B, S, D) fp32
    d_loc = r.shape[-1]                                  # the rank's channels
    n_heads = d_loc // head_dim

    def heads(t):    # a view: the kernel reads it through its strides
        return t.view(b, s, n_heads, head_dim).transpose(1, 2)

    out, state = kops.rwkv6_scan(
        heads(r), heads(k), heads(v), heads(w.to(x.dtype)), p["bonus"],
        cache["wkv"] if cache is not None else None)
    out = out.transpose(1, 2).reshape(b, s, d_loc)     # a view on CUDA
    normed = (rms_norm_split(out, p["ln_out"]) if split
              else rms_norm(out, p["ln_out"]))
    tm_out = (normed * g) @ p["w_o"]
    if split:
        tm_out = AS.reduce_from_model(tm_out)

    # channel mix
    y = x + tm_out
    ys = _token_shift(y, _shift_row(cache["cm_shift"], d)
                      if cache is not None else None)
    xk = y + (ys - y) * p["cm_mu_k"]
    if cm_split:
        xk = AS.copy_to_model(xk)
    cm = torch.square(F.relu(xk @ p["cm_k"])) @ p["cm_v"]
    if cm_split:
        cm = AS.reduce_from_model(cm)
    cm = torch.sigmoid(y @ p["cm_r"]) * cm
    out_final = tm_out + cm

    if cache is None:
        return out_final, None
    cache["wkv"].copy_(state)
    _keep_row(cache["shift"], x[:, -1:])
    _keep_row(cache["cm_shift"], y[:, -1:])
    return out_final, cache
