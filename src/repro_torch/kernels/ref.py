"""Plain PyTorch oracles for every kernel (the allclose ground truth),
under the names and argument conventions of ``repro/kernels/ref.py``.

Each calls the port's plain version of the kernel (``*_plain``) after
putting its operands in that version's layout: the kernels group the
query heads by KV head and flatten (batch, head), where the reference's
oracles take the model's (B, H, S, D) layouts; ``mamba_scan`` returns
``y`` alone, as the reference's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .decode_attention import decode_attention_plain, paged_attention_plain
from .flash_attention import flash_attention_plain
from .mamba import mamba_scan_plain
from .rwkv6 import rwkv6_scan_plain


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) — GQA broadcast inside."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    out = flash_attention_plain(
        q.reshape(b * hq, sq, d), k.reshape(b * hkv, skv, d),
        v.reshape(b * hkv, skv, d), causal=causal,
        scale=scale if scale is not None else d ** -0.5, window=window)
    return out.reshape(b, hq, sq, d)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, 1, D) against a (B, Hkv, Smax, D) cache filled up to
    ``cache_len`` (an int or a (B,) tensor)."""
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    lens = torch.as_tensor(cache_len, device=q.device).to(
        torch.int32).reshape(-1).expand(b)
    out = decode_attention_plain(
        q.reshape(b, hkv, hq // hkv, d), k_cache, v_cache, lens,
        scale=scale if scale is not None else d ** -0.5, window=window)
    return out.reshape(b, hq, 1, d)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, tables: torch.Tensor,
                    seg_ids: torch.Tensor, positions: torch.Tensor,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q: (T, Hq, D) vs the physical page pool (N, ps, Hkv, D) via (S, P)
    block tables: gather, then attend.  A quantized pool passes its (N,
    ps, Hkv) fp32 ``k_scale``/``v_scale``: the pages are dequantized
    before the gather."""
    t, hq, d = q.shape
    hkv = k_pages.shape[2]
    out = paged_attention_plain(
        q.reshape(t, hkv, hq // hkv, d), k_pages, v_pages, tables, seg_ids,
        positions, scale=scale if scale is not None else d ** -0.5,
        window=window, k_scale=k_scale, v_scale=v_scale)
    return out.reshape(t, hq, d)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B, H, S, D); u: (H, D).  Returns (out, final_state)."""
    return rwkv6_scan_plain(r, k, v, w, u)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, A: torch.Tensor,
               D: torch.Tensor) -> torch.Tensor:
    """x/dt: (B, S, Di); B/C: (B, S, N); A: (Di, N); D: (Di,)."""
    return mamba_scan_plain(x, dt, B, C, A, D)[0]
