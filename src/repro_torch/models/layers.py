"""Functional LM building blocks in PyTorch (params are plain dicts).

Counterpart of ``repro/models/layers.py`` for the attn/dense path.
Layouts are the reference's: linear weights are stored ``(in, out)`` and
applied as ``x @ W``; norm weights and statistics are fp32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# ----------------------------------------------------------------------
# init helpers (explicit generator and device)
# ----------------------------------------------------------------------


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
              n_kv_heads: int, head_dim: int, dtype, device) -> Params:
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype, device),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, dtype, device),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, dtype, device),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, device),
    }


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype, device,
             gated: bool = True) -> Params:
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype, device),
         "w_down": dense_init(gen, d_ff, d_model, dtype, device)}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, device)
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
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


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


def mlp(p: Params, x: torch.Tensor, activation: str = "silu"
        ) -> torch.Tensor:
    up = x @ p["w_up"]
    if "w_gate" in p:
        h = _act(x @ p["w_gate"], activation) * up
    else:
        h = _act(up, activation)
    return h @ p["w_down"]
