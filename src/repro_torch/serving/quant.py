"""KV quantization math, in PyTorch.

Counterpart of ``repro/serving/quant.py``.  The paged KV cache stores
int8 / fp8_e4m3 CODES in the page arrays and fp32 SCALES in parallel
``(num_pages, page_size, n_kv_heads)`` arrays beside them; scale
granularity is per (token, kv-head), one absmax scale per written K/V
vector.  Scheme: symmetric absmax, ``scale = max|x| / QMAX`` over
head_dim, ``code = round(x / scale)`` clipped to ±127 (int8, rounding
half to even like ``jnp.round``) or cast to ``torch.float8_e4m3fn``
(QMAX 448, the format's largest finite value); ``dequant = code *
scale``.  An all-zero vector stores scale 0 and dequantizes to zeros.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

QMAX = {"int8": 127.0, "fp8_e4m3": 448.0}

_ALIASES = {"fp8": "fp8_e4m3", "float8": "fp8_e4m3",
            "float8_e4m3fn": "fp8_e4m3"}


def canonical(kv_dtype: Optional[str]) -> Optional[str]:
    """``None`` for an unquantized pool (``None``/"fp32"/"float32"/
    "bf16"/"bfloat16"), else "int8" / "fp8_e4m3"."""
    if kv_dtype is None or kv_dtype in ("fp32", "float32", "bf16",
                                        "bfloat16"):
        return None
    mode = _ALIASES.get(kv_dtype, kv_dtype)
    if mode not in QMAX:
        raise ValueError(
            f"unknown kv_dtype {kv_dtype!r}; expected one of "
            f"fp32, int8, fp8_e4m3")
    return mode


def storage_dtype(mode: str) -> torch.dtype:
    """The pool tensor dtype for a quantization mode."""
    return torch.int8 if mode == "int8" else torch.float8_e4m3fn


def quantize(x: torch.Tensor, mode: str
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x``: (..., head_dim) float.  Returns ``(codes, scales)``: codes
    (..., head_dim) in the storage dtype, scales (...,) fp32."""
    x = x.float()
    qmax = QMAX[mode]
    scale = x.abs().amax(dim=-1) / qmax
    y = x / torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    if mode == "int8":
        codes = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        codes = y.to(storage_dtype(mode))
    return codes, scale


def dequantize(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(..., hd) codes × (...,) scales -> (..., hd) fp32."""
    return codes.float() * scales[..., None]
