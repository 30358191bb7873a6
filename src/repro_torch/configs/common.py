"""Shared machinery of the architecture configs, in torch dtypes.

Counterpart of ``repro/configs/common.py``.  Every arch module defines:

  CONFIG  -- the published configuration (``LMConfig``)
  SMOKE   -- a reduced config of the same family for CPU tests
  SHAPES  -- ``{shape_name: ShapeSpec | SkipSpec}``

:func:`input_specs` gives one cell's inputs as tensors on the ``meta``
device: the shapes and dtypes of the real batch, with no memory behind
them (the reference returns ``jax.ShapeDtypeStruct`` stand-ins).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ..models.lm import LMConfig


@dataclass(frozen=True)
class ShapeSpec:
    kind: str              # train | prefill | decode
    seq_len: int
    global_batch: int


@dataclass(frozen=True)
class SkipSpec:
    reason: str


TRAIN_4K = ShapeSpec("train", 4096, 256)
PREFILL_32K = ShapeSpec("prefill", 32768, 32)
DECODE_32K = ShapeSpec("decode", 32768, 128)
LONG_500K = ShapeSpec("decode", 524288, 1)


def lm_shapes(*, long_ok: bool, long_reason: str = "",
              decode_ok: bool = True,
              decode_reason: str = "") -> Dict[str, object]:
    shapes: Dict[str, object] = {
        "train_4k": TRAIN_4K,
        "prefill_32k": PREFILL_32K,
    }
    shapes["decode_32k"] = DECODE_32K if decode_ok else SkipSpec(
        decode_reason or "encoder-only architecture has no decode step")
    if long_ok:
        shapes["long_500k"] = LONG_500K
    else:
        shapes["long_500k"] = SkipSpec(
            long_reason or "pure full-attention arch: 500k decode KV is "
                           "quadratic-prefill territory; skipped per spec")
    return shapes


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: LMConfig, spec: ShapeSpec) -> Dict[str, torch.Tensor]:
    """``meta`` tensors for one (arch x shape) cell: bf16 ``embeds``
    (B, S, D) for an embeddings-mode arch or int32 ``tokens`` (B, S),
    int32 ``labels`` (B, S) when training; a decode cell is a one-token
    batch and an int32 scalar ``pos`` (the cache is a separate argument,
    ``lm.cache_layout``)."""
    b, s = spec.global_batch, spec.seq_len
    if spec.kind in ("train", "prefill"):
        if cfg.input_mode == "embeddings":
            out = {"embeds": _meta((b, s, cfg.d_model), torch.bfloat16)}
        else:
            out = {"tokens": _meta((b, s), torch.int32)}
        if spec.kind == "train":
            out["labels"] = _meta((b, s), torch.int32)
        return out
    if spec.kind == "decode":
        return {"tokens": _meta((b, 1), torch.int32),
                "pos": _meta((), torch.int32)}
    raise ValueError(spec.kind)
