"""Step builders: prefill and decode (counterpart of
``repro/launch/train.py::make_prefill_step`` / ``make_serve_step``).

The reference wraps each step in ``jax.jit`` with parameter and cache
shardings over a device mesh and donates the cache.  The port runs
eagerly on one device: meshes and shardings are dropped (sharding is
ROADMAP.md queue A, item 9), and donation becomes the in-place cache
update of ``lm.decode_step``.  ``make_train_step`` and ``train_loop``
come with the training slice (ROADMAP.md queue A, item 10).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from .. import resolve_device
from ..models import lm as LM


def make_prefill_step(cfg: LM.LMConfig, device=None) -> Callable:
    """Returns ``prefill(params, batch) -> logits (B, S, V)``, where
    ``batch`` holds ``"tokens"`` (B, S) or ``"embeds"`` (B, S, D).  Runs
    ``lm.forward`` without autograd on ``device`` (default CUDA); inputs
    on another device are moved there."""
    LM._check_supported(cfg)
    dev = resolve_device(device)

    def prefill(params: LM.Params, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        tokens, embeds = batch.get("tokens"), batch.get("embeds")
        with torch.no_grad():
            logits, _ = LM.forward(
                cfg, params,
                tokens=None if tokens is None else tokens.to(dev),
                embeds=None if embeds is None else embeds.to(dev))
        return logits

    return prefill


def make_serve_step(cfg: LM.LMConfig, *, batch: int, max_seq: int,
                    cache_dtype: torch.dtype = torch.bfloat16,
                    device=None) -> Callable:
    """Returns ``serve_step(params, cache, tokens, pos) -> (logits (B, 1,
    V), cache)``: one token per row at the host int position ``pos``,
    written into the cache in place.  The cache is
    ``lm.init_cache(cfg, batch, max_seq, cache_dtype, device)``; the step
    checks its shape and that ``pos`` lies inside it, where the
    reference's ``dynamic_update_slice`` would clamp the write."""
    LM._check_supported(cfg)
    dev = resolve_device(device)
    shape = (batch, cfg.n_kv_heads, max_seq, cfg.hd)

    def serve_step(params: LM.Params, cache: LM.Cache,
                   tokens: torch.Tensor, pos: int):
        c0 = cache[0]["k"]
        if tuple(c0.shape) != shape or c0.dtype != cache_dtype or \
                c0.device.type != dev.type:
            raise ValueError(f"serve_step: cache {tuple(c0.shape)} "
                             f"{c0.dtype} on {c0.device} is not the "
                             f"{shape} {cache_dtype} cache on {dev} this "
                             f"step was built for")
        if not 0 <= pos < max_seq:
            raise ValueError(f"serve_step: position {pos} outside the "
                             f"cache (max_seq {max_seq})")
        with torch.no_grad():
            return LM.decode_step(cfg, params, cache, tokens.to(dev), pos)

    return serve_step
