"""Step builders: prefill and decode (counterpart of
``repro/launch/train.py::make_prefill_step`` / ``make_serve_step``).

The reference wraps each step in ``jax.jit`` with parameter and cache
shardings over a device mesh and donates the cache.  The port runs
eagerly on one device: meshes and shardings are dropped (sharding is
ROADMAP.md queue A7), and donation becomes the in-place cache
update of ``lm.decode_step``.  ``make_train_step`` and ``train_loop``
come with the training slice (ROADMAP.md queue A5).
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
    ``lm.init_cache(cfg, batch, max_seq, cache_dtype, device)``.  Each
    step checks its layer count, and the entries (names, shapes, dtypes,
    device) of the first layer of each kind of block against that layout,
    whatever the mixer.  Where a layer caches keys by position, ``pos``
    must lie inside ``max_seq``, where the reference's
    ``dynamic_update_slice`` would clamp the write; a recurrent state
    (rwkv) holds no positions, and there ``pos`` need only be >= 0."""
    layout = LM.cache_layout(cfg, batch, max_seq, cache_dtype)
    dev = resolve_device(device)
    probes = [i for i, entry in enumerate(layout)
              if entry not in layout[:i]]
    positional = any(spec.mixer not in ("rwkv", "mamba")
                     for spec in cfg.layer_specs())

    def check(cache: LM.Cache) -> None:
        got = {i: {n: (tuple(t.shape), t.dtype)
                   for n, t in cache[i].items()}
               for i in probes if i < len(cache)}
        if len(cache) != len(layout) or \
                any(got[i] != layout[i] for i in probes) or \
                any(t.device.type != dev.type
                    for i in probes for t in cache[i].values()):
            raise ValueError(f"serve_step: cache ({len(cache)} layers, "
                             f"first {got.get(0)}) is not the {cfg.name} "
                             f"cache ({len(layout)} layers, first "
                             f"{layout[0]}) on {dev} this step was built "
                             f"for")

    def serve_step(params: LM.Params, cache: LM.Cache,
                   tokens: torch.Tensor, pos: int):
        check(cache)
        if pos < 0 or (positional and pos >= max_seq):
            raise ValueError(f"serve_step: position {pos} outside the "
                             f"cache (max_seq {max_seq})")
        with torch.no_grad():
            return LM.decode_step(cfg, params, cache, tokens.to(dev), pos)

    return serve_step
