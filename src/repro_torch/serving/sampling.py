"""Token sampling for the serving executor, on the device.

Counterpart of ``repro/serving/sampling.py``.  Logits never go to the
host: the step's only device-to-host copies are the sampled token ids
and the per-slot fault flags.

Determinism contract.  The reference draws its noise from JAX threefry
keys ``fold_in(key(seed), position)``, which torch cannot reproduce.
What carries over is the contract: the uniform noise for a sampled token
is a function of ``(seed, absolute position)`` only (and of the vocab
lane), so a request replayed on a rebuilt engine, after a preemption, or
inside a speculative batch draws the same token at every position.  The
port's uniforms come from a counter-based hash of
``(seed, position, lane)`` (:func:`position_uniforms`, defined in
``kernels/_noise.py`` and re-exported here), which gives the same bits
on the CPU and on CUDA; on the card the keyed Gumbel kernel draws them
in registers (``kernels.ops.gumbel_perturb_keyed``), so they are never
written to memory.  ``temperature <= 0`` is plain argmax; filtering
keeps ties at the top-k boundary and at the top-p cutoff.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..kernels import ops as kops
from ..kernels._noise import position_uniforms

__all__ = ["SamplingParams", "filter_logits", "sample_tokens",
           "position_uniforms", "sample_ref"]

_NEG_INF = torch.finfo(torch.float32).min
_MIN_TEMP = 1e-6


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    ``temperature <= 0`` means greedy (argmax); ``top_k <= 0`` disables
    the top-k filter; ``top_p >= 1`` disables the nucleus filter.
    ``seed`` roots the request's noise: equal seeds draw identical noise
    at equal positions."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def validate(self) -> "SamplingParams":
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        return self


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Row-wise: temperature-scale ``(R, V)`` logits and set everything
    outside the top-k / top-p support to ``finfo(float32).min``.

    ``top_k`` is a value threshold (the k-th largest scaled logit; ties
    kept); ``top_p`` keeps the smallest sorted prefix whose exclusive
    cumulative probability is below ``top_p``, then thresholds by value
    (ties kept).  ``top_k <= 0`` and ``top_p >= 1`` are no-ops."""
    v = logits.shape[-1]
    scaled = logits.float() / torch.clamp(temperature.float(),
                                          min=_MIN_TEMP)[:, None]
    k_eff = torch.where(top_k > 0, top_k, torch.full_like(top_k, v))
    k_eff = k_eff.clamp(1, v).long()
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = srt.gather(1, (k_eff - 1)[:, None])
    keep = scaled >= kth
    ranks = torch.arange(v, device=logits.device)[None, :]
    in_k = ranks < k_eff[:, None]
    srt_k = torch.where(in_k, srt, torch.full_like(srt, _NEG_INF))
    probs = torch.softmax(srt_k, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = ((cum - probs) < top_p.float()[:, None]) & in_k
    thr = torch.where(keep_sorted, srt_k,
                      torch.full_like(srt_k, float("inf"))).amin(dim=-1)
    keep = keep & (scaled >= thr[:, None])
    return torch.where(keep, scaled, torch.full_like(scaled, _NEG_INF))


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  seeds: torch.Tensor, positions: torch.Tensor,
                  uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample one token per ``(R, V)`` logits row.  Per-row ``(R,)``
    temperature / top_k / top_p / seeds / positions.  Stochastic rows
    take the Gumbel-max draw over the filtered support; rows with
    ``temperature <= 0`` return ``argmax(logits)``.  The noise is keyed
    by ``(seed, position)`` and drawn inside the keyed Gumbel kernel
    (``kernels.ops.gumbel_perturb_keyed``); ``uniform`` (R, V) replaces
    it (tests feed both packages the same numbers) and goes through
    ``kernels.ops.gumbel_perturb``.  Returns (R,) int32."""
    logits = logits.float()
    filtered = filter_logits(logits, temperature, top_k, top_p)
    if uniform is None:
        perturbed = kops.gumbel_perturb_keyed(filtered, seeds, positions)
    else:
        perturbed = kops.gumbel_perturb(filtered, uniform)
    stochastic = torch.argmax(perturbed, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temperature > 0.0, stochastic,
                       greedy).to(torch.int32)


def sample_ref(logits: torch.Tensor, params: SamplingParams, position: int,
               seed: Optional[int] = None) -> int:
    """Host-side single-row reference: the token :func:`sample_tokens`
    draws for one ``(V,)`` logits row at ``position`` under ``params``
    (``seed`` overrides ``params.seed``)."""
    seed = params.seed if seed is None else seed
    logits = torch.as_tensor(logits, dtype=torch.float32)
    dev = logits.device

    def row(x, dtype):
        return torch.tensor([x], dtype=dtype, device=dev)

    tok = sample_tokens(logits[None], row(params.temperature, torch.float32),
                        row(params.top_k, torch.int64),
                        row(params.top_p, torch.float32),
                        row(seed, torch.int64), row(position, torch.int64))
    return int(tok[0])
