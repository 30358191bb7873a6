"""Speculative-decoding proposers for the serving scheduler.

Copied from ``repro/serving/spec.py``; :class:`DraftModelProposer` runs
the port's ``lm.forward``, so on the card every draft forward goes
through the flash kernel.

Decode throughput is bounded by one ``unified_step`` per token per
sequence.  A proposer breaks that bound: it guesses ``k`` draft tokens
for a decoding sequence from host-side evidence, the scheduler feeds
``pending + drafts`` as ONE multi-token span (the flat token batch
already mixes multi-token and single-token segments — chunked prefill
proved the shape), the executor samples a target token at every draft
position in the same jitted call, and the scheduler commits the longest
prefix where target == draft plus the first correction token.

Exactness is the correctness anchor, not a best-effort approximation:
because the sampler's PRNG key depends only on ``(seed, position)``
(see ``sampling.py``), the token sampled at a position inside a
speculative batch is IDENTICAL to the token a non-speculative step
would sample there — for greedy and for temperature/top-k/top-p alike.
A wrong draft costs wasted compute, never a changed output;
``metrics["accepted_tokens"] / metrics["proposed_tokens"]`` is the
first-class observability signal for how much of the speculative work
paid off.

Proposers are host Python (control plane) behind one interface:

  * :class:`NgramProposer` — prompt-lookup decoding: match the
    sequence's own trailing n-gram against its earlier history and
    propose the continuation.  Free (no model), and strong on
    repeat-heavy text (code, retrieval-augmented prompts, the argmax
    cycles small models fall into);
  * :class:`DraftModelProposer` — greedy drafts from a (smaller) LM over
    the history tail;
  * :class:`FixedProposer` — deterministic drafts for tests (force
    all-reject / all-accept interleavings).
"""

from __future__ import annotations

from typing import List, Protocol, Sequence, runtime_checkable

import torch

__all__ = ["Proposer", "NgramProposer", "DraftModelProposer",
           "FixedProposer"]


@runtime_checkable
class Proposer(Protocol):
    """Anything with ``propose(history, k) -> up to k draft tokens``.

    ``history`` is the request's full token history
    (``prompt + out_tokens``); the return value may be shorter than
    ``k`` (including empty — "no guess", which costs nothing)."""

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """Return up to ``k`` draft tokens continuing ``history``."""
        ...


class NgramProposer:
    """Prompt-lookup proposer: find the most recent earlier occurrence
    of the trailing ``n``-gram (longest match first, down to
    ``min_n``) and propose the tokens that followed it."""

    def __init__(self, n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= n:
            raise ValueError(f"need 1 <= min_n <= n, got {min_n}, {n}")
        self.n = n
        self.min_n = min_n

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """Scan ``history`` for its own trailing n-gram; on a match at
        ``i`` propose the continuation ``history[i+n:]``, extended
        cyclically to ``k`` tokens.  A match ``q = |h| - n - i`` tokens
        back implies period ``q``, so the predicted token at future
        offset ``m`` is ``h[|h| + m - q]`` — which IS the cyclic
        extension of the matched continuation (without it, a period-1
        loop would yield a single draft per step no matter how large
        ``k`` is).  Deterministic, O(n·|h|) per call, empty when
        nothing matches."""
        h = list(history)
        if k <= 0 or len(h) < self.min_n + 1:
            return []
        for n in range(min(self.n, len(h) - 1), self.min_n - 1, -1):
            tail = h[-n:]
            # most recent earlier occurrence wins (locality: decode
            # loops repeat their own recent past)
            for i in range(len(h) - n - 1, -1, -1):
                if h[i:i + n] == tail:
                    span = h[i + n:]
                    if span:
                        return [span[m % len(span)] for m in range(k)]
        return []


class DraftModelProposer:
    """Greedy drafts from a (smaller) LM over the history tail.

    The two-model scheme behind the same ``Proposer`` interface: runs
    ``lm.forward`` over the last ``window`` tokens and extends greedily
    ``k`` times, on the device of the draft's params.  Host-blocking (one
    token id comes back per draft) — meant for small draft configs."""

    def __init__(self, cfg, params, window: int = 64):
        self.cfg = cfg
        self.params = params
        self.window = window

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """Autoregressive greedy continuation of ``history`` under the
        draft model; returns ``k`` tokens (or [] for empty history)."""
        from ..models.lm import forward
        if k <= 0 or not history:
            return []
        dev = self.params["embed"].device
        toks = list(history)
        out: List[int] = []
        with torch.no_grad():
            for _ in range(k):
                ctx = torch.tensor([toks[-self.window:]], dtype=torch.long,
                                   device=dev)
                logits, _ = forward(self.cfg, self.params, ctx)
                nxt = int(torch.argmax(logits[0, -1]))
                out.append(nxt)
                toks.append(nxt)
        return out


class FixedProposer:
    """Always proposes a fixed draft list (truncated to ``k``) — the
    test hook for forcing accept/reject interleavings."""

    def __init__(self, drafts: Sequence[int]):
        self.drafts = list(drafts)

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """Return the configured drafts, clipped to ``k``."""
        return self.drafts[:k]
