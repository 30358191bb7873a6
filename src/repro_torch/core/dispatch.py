"""Signature-keyed eager dispatch cache (the fast path for §5's claim).

Counterpart of ``repro/core/dispatch.py``: the same key, the same
``dispatch_cache_stats()`` keys and ``per_op`` fields.  Each distinct
dispatch *signature*

    (op name, static args, per-input (shape, dtype, device), grad flag)

maps to a cached entry.  The key carries the device type besides the
reference's (shape, dtype), so CPU and CUDA entries never collide.  An
entry holds

  * ``fwd`` — the op's torch function, or, for a fused elementwise chain,
    the chain's generated kernel (``wrap``);
  * its VJP: :func:`partial_vjp` (``torch.func.vjp`` where the reference
    takes ``jax.vjp``).  PyTorch runs eagerly, so there is no executable
    to replay: an op's VJP is taken where it runs forward, keeping the
    residuals ``torch.func`` saves, and only a fused chain's VJP
    recomputes its plain version from the chain's inputs in the backward
    pass (``bwd``), as the reference's cached jitted VJP does.

Cache-key contract: the ``static`` tuple supplied by a call site must
capture everything the op closure depends on besides the tensor
operands.  Call sites that cannot pass ``static=None`` and stay
uncached; unhashable statics take the uncached path and bump
``num_fallback_unhashable`` instead of raising.

Trace-time seeding (``seeding``, ``seed_op``): while
``repro_torch.compile(seed_cache=True)`` traces a function, every op
dispatched with a ``static=`` descriptor pre-creates its eager entry
from the traced signature (``num_seeded``, the per-op ``seeded``
count), so a model traced once starts its eager life warm.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

# ----------------------------------------------------------------------
# stats
# ----------------------------------------------------------------------


@dataclass
class DispatchCacheStats:
    num_hits: int = 0                  # warm dispatch
    num_misses: int = 0                # first-signature dispatch
    num_uncached: int = 0              # no static descriptor supplied
    num_fallback_unhashable: int = 0   # statics present but unhashable
    num_evictions: int = 0             # wholesale clears on overflow
    num_seeded: int = 0                # entries pre-created from traces
    num_entries: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


_PER_OP_FIELDS = ("hits", "misses", "uncached", "fallback_unhashable",
                  "seeded")


# ----------------------------------------------------------------------
# VJPs
# ----------------------------------------------------------------------


def _is_float(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def partial_vjp(fn: Callable, args: Sequence[Any],
                diffable: Sequence[int]):
    """``torch.func.vjp`` of ``fn`` w.r.t. the ``diffable`` argument
    positions only, closing over the rest (integer/bool operands).
    Returns ``(out, vjp_fn)`` where ``vjp_fn`` maps the cotangent of
    ``out`` (a tensor, or a tuple for a tuple output) to cotangents for
    the diffable positions.  Outputs that are not floating point get no
    cotangent (``torch.func.vjp`` takes floating outputs only), and a
    function with none returns ``None`` for every position.  The single
    implementation behind ``_apply_op`` and fused-chain flushes."""
    n = len(args)
    diffable = tuple(diffable)
    frozen = {i: args[i] for i in range(n) if i not in diffable}
    float_idx: list = []

    def fn_split(*diff_args):
        full = [frozen.get(i) for i in range(n)]
        for i, a in zip(diffable, diff_args):
            full[i] = a
        out = fn(*full)
        outs = out if isinstance(out, tuple) else (out,)
        float_idx[:] = [k for k, o in enumerate(outs) if _is_float(o)]
        fl = tuple(outs[k] for k in float_idx)
        if not fl:  # torch.func.vjp takes no empty output
            fl = (diff_args[0].sum() * 0,)
        return fl, out

    _, vjp, out = torch.func.vjp(fn_split, *[args[i] for i in diffable],
                                 has_aux=True)

    def vjp_fn(cot):
        if not float_idx:
            return (None,) * len(diffable)
        cots = cot if isinstance(cot, tuple) else (cot,)
        return vjp(tuple(cots[k] for k in float_idx))

    return out, vjp_fn


# ----------------------------------------------------------------------
# cache entries
# ----------------------------------------------------------------------


class CacheEntry:
    """The op's forward (``wrap(fn)`` when given: a fused chain's
    kernel) and its VJP for one dispatch key."""

    __slots__ = ("fwd", "_fn", "_diffable")

    def __init__(self, fn: Callable, diffable: Sequence[int],
                 wrap: Optional[Callable] = None):
        self._fn = fn
        self._diffable = tuple(diffable)
        self.fwd = wrap(fn) if wrap is not None else fn

    def vjp(self, args: Sequence[Any]):
        """``(out, vjp_fn)`` of the op's torch function on ``args``."""
        return partial_vjp(self._fn, args, self._diffable)

    def bwd(self) -> Callable:
        """``(inputs_tuple, cotangent) -> input cotangents`` (diffable
        positions only), recomputing the forward of ``fn`` from the
        inputs: the backward of a fused chain."""
        fn, diffable = self._fn, self._diffable

        def bwd_fn(args, cot):
            return partial_vjp(fn, args, diffable)[1](cot)

        return bwd_fn


# ----------------------------------------------------------------------
# the cache
# ----------------------------------------------------------------------


class DispatchCache:
    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self._lock = threading.RLock()
        self._entries: Dict[Any, CacheEntry] = {}
        self.stats = DispatchCacheStats()
        self._per_op: Dict[str, Dict[str, int]] = {}

    def _op_rec(self, name: str) -> Dict[str, int]:
        rec = self._per_op.get(name)
        if rec is None:
            rec = self._per_op[name] = dict.fromkeys(_PER_OP_FIELDS, 0)
        return rec

    def get_or_create(self, key, fn: Callable, diffable: Sequence[int],
                      wrap: Optional[Callable] = None) -> CacheEntry:
        # every dispatch key leads with the op name (make_key contract)
        name = key[0]
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self.stats.num_hits += 1
                self._op_rec(name)["hits"] += 1
                return entry
            if len(self._entries) >= self.max_entries:
                # runaway-signature backstop: wholesale clear
                self._entries.clear()
                self.stats.num_evictions += 1
            entry = CacheEntry(fn, diffable, wrap=wrap)
            self._entries[key] = entry
            self.stats.num_misses += 1
            self._op_rec(name)["misses"] += 1
            self.stats.num_entries = len(self._entries)
            return entry

    def seed_entry(self, key, fn: Callable,
                   diffable: Sequence[int]) -> None:
        """Pre-create an entry (from a ``repro_torch.compile`` trace)
        without counting a miss: the first eager dispatch after the
        trace is then already warm."""
        with self._lock:
            if key in self._entries:
                return
            if len(self._entries) >= self.max_entries:
                self._entries.clear()
                self.stats.num_evictions += 1
            self._entries[key] = CacheEntry(fn, diffable)
            self.stats.num_seeded += 1
            self._op_rec(key[0])["seeded"] += 1
            self.stats.num_entries = len(self._entries)

    def record_uncached(self, name: str) -> None:
        with self._lock:
            self.stats.num_uncached += 1
            self._op_rec(name)["uncached"] += 1

    def record_fallback(self, name: str) -> None:
        with self._lock:
            self.stats.num_fallback_unhashable += 1
            self._op_rec(name)["fallback_unhashable"] += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.stats = DispatchCacheStats()
            self._per_op = {}

    def memory_stats(self) -> Dict[str, Any]:
        with self._lock:
            self.stats.num_entries = len(self._entries)
            out: Dict[str, Any] = self.stats.as_dict()
            per_op = {}
            for name, rec in self._per_op.items():
                warm = rec["hits"] + rec["misses"]
                per_op[name] = dict(
                    rec,
                    hit_rate=(rec["hits"] / warm) if warm else 0.0)
            out["per_op"] = per_op
            return out


_cache = DispatchCache()

_enabled = os.environ.get("REPRO_DISPATCH_CACHE", "1") != "0"


def dispatch_cache() -> DispatchCache:
    return _cache


def is_enabled() -> bool:
    return _enabled


def set_enabled(flag: bool) -> bool:
    """Toggle the cache globally; returns the previous setting."""
    global _enabled
    prev = _enabled
    _enabled = bool(flag)
    return prev


class cache_disabled:
    """Context manager: run a block with the dispatch cache off."""

    def __enter__(self):
        self._prev = set_enabled(False)
        return self

    def __exit__(self, *exc):
        set_enabled(self._prev)


def dispatch_cache_stats() -> Dict[str, Any]:
    """Counter snapshot.  Besides the global counters, ``"per_op"`` maps
    each op name to its own hits/misses/uncached/fallback_unhashable/
    seeded counts plus a derived ``hit_rate``."""
    return _cache.memory_stats()


def reset_dispatch_cache() -> None:
    """Drop every cached entry and zero the hit/miss counters."""
    _cache.clear()


# ----------------------------------------------------------------------
# trace-time seeding (dispatch-cache-aware ``repro_torch.compile``)
# ----------------------------------------------------------------------

_seed_tls = threading.local()


def seeding_enabled() -> bool:
    return getattr(_seed_tls, "on", False)


class seeding:
    """Context manager: while active, ops dispatched inside a
    ``repro_torch.compile`` trace *seed* dispatch-cache entries from
    their traced signatures instead of being invisible to the cache.
    ``sink``, when given, collects the seeded op names."""

    def __init__(self, enabled: bool = True, sink: Optional[list] = None):
        self._enabled = enabled
        self._sink = sink

    def __enter__(self):
        self._prev = (seeding_enabled(),
                      getattr(_seed_tls, "sink", None))
        _seed_tls.on = self._enabled
        _seed_tls.sink = self._sink
        return self

    def __exit__(self, *exc):
        _seed_tls.on, _seed_tls.sink = self._prev


def seed_op(name: str, static, datas: Sequence[Any], fn: Callable,
            diffable: Sequence[int]) -> None:
    """Seed entries for one traced op.  Traced tensors carry concrete
    shapes, dtypes and devices, so the eager key is reconstructible;
    both grad-flag keys are seeded (an entry does not depend on the flag,
    which only partitions the key space)."""
    seeded = False
    for grad in (False, True):
        key = make_key(name, static, datas, grad)
        if key is not None:
            _cache.seed_entry(key, fn, diffable)
            seeded = True
    sink = getattr(_seed_tls, "sink", None)
    if seeded and sink is not None and name not in sink:
        sink.append(name)


# ----------------------------------------------------------------------
# key construction
# ----------------------------------------------------------------------


def signature_of(datas: Sequence[Any]) -> Tuple:
    return tuple((tuple(d.shape), str(d.dtype), d.device.type)
                 for d in datas)


def _typed(static):
    """Type-tag static leaves: ``0``, ``0.0``, and ``False`` hash and
    compare equal in Python, but bake into *different* closures (dtype
    promotion differs), so they must occupy different cache keys."""
    if isinstance(static, tuple):
        return tuple(_typed(s) for s in static)
    return (static.__class__.__name__, static)


def make_key(name: str, static, datas: Sequence[Any],
             grad: bool) -> Optional[Tuple]:
    """Build the dispatch key, or ``None`` when the statics are not
    usable as a key (unhashable values — the caller falls back to the
    uncached path and bumps ``num_fallback_unhashable``)."""
    key = (name, _typed(static), signature_of(datas), grad)
    try:
        hash(key)
    except TypeError:
        return None
    return key
