"""Deterministic, seedable fault injection for the serving stack.

Copied from ``repro/serving/faults.py``; only the NaN injection is
rewritten for torch tensors.

The TorchBench lesson applied to failure modes: narrow benchmarks (and
happy-path tests) miss what a broad, systematic sweep finds.  This
harness injects the four production failure classes at exact engine
steps so ``make chaos`` can require the engine to degrade gracefully —
fail ONE request, never the step loop — and recover:

  * ``pool_exhaustion``  — steal free pages for ``hold_steps`` steps
    (admission backpressure + preemption must absorb it, and every
    request must still finish once the pages return);
  * ``nan_logits``       — write NaN into a victim sequence's private
    KV page, so its next logits row is non-finite (the executor's
    finite-logits barrier must quarantine exactly that request);
  * ``executor_crash``   — raise :class:`~.errors.FaultInjected` at the
    executor boundary with a culprit req id (the engine's exception
    path must fail the culprit and keep stepping);
  * ``table_corruption`` — overwrite a victim's block-table tail with
    an out-of-range page id (the invariant watchdog must catch it and
    force-rebuild the device tables).

Gating: pass a :class:`FaultInjector` to ``ServingEngine(faults=...)``
or set ``REPRO_FAULTS`` (see :meth:`FaultInjector.from_env`).  When
neither is set the engine holds ``faults is None`` and the hot path
pays a single ``is None`` test per step — zero overhead, nothing to
compile out.

Spec string grammar (``;``-separated, seed via ``REPRO_FAULT_SEED``)::

    kind@step[:key=val[,key=val...]]
    e.g.  REPRO_FAULTS="nan_logits@6;pool_exhaustion@4:pages=16,hold=6"
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from .errors import FaultInjected

__all__ = ["FaultSpec", "FaultInjector"]

KINDS = ("pool_exhaustion", "nan_logits", "executor_crash",
         "table_corruption")


@dataclass
class FaultSpec:
    """One scheduled fault.  ``step`` is the engine step number at (or
    after) which it fires; ``seq`` pins the victim req id (``None`` =
    seeded pick among eligible running requests)."""
    kind: str
    step: int
    seq: Optional[int] = None
    pages: int = 0               # pool_exhaustion: pages to steal
                                 # (0 = every free page)
    hold_steps: int = 4          # pool_exhaustion: steps held
    fired: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")


class FaultInjector:
    """Injects :class:`FaultSpec` s into a running engine, deterministic
    under (specs, seed).  ``injected`` counts faults actually fired —
    the chaos gate compares it against ``watchdog_trips``."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.rng = random.Random(seed)
        self.injected = 0
        # (release_at_step, [page ids]) for pool_exhaustion holds
        self._holds: List[Tuple[int, List[int]]] = []

    # -- construction -----------------------------------------------------
    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultInjector":
        """Build from the spec-string grammar (module docstring)."""
        specs = []
        for part in filter(None, (p.strip() for p in text.split(";"))):
            head, _, opts = part.partition(":")
            kind, _, step = head.partition("@")
            kw = {}
            for kv in filter(None, opts.split(",")):
                k, _, v = kv.partition("=")
                kw[{"hold": "hold_steps"}.get(k, k)] = int(v)
            specs.append(FaultSpec(kind.strip(), int(step or 0), **kw))
        return cls(specs, seed=seed)

    @classmethod
    def from_env(cls) -> Optional["FaultInjector"]:
        """``REPRO_FAULTS`` spec string (+ ``REPRO_FAULT_SEED``);
        returns None when unset so the engine stays zero-overhead."""
        text = os.environ.get("REPRO_FAULTS", "")
        if not text:
            return None
        return cls.parse(text, seed=int(os.environ.get(
            "REPRO_FAULT_SEED", "0")))

    # -- helpers ----------------------------------------------------------
    def _victim(self, spec: FaultSpec, candidates: List[int]
                ) -> Optional[int]:
        if spec.seq is not None:
            return spec.seq if spec.seq in candidates else None
        if not candidates:
            return None
        return self.rng.choice(sorted(candidates))

    # -- engine hooks -----------------------------------------------------
    def before_plan(self, step_no: int, scheduler, kv) -> None:
        """Fire pool-exhaustion / table-corruption faults and release
        expired page holds.  Called by the engine before ``plan()``."""
        for at, pages in list(self._holds):
            if step_no >= at:
                for p in pages:
                    kv.external_refs[p] -= 1
                    if kv.external_refs[p] <= 0:
                        del kv.external_refs[p]
                    kv.pool.release(p)
                self._holds.remove((at, pages))
        for spec in self.specs:
            if spec.fired or step_no < spec.step:
                continue
            if spec.kind == "pool_exhaustion":
                want = spec.pages or kv.pool.num_free
                stolen = []
                for _ in range(min(want, kv.pool.num_free)):
                    p = kv.pool.alloc()
                    if p is None:
                        break
                    stolen.append(p)
                    kv.external_refs[p] = kv.external_refs.get(p, 0) + 1
                self._holds.append((step_no + spec.hold_steps, stolen))
                spec.fired = True
                self.injected += 1
            elif spec.kind == "table_corruption":
                sid = self._victim(spec, [
                    s for s in scheduler.running if kv.tables.get(s)])
                if sid is None:
                    continue
                kv.tables[sid][-1] = kv.pool.num_pages + 3
                kv._bump(sid)           # upload the corrupt row, as a
                spec.fired = True       # real table bug would
                self.injected += 1

    def before_execute(self, step_no: int, plan, scheduler, kv) -> None:
        """Fire NaN-logits / executor-crash faults.  Called between
        ``plan()`` and ``executor.execute`` (may raise)."""
        for spec in self.specs:
            if spec.fired or step_no < spec.step:
                continue
            if spec.kind == "executor_crash":
                sid = self._victim(
                    spec, [s.req.req_id for s in plan.spans])
                if sid is None:
                    continue
                spec.fired = True
                self.injected += 1
                raise FaultInjected(
                    f"injected executor crash at step {step_no}",
                    req_id=sid)
            if spec.kind == "nan_logits":
                sampled = [s.req.req_id for s in plan.spans if s.sample]
                sid = self._victim(spec, sampled)
                if sid is None or kv.lengths.get(sid, 0) < 1:
                    continue
                pos = kv.lengths[sid] - 1
                page = kv.tables[sid][pos // kv.page_size]
                if kv.pool.refs.get(page, 0) != 1:
                    continue            # only poison PRIVATE pages
                # the pool is updated in place; an int8 pool cannot hold
                # a NaN, so its scale carries the poison instead
                if kv.k[0].dtype == torch.int8:
                    kv.k_scale[0][page, pos % kv.page_size] = float("nan")
                else:
                    kv.k[0][page, pos % kv.page_size] = float("nan")
                spec.fired = True
                self.injected += 1
