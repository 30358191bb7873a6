"""Per-step invariant watchdog for the serving stack.

Copied from ``repro/serving/watchdog.py`` (host Python; only the imports
are rewired to the port's modules).

The scheduler/executor split makes the control plane pure host Python —
which means its load-bearing invariants are CHECKABLE host-side, every
step, without touching the device:

  * **refcount conservation** — ``allocated == freed + held`` and
    ``held + free == total`` on the page pool, and the pool's refcounts
    must equal the reference counts implied by the live block tables
    (a leaked page or a double-retain shows up here);
  * **table coherence** — every page id in a running sequence's block
    table must be a live, in-range page (a corrupted row is caught
    before it can serve garbage for more than one step);
  * **per-sequence progress** — a decodable sequence whose cursor has
    not advanced in ``stall_steps`` scheduler steps is wedged (an
    executor or commit dysfunction that would otherwise hold its slot
    and pages forever).

The engine runs :meth:`Watchdog.check` every ``interval`` steps and
QUARANTINES the offending sequence on violation: the request lands in
``FAILED``, its pages are reclaimed through the pool-reconciliation
path (``PagedKVCache.recover``), the device table mirror is force-
rebuilt, and the step loop keeps serving everyone else.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import List, Optional

__all__ = ["Violation", "Watchdog"]


@dataclass
class Violation:
    """One detected invariant break.  ``seq_id`` names the offending
    sequence when the break is attributable (table corruption, stall);
    ``None`` means a global inconsistency repaired by reconciliation."""
    kind: str                    # "table" | "refcount" | "stall"
    seq_id: Optional[int]
    detail: str


class Watchdog:
    """Host-side invariant checker over (scheduler, kv) state."""

    def __init__(self, *, interval: int = 8, stall_steps: int = 64):
        self.interval = max(1, interval)
        self.stall_steps = stall_steps
        self.trips = 0

    def due(self, step_no: int) -> bool:
        """True when ``step_no`` is a checking step."""
        return step_no % self.interval == 0

    def check(self, scheduler, kv) -> List[Violation]:
        """Run all invariant checks; returns violations (may be empty).
        Pure inspection — the ENGINE applies quarantine/recovery."""
        out: List[Violation] = []
        pool = kv.pool
        corrupt: set = set()

        # 1. table coherence for running sequences
        for sid in list(scheduler.running):
            table = kv.tables.get(sid)
            if table is None:
                out.append(Violation("table", sid, "running seq has no "
                                     "block table"))
                corrupt.add(sid)
                continue
            for p in table:
                if not (0 <= p < pool.num_pages) or p not in pool.refs:
                    out.append(Violation(
                        "table", sid,
                        f"seq {sid} table references dead/out-of-range "
                        f"page {p}"))
                    corrupt.add(sid)
                    break

        # 2. refcount conservation (skip tables already known corrupt —
        # their quarantine will be followed by a reconcile)
        st = pool.stats
        held = len(pool.refs)
        if st.allocated_pages != st.freed_pages + held:
            out.append(Violation(
                "refcount", None,
                f"allocated({st.allocated_pages}) != "
                f"freed({st.freed_pages}) + held({held})"))
        if held + pool.num_free != pool.num_pages:
            out.append(Violation(
                "refcount", None,
                f"held({held}) + free({pool.num_free}) != "
                f"total({pool.num_pages})"))
        expected = Counter(p for sid, t in kv.tables.items()
                           if sid not in corrupt for p in t)
        expected.update(kv.external_refs)    # e.g. fault-injector holds
        if not corrupt and dict(expected) != pool.refs:
            drift = {p: (expected.get(p, 0), pool.refs.get(p, 0))
                     for p in set(expected) | set(pool.refs)
                     if expected.get(p, 0) != pool.refs.get(p, 0)}
            out.append(Violation(
                "refcount", None,
                f"table-implied refcounts != pool refcounts: {drift}"))

        # 3. per-sequence progress
        steps = scheduler.metrics["steps"]
        for sid, req in list(scheduler.running.items()):
            if sid in corrupt:
                continue
            if req.in_decode and \
                    steps - req.last_advance_step >= self.stall_steps:
                out.append(Violation(
                    "stall", sid,
                    f"seq {sid} decodable but stuck for "
                    f"{steps - req.last_advance_step} steps"))
        self.trips += len(out)
        return out
