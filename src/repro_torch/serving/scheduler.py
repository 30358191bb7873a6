"""Serving control plane — pure-Python scheduling over the paged KV pool.

Copied from ``repro/serving/scheduler.py`` (host Python; only the imports
are rewired to the port's modules).

The §5.2 separation applied to serving: everything here is host Python
(FIFO admission, chunked-prefill token budgeting, preemption, COW and
page-table maintenance); everything shape-like is bucketed so the
executor's single jitted ``unified_step`` compiles O(log) variants.

A request's lifetime is a single token cursor ``computed`` over its full
token history ``prompt + out_tokens``:

  * prefill = spans of up to ``chunk_size`` tokens per step (so a long
    prompt never blocks the decode tokens of running sequences — chunked
    prefill, no head-of-line blocking),
  * decode = the degenerate 1-token span at the end of the history,
  * the step that processes the FINAL history token samples the next
    token (argmax) — uniform across "last prefill chunk" and "decode".

Preempt/resume falls out of the same cursor: preemption frees the pages
and requeues the request AT THE FRONT with ``out_tokens`` intact;
re-admission rebuilds the history as ``prompt + out_tokens`` and prefills
from the (possibly prefix-cache-reused) start — no token is re-emitted
because sampling only happens at the end of the rebuilt history.  (The
old engine re-prefilled ``prompt`` alone and unconditionally appended a
fresh argmax token — the preemption-data-loss bug this refactor fixes.)

Scheduling policy per step (``token_budget`` tokens total):

  1. decode spans first, one token per running decode-phase sequence —
     a step can never have 0 decode tokens while decodable sequences
     exist (liveliness; violations would bump ``zero_decode_steps``),
  2. remaining budget goes to prefill chunks in admission order,
     ``chunk_size`` (env ``REPRO_PREFILL_CHUNK``) tokens max per request
     per step.

Admission is SLO-aware, not plain FIFO.  Waiting requests are ranked
by :meth:`Scheduler._admission_rank`:

  1. **aged** requests first — a request that has waited
     ``aging_steps`` plans stops being bypassed entirely (the
     starvation guard; its landing counts in ``aged_admissions``),
  2. **priority** tier (``submit(priority=...)``, higher first),
  3. **TTFT-deadline slack** — earliest-deadline-first within a tier:
     ``submitted_at + ttft_deadline_ms - now`` orders who must start
     prefilling NOW to meet its first-token SLO (deadline-less
     requests sort after every armed deadline),
  4. **tenant fair-share** — among otherwise-equal requests the tenant
     with the least tokens scheduled so far (``tenant_tokens``) goes
     first, so one chatty tenant cannot monopolize admission,
  5. submit order (``req_id``) — with default priority/tenant and no
     deadlines the whole rank degenerates to classic FIFO, which is
     what batch callers still get.

A TTFT deadline is therefore an *ordering key* at admission time, not
just an expiry check: ``ttft_deadline_misses`` counts the requests
whose deadline still lapsed (the front door's SLO regression signal).

Speculative decoding (``spec_k > 0`` + a ``spec.Proposer``) widens a
decode span: the pending token plus up to ``spec_k`` host-proposed
draft tokens travel as one multi-token segment, the executor samples a
target token at EVERY draft position in the same jitted call, and
``commit`` keeps the longest prefix where target == draft plus the
first correction token.  Rejected drafts rewind: ``kv.advance`` only
ever covers committed tokens (no stale ``filled`` counts) and
``kv.truncate`` releases the pages past the committed end (bumping the
table version so the device mirror row re-uploads).  Sampling params
(temperature/top-k/top-p/seed) ride per-request and are resolved
in-jit — see ``sampling.py`` for why this makes speculation exact at
any temperature.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .errors import (AdmissionRejected, BucketOverflow, MeshConfigError,
                     PoolExhausted)
from .kv_cache import PagedKVCache
from .sampling import SamplingParams
from .spec import Proposer


class RequestState(Enum):
    """Explicit per-request lifecycle:
    QUEUED → PREFILL → DECODE → {FINISHED, CANCELLED, TIMED_OUT,
    FAILED} (preemption loops PREFILL/DECODE back to QUEUED).  The
    last four are terminal; terminal requests live in
    ``Scheduler.done`` with pages released."""
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"
    FAILED = "failed"


TERMINAL = (RequestState.FINISHED, RequestState.CANCELLED,
            RequestState.TIMED_OUT, RequestState.FAILED)


@dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # scheduler state
    computed: int = 0            # history tokens whose compute has run
    slot: int = -1               # executor slot while RUNNING
    created_len: int = 0         # history length at (re-)admission:
                                 # writes below it are hash-pledged
                                 # prompt content, at/above it divergent
    # lifecycle / fault tolerance
    state: RequestState = RequestState.QUEUED
    sampling: SamplingParams = field(default_factory=SamplingParams)
    ttft_deadline_ms: Optional[float] = None   # first token due by
    timeout_ms: Optional[float] = None         # whole request due by
    # SLO-aware admission
    priority: int = 0            # higher = admitted earlier
    tenant: str = "default"      # fair-share accounting bucket
    error: Optional[str] = None  # why a terminal state was reached
    last_advance_step: int = 0   # scheduler step of last cursor move
    age_steps: int = 0           # steps spent QUEUED (aging guard)

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens

    @property
    def history(self) -> List[int]:
        return self.prompt + self.out_tokens

    @property
    def in_decode(self) -> bool:
        """One history token left to process — the continuous-batching
        steady state (also the final chunk of a 1-token-tail prefill)."""
        return self.computed == len(self.prompt) + len(self.out_tokens) - 1


@dataclass
class Span:
    """One request's scheduled token span [start, end) for this step.
    ``drafts`` extends a decode span speculatively: the draft tokens
    are fed (and their K/V written) at positions ``end .. end+len-1``
    but enter ``out_tokens`` only if the executor's target samples
    agree (``Scheduler.commit``)."""
    req: Request
    start: int
    end: int
    sample: bool                 # span covers the last history token
    decode: bool                 # steady-state decode span
    drafts: List[int] = field(default_factory=list)


@dataclass
class StepPlan:
    """Host-built, bucket-padded operands for one ``unified_step``.
    K = ``spec_k`` is fixed per engine, so every operand shape below is
    constant across steps (no bucket growth from speculation)."""
    spans: List[Span]
    slot_seqs: List[int]         # slot -> seq id (-1 = empty slot),
                                 # length R*S; slot = replica*S + lane
    tokens: np.ndarray           # (T,) int32, 0-padded   [R>1: (R, T)]
    seg_ids: np.ndarray          # (T,) int32, -1 = padding; values are
                                 # replica-LOCAL lanes     [R>1: (R, T)]
    positions: np.ndarray        # (T,) int32              [R>1: (R, T)]
    write_idx: np.ndarray        # (T,) int32 replica-local flat page
                                 # slot, OOB = skip        [R>1: (R, T)]
    sample_idx: np.ndarray       # (S, K+1) int32 replica-local token-
                                 # batch rows           [R>1: (R, S, K+1)]
    sample_pos: np.ndarray       # (S,) int32 first new token [R>1: (R, S)]
    temps: np.ndarray            # (S,) f32 temperature      [R>1: (R, S)]
    top_ks: np.ndarray           # (S,) int32 top-k (0 = off) [R>1: (R, S)]
    top_ps: np.ndarray           # (S,) f32 top-p (1 = off)  [R>1: (R, S)]
    seeds: np.ndarray            # (S,) uint32 PRNG seed     [R>1: (R, S)]
    n_tokens: int                # live tokens before padding (all replicas)
    t_bucket: int                # per-replica token width
    p_bucket: int


def pow2_bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n:
        b *= 2
    if b > hi:
        raise BucketOverflow(f"{n} exceeds bucket cap {hi}")
    return b


class Scheduler:
    """FIFO continuous-batching scheduler with chunked prefill."""

    def __init__(self, kv: PagedKVCache, *, max_batch: int,
                 chunk_size: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 max_pages_per_seq: Optional[int] = None,
                 min_t_bucket: int = 8, min_p_bucket: int = 4,
                 max_queue_depth: Optional[int] = None,
                 admit_hwm_frac: float = 1.0,
                 aging_steps: int = 32,
                 sampling: Optional[SamplingParams] = None,
                 spec_k: int = 0,
                 proposer: Optional[Proposer] = None,
                 n_replicas: int = 1,
                 clock: Callable[[], float] = time.perf_counter):
        self.kv = kv
        self.max_batch = max_batch
        if n_replicas < 1:
            raise MeshConfigError(f"n_replicas must be >= 1, "
                                  f"got {n_replicas}")
        if getattr(kv, "n_replicas", 1) != n_replicas:
            raise MeshConfigError(
                f"scheduler n_replicas={n_replicas} but the KV cache was "
                f"built with n_replicas={getattr(kv, 'n_replicas', 1)}")
        self.n_replicas = n_replicas
        self.total_slots = max_batch * n_replicas
        self.default_sampling = (sampling or SamplingParams()).validate()
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.spec_k = spec_k
        self.proposer = proposer
        self.chunk_size = chunk_size or int(
            os.environ.get("REPRO_PREFILL_CHUNK", "16"))
        # token_budget and max_pages_per_seq are PER-REPLICA: each data
        # replica plans its own (t_bucket,) token row against its own
        # page range, so bucket shapes don't change with replica count
        budget = token_budget or max(2 * max_batch, self.chunk_size)
        self.token_budget = pow2_bucket(max(budget, max_batch), 1, 1 << 30)
        self.max_pages_per_seq = (max_pages_per_seq
                                  or kv.pool.num_pages // n_replicas)
        self.min_t_bucket = min(min_t_bucket, self.token_budget)
        self.min_p_bucket = min(min_p_bucket,
                                pow2_bucket(self.max_pages_per_seq, 1,
                                            1 << 30))
        # admission gates: bounded queue + page-watermark backpressure
        # (defaults leave both OFF so batch callers keep FIFO-forever)
        self.max_queue_depth = max_queue_depth
        self.admit_hwm_frac = admit_hwm_frac
        self.aging_steps = aging_steps   # waiting steps before a blocked
                                         # request stops being bypassed
        self.clock = clock               # injectable for deadline tests
        self.waiting: List[Request] = []
        self.running: Dict[int, Request] = {}
        self.done: Dict[int, Request] = {}    # terminal requests
        self.aborted: List[Request] = []      # CANCELLED/TIMED_OUT/FAILED
        # slot -> seq id; slot = replica * max_batch + lane (the lane is
        # the executor's replica-local segment id)
        self.slots: List[int] = [-1] * self.total_slots
        self._next_id = 0
        # tenant -> tokens scheduled (prompt at admission + emitted
        # tokens at commit): the fair-share admission key
        self.tenant_tokens: Dict[str, int] = {}
        self.metrics = {
            "steps": 0, "prefills": 0, "decoded_tokens": 0,
            "rejected_admissions": 0, "prefill_chunks": 0,
            "preemptions": 0, "zero_decode_steps": 0,
            "cancellations": 0, "timeouts": 0, "failed_requests": 0,
            "aged_admissions": 0, "rejected_submits": 0,
            "ttft_deadline_misses": 0,
            "proposed_tokens": 0, "accepted_tokens": 0, "spec_steps": 0,
        }

    # -- bucket contract --------------------------------------------------
    def t_buckets(self) -> List[int]:
        out, b = [], self.min_t_bucket
        while b <= self.token_budget:
            out.append(b)
            b *= 2
        return out

    def p_buckets(self) -> List[int]:
        cap = pow2_bucket(self.max_pages_per_seq, self.min_p_bucket,
                          1 << 30)
        out, b = [], self.min_p_bucket
        while b <= cap:
            out.append(b)
            b *= 2
        return out

    @property
    def bucket_count(self) -> int:
        return len(self.t_buckets()) * len(self.p_buckets())

    # -- admission --------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               *, sampling: Optional[SamplingParams] = None,
               ttft_deadline_ms: Optional[float] = None,
               timeout_ms: Optional[float] = None,
               priority: int = 0, tenant: str = "default") -> int:
        total = len(prompt) + max_new_tokens
        if self.kv.pages_needed(total) > self.max_pages_per_seq:
            self.metrics["rejected_submits"] += 1
            raise AdmissionRejected(
                f"request needs {self.kv.pages_needed(total)} pages, "
                f"max_pages_per_seq={self.max_pages_per_seq}")
        if self.max_queue_depth is not None and \
                len(self.waiting) >= self.max_queue_depth:
            self.metrics["rejected_submits"] += 1
            raise AdmissionRejected(
                f"queue depth {len(self.waiting)} at "
                f"max_queue_depth={self.max_queue_depth}")
        if self.admit_hwm_frac < 1.0:
            live = self.kv.pool.num_pages - self.kv.pool.num_free
            if live >= self.admit_hwm_frac * self.kv.pool.num_pages:
                self.metrics["rejected_submits"] += 1
                raise PoolExhausted(
                    f"{live}/{self.kv.pool.num_pages} pages live >= "
                    f"admit_hwm_frac={self.admit_hwm_frac} watermark")
        req = Request(self._next_id, list(prompt), max_new_tokens,
                      submitted_at=self.clock(),
                      sampling=(sampling or
                                self.default_sampling).validate(),
                      ttft_deadline_ms=ttft_deadline_ms,
                      timeout_ms=timeout_ms,
                      priority=priority, tenant=tenant)
        self._next_id += 1
        self.waiting.append(req)
        return req.req_id

    def _free_slot(self, replica: int) -> int:
        lo = replica * self.max_batch
        for i in range(lo, lo + self.max_batch):
            if self.slots[i] < 0:
                return i
        return -1

    def _replica_of_slot(self, slot: int) -> int:
        return slot // self.max_batch

    def _candidate_replicas(self) -> List[int]:
        """Replicas with a free lane, most free pages first (ties break
        toward the lowest index so placement is deterministic)."""
        cands = [r for r in range(self.n_replicas)
                 if self._free_slot(r) >= 0]
        cands.sort(key=lambda r: (-self.kv.pool.free_in(r), r))
        return cands

    def _admission_rank(self, req: Request, now: float):
        """SLO-aware admission key (smaller admits first): aged
        requests hold the front, then priority tier (higher first),
        then TTFT-deadline slack (earliest deadline first; no deadline
        sorts last), then tenant fair-share (least tokens scheduled
        first), then submit order.  All-default submissions reduce to
        plain FIFO."""
        slack = (float("inf") if req.ttft_deadline_ms is None
                 else req.submitted_at + req.ttft_deadline_ms / 1e3 - now)
        return (0 if req.age_steps >= self.aging_steps else 1,
                -req.priority, slack,
                self.tenant_tokens.get(req.tenant, 0), req.req_id)

    def _admit(self) -> None:
        # best-effort ranked admission: a blocked request is BYPASSED
        # by lower-ranked ones that do fit — until it has waited
        # ``aging_steps`` plans, after which it ranks at the very front
        # and holds the line (starvation-free aging; the admission that
        # finally lands counts in ``aged_admissions``).  With data
        # replicas, each request lands on ONE replica (free lane + most
        # free pages): its pages, lane, and token budget all come from
        # that replica's share.
        now = self.clock()
        order = sorted(self.waiting,
                       key=lambda r: self._admission_rank(r, now))
        for req in order:
            if len(self.running) >= self.total_slots:
                break
            hist = req.history
            replica = -1
            for r in self._candidate_replicas():
                if (self.kv.can_admit(len(hist) + 1, r)
                        and self.kv.create(req.req_id, hist, r)):
                    replica = r
                    break
            if replica < 0:
                self.metrics["rejected_admissions"] += 1
                if req.age_steps >= self.aging_steps:
                    break                # aged: nobody bypasses it
                continue
            self.waiting.remove(req)
            if req.age_steps >= self.aging_steps:
                self.metrics["aged_admissions"] += 1
            self.tenant_tokens[req.tenant] = (
                self.tenant_tokens.get(req.tenant, 0) + len(hist))
            # prefix reuse skips compute too — capped by what sharers
            # have actually written (kv.lengths) — but the LAST history
            # token is always recomputed: its logits seed the next
            # sample.  Already-valid K/V is not re-written (the executor
            # keeps those rows OOB).
            req.computed = min(self.kv.lengths[req.req_id],
                               len(hist) - 1)
            req.created_len = len(hist)
            req.slot = self._free_slot(replica)
            self.slots[req.slot] = req.req_id
            self.running[req.req_id] = req
            req.state = (RequestState.DECODE if req.in_decode
                         else RequestState.PREFILL)
            req.last_advance_step = self.metrics["steps"]
            self.metrics["prefills"] += 1

    def _preempt(self, req: Request) -> None:
        """Out of pages: free everything, requeue AT THE FRONT keeping
        the generated tokens (resume re-prefills prompt + out_tokens)."""
        self.kv.free_seq(req.req_id)
        self.slots[req.slot] = -1
        req.slot = -1
        req.computed = 0
        req.state = RequestState.QUEUED
        del self.running[req.req_id]
        self.waiting.insert(0, req)
        self.metrics["preemptions"] += 1

    # -- request lifecycle -------------------------------------------------
    def _lookup(self, req_id: int) -> Optional[Request]:
        req = self.running.get(req_id)
        if req is None:
            req = next((r for r in self.waiting if r.req_id == req_id),
                       None)
        return req

    def _retire(self, req: Request, state: RequestState, reason: str,
                quarantine: bool = False) -> None:
        """Move a request to a terminal state, releasing its resources.
        ``quarantine=True`` routes page release through the suspect-
        state path (``kv.quarantine_seq`` — never walks a possibly
        corrupt table through ``pool.release``); the engine follows up
        with ``kv.recover()``."""
        if req.req_id in self.running:
            if quarantine:
                self.kv.quarantine_seq(req.req_id)
            else:
                self.kv.free_seq(req.req_id)
            if req.slot >= 0:
                self.slots[req.slot] = -1
                req.slot = -1
            del self.running[req.req_id]
        elif req in self.waiting:
            self.waiting.remove(req)
        req.state = state
        req.error = reason
        req.finished_at = self.clock()
        self.done[req.req_id] = req
        self.aborted.append(req)

    def cancel(self, req_id: int) -> bool:
        """Cancel a request at ANY lifecycle point — queued, mid-prefill
        or mid-decode.  Pages release refcount-safely (shared/COW pages
        just drop one reference; sharers keep theirs).  Returns False
        when the id is unknown or already terminal."""
        req = self._lookup(req_id)
        if req is None:
            return False
        self._retire(req, RequestState.CANCELLED, "cancelled by caller")
        self.metrics["cancellations"] += 1
        return True

    def fail(self, req_id: int, reason: str) -> bool:
        """Quarantine a request (state FAILED): its bookkeeping is
        dropped WITHOUT trusting its block table; the caller must run
        ``kv.recover()`` afterwards to reclaim + scrub the orphaned
        pages and force a device-table rebuild."""
        req = self._lookup(req_id)
        if req is None:
            return False
        self._retire(req, RequestState.FAILED, reason, quarantine=True)
        self.metrics["failed_requests"] += 1
        return True

    def timeout_all(self, reason: str) -> int:
        """Retire EVERY queued/running request as TIMED_OUT (pages
        freed) — the engine's step-cap drain.  Returns the count."""
        n = 0
        for req in list(self.running.values()) + list(self.waiting):
            self._retire(req, RequestState.TIMED_OUT, reason)
            self.metrics["timeouts"] += 1
            n += 1
        return n

    def _expire_deadlines(self) -> None:
        """Retire requests whose TTFT or total deadline has passed
        (checked every ``plan``; uses the injectable ``clock``)."""
        now = self.clock()
        for req in list(self.waiting) + list(self.running.values()):
            late: Optional[str] = None
            if req.timeout_ms is not None and \
                    now > req.submitted_at + req.timeout_ms / 1e3:
                late = f"timeout_ms={req.timeout_ms} exceeded"
            elif req.ttft_deadline_ms is not None and \
                    req.first_token_at is None and \
                    now > req.submitted_at + req.ttft_deadline_ms / 1e3:
                late = f"ttft_deadline_ms={req.ttft_deadline_ms} missed"
                self.metrics["ttft_deadline_misses"] += 1
            if late is not None:
                self._retire(req, RequestState.TIMED_OUT, late)
                self.metrics["timeouts"] += 1

    # -- step planning ----------------------------------------------------
    def plan(self) -> Optional[StepPlan]:
        """Expire deadlines, admit, pick spans under the token budget,
        maintain pages/COW, and emit bucket-padded operands.  None =
        nothing runnable."""
        self._expire_deadlines()
        for r in self.waiting:
            r.age_steps += 1
        self._admit()
        if not self.running:
            return None

        spans: List[Span] = []
        # one token budget PER data replica: each replica fills its own
        # (t_bucket,) row, so a busy replica can't starve another's
        budget = [self.token_budget] * self.n_replicas
        # priority tier first, then FIFO: req ids are issued in submit
        # order and survive preemption, so ascending id = oldest first
        # (slot index does NOT track age — a young request can land in
        # a freed low slot); a higher-priority request gets budget
        # before an older lower-priority one
        order = sorted((self.running[s] for s in self.slots if s >= 0),
                       key=lambda r: (-r.priority, r.req_id))
        # decode spans first (liveliness); speculation widens them
        for req in order:
            rep = self._replica_of_slot(req.slot)
            if not req.in_decode or budget[rep] <= 0:
                continue
            drafts: List[int] = []
            if self.spec_k > 0 and self.proposer is not None:
                cap = min(self.spec_k,
                          req.max_new_tokens - len(req.out_tokens) - 1,
                          budget[rep] - 1)
                if cap > 0:
                    drafts = list(
                        self.proposer.propose(req.history, cap))[:cap]
            span = self._reserve(req, req.computed + 1, drafts)
            if span is not None:
                spans.append(span)
                budget[rep] -= 1 + len(span.drafts)
                if span.drafts:
                    self.metrics["spec_steps"] += 1
                    self.metrics["proposed_tokens"] += len(span.drafts)
        # prefill chunks with whatever budget remains
        for req in order:
            if req.req_id not in self.running or req.in_decode:
                continue
            rep = self._replica_of_slot(req.slot)
            if budget[rep] <= 0:
                continue
            end = min(req.computed + min(self.chunk_size, budget[rep]),
                      len(req.history))
            span = self._reserve(req, end)
            if span is not None:
                spans.append(span)
                budget[rep] -= span.end - span.start
                self.metrics["prefill_chunks"] += 1

        # liveliness: a STILL-decodable sequence (not OOM-preempted
        # above) with no decode span this step is starvation
        if not any(s.decode for s in spans) and any(
                r.req_id in self.running and r.in_decode for r in order):
            self.metrics["zero_decode_steps"] += 1
        if not spans:
            return None
        return self._pad(spans)

    def _reserve(self, req: Request, end: int,
                 drafts: Sequence[int] = ()) -> Optional[Span]:
        """Allocate pages + COW-protect the span's written range; preempt
        the request itself when the pool is dry.  ``drafts`` extend the
        reservation past ``end`` (always-divergent speculative writes);
        when the pool can't cover the speculative tail the drafts are
        shed FIRST and the span degrades to a plain reservation."""
        start = req.computed
        end_spec = end + len(drafts)
        write_from = max(start, self.kv.lengths[req.req_id])
        divergent = end > req.created_len
        ok = (self.kv.ensure_capacity(req.req_id, end_spec)
              and self.kv.make_writable(req.req_id, write_from,
                                        max(end, write_from),
                                        divergent=divergent)
              and self.kv.make_writable(req.req_id, max(end, write_from),
                                        max(end_spec, write_from),
                                        divergent=True))
        if not ok:
            if drafts:
                self.kv.truncate(req.req_id,
                                 max(end, self.kv.lengths[req.req_id]))
                return self._reserve(req, end)
            self._preempt(req)
            return None
        last = len(req.history) - 1
        return Span(req, start, end, sample=end > last,
                    decode=req.in_decode, drafts=list(drafts))

    def _pad(self, spans: List[Span]) -> StepPlan:
        """Bucket-pad the step's spans into executor operands.  With
        data replicas every token/sample array grows a leading replica
        axis (R, ·): replica r's row holds ONLY its own spans, segment
        ids are replica-LOCAL lanes, and write/sample indices are local
        to the replica's page range / token row — the executor vmaps
        one body over the axis, so per-replica shapes (and hence the
        compiled bucket set) are IDENTICAL to the single-device plan.
        R == 1 squeezes the axis away (bit-for-bit the old layout)."""
        kv = self.kv
        R, S = self.n_replicas, self.max_batch
        n = sum(s.end - s.start + len(s.drafts) for s in spans)
        counts = [0] * R
        for s in spans:
            counts[self._replica_of_slot(s.req.slot)] += \
                s.end - s.start + len(s.drafts)
        t_bucket = pow2_bucket(max(counts), self.min_t_bucket,
                               self.token_budget)
        max_pages = max(len(kv.tables[s.req.req_id]) for s in spans)
        p_bucket = pow2_bucket(max_pages, self.min_p_bucket,
                               pow2_bucket(self.max_pages_per_seq,
                                           self.min_p_bucket, 1 << 30))

        tokens = np.zeros((R, t_bucket), np.int32)
        seg = np.full((R, t_bucket), -1, np.int32)
        pos = np.zeros((R, t_bucket), np.int32)
        oob = kv.pages_per_replica * kv.page_size    # replica-local OOB
        widx = np.full((R, t_bucket), oob, np.int32)
        kp1 = self.spec_k + 1
        sample_idx = np.zeros((R, S, kp1), np.int32)
        sample_pos = np.zeros((R, S), np.int32)
        temps = np.zeros((R, S), np.float32)
        top_ks = np.zeros((R, S), np.int32)
        top_ps = np.ones((R, S), np.float32)
        seeds = np.zeros((R, S), np.uint32)

        cursors = [0] * R
        for s in spans:
            req_id = s.req.req_id
            rep = self._replica_of_slot(s.req.slot)
            lane = s.req.slot - rep * S
            cursor = cursors[rep]
            hist = s.req.history
            m = s.end - s.start + len(s.drafts)
            sl = slice(cursor, cursor + m)
            tokens[rep, sl] = hist[s.start:s.end] + s.drafts
            seg[rep, sl] = lane
            pos[rep, sl] = np.arange(s.start, s.start + m)
            # reused-prefix tokens recomputed for logits keep their
            # already-valid K/V: skip the write (stays OOB)
            wfrom = max(s.start, kv.lengths[req_id])
            if s.start + m > wfrom:
                off = (kv.seq_replica.get(req_id, 0)
                       * kv.pages_per_replica * kv.page_size)
                widx[rep, cursor + (wfrom - s.start): cursor + m] = \
                    kv.flat_slots(req_id, wfrom, s.start + m) - off
            if s.sample:
                # one sample row per new token: the pending token's row
                # plus one per draft (rows of the last 1+len(drafts)
                # fed tokens); unused tail entries repeat the last row
                n_s = 1 + len(s.drafts)
                rows = cursor + (m - n_s) + np.arange(n_s)
                sample_idx[rep, lane, :n_s] = rows
                sample_idx[rep, lane, n_s:] = rows[-1]
                sample_pos[rep, lane] = s.end
                sp = s.req.sampling
                temps[rep, lane] = sp.temperature
                top_ks[rep, lane] = sp.top_k
                top_ps[rep, lane] = sp.top_p
                seeds[rep, lane] = np.uint32(sp.seed & 0xFFFFFFFF)
            cursors[rep] += m
        arrs = [tokens, seg, pos, widx, sample_idx, sample_pos,
                temps, top_ks, top_ps, seeds]
        if R == 1:
            arrs = [a[0] for a in arrs]
        return StepPlan(spans=spans, slot_seqs=list(self.slots),
                        tokens=arrs[0], seg_ids=arrs[1], positions=arrs[2],
                        write_idx=arrs[3], sample_idx=arrs[4],
                        sample_pos=arrs[5], temps=arrs[6],
                        top_ks=arrs[7], top_ps=arrs[8], seeds=arrs[9],
                        n_tokens=n, t_bucket=t_bucket, p_bucket=p_bucket)

    # -- step commit ------------------------------------------------------
    def commit(self, plan: StepPlan, next_tokens: np.ndarray
               ) -> List[Request]:
        """Apply a step's results: advance cursors/lengths, append
        sampled tokens, retire finished requests (pages released for the
        very next admission).

        ``next_tokens`` is the executor's ``(S, K+1)`` target-token
        matrix.  For a speculative span the acceptance rule is the
        standard greedy-verify prefix: with drafts ``d[0..L)`` and
        target row ``t``, keep ``j = |longest prefix with
        t[i] == d[i]|`` drafts plus the correction token ``t[j]`` —
        exactly the tokens a non-speculative loop would have emitted
        (``sampling.py`` pins the PRNG to (seed, position), so ``t[i]``
        IS the non-speculative sample at that position).  Rejected
        drafts rewind: the cursor and ``kv.advance`` stop at the
        committed end and ``kv.truncate`` releases the speculative-tail
        pages (no leaked refcounts, no stale ``filled`` counts)."""
        finished: List[Request] = []
        self.metrics["steps"] += 1
        for s in plan.spans:
            req = s.req
            if self.running.get(req.req_id) is not req:
                continue             # retired mid-step (cancel/fail)
            if not s.sample:         # pure prefill chunk: cursor only
                req.computed = s.end
                req.last_advance_step = self.metrics["steps"]
                self.kv.advance(req.req_id, s.end)
                req.state = (RequestState.DECODE if req.in_decode
                             else RequestState.PREFILL)
                continue
            row = next_tokens[req.slot]
            j = 0
            while j < len(s.drafts) and int(row[j]) == s.drafts[j]:
                j += 1
            room = req.max_new_tokens - len(req.out_tokens)
            take = min(j + 1, room)  # plan() caps drafts so take==j+1;
            toks = (s.drafts[:j] + [int(row[j])])[:take]
            req.out_tokens.extend(toks)
            self.tenant_tokens[req.tenant] = (
                self.tenant_tokens.get(req.tenant, 0) + len(toks))
            # accepted drafts were computed in-step; the correction
            # token was only SAMPLED — its compute runs next step
            req.computed = s.end + min(j, take)
            req.last_advance_step = self.metrics["steps"]
            self.kv.advance(req.req_id, req.computed)
            if s.drafts:
                self.metrics["accepted_tokens"] += min(j, take)
                if j < len(s.drafts):
                    # rejected tail: drop its pages past the next
                    # pending token's page (version bump re-uploads
                    # the device table row)
                    self.kv.truncate(req.req_id, req.computed + 1)
            if req.first_token_at is None:
                req.first_token_at = self.clock()
            if s.decode:
                self.metrics["decoded_tokens"] += len(toks)
            if req.done:
                req.state = RequestState.FINISHED
                req.finished_at = self.clock()
                self.kv.free_seq(req.req_id)
                self.slots[req.slot] = -1
                req.slot = -1
                del self.running[req.req_id]
                self.done[req.req_id] = req
                finished.append(req)
                continue
            # state AFTER any append: a request that just sampled its
            # first token is now in steady-state decode, not prefill
            req.state = (RequestState.DECODE if req.in_decode
                         else RequestState.PREFILL)
        return finished
