"""Async streaming front door over :class:`~.engine.ServingEngine`.

Counterpart of ``repro/serving/frontend.py``, copied: the front door is
host Python and touches no tensor.  The paper's thesis — an imperative,
plain-Python control plane coexisting with hardware-rate execution —
extended to the live-traffic boundary: everything here is
single-threaded asyncio host Python.  The engine's step (one eager
PyTorch step through the paged-attention and Gumbel kernels on the card)
stays the data plane; the front door only *routes*:

* **per-token streaming** — :meth:`AsyncFrontend.stream` is an async
  generator yielding one :class:`StreamEvent` per committed token and
  exactly ONE terminal event (``finished`` / ``cancelled`` /
  ``timed_out`` / ``failed``).  Tokens are bridged from the engine loop
  by :meth:`AsyncFrontend.pump`, which runs one continuous-batching
  step and fans newly committed tokens into per-stream queues.
* **mid-stream cancellation** — a consumer that stops iterating
  (client disconnect, ``aclose()``, task cancellation) triggers the
  generator's ``finally``, which calls ``engine.cancel``: the
  request's KV pages release refcount-immediately, in the same
  scheduler tick, so a dead client never holds pool capacity.
* **SLO admission** — ``priority`` / ``tenant`` / ``ttft_deadline_ms``
  plumb straight into the scheduler's SLO-aware admission rank;
  ``max_stream_tokens`` caps any one request's token budget.
* **watermark backpressure** — when live pages or queue depth cross
  the admission watermark for a request's priority tier, ``stream``
  raises :class:`~.errors.BackpressureRejected` *before* submitting
  (the request never holds resources).  The error carries
  ``retry_after_s``; the HTTP layer (``launch/server.py``) maps it to
  ``503`` + ``Retry-After``.  Low-priority traffic sheds at
  ``low_priority_hwm_frac`` while high-priority requests keep
  admitting up to ``hwm_frac`` — the headroom that lets TTFT SLOs
  survive saturation.

Determinism is a design constraint, not an accident: the frontend
never spawns threads and never reads wall time.  Tests drive
:meth:`pump` manually against a fake engine clock; :meth:`run` is the
thin convenience loop a real server uses.  :meth:`pump` runs one
``engine.step()``, which waits for the card when it reads the step's
sampled tokens back; while it runs, the event loop serves no other
coroutine.  That is the reference's design, kept: no thread hides it.

Zero-drop contract: every token the engine commits for a streamed
request is enqueued to its stream before (or in the same pump as) the
terminal event — ``metrics["tokens_dropped"]`` counts violations and
must stay 0.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import AsyncIterator, Dict, Optional, Sequence

from .engine import ServingEngine
from .errors import BackpressureRejected
from .sampling import SamplingParams
from .scheduler import TERMINAL, Request, RequestState

__all__ = ["AsyncFrontend", "StreamEvent"]


@dataclass
class StreamEvent:
    """One event on a token stream.  ``kind`` is ``"token"`` for a
    committed token (with ``token``/``index`` set) or a terminal state
    value — ``"finished"``, ``"cancelled"``, ``"timed_out"``,
    ``"failed"`` — with ``error`` carrying the retirement reason.  A
    stream yields zero or more token events and exactly one terminal
    event."""
    kind: str
    req_id: int
    token: Optional[int] = None
    index: int = -1
    error: Optional[str] = None

    @property
    def terminal(self) -> bool:
        """True for the stream's single end-of-stream event."""
        return self.kind != "token"


@dataclass
class _Stream:
    """Host-side state for one open stream: the consumer's event queue
    plus the count of tokens already enqueued (``delivered``)."""
    queue: "asyncio.Queue[StreamEvent]"
    delivered: int = 0
    closed: bool = False          # terminal event enqueued


class AsyncFrontend:
    """Asyncio streaming facade over a :class:`ServingEngine`.

    One frontend owns one engine; all methods must run on one event
    loop (the frontend is deliberately lock-free and thread-free).
    ``hwm_frac`` is the page watermark for priority >=
    ``high_priority_min`` requests; ``low_priority_hwm_frac`` (default:
    ``hwm_frac - 0.15``) sheds lower-priority traffic earlier, keeping
    admission headroom for SLO-critical requests.  ``max_queue_depth``
    bounds the scheduler's waiting queue at the front door (typed
    shed, not an engine error)."""

    def __init__(self, engine: ServingEngine, *,
                 hwm_frac: float = 0.95,
                 low_priority_hwm_frac: Optional[float] = None,
                 high_priority_min: int = 1,
                 max_queue_depth: Optional[int] = None,
                 retry_after_s: float = 0.5,
                 max_stream_tokens: Optional[int] = None,
                 idle_sleep_s: float = 0.002):
        self.engine = engine
        self.hwm_frac = hwm_frac
        self.low_priority_hwm_frac = (
            low_priority_hwm_frac if low_priority_hwm_frac is not None
            else max(0.0, hwm_frac - 0.15))
        self.high_priority_min = high_priority_min
        self.max_queue_depth = max_queue_depth
        self.retry_after_s = retry_after_s
        self.max_stream_tokens = max_stream_tokens
        self.idle_sleep_s = idle_sleep_s
        self._streams: Dict[int, _Stream] = {}
        self._running = False
        self.metrics: Dict[str, int] = {
            "streams_opened": 0, "streams_finished": 0,
            "streams_aborted": 0, "client_cancelled": 0,
            "backpressure_rejections": 0, "tokens_streamed": 0,
            "tokens_dropped": 0,
        }

    # -- admission ----------------------------------------------------------
    def _gate(self, priority: int) -> None:
        """Watermark backpressure: shed BEFORE submit so a rejected
        request never holds pages or queue slots.  Low-priority tiers
        shed earlier than high-priority ones."""
        pool = self.engine.kv.pool
        frac = (self.hwm_frac if priority >= self.high_priority_min
                else self.low_priority_hwm_frac)
        live = pool.num_pages - pool.num_free
        if live >= frac * pool.num_pages:
            self.metrics["backpressure_rejections"] += 1
            raise BackpressureRejected(
                f"{live}/{pool.num_pages} pages live >= {frac:.2f} "
                f"watermark for priority {priority}",
                retry_after_s=self.retry_after_s)
        depth = len(self.engine.scheduler.waiting)
        if self.max_queue_depth is not None and \
                depth >= self.max_queue_depth:
            self.metrics["backpressure_rejections"] += 1
            raise BackpressureRejected(
                f"queue depth {depth} at front-door cap "
                f"{self.max_queue_depth}",
                retry_after_s=self.retry_after_s)

    # -- streaming ----------------------------------------------------------
    async def stream(self, prompt: Sequence[int],
                     max_new_tokens: int = 16, *,
                     priority: int = 0, tenant: str = "default",
                     sampling: Optional[SamplingParams] = None,
                     ttft_deadline_ms: Optional[float] = None,
                     timeout_ms: Optional[float] = None
                     ) -> AsyncIterator[StreamEvent]:
        """Submit a request and stream its tokens as they commit.

        Yields ``token`` events then exactly one terminal event, and
        returns.  Raises :class:`BackpressureRejected` /
        :class:`~.errors.AdmissionRejected` before the first yield if
        the request is shed.  Abandoning the iterator at any point
        cancels the request in the engine and releases its KV pages
        immediately."""
        self._gate(priority)
        if self.max_stream_tokens is not None:
            max_new_tokens = min(max_new_tokens, self.max_stream_tokens)
        rid = self.engine.submit(
            prompt, max_new_tokens, sampling=sampling,
            ttft_deadline_ms=ttft_deadline_ms, timeout_ms=timeout_ms,
            priority=priority, tenant=tenant)
        st = _Stream(queue=asyncio.Queue())
        self._streams[rid] = st
        self.metrics["streams_opened"] += 1
        try:
            while True:
                ev = await st.queue.get()
                yield ev
                if ev.terminal:
                    return
        finally:
            self._finalize(rid)

    def _lookup(self, rid: int) -> Optional[Request]:
        sched = self.engine.scheduler
        req = sched.running.get(rid) or sched.done.get(rid)
        if req is None:
            req = next((r for r in sched.waiting if r.req_id == rid),
                       None)
        return req

    def _finalize(self, rid: int) -> None:
        """Close out a stream.  If the request is still live the
        consumer walked away mid-stream: cancel it so its pages free
        NOW.  Any token committed but never enqueued counts as dropped
        (the zero-drop gate)."""
        st = self._streams.pop(rid, None)
        if st is None:
            return
        req = self._lookup(rid)
        if req is not None and req.state not in TERMINAL:
            self.engine.cancel(rid)
            self.metrics["client_cancelled"] += 1
            req = self.engine.scheduler.done.get(rid)
        if req is not None:
            missed = len(req.out_tokens) - st.delivered
            if missed > 0:
                self.metrics["tokens_dropped"] += missed

    # -- the engine bridge --------------------------------------------------
    def pump(self) -> int:
        """Run ONE engine step and fan newly committed tokens (and any
        terminal transitions) into the open stream queues.  Returns the
        number of events enqueued.  This is the only place the frontend
        touches the engine loop — tests and the traffic simulator call
        it directly for deterministic interleaving; :meth:`run` wraps
        it for real servers."""
        self.engine.step()
        events = 0
        for rid, st in list(self._streams.items()):
            if st.closed:
                continue
            req = self._lookup(rid)
            if req is None:
                continue
            out = req.out_tokens
            while st.delivered < len(out):
                st.queue.put_nowait(StreamEvent(
                    "token", rid, token=out[st.delivered],
                    index=st.delivered))
                st.delivered += 1
                self.metrics["tokens_streamed"] += 1
                events += 1
            if req.state in TERMINAL:
                st.queue.put_nowait(StreamEvent(
                    req.state.value, rid, error=req.error))
                st.closed = True
                events += 1
                if req.state is RequestState.FINISHED:
                    self.metrics["streams_finished"] += 1
                else:
                    self.metrics["streams_aborted"] += 1
        return events

    @property
    def busy(self) -> bool:
        """True while any request is queued/running or any stream still
        has a consumer attached."""
        sched = self.engine.scheduler
        return bool(sched.waiting or sched.running or self._streams)

    async def run(self) -> None:
        """Drive :meth:`pump` until :meth:`close` — the server's
        background engine task.  Steps are synchronous (each step blocks
        the loop until its tokens are back from the card; what keeps the
        frontend deterministic and lock-free); when idle it sleeps
        ``idle_sleep_s`` so the loop stays responsive to new
        submissions."""
        self._running = True
        try:
            while self._running:
                moved = self.pump() if self.busy else 0
                # yield to consumers every pump; back off when idle
                await asyncio.sleep(0 if moved else self.idle_sleep_s)
        finally:
            self._running = False

    def close(self) -> None:
        """Stop :meth:`run` after its current iteration and cancel any
        still-open engine requests (their streams see a terminal
        ``cancelled`` event on the next pump)."""
        self._running = False
        for rid in list(self._streams):
            req = self._lookup(rid)
            if req is not None and req.state not in TERMINAL:
                self.engine.cancel(rid)

    def stats(self) -> Dict[str, object]:
        """Frontend counters merged over :attr:`ServingEngine.metrics`
        (frontend keys win on collision; there are none today)."""
        return {**self.engine.metrics, **self.metrics,
                "open_streams": len(self._streams)}
