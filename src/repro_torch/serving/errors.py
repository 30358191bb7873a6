"""Typed serving errors — the request-lifecycle failure vocabulary.

Copied from ``repro/serving/errors.py`` (host Python; only the imports
are rewired to the port's modules).

Every failure the serving stack can hand a caller is a subclass of
:class:`ServingError`, so front ends catch ONE type and report
per-request outcomes instead of dying on a bare ``ValueError``
(``launch/serve.py`` does exactly that).  The admission-shaped errors
also subclass ``ValueError`` for backward compatibility with callers
that predate the hierarchy.

Hierarchy::

    ServingError
    ├── AdmissionRejected (ValueError)   submit-time rejection
    │   ├── PoolExhausted                page-watermark backpressure
    │   └── BackpressureRejected         front-door load shed (carries
    │                                    retry_after_s → 503 Retry-After)
    ├── BucketOverflow (ValueError)      pow2 shape-bucket cap exceeded
    ├── MeshConfigError (ValueError)     invalid serving mesh shape
    ├── DeadlineExceeded                 ttft/timeout/step-cap expiry
    └── RequestFailed                    quarantined by the watchdog /
        └── FaultInjected                executor fault barrier
"""

from __future__ import annotations

from typing import Optional

__all__ = ["ServingError", "AdmissionRejected", "PoolExhausted",
           "BackpressureRejected", "BucketOverflow", "MeshConfigError",
           "DeadlineExceeded", "RequestFailed", "FaultInjected"]


class ServingError(Exception):
    """Base class for every typed serving-stack error."""


class AdmissionRejected(ServingError, ValueError):
    """Request refused at ``submit`` time — over-cap prompt, queue
    depth at ``max_queue_depth``, or pool watermark backpressure.  The
    request holds NO resources; the caller may retry later."""


class PoolExhausted(AdmissionRejected):
    """Admission gate: live pages are at/above the configured watermark
    of the pool — shed load now rather than wedge mid-decode later."""


class BackpressureRejected(AdmissionRejected):
    """Front-door load shed: the page pool (or request queue) is past
    the admission watermark for this request's priority tier.  The
    request holds no resources; ``retry_after_s`` tells the client how
    long to back off (the HTTP layer maps this to a 503 response with a
    ``Retry-After`` header)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class BucketOverflow(ServingError, ValueError):
    """A size exceeds its pow2 shape-bucket cap (token budget or
    pages-per-sequence) — the shape can never be scheduled."""


class MeshConfigError(ServingError, ValueError):
    """A serving mesh shape cannot be built: tensor-parallel degree not
    dividing the device count, more devices requested than exist, or a
    pool/slot count that does not divide across the ``data`` replicas.
    Raised at construction time — never mid-serve."""


class DeadlineExceeded(ServingError):
    """A per-request deadline (``ttft_deadline_ms``, ``timeout_ms``) or
    the engine's step cap expired; the request was retired TIMED_OUT
    with its pages freed."""


class RequestFailed(ServingError):
    """A request was quarantined (state FAILED): non-finite logits, a
    corrupted block table, a stalled sequence, or an executor fault
    attributed to it.  ``req_id`` names the culprit when known."""

    def __init__(self, msg: str, req_id: Optional[int] = None):
        super().__init__(msg)
        self.req_id = req_id


class FaultInjected(RequestFailed):
    """Raised by the deterministic fault harness (``serving.faults``)
    at the executor boundary — exercises the same recovery path a real
    executor exception takes."""
