"""Streams and events (paper §5.2): separate control and data flow.

Counterpart of ``repro/core/stream.py`` with the same API.  Where the
eager runtime's default device is CUDA, a :class:`Stream` wraps a
``torch.cuda.Stream`` (the process's default stream for
:func:`default_stream`) and an :class:`Event` a ``torch.cuda.Event``:
``with repro_torch.stream(s):`` also makes ``s`` PyTorch's current CUDA
stream, so the kernels an op launches queue on it, and ``synchronize``,
``query``, ``wait_stream``, ``record_event`` and ``elapsed_time`` are the
card's.  On the CPU (``repro_torch.default_device("cpu")``) they keep the
reference's host bookkeeping: results noted per stream, events that
record the host clock.  The CUDA objects are made at first use, never
at import.

Tensors remember their stream id, so the accounting allocator keeps one
block pool per stream (§5.3) and flags cross-stream reuse.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional

import torch

from .. import _device
from . import allocator as _alloc


def _on_cuda() -> bool:
    dev = _device.requested_device()
    return dev is None or dev.type == "cuda"


class Stream:
    """An ordered queue of device work (§5.1): ops enqueue results here
    so the host can run ahead; ``synchronize()`` joins the tail.  The
    caching allocator keeps one block pool per stream."""

    _next_id = 0
    _lock = threading.Lock()

    def __init__(self, priority: int = 0, _default: bool = False):
        with Stream._lock:
            self.stream_id = Stream._next_id
            Stream._next_id += 1
        self.priority = priority
        self._default = _default
        self._cuda_stream = None
        # Host bookkeeping (CPU): results not yet known to be consumed,
        # a bounded ring so the host can run ahead without leaking.
        self._pending: List[Any] = []
        self._max_pending = 64

    def cuda_stream(self):
        """The ``torch.cuda.Stream`` this stream wraps (made at first
        use)."""
        if self._cuda_stream is None:
            self._cuda_stream = (torch.cuda.default_stream()
                                 if self._default
                                 else torch.cuda.Stream(priority=self.priority))
        return self._cuda_stream

    # -- dispatch ------------------------------------------------------
    def enqueue(self, *arrays: Any) -> None:
        """Note results dispatched on this stream (host bookkeeping; on
        the card the CUDA stream itself orders the work)."""
        if _on_cuda():
            return
        self._pending.extend(arrays)
        if len(self._pending) > self._max_pending:
            del self._pending[: -self._max_pending]

    def synchronize(self) -> None:
        """Block the host until all work on this stream has completed."""
        if _on_cuda():
            self.cuda_stream().synchronize()
        self._pending.clear()
        _alloc.device_allocator().synchronize()

    def query(self) -> bool:
        """True if all submitted work has completed."""
        if _on_cuda():
            return self.cuda_stream().query()
        return True  # CPU ops complete before they return

    def wait_stream(self, other: "Stream") -> None:
        """Make future work on self wait for work already queued on other."""
        if _on_cuda():
            self.cuda_stream().wait_stream(other.cuda_stream())
        else:
            other.synchronize()

    def record_event(self, event: Optional["Event"] = None) -> "Event":
        event = event or Event()
        event.record(self)
        return event

    def wait_event(self, event: "Event") -> None:
        event.wait(self)

    def __repr__(self):
        return f"Stream(id={self.stream_id}, pending={len(self._pending)})"


class Event:
    """Marker on a stream's work (torch.cuda.Event): ``record()`` then
    ``wait()``/``synchronize()``/``query()``; with
    ``enable_timing=True``, ``elapsed_time()`` gives milliseconds."""

    def __init__(self, enable_timing: bool = False):
        self.enable_timing = enable_timing
        self._cuda_event = None
        self._time: Optional[float] = None

    def record(self, stream: Optional[Stream] = None) -> None:
        stream = stream or current_stream()
        if _on_cuda():
            if self._cuda_event is None:
                self._cuda_event = torch.cuda.Event(
                    enable_timing=self.enable_timing)
            self._cuda_event.record(stream.cuda_stream())
        elif self.enable_timing:
            self._time = time.perf_counter()

    def wait(self, stream: Optional[Stream] = None) -> None:
        """Future work on ``stream`` waits for this event's work (on the
        CPU, work is done when its op returns)."""
        if self._cuda_event is not None:
            self._cuda_event.wait((stream or current_stream()).cuda_stream())

    def synchronize(self) -> None:
        if self._cuda_event is not None:
            self._cuda_event.synchronize()

    def query(self) -> bool:
        if self._cuda_event is not None:
            return self._cuda_event.query()
        return True

    def elapsed_time(self, end: "Event") -> float:
        """Milliseconds between two timing events."""
        if not (self.enable_timing and end.enable_timing):
            raise RuntimeError("events must be created with enable_timing=True")
        if self._cuda_event is not None and end._cuda_event is not None:
            return self._cuda_event.elapsed_time(end._cuda_event)
        if self._time is None or end._time is None:
            raise RuntimeError("both events must be recorded first")
        return (end._time - self._time) * 1e3


# -- current-stream state ------------------------------------------------
_tls = threading.local()
_default_stream = Stream(_default=True)


def default_stream() -> Stream:
    """The process-wide stream ops run on outside ``with stream(s):``."""
    return _default_stream


def current_stream() -> Stream:
    """The stream new work lands on in this thread (default unless a
    ``with repro_torch.stream(s):`` scope is active)."""
    return getattr(_tls, "stream", _default_stream)


class stream:
    """Context manager: ``with repro_torch.stream(s): ...`` (on the card
    it also enters ``torch.cuda.stream``)."""

    def __init__(self, s: Stream):
        self._s = s
        self._prev: Optional[Stream] = None
        self._cuda_ctx = None

    def __enter__(self) -> Stream:
        self._prev = current_stream()
        _tls.stream = self._s
        if _on_cuda():
            self._cuda_ctx = torch.cuda.stream(self._s.cuda_stream())
            self._cuda_ctx.__enter__()
        return self._s

    def __exit__(self, *exc) -> None:
        if self._cuda_ctx is not None:
            self._cuda_ctx.__exit__(*exc)
            self._cuda_ctx = None
        _tls.stream = self._prev


def synchronize() -> None:
    """Device-wide synchronize (torch.cuda.synchronize analogue)."""
    if _on_cuda():
        torch.cuda.synchronize()
    _default_stream.synchronize()
    s = getattr(_tls, "stream", None)
    if s is not None and s is not _default_stream:
        s.synchronize()
