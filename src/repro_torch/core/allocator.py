"""Caching memory allocator (paper §5.3): the accounting layer.

Counterpart of ``repro/core/allocator.py``, with the same policies and
the same ``memory_stats`` keys: allocations rounded up to multiples of
512 bytes, one free pool per stream, blocks reused without touching the
system allocator, ``empty_cache()`` to release.

On the card the physical memory of every eager tensor is held by
PyTorch's own CUDA caching allocator (``torch.cuda.memory_allocated``,
``max_memory_allocated``); this module keeps the paper's allocator as an
accounting layer over the eager runtime's tensor lifetimes, so that the
refcounted frees of §5.5 and the first-iteration allocation storm stay
observable with the reference's keys.  ``backed=True`` blocks carry real
``numpy`` buffers (the host staging / pinned-memory analogue).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# Paper §5.3: "it rounds up allocations to multiples of 512 bytes to avoid
# fragmentation issues."
ROUND_BYTES = 512
# Large allocations get their own segments (mirrors the CUDA allocator's
# small/large pool split at 1MB).
SMALL_LIMIT = 1 << 20


def round_size(nbytes: int) -> int:
    if nbytes <= 0:
        return ROUND_BYTES
    return (nbytes + ROUND_BYTES - 1) // ROUND_BYTES * ROUND_BYTES


@dataclass
class Block:
    """One cached allocation."""

    size: int                      # rounded size in bytes
    stream: int                    # owning stream id (one pool per stream)
    requested: int = 0             # last requested (un-rounded) size
    buffer: Optional[np.ndarray] = None   # host arena backing, if any
    live: bool = False
    alloc_id: int = -1


@dataclass
class AllocatorStats:
    num_system_allocs: int = 0     # "cudaMalloc" equivalents
    num_system_frees: int = 0      # "cudaFree" equivalents
    num_cache_hits: int = 0
    num_cache_misses: int = 0
    bytes_active: int = 0          # currently live
    bytes_reserved: int = 0        # live + cached
    peak_bytes_active: int = 0
    peak_bytes_reserved: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


class CachingAllocator:
    """Incremental caching block allocator with one free-pool per stream.

    ``backed=True`` makes blocks carry real ``numpy`` buffers (host staging /
    pinned-memory analogue); ``backed=False`` runs pure accounting for device
    tensors whose physical memory is owned by PyTorch's caching allocator.
    """

    def __init__(self, *, backed: bool = False, name: str = "device"):
        self.backed = backed
        self.name = name
        self._lock = threading.RLock()
        # (stream, rounded_size) -> free blocks.  One pool per stream:
        # paper §5.3 "maintains a distinct pool of memory for every CUDA
        # stream (work queue)".
        self._free: Dict[int, Dict[int, List[Block]]] = {}
        self.stats = AllocatorStats()
        self._next_alloc_id = 0
        # Streams whose frees must synchronize before reuse on another
        # stream (recorded by Stream.record_event / tensor.record_stream).
        self._cross_stream_pending: List[Block] = []

    # ------------------------------------------------------------------
    def allocate(self, nbytes: int, stream: int = 0) -> Block:
        size = round_size(nbytes)
        with self._lock:
            pool = self._free.setdefault(stream, {})
            bucket = pool.get(size)
            if bucket:
                block = bucket.pop()
                block.live = True
                block.requested = nbytes
                self.stats.num_cache_hits += 1
            else:
                block = self._system_alloc(size, stream)
                block.requested = nbytes
                self.stats.num_cache_misses += 1
            block.alloc_id = self._next_alloc_id
            self._next_alloc_id += 1
            self.stats.bytes_active += size
            self.stats.peak_bytes_active = max(
                self.stats.peak_bytes_active, self.stats.bytes_active
            )
            return block

    def free(self, block: Block, stream: Optional[int] = None) -> None:
        """Return a block to its stream pool (immediately reusable on the
        same stream — §5.3's run-ahead argument).  Freeing on a *different*
        stream than the allocation requires an event sync; we model that by
        placing the block on a pending list drained at ``synchronize``.
        """
        with self._lock:
            if not block.live:
                return
            block.live = False
            self.stats.bytes_active -= block.size
            if stream is not None and stream != block.stream:
                # cross-stream free: defer reuse until synchronization
                self._cross_stream_pending.append(block)
                return
            self._free.setdefault(block.stream, {}).setdefault(
                block.size, []
            ).append(block)

    def synchronize(self) -> None:
        """Drain cross-stream frees (called by Stream.synchronize)."""
        with self._lock:
            for block in self._cross_stream_pending:
                self._free.setdefault(block.stream, {}).setdefault(
                    block.size, []
                ).append(block)
            self._cross_stream_pending.clear()

    def empty_cache(self) -> int:
        """Release cached blocks back to the system; returns bytes freed."""
        with self._lock:
            freed = 0
            for pool in self._free.values():
                for bucket in pool.values():
                    for block in bucket:
                        freed += block.size
                        block.buffer = None
                        self.stats.num_system_frees += 1
                    bucket.clear()
            self.stats.bytes_reserved -= freed
            return freed

    def memory_stats(self) -> Dict[str, int]:
        with self._lock:
            return self.stats.as_dict()

    def reset_peak_stats(self) -> None:
        with self._lock:
            self.stats.peak_bytes_active = self.stats.bytes_active
            self.stats.peak_bytes_reserved = self.stats.bytes_reserved

    # ------------------------------------------------------------------
    def _system_alloc(self, size: int, stream: int) -> Block:
        # The expensive path ("cudaMalloc"): on the host arena this is a
        # real numpy allocation; for device accounting it is bookkeeping.
        buffer = np.empty(size, dtype=np.uint8) if self.backed else None
        self.stats.num_system_allocs += 1
        self.stats.bytes_reserved += size
        self.stats.peak_bytes_reserved = max(
            self.stats.peak_bytes_reserved, self.stats.bytes_reserved
        )
        return Block(size=size, stream=stream, buffer=buffer, live=True)


# Global allocators -----------------------------------------------------
_device_allocator = CachingAllocator(backed=False, name="device")
_host_allocator = CachingAllocator(backed=True, name="host")


def device_allocator() -> CachingAllocator:
    return _device_allocator


def host_allocator() -> CachingAllocator:
    return _host_allocator


def memory_stats() -> Dict[str, int]:
    return _device_allocator.memory_stats()


def empty_cache() -> int:
    return _device_allocator.empty_cache() + _host_allocator.empty_cache()
