"""The torch.multiprocessing analogue (paper §5.4): move array *data*
through shared memory instead of serializing it over the IPC channel.

Counterpart of ``repro/data/shared_memory.py`` (the port keeps its own
copy; it imports nothing of ``repro``).  ``ShmChannel.send`` writes the
array into a ``multiprocessing.shared_memory`` segment and queues only
the (name, shape, dtype) descriptor; ``recv`` maps the segment without a
copy.  ``PickleChannel`` is the baseline the paper improves on (full
serialization).  Both take numpy arrays, and CPU torch tensors through
``.numpy()``.
"""

from __future__ import annotations

import pickle
import queue
from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclass
class ShmDescriptor:
    name: str
    shape: Tuple[int, ...]
    dtype: str


def _as_array(arr) -> np.ndarray:
    # a CUDA tensor raises in .numpy(): the channel moves host memory
    return arr.numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)


class ShmChannel:
    """Single-process-pair channel: descriptors travel through a queue,
    bytes through shared memory (a constant-size message)."""

    def __init__(self, maxsize: int = 8):
        self._q: "queue.Queue[ShmDescriptor]" = queue.Queue(maxsize)
        self._owned: List[shared_memory.SharedMemory] = []
        # receiver-side mappings, kept alive while views of them exist
        self._mapped: List[shared_memory.SharedMemory] = []
        self._recv_cache: Dict[str, shared_memory.SharedMemory] = {}
        # size -> reusable segments (the caching-allocator policy of
        # §5.3 applied to IPC segments)
        self._pool: Dict[int, List[shared_memory.SharedMemory]] = {}

    def send(self, arr) -> ShmDescriptor:
        arr = _as_array(arr)
        size = max(arr.nbytes, 1)
        bucket = self._pool.setdefault(size, [])
        if bucket:
            seg = bucket.pop()
        else:
            seg = shared_memory.SharedMemory(create=True, size=size)
            self._owned.append(seg)
        view = np.ndarray(arr.shape, dtype=arr.dtype, buffer=seg.buf)
        np.copyto(view, arr)
        desc = ShmDescriptor(seg.name, arr.shape, str(arr.dtype))
        self._q.put(desc)
        return desc

    def recycle(self, desc: ShmDescriptor, seg=None) -> None:
        """Return a consumed segment to the pool for reuse."""
        for s_ in self._owned:
            if s_.name == desc.name:
                self._pool.setdefault(s_.size, []).append(s_)
                return

    def recv(self) -> np.ndarray:
        desc = self._q.get()
        seg = self._recv_cache.get(desc.name)
        if seg is None:
            seg = shared_memory.SharedMemory(name=desc.name)
            self._recv_cache[desc.name] = seg
            self._mapped.append(seg)
        return np.ndarray(desc.shape, dtype=np.dtype(desc.dtype),
                          buffer=seg.buf)

    def close(self) -> None:
        # a mapping with live views cannot be closed (BufferError): it is
        # unmapped when its last view dies; the segment is unlinked anyway
        for seg in self._mapped:
            try:
                seg.close()
            except BufferError:
                pass
        self._mapped.clear()
        self._recv_cache.clear()
        for seg in self._owned:
            try:
                seg.close()
            except BufferError:
                pass
            try:
                seg.unlink()
            except FileNotFoundError:
                pass
        self._owned.clear()
        self._pool.clear()


class PickleChannel:
    """Baseline: the default multiprocessing transport (serialize the
    bytes)."""

    def __init__(self, maxsize: int = 8):
        self._q: "queue.Queue[bytes]" = queue.Queue(maxsize)

    def send(self, arr) -> None:
        self._q.put(pickle.dumps(_as_array(arr),
                                 protocol=pickle.HIGHEST_PROTOCOL))

    def recv(self) -> np.ndarray:
        return pickle.loads(self._q.get())

    def close(self) -> None:
        pass
