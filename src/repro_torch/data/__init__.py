"""repro_torch.data — datasets and loaders (paper §4.2, §5.4).

Counterpart of ``repro/data/__init__.py``.  ``Dataset`` is the paper's
two-method protocol (``__getitem__`` + ``__len__``); ``DataLoader`` adds
shuffling, batching, parallel workers and staged host memory.  The
datasets and samplers are the reference's numpy code, so the same seed
gives the same tokens and the same index order.

Workers are a thread pool, as in the reference: the hot loop is numpy C
code that releases the GIL.  A process + ``multiprocessing.
shared_memory`` channel is in ``repro_torch.data.shared_memory``.

Batches come out as the eager runtime's :class:`repro_torch.Tensor` on
``repro_torch.current_device()`` (CUDA unless a ``with
repro_torch.default_device("cpu"):`` scope names the CPU).  With
``pin_memory=True`` and a CUDA target, each array is staged in
page-locked host memory and copied to the card with ``non_blocking=True``
on the loader's own copy stream (a ``repro_torch.Stream``); the
consumer's stream waits on an event recorded after the copy, and the
pinned buffer goes back to the loader's pool of buffers only when that
event has completed, so no batch is read from a buffer already
refilled.  The staged bytes are counted in
``repro_torch.allocator.host_allocator()``, as the reference counts its
staging blocks, and in :attr:`DataLoader.staging`.  A CPU target stages
nothing: the caller asked for the CPU.

Straggler mitigation: a per-batch worker deadline; on timeout the batch
is refetched inline and the event is counted (``straggler_events``).
"""

from __future__ import annotations

import collections
import queue
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import (Any, Callable, Deque, Dict, Generic, Iterator, List,
                    Optional, Sequence, Set, Tuple, TypeVar)

import numpy as np
import torch

from .. import _device
from ..core import allocator as _alloc
from ..core import stream as _stream
from ..core.tensor import Tensor

T_co = TypeVar("T_co", covariant=True)


class Dataset(Generic[T_co]):
    """Map-style dataset: implement ``__getitem__`` and ``__len__``."""

    def __getitem__(self, index: int) -> T_co:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class IterableDataset(Generic[T_co]):
    def __iter__(self) -> Iterator[T_co]:
        raise NotImplementedError


def _host_array(t) -> np.ndarray:
    if isinstance(t, Tensor):
        return t.numpy()
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class TensorDataset(Dataset):
    def __init__(self, *tensors):
        if any(t.shape[0] != tensors[0].shape[0] for t in tensors):
            raise ValueError("TensorDataset: tensors differ in length")
        self.tensors = [_host_array(t) for t in tensors]

    def __getitem__(self, index: int):
        return tuple(t[index] for t in self.tensors)

    def __len__(self) -> int:
        return len(self.tensors[0])


class SyntheticLMDataset(Dataset):
    """Deterministic synthetic token stream (hash-based, no I/O), the
    reference's: item ``i`` is drawn from ``default_rng(seed * 1_000_003
    + i)``."""

    def __init__(self, vocab_size: int, seq_len: int, size: int = 1 << 16,
                 seed: int = 0):
        self.vocab_size, self.seq_len, self.size = vocab_size, seq_len, size
        self.seed = seed

    def __getitem__(self, index: int):
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        tokens = rng.integers(0, self.vocab_size,
                              size=self.seq_len + 1).astype(np.int32)
        return tokens[:-1], tokens[1:]

    def __len__(self) -> int:
        return self.size


# ----------------------------------------------------------------------
# samplers (the reference's numpy permutations)
# ----------------------------------------------------------------------

class Sampler:
    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, data_source):
        self.n = len(data_source)

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n


class RandomSampler(Sampler):
    def __init__(self, data_source, seed: Optional[int] = None):
        self.n = len(data_source)
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(
            None if self.seed is None else self.seed + self._epoch)
        return iter(rng.permutation(self.n).tolist())

    def __len__(self):
        return self.n


class DistributedSampler(Sampler):
    """Shards indices across data-parallel replicas: each rank sees
    len(dataset)/num_replicas samples, padded to equal length so
    collectives stay aligned."""

    def __init__(self, dataset, num_replicas: int, rank: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        if rank >= num_replicas:
            raise ValueError(f"rank {rank} >= num_replicas {num_replicas}")
        self.dataset_len = len(dataset)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        if drop_last:
            self.num_samples = self.dataset_len // num_replicas
        else:
            self.num_samples = -(-self.dataset_len // num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self):
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            indices = rng.permutation(self.dataset_len).tolist()
        else:
            indices = list(range(self.dataset_len))
        if not self.drop_last:
            pad = self.total_size - len(indices)
            indices += indices[:pad]
        else:
            indices = indices[: self.total_size]
        return iter(indices[self.rank: self.total_size: self.num_replicas])

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, sampler: Sampler, batch_size: int, drop_last: bool):
        self.sampler, self.batch_size, self.drop_last = \
            sampler, batch_size, drop_last

    def __iter__(self):
        batch: List[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))


# ----------------------------------------------------------------------
# collation and staging
# ----------------------------------------------------------------------

def default_collate(items: Sequence[Any]):
    first = items[0]
    if isinstance(first, (tuple, list)):
        return tuple(default_collate([it[i] for it in items])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, np.ndarray):
        return np.stack(items)
    if isinstance(first, (Tensor, torch.Tensor)):
        return np.stack([_host_array(t) for t in items])
    return np.asarray(items)


@dataclass
class StagingStats:
    """What the pinned path of one loader has staged: copies, bytes, and
    whether every staging buffer was page-locked; ``streams`` holds the
    ``stream_id`` of every CUDA stream a copy was issued on (the copy
    stream's alone, when the path works as designed)."""

    copies: int = 0
    bytes: int = 0
    all_pinned: bool = True
    streams: Set[int] = field(default_factory=set)


class _PinnedStager:
    """Pinned staging for one pass over a loader: a page-locked buffer
    from the loader's pool, a ``non_blocking`` copy on the copy stream,
    the consumer's stream made to wait on it, and the buffer (with its
    host-allocator block) kept out of the pool until the copy's event
    has completed."""

    def __init__(self, dev: torch.device, copy: _stream.Stream,
                 stats: StagingStats, pool: Dict[int, List[torch.Tensor]]):
        self.dev, self.copy, self.stats, self.pool = dev, copy, stats, pool
        self.inflight: Deque[Tuple[torch.cuda.Event, torch.Tensor,
                                   _alloc.Block]] = collections.deque()

    def release(self, wait: bool) -> None:
        """Return the buffers whose copies have completed to the pool
        (all of them, after waiting, when ``wait``)."""
        while self.inflight and (wait or self.inflight[0][0].query()):
            done, buf, block = self.inflight.popleft()
            done.synchronize()
            self.pool.setdefault(buf.numel(), []).append(buf)
            _alloc.host_allocator().free(block)

    def __call__(self, arr: np.ndarray) -> torch.Tensor:
        self.release(wait=False)
        src = torch.from_numpy(arr)
        if not arr.nbytes:
            return src.to(self.dev)
        block = _alloc.host_allocator().allocate(
            arr.nbytes, stream=self.copy.stream_id)
        bucket = self.pool.get(arr.nbytes)
        buf = bucket.pop() if bucket else torch.empty(
            arr.nbytes, dtype=torch.uint8, pin_memory=True)
        staged = buf.view(src.dtype).view(src.shape)
        staged.copy_(src)
        consumer = torch.cuda.current_stream(self.dev)
        with _stream.stream(self.copy):
            issued_on = torch.cuda.current_stream(self.dev)
            out = staged.to(self.dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(issued_on)
        consumer.wait_event(done)
        # ``out`` came from the copy stream's pool and is used on the
        # consumer's: its memory is not reused before that work is done
        out.record_stream(consumer)
        self.inflight.append((done, buf, block))
        self.stats.copies += 1
        self.stats.bytes += arr.nbytes
        self.stats.all_pinned &= staged.is_pinned()
        self.stats.streams.add(issued_on.stream_id)
        return out


def _stage_and_transfer(batch, to_device: Callable):
    """numpy batch (tuple / dict / array) -> the eager runtime's
    Tensors, each array moved by ``to_device``."""
    if isinstance(batch, tuple):
        return tuple(_stage_and_transfer(b, to_device) for b in batch)
    if isinstance(batch, dict):
        return {k: _stage_and_transfer(v, to_device)
                for k, v in batch.items()}
    return Tensor(to_device(batch))


# ----------------------------------------------------------------------
# DataLoader
# ----------------------------------------------------------------------

class DataLoader(Generic[T_co]):
    def __init__(self, dataset: Dataset, batch_size: int = 1,
                 shuffle: bool = False, sampler: Optional[Sampler] = None,
                 batch_sampler: Optional[BatchSampler] = None,
                 num_workers: int = 0,
                 collate_fn: Optional[Callable] = None,
                 pin_memory: bool = False, drop_last: bool = False,
                 prefetch_factor: int = 2,
                 worker_timeout_s: Optional[float] = None,
                 seed: Optional[int] = None):
        self.dataset = dataset
        self.num_workers = num_workers
        self.collate_fn = collate_fn or default_collate
        self.pin_memory = pin_memory
        self.prefetch_factor = max(1, prefetch_factor)
        self.worker_timeout_s = worker_timeout_s
        self.straggler_events = 0
        self.staging = StagingStats()
        self._copy_stream: Optional[_stream.Stream] = None
        # page-locked staging buffers by size, reused across passes
        self._pinned: Dict[int, List[torch.Tensor]] = {}

        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            if sampler is None:
                sampler = (RandomSampler(dataset, seed=seed) if shuffle
                           else SequentialSampler(dataset))
            self.sampler = sampler
            self.batch_sampler = BatchSampler(sampler, batch_size, drop_last)

    def __len__(self):
        return len(self.batch_sampler)

    def set_epoch(self, epoch: int):
        s = getattr(self, "sampler", None)
        if s is not None and hasattr(s, "set_epoch"):
            s.set_epoch(epoch)

    def _fetch(self, indices: List[int]):
        return self.collate_fn([self.dataset[i] for i in indices])

    def _batches(self):
        """Collated numpy batches in the sampler's order."""
        if self.num_workers == 0:
            for indices in self.batch_sampler:
                yield self._fetch(indices)
            return
        # threaded prefetch pipeline with bounded depth
        depth = self.num_workers * self.prefetch_factor
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            batches = iter(self.batch_sampler)
            inflight: "queue.Queue" = queue.Queue()
            for indices in batches:
                inflight.put((pool.submit(self._fetch, indices), indices))
                if inflight.qsize() >= depth:
                    break
            while not inflight.empty():
                fut, indices = inflight.get()
                # straggler mitigation: deadline + inline refetch
                try:
                    batch = fut.result(timeout=self.worker_timeout_s)
                except TimeoutError:
                    self.straggler_events += 1
                    fut.cancel()
                    batch = self._fetch(indices)
                nxt = next(batches, None)
                if nxt is not None:
                    inflight.put((pool.submit(self._fetch, nxt), nxt))
                yield batch

    def __iter__(self):
        dev = _device.current_device()
        stager = None
        if dev.type == "cuda" and self.pin_memory:
            if self._copy_stream is None:
                self._copy_stream = _stream.Stream()
            stager = _PinnedStager(dev, self._copy_stream, self.staging,
                                   self._pinned)
            to_device = stager
        else:
            def to_device(arr):
                return torch.from_numpy(arr).to(dev)
        try:
            for batch in self._batches():
                yield _stage_and_transfer(batch, to_device)
        finally:
            if stager is not None:
                stager.release(wait=True)
