"""The port's data pipeline (``repro_torch.data``) against the JAX
package's (``repro.data``): the reference's ``TestData`` cases re-run on
the port, dataset items, sampler orders and loader batches equal to the
reference's for the same seeds, straggler refetch, and the shared-memory
and pickle channels.  Everything here is exact: both packages draw with
the same numpy generators."""

import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro
import repro.data as jdata
import repro_torch as rt
from repro_torch.data import (BatchSampler, DataLoader, DistributedSampler,
                              RandomSampler, SequentialSampler,
                              SyntheticLMDataset, TensorDataset,
                              default_collate)
from repro_torch.data.shared_memory import PickleChannel, ShmChannel
from torch_port_helpers import port_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cpu")


def host(t) -> np.ndarray:
    return t.numpy()


# ----------------------------------------------------------------------
# the reference's TestData (tests/test_nn_optim_data.py), on the port
# ----------------------------------------------------------------------

def test_tensor_dataset_loader():
    x = rt.randn(20, 3)
    y = rt.arange(20)
    dl = DataLoader(TensorDataset(x, y), batch_size=6)
    batches = list(dl)
    assert len(batches) == 4
    assert batches[0][0].shape == (6, 3)
    assert batches[-1][0].shape == (2, 3)
    np.testing.assert_array_equal(host(batches[-1][1]), [18, 19])


def test_drop_last():
    ds = SyntheticLMDataset(50, 4, size=20)
    assert len(DataLoader(ds, batch_size=6, drop_last=True)) == 3
    assert len(list(DataLoader(ds, batch_size=6, drop_last=True))) == 3


def test_workers_and_pinned():
    ds = SyntheticLMDataset(100, 8, size=32)
    dl = DataLoader(ds, batch_size=4, num_workers=3, pin_memory=True,
                    shuffle=True, seed=1)
    seen = [tuple(host(t)[0, :3]) for t, _ in dl]
    assert len(seen) == 8
    # the CPU was asked for: nothing is staged or pinned
    assert dl.staging.copies == 0


def test_determinism_with_seed():
    ds = SyntheticLMDataset(100, 8, size=32)
    a = [host(t) for t, _ in DataLoader(ds, batch_size=4, shuffle=True,
                                        seed=7)]
    b = [host(t) for t, _ in DataLoader(ds, batch_size=4, shuffle=True,
                                        seed=7)]
    assert len(a) == 8
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@given(n=st.integers(4, 100), reps=st.integers(1, 8))
@settings(max_examples=30, deadline=None)
def test_distributed_sampler_partition(n, reps):
    """Ranks partition the (pad-extended) indices without overlap."""
    ds = list(range(n))
    all_idx, lens = [], set()
    for rank in range(reps):
        s = DistributedSampler(ds, num_replicas=reps, rank=rank,
                               shuffle=True, seed=3)
        idx = list(iter(s))
        lens.add(len(idx))
        all_idx.extend(idx)
    assert len(lens) == 1
    assert set(all_idx) == set(range(n))
    assert len(all_idx) == -(-n // reps) * reps


class SlowDS(SyntheticLMDataset):
    def __getitem__(self, i):
        if i == 5:
            time.sleep(0.3)
        return super().__getitem__(i)


def test_straggler_refetch():
    ds = SlowDS(50, 4, size=16)
    dl = DataLoader(ds, batch_size=4, num_workers=2, worker_timeout_s=0.05)
    batches = [host(t) for t, _ in dl]
    assert len(batches) == 4
    assert dl.straggler_events >= 1
    # the refetched batch is the one the worker was late with
    want = [host(t) for t, _ in DataLoader(SyntheticLMDataset(50, 4,
                                                              size=16),
                                           batch_size=4)]
    for got, ref in zip(batches, want):
        np.testing.assert_array_equal(got, ref)


def test_shm_channel_zero_copy_vs_pickle():
    arr = np.random.default_rng(0).standard_normal(
        (256, 256)).astype(np.float32)
    shm = ShmChannel()
    shm.send(arr)
    out = shm.recv()
    np.testing.assert_array_equal(out, arr)
    del out
    shm.close()
    pk = PickleChannel()
    pk.send(arr)
    np.testing.assert_array_equal(pk.recv(), arr)


# ----------------------------------------------------------------------
# equal to the reference for the same seeds
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_items_equal_the_reference(seed):
    ours = SyntheticLMDataset(256000, 64, size=100, seed=seed)
    ref = jdata.SyntheticLMDataset(256000, 64, size=100, seed=seed)
    assert len(ours) == len(ref)
    for i in (0, 1, 57, 99):
        for a, b in zip(ours[i], ref[i]):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@given(n=st.integers(1, 300), seed=st.integers(0, 50),
       epoch=st.integers(0, 4))
@settings(max_examples=25, deadline=None)
def test_random_sampler_order_equals_the_reference(n, seed, epoch):
    ours, ref = RandomSampler(range(n), seed=seed), \
        jdata.RandomSampler(range(n), seed=seed)
    ours.set_epoch(epoch)
    ref.set_epoch(epoch)
    assert list(ours) == list(ref)
    assert len(ours) == len(ref) == n


@given(n=st.integers(1, 200), reps=st.integers(1, 9),
       seed=st.integers(0, 20), epoch=st.integers(0, 3),
       flags=st.sampled_from([(True, False), (True, True), (False, False),
                              (False, True)]))
@settings(max_examples=30, deadline=None)
def test_distributed_sampler_order_equals_the_reference(n, reps, seed,
                                                        epoch, flags):
    shuffle, drop_last = flags
    for rank in range(reps):
        kw = dict(num_replicas=reps, rank=rank, shuffle=shuffle, seed=seed,
                  drop_last=drop_last)
        ours = DistributedSampler(range(n), **kw)
        ref = jdata.DistributedSampler(range(n), **kw)
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert list(ours) == list(ref)
        assert len(ours) == len(ref)


def test_distributed_sampler_refuses_a_rank_outside():
    with pytest.raises(ValueError, match="rank 2 >= num_replicas 2"):
        DistributedSampler(range(4), num_replicas=2, rank=2)


@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_sampler_equals_the_reference(drop_last):
    ours = BatchSampler(SequentialSampler(range(11)), 4, drop_last)
    ref = jdata.BatchSampler(jdata.SequentialSampler(range(11)), 4,
                             drop_last)
    assert list(ours) == list(ref)
    assert len(ours) == len(ref)


@pytest.mark.parametrize("workers", [0, 3])
def test_loader_batches_equal_the_reference(workers):
    kw = dict(batch_size=5, shuffle=True, seed=7, num_workers=workers,
              drop_last=True)
    ours = DataLoader(SyntheticLMDataset(1000, 16, size=64, seed=2), **kw)
    ref = jdata.DataLoader(jdata.SyntheticLMDataset(1000, 16, size=64,
                                                    seed=2), **kw)
    got = list(ours)
    want = list(ref)
    assert len(got) == len(want) == len(ours) == 12
    for (t, l), (jt, jl) in zip(got, want):
        assert isinstance(t, rt.Tensor) and t.device.type == "cpu"
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(host(t), np.asarray(jt.data))
        np.testing.assert_array_equal(host(l), np.asarray(jl.data))


def test_set_epoch_reshuffles_as_the_reference():
    kw = dict(batch_size=4, shuffle=True, seed=5)
    ours = DataLoader(SyntheticLMDataset(50, 4, size=16), **kw)
    ref = jdata.DataLoader(jdata.SyntheticLMDataset(50, 4, size=16), **kw)
    first = [host(t) for t, _ in ours]
    ours.set_epoch(1)
    ref.set_epoch(1)
    second = [host(t) for t, _ in ours]
    assert any((a != b).any() for a, b in zip(first, second))
    for a, (jt, _) in zip(second, ref):
        np.testing.assert_array_equal(a, np.asarray(jt.data))


def test_collate_nested_and_tensors():
    items = [{"x": np.full(3, i, np.float32), "y": (i, rt.tensor([i, i]))}
             for i in range(4)]
    out = default_collate(items)
    np.testing.assert_array_equal(out["x"][:, 0], np.arange(4))
    np.testing.assert_array_equal(out["y"][0], np.arange(4))
    np.testing.assert_array_equal(out["y"][1],
                                  np.repeat(np.arange(4)[:, None], 2, 1))
    ref = repro.data.default_collate(
        [{"x": it["x"], "y": (it["y"][0], it["y"][1].numpy())}
         for it in items])
    np.testing.assert_array_equal(out["y"][1], ref["y"][1])


def test_tensor_dataset_refuses_ragged_lengths():
    with pytest.raises(ValueError, match="differ in length"):
        TensorDataset(np.zeros((3, 2)), np.zeros(4))


def test_loader_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dl = DataLoader(SyntheticLMDataset(10, 4, size=8), batch_size=2)
    with rt.default_device(None):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(iter(dl))


# ----------------------------------------------------------------------
# channels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int32", "uint8", "float64"])
def test_channels_round_trip_numpy_and_torch(dtype):
    rng = np.random.default_rng(1)
    arr = (rng.standard_normal((7, 33)) * 50).astype(dtype)
    shm, pk = ShmChannel(), PickleChannel()
    try:
        for payload in (arr, torch.from_numpy(arr.copy())):
            desc = shm.send(payload)
            assert desc.shape == arr.shape and desc.dtype == dtype
            np.testing.assert_array_equal(shm.recv(), arr)
            pk.send(payload)
            np.testing.assert_array_equal(pk.recv(), arr)
    finally:
        shm.close()
        pk.close()


def test_shm_recycle_reuses_the_segment():
    shm = ShmChannel()
    try:
        a = np.arange(64, dtype=np.float32)
        d1 = shm.send(a)
        np.testing.assert_array_equal(shm.recv(), a)
        shm.recycle(d1)
        d2 = shm.send(a * 2)
        assert d2.name == d1.name            # pooled, not a new segment
        np.testing.assert_array_equal(shm.recv(), a * 2)
        d3 = shm.send(np.zeros(10, np.int64))
        assert d3.name != d1.name
        shm.recv()
    finally:
        shm.close()


def test_channels_refuse_tensors_off_the_host():
    t = torch.zeros(3, device="meta")
    with pytest.raises((TypeError, RuntimeError, NotImplementedError)):
        ShmChannel().send(t)
