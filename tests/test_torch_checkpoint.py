"""The port's checkpointing (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``): the reference's ``TestCheckpoint``
cases on the port (all but the mesh one: elastic restore waits for
sharding), bf16 and fp8 leaves round-tripped bit for bit, restore onto a
``like_state``'s dtypes, the same numpy tree saved by both managers
giving the same archive, and an archive plain numpy reads."""

import json
import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro_torch.checkpoint import (SEP, CheckpointManager,
                                    install_preemption_handler)


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as integers (NaN payloads and -0.0 too)."""
    if not t.dtype.is_floating_point:
        return t
    return t.view({4: torch.int32, 2: torch.int16,
                   1: torch.uint8}[t.element_size()])


def assert_same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_tree(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(bits(a), bits(b))


# ----------------------------------------------------------------------
# the reference's TestCheckpoint (tests/test_checkpoint_distributed.py)
# ----------------------------------------------------------------------

def test_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "step": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 7)
    restored = mgr.restore_latest(state)
    np.testing.assert_allclose(restored["params"]["w"].numpy(),
                               state["params"]["w"].numpy())
    assert int(restored["step"]) == 7


def test_atomicity_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"x": torch.ones(3)}, 1)
    names = os.listdir(tmp_path)
    assert "step_1" in names
    assert not any(n.endswith(".tmp") for n in names)
    assert os.path.exists(tmp_path / "step_1" / "manifest.json")


def test_keep_n_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save({"x": torch.ones(2) * s}, s)
    assert mgr.all_steps() == [3, 4]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async({"x": torch.ones(4)}, 5)
    mgr.wait()
    assert mgr.all_steps() == [5]


def test_restore_latest_none_when_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest({"x": torch.ones(1)}) is None


# ----------------------------------------------------------------------
# the port's own cases
# ----------------------------------------------------------------------

def lm_like_state(seed: int, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    p = {"embed": torch.randn(11, 8, generator=g).to(dtype),
         "final_norm": torch.randn(8, generator=g),
         "layers": [{"attn": {"wq": torch.randn(8, 8, generator=g).to(dtype)},
                     "norm1": torch.randn(8, generator=g)}
                    for _ in range(2)]}
    opt = {"m": {k: v for k, v in p.items()}, "step":
           torch.tensor(seed, dtype=torch.int32)}
    return {"params": p, "opt": opt,
            "step": torch.tensor(seed, dtype=torch.int32)}


def test_bf16_and_fp8_leaves_round_trip_bit_for_bit(tmp_path):
    state = lm_like_state(1)
    state["fp8"] = torch.randn(5, 3).to(torch.float8_e4m3fn)
    # bf16 NaN and -0.0 payloads survive too
    state["params"]["embed"][0, :2] = torch.tensor(
        [float("nan"), -0.0]).bfloat16()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 3)
    like = lm_like_state(9)
    like["fp8"] = torch.zeros(5, 3, dtype=torch.float8_e4m3fn)
    assert_same_tree(mgr.restore(3, like), state)
    manifest = json.loads((tmp_path / "step_3" / "manifest.json"
                           ).read_text())
    assert manifest["dtypes"]["params|embed"] == "bfloat16"
    assert manifest["dtypes"]["fp8"] == "float8_e4m3fn"
    assert "params|final_norm" not in manifest["dtypes"]


def test_restore_takes_the_like_states_dtypes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    w = torch.randn(4, 6)
    mgr.save({"w": w, "n": torch.arange(3)}, 1)
    out = mgr.restore(1, {"w": torch.zeros(4, 6, dtype=torch.bfloat16),
                          "n": torch.zeros(3, dtype=torch.int32)})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], w.bfloat16())
    assert out["n"].dtype == torch.int32
    assert out["n"].tolist() == [0, 1, 2]


def test_async_snapshot_is_taken_at_the_call(tmp_path):
    """The train step updates its state in place: the write must hold
    the values of the call, not of the moment the thread writes."""
    state = lm_like_state(2, torch.float32)
    before = {k: v.clone() for k, v in state["params"].items()
              if isinstance(v, torch.Tensor)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(state, 4)
    state["params"]["embed"].add_(1.0)
    state["params"]["final_norm"].zero_()
    mgr.wait()
    out = mgr.restore(4, state)
    for k, v in before.items():
        assert torch.equal(out["params"][k], v)


def test_background_write_error_is_raised_by_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", broken)
    mgr.save_async({"x": torch.ones(2)}, 1)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                             # raised once, then clear


def test_same_tree_gives_the_reference_archive(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"params": {"b": rng.standard_normal(3).astype(np.float32),
                       "a": [rng.standard_normal((2, 2)).astype(np.float32),
                             rng.integers(0, 9, 4).astype(np.int32)]},
            "step": np.int32(12), "opt": {"count": np.int64(3)}}
    CheckpointManager(str(tmp_path / "port")).save(tree, 12)
    JManager(str(tmp_path / "ref")).save(
        {"params": {"b": jnp.asarray(tree["params"]["b"]),
                    "a": [jnp.asarray(x) for x in tree["params"]["a"]]},
         "step": jnp.int32(12), "opt": {"count": np.int64(3)}}, 12)
    mp, mr = (json.loads((tmp_path / d / "step_12" / "manifest.json"
                          ).read_text()) for d in ("port", "ref"))
    assert mp["keys"] == mr["keys"] == sorted(
        ["params|b", "params|a|0", "params|a|1", "step", "opt|count"])
    assert mp["step"] == mr["step"] == 12
    with np.load(tmp_path / "port" / "step_12" / "arrays.npz") as a, \
            np.load(tmp_path / "ref" / "step_12" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    # and each manager restores the other's archive
    ref_tree = JManager(str(tmp_path / "port")).restore(
        12, {"params": {"b": jnp.zeros(3), "a": [jnp.zeros((2, 2)),
                                                 jnp.zeros(4, jnp.int32)]},
             "step": jnp.int32(0), "opt": {"count": jnp.int32(0)}})
    np.testing.assert_array_equal(np.asarray(ref_tree["params"]["a"][0]),
                                  tree["params"]["a"][0])
    port_tree = CheckpointManager(str(tmp_path / "ref")).restore(
        12, {"params": {"b": torch.zeros(3), "a": [torch.zeros(2, 2),
                                                   torch.zeros(4)]},
             "step": torch.zeros((), dtype=torch.int32),
             "opt": {"count": None}})
    np.testing.assert_array_equal(port_tree["params"]["a"][1].numpy(),
                                  tree["params"]["a"][1])
    assert port_tree["params"]["a"][1].dtype == torch.float32
    assert int(port_tree["step"]) == 12
    assert port_tree["opt"]["count"] is None


def test_plain_numpy_reads_the_archive_without_torch(tmp_path):
    state = lm_like_state(3)
    CheckpointManager(str(tmp_path)).save(state, 2)
    code = (
        "import json, sys, numpy as np\n"
        f"d = {str(tmp_path / 'step_2')!r}\n"
        "m = json.load(open(d + '/manifest.json'))\n"
        "a = np.load(d + '/arrays.npz')\n"
        "assert sorted(a.files) == m['keys']\n"
        "w = a['params|embed']\n"
        "assert w.dtype == np.uint16 and w.shape == (11, 8)\n"
        "assert m['dtypes']['params|embed'] == 'bfloat16'\n"
        "f32 = (w.astype(np.uint32) << 16).view(np.float32)\n"
        "assert 'torch' not in sys.modules and 'jax' not in sys.modules\n"
        "print(repr(float(f32[1, 1])))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert float(out.stdout) == float(state["params"]["embed"][1, 1])


def test_keys_join_dict_keys_and_list_indices():
    from repro_torch.checkpoint import _leaves
    keys = [k for k, _ in _leaves({"b": [1, {"z": 2, "y": 3}], "a": 4,
                                   "n": None})]
    assert keys == ["a", f"b{SEP}0", f"b{SEP}1{SEP}y", f"b{SEP}1{SEP}z"]


def test_preemption_handler_saves_then_exits(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = {"x": torch.arange(3.0)}
    old = signal.getsignal(signal.SIGTERM)
    try:
        install_preemption_handler(mgr, lambda: state, lambda: 17)
        handler = signal.getsignal(signal.SIGTERM)
        with pytest.raises(SystemExit) as ei:
            handler(signal.SIGTERM, None)
        assert ei.value.code == 128 + signal.SIGTERM
    finally:
        signal.signal(signal.SIGTERM, old)
    assert mgr.all_steps() == [17]
    assert torch.equal(mgr.restore(17, state)["x"], state["x"])
