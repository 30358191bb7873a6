"""Fault-tolerant checkpointing.

Counterpart of ``repro/checkpoint/__init__.py``, with the same file
format: ``step_N/arrays.npz`` holds one array per leaf of the state,
keyed by the leaf's path (dict keys and list indices joined by ``SEP``,
``"|"``), beside ``step_N/manifest.json`` (step, time, sorted keys).

  * atomic checkpoints: write ``step_N.tmp/``, then rename; a crash
    mid-save never corrupts the latest restorable state;
  * async save: the caller's thread snapshots every leaf to host memory
    (a ``.cpu()`` copy, which waits for the card) and a background thread
    writes the files, so the step loop runs on;
  * restore onto the devices and dtypes of a ``like_state`` tree;
  * preemption hook: ``install_preemption_handler`` saves on SIGTERM;
  * retention: the newest ``keep_n`` checkpoints are kept.

numpy has no bfloat16 or float8 without an extra package, so those
leaves are stored as their bits (``uint16`` / ``uint8``) and the
manifest's ``"dtypes"`` names their dtype; an archive of other dtypes is
the reference's, and plain ``np.load`` reads any of them.

Elastic restore: a state held as each rank's ``sharding.local_shard`` of
its leaves on a mesh (the meshed train step's) is saved unsharded, in the
same format: one leaf at a time, the ranks' pieces are all-gathered, the
writing rank copies the whole leaf to host memory, and every rank frees
it before the next (a rank's device holds one whole leaf more at most,
and only the writer holds the state, in host memory).
``restore(..., mesh=, specs=)`` hands each rank its ``local_shard`` on
whatever mesh the new job has, so a run saved on one mesh resumes on
another, or on none.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.tensor import Tensor
from ..distributed.sharding import gather_leaf, with_specs

SEP = "|"

# dtypes numpy cannot hold, stored as the bits of an unsigned integer:
# dtype -> (torch integer of its width, numpy's twin of it, stored dtype)
_BITS = {torch.bfloat16: (torch.int16, np.int16, np.uint16),
         torch.float8_e4m3fn: (torch.uint8, np.uint8, np.uint8),
         torch.float8_e5m2: (torch.uint8, np.uint8, np.uint8)}
_BY_NAME = {str(dt).removeprefix("torch."): dt for dt in _BITS}


def _leaves(tree, path: Tuple = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs in the reference's order: dict keys sorted, list
    and tuple items in order, ``None`` an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield SEP.join(str(p) for p in path), tree


def _rebuild(tree, fn, path: Tuple = ()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(SEP.join(str(p) for p in path), tree)


def _snapshot(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A host copy of one leaf (never a view of memory the caller may
    update in place) and the dtype name its bits stand for, if any."""
    if isinstance(leaf, Tensor):
        leaf = leaf.data
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf), None
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype in _BITS:
        bits, _, stored = _BITS[t.dtype]
        return t.view(bits).numpy().view(stored), \
            str(t.dtype).removeprefix("torch.")
    return t.numpy(), None


def _host_state(state, mesh=None, specs=None, keep: bool = True
                ) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Every leaf copied to host memory: (arrays by key, dtype names of
    the leaves stored as bits).  On a ``mesh`` (every rank calls) each
    leaf is this rank's piece under its spec in ``specs``: the whole
    leaf is gathered, copied only where ``keep`` (the writing rank), and
    dropped before the next leaf is gathered; elsewhere both are
    empty."""
    spec_of = None
    if mesh is not None:
        spec_of = dict(_leaves(with_specs(
            lambda leaf, spec: _Spec(spec), state, specs)))
    arrays, dtypes = {}, {}
    for key, leaf in _leaves(state):
        if spec_of is not None:
            leaf = gather_leaf(mesh, spec_of[key].spec,
                               leaf.data if isinstance(leaf, Tensor)
                               else leaf)
            if not keep:
                continue
        arrays[key], name = _snapshot(leaf)
        if name is not None:
            dtypes[key] = name
    return arrays, dtypes


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._save_count = 0

    # -- write ----------------------------------------------------------
    def save(self, state, step: int, mesh=None, specs=None
             ) -> Optional[str]:
        """Write ``state`` now.  On a ``mesh`` (every rank of it calls),
        ``state`` holds the rank's pieces of the leaves split as the spec
        tree ``specs`` says: they are assembled leaf by leaf on the
        mesh's first rank (module docstring), which writes, and the
        others wait for the write (they return None)."""
        self.wait()
        if mesh is None:
            return self._write(*_host_state(state), step)
        first = _first_rank(mesh)
        arrays, dtypes = _host_state(state, mesh, specs, first)
        path = self._write(arrays, dtypes, step) if first else None
        _mesh_barrier(mesh)
        return path

    def save_async(self, state, step: int, mesh=None, specs=None) -> None:
        """Snapshot now (a host copy; on a ``mesh`` the assembled leaves,
        as :meth:`save`), write on a background thread (the mesh's first
        rank only)."""
        self.wait()
        first = mesh is None or _first_rank(mesh)
        arrays, dtypes = _host_state(state, mesh, specs, first)
        if not first:
            return
        self._thread = threading.Thread(
            target=self._write_in_background, args=(arrays, dtypes, step),
            daemon=True)
        self._thread.start()

    def _write_in_background(self, arrays, dtypes, step: int) -> None:
        try:
            self._write(arrays, dtypes, step)
        except Exception as e:  # re-raised by wait() on the caller
            self._error = e

    def wait(self) -> None:
        """Join the background write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, arrays: Dict[str, np.ndarray], dtypes: Dict[str, str],
               step: int) -> str:
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {"step": step, "time": time.time(),
                    "keys": sorted(arrays)}
        if dtypes:
            manifest["dtypes"] = dtypes
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        self._save_count += 1
        return final

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- read ------------------------------------------------------------
    def all_steps(self):
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def restore(self, step: int, like_state, mesh=None, specs=None):
        """The checkpoint of ``step`` in the structure of ``like_state``:
        each leaf a tensor on that leaf's device and in its dtype (a
        non-tensor leaf gives a CPU tensor of the stored dtype).  On a
        ``mesh``, each leaf is this rank's ``local_shard`` of the stored
        one under its spec in ``specs`` (the state's spec tree on the
        new mesh), whatever mesh wrote it."""
        cut = None
        if mesh is not None:
            from ..distributed.sharding import local_shard
            from ..launch.mesh import coords
            here = coords(mesh)
            spec_of = dict(_leaves(with_specs(
                lambda leaf, spec: _Spec(spec), like_state, specs)))

            def cut(key, t):
                return local_shard(t, spec_of[key].spec, mesh, here).clone(
                    memory_format=torch.contiguous_format)
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = json.load(f).get("dtypes", {})
        with np.load(os.path.join(path, "arrays.npz")) as data:
            def leaf(key, like):
                arr = data[key]
                if key in dtypes:
                    dt = _BY_NAME[dtypes[key]]
                    t = torch.from_numpy(arr.view(_BITS[dt][1])).view(dt)
                else:
                    t = torch.from_numpy(arr)
                if cut is not None:
                    t = cut(key, t)
                if isinstance(like, Tensor):
                    like = like.data
                if isinstance(like, torch.Tensor):
                    return t.to(device=like.device, dtype=like.dtype)
                return t
            return _rebuild(like_state, leaf)

    def restore_latest(self, like_state, mesh=None, specs=None):
        steps = self.all_steps()
        if not steps:
            return None
        return self.restore(steps[-1], like_state, mesh, specs)


class _Spec:
    """A spec held as a leaf (a ``PartitionSpec`` is a tuple, which the
    tree walks would enter)."""

    def __init__(self, spec):
        self.spec = spec


def _first_rank(mesh) -> bool:
    return all(mesh.get_local_rank(a) == 0 for a in mesh.mesh_dim_names)


def _mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for the others (a sum over each
    axis)."""
    from ..distributed import collectives as C
    for a in mesh.mesh_dim_names:
        C.all_reduce_sum(torch.zeros(1, device=mesh.device_type),
                         mesh.get_group(a))


def install_preemption_handler(manager: CheckpointManager, get_state,
                               get_step) -> None:
    """Save a final checkpoint on SIGTERM (cluster preemption)."""

    def _handler(signum, frame):
        manager.save(get_state(), int(get_step()))
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, _handler)
