"""Meshes over the ranks of a ``torch.distributed`` process group.

Counterpart of ``repro/launch/mesh.py``.  A mesh in the port is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names:

  pod   — pure data parallelism across pods;
  data  — data parallel (serving: replicas of the slot space);
  model — tensor / context parallel.

The reference runs one controller over the devices of a host (GSPMD);
the port runs one process per mesh position (SPMD), so "the devices"
are the ranks of the initialized default process group, and each rank
runs the same program.  The process group is the caller's: nothing here
initializes one (``launch/serve.py`` spawns its ranks and rendezvouses
them through a file).  A rank takes the card ``rank % device_count``,
so on one card every rank shares ``cuda:0``.

:class:`MeshShape` is a mesh's shape alone (axis names and sizes), which
is all the sharding tables (``distributed/sharding.py``) read; a
``DeviceMesh`` and a ``MeshShape`` both pass through :func:`axis_sizes`.

:func:`make_production_mesh` builds the reference's production meshes,
(16, 16) over (data, model) and (2, 16, 16) over (pod, data, model),
over a default group of exactly 256 or 512 ranks: the dry run
(``launch/dryrun.py``) makes one with a fake process group in a single
process and traces a rank's step on it.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import traceback
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from ..distributed import collectives as C
from ..serving.errors import MeshConfigError


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with the reference ``Mesh``'s
    ``axis_names`` and ``shape`` (an ordered name -> size dict)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return OrderedDict(zip(self.axis_names, self.sizes))


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or a :class:`MeshShape`."""
    if isinstance(mesh, DeviceMesh):
        return OrderedDict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return OrderedDict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def world_size() -> int:
    """Ranks of the default process group (1 when none is initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` over ranks ``0 .. prod(shape) - 1`` of the
    default process group, in row-major order (the last axis varies
    fastest), named ``axes``, of ``device_type`` (default ``cuda`` when
    the host has a card, else ``cpu``).  Every rank of the group calls
    it."""
    if len(shape) != len(axes):
        raise MeshConfigError(f"mesh shape {shape} and axes {axes} differ "
                              f"in length")
    n = 1
    for s in shape:
        n *= s
    if n < 1 or n > world_size() or not dist.is_initialized():
        raise MeshConfigError(
            f"mesh {shape} needs {n} rank(s) of an initialized process "
            f"group; {world_size()} available")
    ranks = torch.arange(n).reshape(shape)
    mesh = DeviceMesh(device_type or _device_type(), ranks,
                      mesh_dim_names=tuple(axes))
    C.label_axes(mesh)
    return mesh


# multi_pod -> (shape, axes) of the reference's production meshes
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production mesh over the default process group:
    (data=16, model=16), 256 ranks, or (pod=2, data=16, model=16), 512
    (:data:`PRODUCTION_MESHES`).  The group must have exactly that many
    ranks, else :class:`MeshConfigError`.  The mesh's device type follows
    the group's backend (``cuda`` for NCCL, else ``cpu``: the dry run's
    fake group), never whether this host has a card."""
    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or world_size() != n:
        raise MeshConfigError(
            f"the production mesh {shape} needs a process group of "
            f"exactly {n} ranks; {world_size()} available")
    return make_mesh(shape, axes, device_type=(
        "cuda" if dist.get_backend() == "nccl" else "cpu"))


def make_local_mesh(tp: Optional[int] = None) -> DeviceMesh:
    """Every rank as a (data, model) mesh with ``model`` = ``tp``
    (default 1, pure data parallel); ``tp`` must divide the world size."""
    n = world_size()
    tp = tp or 1
    if tp < 1 or n % tp != 0:
        raise MeshConfigError(
            f"tp={tp} must be >= 1 and divide the local device "
            f"count ({n})")
    return make_mesh((n // tp, tp), ("data", "model"))


def mesh_for_serving(n_devices: Optional[int] = None, tp: int = 1
                     ) -> DeviceMesh:
    """A validated (data, model) serving mesh over ``n_devices`` ranks
    (default: the whole process group) with tensor-parallel degree
    ``tp``.  Raises :class:`~repro_torch.serving.errors.MeshConfigError`,
    never a bare ``ValueError``, when the shape cannot be built: ``tp``
    not dividing ``n_devices``, or more ranks requested than exist.
    ``ServingEngine(..., mesh=...)`` takes the result: ``data`` replicas
    of the slot space, heads / MLP width (or the pages of an undivided
    KV head) over ``model``."""
    avail = world_size()
    n = n_devices if n_devices is not None else avail
    if n < 1 or n > avail:
        raise MeshConfigError(
            f"n_devices={n} out of range: {avail} device(s) available")
    if tp < 1 or n % tp != 0:
        raise MeshConfigError(
            f"tp={tp} must be >= 1 and divide n_devices={n}")
    return make_mesh((n // tp, tp), ("data", "model"))


def data_axis_names(mesh) -> Tuple[str, ...]:
    """Axes over which the batch is sharded (pod folds into data)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def mesh_info(mesh) -> dict:
    sizes = axis_sizes(mesh)
    n = 1
    for s in sizes.values():
        n *= s
    return {"axis_names": tuple(sizes), "shape": dict(sizes),
            "n_devices": n}


def coords(mesh) -> Dict[str, int]:
    """This rank's coordinate along each axis of ``mesh``."""
    return OrderedDict((a, mesh.get_local_rank(a))
                       for a in mesh.mesh_dim_names)


# ----------------------------------------------------------------------
# starting ranks
# ----------------------------------------------------------------------

def default_backend(world: int) -> str:
    """NCCL when every rank can have a card of its own, else gloo (on
    one card several ranks share ``cuda:0``; NCCL refuses that)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_main(fn, rank, world, init, backend, results, args,
               timeout_s) -> None:
    try:
        # the ranks share the host's cores: idle intra-op threads of one
        # rank spinning beside another's collective slow both ~10x
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * world)))
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        # plain pickle bytes: a tensor then carries its data, not a handle
        # to this process's memory, which ends with the process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:       # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, args: tuple = (), *,
              backend: Optional[str] = None, timeout: float = 300.0
              ) -> List[object]:
    """``fn(rank, world, *args)`` in ``world`` processes started with
    ``torch.multiprocessing`` (start method ``spawn``), each inside an
    initialized process group (``backend``, default
    :func:`default_backend`) that rendezvouses through a file in a new
    temporary directory (no port).  Returns the ranks' return values in
    rank order.  ``fn`` and its results must pickle.  Raises with a
    rank's traceback when one fails, and kills every rank and raises
    when the group has not finished within ``timeout`` seconds.  Build
    the CUDA libraries in the parent first (``kernels._build.build_all``)
    so that each rank only loads them.  Each rank takes a share of the
    host's cores for its intra-op threads."""
    backend = backend or default_backend(world)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init = f"file://{os.path.join(tmp, 'rendezvous')}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, init, backend, results, args,
                               timeout))
             for r in range(world)]
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=timeout)
    outs: Dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        while len(outs) < world:
            left = (deadline - datetime.datetime.now()).total_seconds()
            if left <= 0:
                raise TimeoutError(f"{world} ranks of {fn.__name__} did "
                                   f"not finish within {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank of {fn.__name__} exited "
                                       f"with code {dead[0]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                   f"failed:\n{out}")
            outs[rank] = pickle.loads(out)
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [outs[r] for r in range(world)]
