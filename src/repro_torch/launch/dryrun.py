"""Dry run on the production meshes: trace one rank's step of every
(arch × shape) on a fake process group of 256 or 512 ranks, and record
its memory, FLOPs, bytes and collectives for the roofline (counterpart
of ``repro/launch/dryrun.py``)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out build/dryrun

(the cells run side by side, half the host's cores' worth at a time).

The reference lowers and compiles each cell with XLA on forced host
devices and reads ``memory_analysis()``, ``cost_analysis()`` and the
collectives of the compiled HLO.  The port runs eagerly, one process a
rank, so a cell is traced instead: in a process of its own (the fake
group is that process's default group and ends with it), rank 0 of a
fake group (``torch.testing._internal.distributed.fake_pg``) builds the
production mesh (``launch/mesh.make_production_mesh``), its pieces of
the state or the cache on ``meta`` (shapes, no memory, no number drawn),
and runs one train, prefill or serve step of ``launch/train.py``, the
steps a user calls, under

  * ``FlopCounterMode``, which counts each matrix product and each
    kernel launch by the kernel's registered formula
    (``kernels/_build.LaunchOp.register_cost``);
  * :class:`StepTrace`, a dispatch mode that sums each operator's
    operand and result bytes (a view counts 0, an allocation 0; a kernel
    launch counts its formula's bytes: each operand read once, each
    output written once) and tracks the bytes live on the device: each
    new storage, rounded up to the caching allocator's 512-byte blocks,
    counts from the operator that made it until it is freed;

and ``distributed/collectives.py`` tallies every collective by kind and
mesh axis where it is called.  On ``meta`` every kernel wrapper returns
its outputs' shapes from the kernel's shape function, and every
backward is what runs on the card (flash's, the Mamba and WKV6 scans':
autograd through the plain versions on the saved inputs).

The eager trace runs every layer and every microbatch, so the
reference's two-point extrapolation over layer groups and its unrolled
cost pass are not needed, and the multi-pod cells are counted too.  One
shortcut: a scan's plain backward is a loop over the sequence (about 7
ms a step on ``meta`` on a CPU core), and every layer of a cell calls it
on operands of one shape, so :class:`_ScanMemo` runs the first call of
each operand signature under the counters and adds the same FLOPs,
bytes and peak for each later one.

A record's ``memory`` keeps the reference's keys, defined for the eager
step: ``argument_bytes`` is what is live before the step (the rank's
state or parameters and cache, and the inputs), ``bytes`` the peak
during it, ``temp_bytes`` the peak above the arguments, ``output_bytes``
the step's outputs in new memory and ``alias_bytes`` those written into
the arguments (the state or the cache, updated in place where the
reference donates them).  ``fits_80gb`` is ``bytes`` within the card's
80 GB; ``trace_s`` the seconds the traced step took.  A cell that fails
raises: ``main`` lists the failed cells and exits with 1.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import multiprocessing
import os
import pickle
import queue
import sys
import time
import traceback
import weakref
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Dict, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, ShapeSpec, SkipSpec, get_config, get_shapes
from ..configs import input_specs
from ..distributed import collectives as C
from ..distributed import sharding as S
from ..kernels import ops
from ..kernels._build import KERNEL_COSTS
from ..models import lm as LM
from . import roofline as RL
from . import train as T

ACCUM_STEPS = {
    # giant models: microbatch so per-device activations fit
    "arctic-480b": 8,
    "jamba-1.5-large-398b": 8,
    "yi-34b": 2,
}

BLOCK = 512          # the CUDA caching allocator's smallest block

# operators that allocate and write nothing
_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.empty_like.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class StepTrace(TorchDispatchMode):
    """Sums the bytes each operator moves (``bytes``) and tracks the bytes
    live (``live``, ``peak``).  :meth:`track` counts tensors made before
    the step (its arguments) as live."""

    def __init__(self, count_bytes: bool = True):
        super().__init__()
        self.count_bytes = count_bytes
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

    def track(self, tree) -> None:
        for t in _tensors(tree):
            self._add(t)

    def storages(self, tree) -> set:
        return {t.untyped_storage()._cdata for t in _tensors(tree)}

    def _add(self, t: torch.Tensor) -> None:
        if not t.is_meta:          # a host tensor: not on the device
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = -(-st.nbytes() // BLOCK) * BLOCK
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.count_bytes:
            cost = KERNEL_COSTS.get(func.overloadpacket)
            if cost is not None:
                self.bytes += cost(*args, **kwargs)[1]
            elif not func.is_view and func not in _ALLOCATIONS:
                self.bytes += sum(_nbytes(t) for t in _tensors(
                    (args, kwargs, out)))
        for t in _tensors(out):
            self._add(t)
        return out


class _ScanMemo:
    """The plain backward of the Mamba and WKV6 scans (``kernels/ops.py``
    ``_MambaScan``, ``_RWKV6Scan``) memoized by operand signature while a
    step is traced: the first call runs under the counters, and a later
    call with the same shapes, strides and dtypes adds the FLOPs, bytes
    and peak that the first one took and returns new tensors of its
    gradients' layouts."""

    FUNCTIONS = (ops._MambaScan, ops._RWKV6Scan)

    def __init__(self, trace: StepTrace, flops: Optional[FlopCounterMode]):
        self.trace, self.flops = trace, flops
        self.memo: Dict[tuple, tuple] = {}
        self.replays = 0

    def _flop_counts(self) -> dict:
        if self.flops is None:
            return {}
        return dict(self.flops.flop_counts["Global"])

    def _wrap(self, fn):
        def backward(ctx, *grads):
            # saved tensors unpack once (a checkpointed group's raise on
            # a second unpack): the backward gets them through ``saved``
            saved = SimpleNamespace(saved_tensors=ctx.saved_tensors)
            key = (fn, tuple(ctx.needs_input_grad)) + tuple(
                None if t is None else (tuple(t.shape), t.stride(), t.dtype)
                for t in (*saved.saved_tensors, *grads))
            tr = self.trace
            if key not in self.memo:
                f0, b0, live0, peak0 = (self._flop_counts(), tr.bytes,
                                        tr.live, tr.peak)
                tr.peak = live0
                outs = fn(saved, *grads)
                f1 = self._flop_counts()
                self.memo[key] = (
                    {k: n - f0.get(k, 0) for k, n in f1.items()},
                    tr.bytes - b0, tr.peak - live0,
                    [None if g is None else (g.shape, g.stride(), g.dtype)
                     for g in outs])
                tr.peak = max(tr.peak, peak0)
                return outs
            flops, nbytes, rise, layouts = self.memo[key]
            self.replays += 1
            if self.flops is not None:
                for k, n in flops.items():
                    self.flops.flop_counts["Global"][k] += n
            tr.bytes += nbytes
            tr.peak = max(tr.peak, tr.live + rise)
            return tuple(None if lay is None else torch.empty_strided(
                lay[0], lay[1], dtype=lay[2], device="meta")
                for lay in layouts)
        return backward

    def __enter__(self):
        self._saved = [f.backward for f in self.FUNCTIONS]
        for f, fn in zip(self.FUNCTIONS, self._saved):
            f.backward = staticmethod(self._wrap(fn))
        return self

    def __exit__(self, *exc):
        for f, fn in zip(self.FUNCTIONS, self._saved):
            f.backward = staticmethod(fn)


def _meta_params(cfg, mesh):
    params = LM.abstract_params(cfg)
    return T.shard_tree(mesh, S.param_specs(cfg, params, mesh), params)


def trace_step(cfg, spec: ShapeSpec, mesh, *, optimizer: str = "adamw",
               accum_steps: int = 1, skip_cost: bool = False) -> Dict:
    """One rank's step of ``cfg`` on a ``spec`` batch on ``mesh`` (a mesh
    over an initialized process group, usually a fake one), traced on
    ``meta``: ``{"memory", "cost", "collectives", "trace_s",
    "scan_replays"}``.  A train step takes the state of
    ``train.init_train_state`` and ``accum_steps`` microbatches; a
    prefill step the parameters; a serve step the parameters and an
    empty cache, at position ``seq_len - 1`` (every slot live).
    ``skip_cost`` leaves FLOPs and bytes uncounted (``None``)."""
    if spec.kind == "train":
        state = T.init_train_state(cfg, optimizer=optimizer, device="meta",
                                   mesh=mesh)
        step = T.make_train_step(cfg, optimizer=optimizer,
                                 accum_steps=accum_steps, device="meta",
                                 mesh=mesh)
        args = (state, input_specs(cfg, spec))
    elif spec.kind == "prefill":
        step = T.make_prefill_step(cfg, device="meta", mesh=mesh)
        args = (_meta_params(cfg, mesh), input_specs(cfg, spec))
    else:
        b, s = spec.global_batch, spec.seq_len
        step = T.make_serve_step(cfg, batch=b, max_seq=s, device="meta",
                                 mesh=mesh)
        cache = LM.init_cache(cfg, b, s, device="meta", mesh=mesh)
        args = (_meta_params(cfg, mesh), cache,
                input_specs(cfg, spec)["tokens"], s - 1)
    trace = StepTrace(count_bytes=not skip_cost)
    trace.track(args)
    held = trace.live
    flops = None if skip_cost else FlopCounterMode(display=False)
    memo = _ScanMemo(trace, flops)
    C.reset_stats()
    t0 = time.perf_counter()
    with memo:
        if flops is not None:
            with flops, trace:
                out = step(*args)
        else:
            with trace:
                out = step(*args)
    trace_s = time.perf_counter() - t0
    collectives = copy.deepcopy({k: v for k, v in C.stats.items()
                                 if k != "staged_bytes"})
    inside = trace.storages(args)
    outs = {t.untyped_storage()._cdata: _nbytes(t) for t in _tensors(out)}
    memory = {
        "bytes": float(trace.peak),
        "temp_bytes": float(trace.peak - held),
        "argument_bytes": float(held),
        "output_bytes": float(sum(n for k, n in outs.items()
                                  if k not in inside)),
        "alias_bytes": float(sum(n for k, n in outs.items()
                                 if k in inside)),
    }
    cost = {"flops": None if flops is None else float(
                flops.get_total_flops()),
            "bytes accessed": None if skip_cost else float(trace.bytes)}
    return {"memory": memory, "cost": cost, "collectives": collectives,
            "trace_s": trace_s, "scan_replays": memo.replays}


MeshArg = Union[str, Tuple[Tuple[int, ...], Tuple[str, ...]]]


def _traced_in_fake_group(cfg, spec, mesh: MeshArg, kwargs) -> Dict:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from .mesh import PRODUCTION_MESHES, make_mesh, make_production_mesh
    production = mesh in ("single", "multi")
    shape, axes = PRODUCTION_MESHES[mesh == "multi"] if production else mesh
    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        on = (make_production_mesh(multi_pod=mesh == "multi") if production
              else make_mesh(tuple(shape), tuple(axes), device_type="cpu"))
        return trace_step(cfg, spec, on, **kwargs)
    finally:
        dist.destroy_process_group()


def _child(results, fn, args) -> None:
    try:
        results.put((True, pickle.dumps(fn(*args))))
    except BaseException:       # noqa: BLE001 - reported to the parent
        results.put((False, traceback.format_exc()))


def in_process(fn, *args, timeout: float = 3600.0):
    """``fn(*args)`` in a new process (start method ``spawn``): its
    result, or a ``RuntimeError`` with the child's traceback.  The child
    is killed when it has not finished within ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=_child, args=(results, fn, args), daemon=True)
    proc.start()
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                ok, out = results.get(timeout=1.0)
                break
            except queue.Empty:
                if proc.exitcode is not None:
                    raise RuntimeError(f"the dry-run process exited with "
                                       f"code {proc.exitcode}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the dry-run process did not "
                                       f"finish within {timeout} s") \
                        from None
        proc.join(timeout=30)
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join()
    if not ok:
        raise RuntimeError(f"the dry-run process failed:\n{out}")
    return pickle.loads(out)


def trace_cell(cfg, spec: ShapeSpec, mesh: MeshArg, *,
               optimizer: str = "adamw", accum_steps: int = 1,
               skip_cost: bool = False, timeout: float = 3600.0) -> Dict:
    """:func:`trace_step` in a process of its own, as rank 0 of a fake
    process group that ends with it, on ``mesh``: ``"single"`` or
    ``"multi"`` (the production meshes) or ``(shape, axes)``."""
    return in_process(_traced_in_fake_group, cfg, spec, mesh,
                      {"optimizer": optimizer, "accum_steps": accum_steps,
                       "skip_cost": skip_cost}, timeout=timeout)


def run_cell(arch: str, shape_name: str, mesh_name: str,
             out_dir: Optional[str] = None,
             optimizer: Optional[str] = None,
             accum_steps: Optional[int] = None,
             skip_cost: bool = False) -> Dict:
    cfg = get_config(arch)
    spec = get_shapes(arch)[shape_name]
    if isinstance(spec, SkipSpec):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": spec.reason}
    from .mesh import PRODUCTION_MESHES
    shape, axes = PRODUCTION_MESHES[mesh_name == "multi"]
    sizes = dict(zip(axes, shape))
    n_dev = math.prod(shape)
    if optimizer is None:
        # giant MoEs train with factored second moments to fit HBM
        optimizer = "adafactor" if arch in ("arctic-480b",
                                            "jamba-1.5-large-398b") \
            else "adamw"
    if accum_steps is None:
        accum_steps = ACCUM_STEPS.get(arch, 1) if spec.kind == "train" \
            else 1

    res = trace_cell(cfg, spec, mesh_name, optimizer=optimizer,
                     accum_steps=accum_steps, skip_cost=skip_cost)
    mem, cost = res["memory"], res["cost"]
    rl = RL.analyze(arch, shape_name, mesh_name, sizes, cfg, spec,
                    spec.kind, cost, res["collectives"], mem)
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "n_devices": n_dev, "optimizer": optimizer,
        "accum_steps": accum_steps,
        "trace_s": round(res["trace_s"], 2),
        "memory": mem,
        "fits_80gb": mem["bytes"] <= RL.HBM_BYTES,
        "cost": cost,
        "collectives": res["collectives"],
        "scan_replays": res["scan_replays"],
        "roofline": rl.as_dict(),
    }
    print(f"[{arch} × {shape_name} × {mesh_name}] "
          f"dev={n_dev} bytes/dev={mem['bytes']/1e9:.2f}GB "
          f"flops/dev={rl.flops_per_device/1e9:.1f}G "
          f"coll/dev={rl.collective_bytes_per_device/1e6:.1f}MB "
          f"dominant={rl.dominant} "
          f"(trace {res['trace_s']:.1f}s)\n  memory: {json.dumps(mem)}",
          flush=True)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{mesh_name}.json".replace("/", "_")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--skip-cost", action="store_true",
                    help="count no FLOPs and no bytes (memory and "
                         "collectives only)")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for arch in ARCHS:
            for shape_name in get_shapes(arch):
                for m in meshes:
                    cells.append((arch, shape_name, m))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required without --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    def one(cell):
        arch, shape_name, m = cell
        try:
            run_cell(arch, shape_name, m, out_dir=args.out,
                     optimizer=args.optimizer, skip_cost=args.skip_cost)
            return None
        except Exception as e:       # noqa: BLE001 - listed, exit code 1
            traceback.print_exc()
            last = (str(e).strip().splitlines() or [""])[-1]
            return (arch, shape_name, m, f"{type(e).__name__}: {last}")

    # a trace is one Python thread: half the cores trace at once
    with ThreadPoolExecutor(max(1, (os.cpu_count() or 2) // 2)) as pool:
        failures = [f for f in pool.map(one, cells) if f is not None]
    if failures:
        print(f"\nFAILED {len(failures)} cells:")
        for f in failures:
            print(" ", f)
        return 1
    print(f"\nall {len(cells)} cells OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
