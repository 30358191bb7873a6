"""Build the hand-written CUDA sources into a plain-C shared library.

Route: ``nvcc`` by hand into a ``.so`` with an ``extern "C"`` interface,
loaded with ``ctypes`` (pointers from ``tensor.data_ptr()``, the stream
from ``torch.cuda.current_stream().cuda_stream``).  No source includes
PyTorch's headers, so a build takes seconds rather than minutes.

The library is built at first use into ``build/repro_torch/<hash>/`` at
the repository root, keyed by a hash of the sources and the flags, so an
edited kernel is never served from a stale build.  Nothing is built or
loaded at import time.

:data:`LIBRARIES` names every library and its sources;
:func:`build_all` compiles them all at once, one ``nvcc`` process per
library started together, so a cold start waits for the slowest build
rather than their sum.

Every kernel wrapper owns a :class:`LaunchCounter`; ``launch_counts()``
and ``reset_launch_counts()`` read and zero all of them, which is how a
run shows that it went through the kernels.  The attention wrappers also
share :data:`HEAD_DIMS`, :data:`Q_CODES` and :func:`check_operands`, and
the attention, WKV6 and Mamba wrappers :func:`dense_aligned`, which
copies a strided or misaligned operand rather than refusing it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _python_dispatch
from torch.utils.flop_counter import register_flop_formula

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# library name -> its CUDA sources under csrc/
LIBRARIES: Dict[str, Tuple[str, ...]] = {
    "repro_paged_attention": ("paged_attention.cu",),
    "repro_flash_attention": ("flash_attention.cu",),
    "repro_decode_attention": ("decode_attention.cu",),
    "repro_mixed_attention": ("mixed_attention.cu",),
    "repro_rwkv6": ("rwkv6.cu",),
    "repro_mamba": ("mamba.cu",),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# operand rules every attention wrapper shares
HEAD_DIMS = (16, 32, 64, 128, 256)     # head_dims the kernels instantiate
Q_CODES = {torch.float32: 0, torch.bfloat16: 1}   # q dtype -> kernel code


def check_operands(who: str, ref: torch.Tensor, tensors) -> None:
    """Every operand on ``ref``'s device and contiguous."""
    for x in tensors:
        if x.device != ref.device:
            raise ValueError(f"{who}: all operands must be on one device")
        if not x.is_contiguous():
            raise ValueError(f"{who}: operands must be contiguous")


def dense_aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous in new 16-byte aligned memory if it is not so
    already (``contiguous`` keeps a contiguous view's offset): for the
    kernels that copy rows in 16-byte pieces."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


class LaunchCounter:
    """A plain integer count of one kernel's launches.  The wrapper adds
    one where it launches its kernel, and nowhere else."""

    registry: List["LaunchCounter"] = []

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        LaunchCounter.registry.append(self)

    def bump(self) -> None:
        self.launches += 1


def launch_counts() -> Dict[str, int]:
    return {c.name: c.launches for c in LaunchCounter.registry}


def reset_launch_counts() -> None:
    for c in LaunchCounter.registry:
        c.launches = 0


def _tracing(args) -> bool:
    """A launch goes through its operator: a graph is being traced
    (Dynamo is compiling, a dispatch mode is on: ``make_fx``, fake
    tensors, functionalization, the dry run's counters), the first
    tensor operand is a tensor subclass (a fake or functional tensor; a
    launch's operands are all of one kind), or it is on ``meta`` (the
    dry run: the operator's Meta kernel is its shape function)."""
    if torch.compiler.is_compiling() or \
            _python_dispatch._get_current_dispatch_mode() is not None:
        return True
    for a in args:
        t = a[0] if isinstance(a, (list, tuple)) and a else a
        if isinstance(t, torch.Tensor):
            return (type(t) not in (torch.Tensor, torch.nn.Parameter)
                    or t.is_meta)
    return False


# the operator of each kernel -> ``cost(*args) -> (flops, bytes)`` of one
# launch (:meth:`LaunchOp.register_cost`; the dry run's byte count)
KERNEL_COSTS: Dict[object, Callable] = {}


class LaunchOp:
    """A kernel launch ``body`` and its operator ``repro_torch::<name>``
    (``torch.library.custom_op``, no mutated argument, CUDA).  While a
    graph is traced (``repro_torch.compile``'s ``make_fx`` over fake
    tensors, Dynamo) a call goes through the operator: one node of the
    graph, shaped by the function given to :meth:`register_fake`, that
    launches the kernel, counted, on every call of the compiled graph.
    So does a call on ``meta`` tensors, which that function answers
    with the outputs' shapes and dtypes and launches nothing.  Eagerly
    a call runs ``body`` itself: the dispatcher's round trip through
    Python cost ~30-50 us a launch on the H100 (PERF.md §6), which
    host-bound steps would pay in full."""

    def __init__(self, name: str, body):
        self.body = body
        self.op = torch.library.custom_op(f"repro_torch::{name}", body,
                                          mutates_args=(),
                                          device_types="cuda")
        self.packet = getattr(torch.ops.repro_torch, name)

    def register_fake(self, fn):
        self.op.register_fake(fn)
        return fn

    def register_cost(self, fn):
        """``fn(*args) -> (flops, bytes)``: one launch's work from its
        operands' shapes, 2·m·n·k FLOPs for each product (elementwise
        operations count 0, as in ``FlopCounterMode``) and each operand
        read once and each output written once.  The FLOPs become the
        operator's formula in ``torch.utils.flop_counter`` (a
        ``FlopCounterMode`` made after this counts the launch, on
        ``meta`` and on the card alike); :data:`KERNEL_COSTS` keeps
        ``fn``."""
        register_flop_formula(self.packet, get_raw=True)(
            lambda *args, out_val=None, **kwargs: fn(*args, **kwargs)[0])
        KERNEL_COSTS[self.packet] = fn
        return fn

    def __call__(self, *args):
        if _tracing(args):
            return self.op(*args)
        return self.body(*args)


def launch_op(name: str):
    """Decorator: the function is the body of :class:`LaunchOp` ``name``."""
    return lambda body: LaunchOp(name, body)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source at first use and need the CUDA "
                           "toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(sources):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def _start_build(name: str) -> Tuple[Path, Optional[tuple]]:
    """The path of ``lib<name>.so`` for the current sources, and the
    running ``nvcc`` job that builds it (None when it is built)."""
    paths = [CSRC / s for s in LIBRARIES[name]]
    lib_path = BUILD_ROOT / _digest(paths) / f"lib{name}.so"
    if lib_path.exists():
        return lib_path, None
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f".lib{name}.{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(p) for p in paths]]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib_path, (proc, cmd, tmp)


def _finish_build(name: str, lib_path: Path, job: Optional[tuple]) -> None:
    """Wait for ``job`` (if any), then load the library."""
    if job is not None:
        proc, cmd, tmp = job
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name} "
                               f"({' '.join(cmd)}):\n{output}")
        os.replace(tmp, lib_path)
    _libs[name] = ctypes.CDLL(str(lib_path))


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``LIBRARIES[name]`` into ``lib<name>.so`` (once per source
    hash) and load it.  Raises with nvcc's output when the build fails."""
    with _lock:
        if name not in _libs:
            _finish_build(name, *_start_build(name))
        return _libs[name]


def build_all() -> None:
    """Build (or load the cached builds of) every library in
    :data:`LIBRARIES`, all ``nvcc`` processes started together."""
    with _lock:
        jobs = [(n, *_start_build(n)) for n in LIBRARIES if n not in _libs]
        try:
            for name, lib_path, job in jobs:
                _finish_build(name, lib_path, job)
        finally:
            for _, _, job in jobs:
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
