"""Build the hand-written CUDA sources into a plain-C shared library.

Route: ``nvcc`` by hand into a ``.so`` with an ``extern "C"`` interface,
loaded with ``ctypes`` (pointers from ``tensor.data_ptr()``, the stream
from ``torch.cuda.current_stream().cuda_stream``).  No source includes
PyTorch's headers, so a build takes seconds rather than minutes.

The library is built at first use into ``build/repro_torch/<hash>/`` at
the repository root, keyed by a hash of the sources and the flags, so an
edited kernel is never served from a stale build.  Nothing is built or
loaded at import time.

Every kernel wrapper owns a :class:`LaunchCounter`; ``launch_counts()``
and ``reset_launch_counts()`` read and zero all of them, which is how a
run shows that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile ``csrc/<sources>`` into ``lib<name>.so`` (once per source
    hash) and load it.  Raises with nvcc's output when the build fails."""
    with _lock:
        if name in _libs:
            return _libs[name]
        paths = [CSRC / s for s in sources]
        out_dir = BUILD_ROOT / _digest(paths)
        lib_path = out_dir / f"lib{name}.so"
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(p) for p in paths]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {name} ({' '.join(cmd)}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib_path)
        _libs[name] = ctypes.CDLL(str(lib_path))
        return _libs[name]
