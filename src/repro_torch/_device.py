"""Where the port's tensors live.

:func:`resolve_device` turns a requested device into a ``torch.device``:
``None`` means CUDA, and asking for CUDA without a GPU raises.  The eager
runtime's factories (``repro_torch.randn``, ``zeros``, ``tensor``, ...)
place their tensors on :func:`current_device`, which is CUDA unless the
caller enters ``with repro_torch.default_device("cpu"):``.  There is no
fallback to the CPU: the CPU is used only when it is asked for, and
``meta`` (shapes and dtypes without memory: the dry run,
``launch/dryrun.py``) only when it is named.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises ``RuntimeError`` when a CUDA
    device is asked for (explicitly or by default) and none is present;
    the CPU and ``meta`` are used only when the caller names them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_tls = threading.local()


def requested_device() -> Optional[torch.device]:
    """The device named by the innermost ``default_device`` scope of this
    thread, or ``None`` (CUDA).  Reading it touches no GPU."""
    return getattr(_tls, "device", None)


def current_device() -> torch.device:
    """The device the eager factories place tensors on (resolved: raises
    on a default of CUDA without a GPU)."""
    return resolve_device(requested_device())


class default_device:
    """Context manager: ``with repro_torch.default_device("cpu"): ...``
    makes the eager runtime's factories place tensors on that device in
    this thread (the tests run the port on the CPU this way);
    ``default_device(None)`` restores the default, CUDA."""

    def __init__(self, device: DeviceLike):
        self._device = None if device is None else torch.device(device)
        self._prev: Optional[torch.device] = None

    def __enter__(self) -> Optional[torch.device]:
        self._prev = requested_device()
        _tls.device = self._device
        return self._device

    def __exit__(self, *exc) -> None:
        _tls.device = self._prev
