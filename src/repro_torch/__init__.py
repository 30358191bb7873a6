"""PyTorch/CUDA port of the ``repro`` serving path.

The package mirrors ``repro``'s subpackage and file names, so each file
names the module it is held against.  It imports ``torch`` only: never
``jax`` and nothing of ``repro``.

Entry points run on CUDA unless the caller asks for the CPU.  There is
no silent fallback: :func:`resolve_device` raises when no GPU is present
and ``device="cpu"`` was not passed.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``.  Raises ``RuntimeError`` when a CUDA
    device is asked for (explicitly or by default) and none is present;
    the CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
