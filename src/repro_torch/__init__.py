"""PyTorch/CUDA port of ``repro`` (package ``repro_torch``).

The package mirrors ``repro``'s subpackage and file names, so each file
names the module it is held against.  It imports ``torch`` only: never
``jax`` and nothing of ``repro``.  What it holds:

  * the eager runtime (``core``: the imperative ``Tensor``, the
    define-by-run tape, the dispatch cache, the fusion queue, streams
    and the allocator's accounting), ``nn``, ``optim`` and the paper's
    models (``models.paper_models``), with the torch-shaped flat
    namespace of ``repro``::

        import repro_torch as rt
        x = rt.randn(4, 8, requires_grad=True)
        with rt.fuse.fusion():
            y = (x @ x.T).relu().sum()
        y.backward()
        step = rt.compile(fn)   # the compiled path (the jit bridge)

  * the LM serving path (``serving``), the train, prefill and decode
    step builders and the trainer (``launch.train``), their models
    (``models.lm``), the data loaders (``data``) and checkpointing
    (``checkpoint``);
  * the hand-written Hopper kernels (``kernels``), each beside its plain
    PyTorch version.

Entry points run on CUDA unless the caller asks for the CPU: the eager
factories place tensors on CUDA unless a ``with
repro_torch.default_device("cpu"):`` scope says otherwise, and
:func:`resolve_device` raises when no GPU is present and the CPU was not
named.  There is no silent fallback.
"""

from __future__ import annotations

from ._device import current_device, default_device, resolve_device
from .core import *          # noqa: F401,F403  torch-like flat namespace
from .core import allocator, autograd, dispatch, fuse, stream  # noqa: F401
from .core.tensor import Tensor  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # lazy subpackage access: repro_torch.nn, repro_torch.optim, ...
    import importlib
    if name in ("nn", "optim", "models", "kernels", "configs", "launch",
                "serving", "data", "checkpoint"):
        mod = importlib.import_module(f"repro_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
