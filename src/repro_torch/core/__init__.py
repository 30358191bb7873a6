"""repro_torch.core — the eager runtime (the paper's contribution), in
PyTorch.  Counterpart of ``repro/core``.

Layers:
  tensor     — operator-overloaded Tensor, views, versioning, storage
  autograd   — define-by-run tape, Function, no_grad, backward engine
  allocator  — caching block allocator accounting (512B rounding,
               per-stream pools)
  stream     — streams/events over CUDA streams and events
  dispatch   — signature-keyed op/VJP cache (the eager fast path)
  fuse       — the compiled path (the jit bridge: ``compile``,
               ``value_and_grad``, ``grad``) and the elementwise fusion
               queue (its chains run as one generated Triton kernel on
               the card)

As in the reference, ``grad`` here is the tape's (``autograd.grad``);
the functional one is ``fuse.grad``.
"""

from . import allocator
from . import autograd
from . import dispatch
from . import fuse
from . import stream
from .autograd import Function, enable_grad, grad, is_grad_enabled, no_grad
from .dispatch import (
    dispatch_cache_stats,
    reset_dispatch_cache,
    seeding,
)
from .fuse import block_until_ready, compile, fusion, value_and_grad
from .stream import Event, Stream, current_stream, default_stream, \
    stream as stream_ctx, synchronize
from .tensor import (
    Tensor,
    arange,
    cat,
    concat,
    einsum,
    empty,
    eye,
    from_numpy,
    full,
    logsumexp,
    manual_seed,
    matmul,
    maximum,
    minimum,
    normal,
    one_hot,
    ones,
    ones_like,
    rand,
    randint,
    randn,
    softmax,
    split,
    stack,
    take_along_dim,
    tensor,
    tril,
    triu,
    uniform,
    where,
    zeros,
    zeros_like,
)
