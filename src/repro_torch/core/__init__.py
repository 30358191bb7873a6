"""repro_torch.core — the eager runtime (the paper's contribution), in
PyTorch.  Counterpart of ``repro/core``.

Layers:
  tensor     — operator-overloaded Tensor, views, versioning, storage
  autograd   — define-by-run tape, Function, no_grad, backward engine
  allocator  — caching block allocator accounting (512B rounding,
               per-stream pools)
  stream     — streams/events over CUDA streams and events
  dispatch   — signature-keyed op/VJP cache (the eager fast path)
  fuse       — the elementwise fusion queue (its chains run as one
               generated Triton kernel on the card)

The reference's jit bridge (``repro.compile``, ``value_and_grad``,
``grad`` of ``fuse``) is not ported yet (ROADMAP.md queue A).
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
)
from .fuse import block_until_ready, fusion
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
