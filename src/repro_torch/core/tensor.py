"""The eager Tensor (paper §4, §5.5).

Counterpart of ``repro/core/tensor.py``.  A :class:`Tensor` wraps a
``torch.Tensor`` and gives the imperative, operator-overloaded
programming model of the paper:

* every op executes immediately (on the card, queued on the current CUDA
  stream);
* the autograd tape records a VJP node per op (``torch.func.vjp``
  supplies the derivative closure; the engine is ``core.autograd``'s,
  not ``torch.autograd``'s);
* in-place ops mutate through a shared :class:`VersionCounter`, so the
  engine can detect use-after-mutate (§4.3).  The wrapped torch tensors
  themselves are never written in place: a mutation makes a new torch
  tensor, as the reference's ``.at[].set`` makes a new array, so
  residuals saved for a backward pass never change under it;
* storage is refcounted: Python's refcounting drives immediate frees
  back into the accounting allocator (``core.allocator``) while PyTorch's
  caching allocator holds the bytes.

Every differentiable op funnels through :func:`_apply_op`, which consults
the signature-keyed dispatch cache (``core.dispatch``) and, inside
``with repro_torch.fuse.fusion():``, defers elementwise ops into the
fusion queue (``core.fuse``); reads of ``Tensor._data`` are the single
materialization funnel.

Dtypes follow the reference (JAX without x64): data from outside is
canonicalized to 32 bits (int64 -> int32, float64 -> float32), Python
scalars become cached 0-d tensors (bool, int32, float32, or the other
operand's floating dtype) that promote as JAX's weakly typed scalars
do, and reductions of integers stay int32.

Tensors are placed on ``repro_torch.current_device()`` (CUDA unless a
``repro_torch.default_device`` scope names another).

``Tensor`` is a ``torch.utils._pytree`` node (its child the wrapped
torch tensor), as the reference's is a JAX pytree node, so the jit
bridge (``fuse.compile``, ``value_and_grad``, ``grad``) and
``torch.func`` flatten unmodified eager code's arguments and results.
Inside the bridge's trace (``autograd.is_tracing()``, the reference's
tracer operands) an op records no tape node, touches no dispatch-cache
entry (it seeds one under ``dispatch.seeding``), enqueues nothing in the
fusion queue and does no allocator accounting.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree

from .. import _device
from . import allocator as _alloc
from . import dispatch as _dispatch
from . import stream as _stream
from .autograd import (
    Node,
    VersionCounter,
    backward as _backward,
    is_grad_enabled,
    is_tracing,
    op_range,
)

_fuse_mod = None


def _fuse():
    """Lazy import of ``core.fuse`` (it imports this module at top level)."""
    global _fuse_mod
    if _fuse_mod is None:
        from . import fuse as f
        _fuse_mod = f
    return _fuse_mod


# ----------------------------------------------------------------------
# dtypes
# ----------------------------------------------------------------------

# the names the reference's statics use (``np.dtype(d).name``)
DTYPE_NAMES = {
    torch.float32: "float32", torch.bfloat16: "bfloat16",
    torch.float16: "float16", torch.float64: "float64",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
    torch.complex64: "complex64",
}
DTYPES_BY_NAME = {v: k for k, v in DTYPE_NAMES.items()}
DTYPES_BY_NAME["bool_"] = torch.bool

# x64 off, as in the reference: 64-bit data from outside becomes 32-bit
_CANONICAL = {torch.int64: torch.int32, torch.float64: torch.float32,
              torch.complex128: torch.complex64}


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name (``"bfloat16"``), a numpy
    dtype or a Python/numpy scalar type."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        return DTYPES_BY_NAME[dtype]
    if dtype is bool:
        return torch.bool
    if dtype is int:
        return torch.int32
    if dtype is float:
        return torch.float32
    return DTYPES_BY_NAME[np.dtype(dtype).name]


def dtype_name(dtype) -> str:
    return DTYPE_NAMES[as_dtype(dtype)]


def _is_inexact(dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


def _as_torch(x: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    """``torch.Tensor`` of array-like ``x`` on ``device`` (default: the
    current device), 64-bit types canonicalized to 32 bits."""
    dev = device if device is not None else _device.current_device()
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":   # numpy bf16 (ml_dtypes) arrays
            t = torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:   # a read-only buffer is copied: torch wants writable ones
            t = torch.as_tensor(a if a.flags.writeable else a.copy())
    t = t.to(dtype=_CANONICAL.get(t.dtype, t.dtype), device=dev)
    return t


# ----------------------------------------------------------------------
# Storage: refcounted allocation accounting (§5.5)
# ----------------------------------------------------------------------

class Storage:
    """Owns one accounting block in the caching allocator.

    Python's refcounting destroys this object the moment the last Tensor
    (or autograd closure) referencing it dies, returning the block to the
    allocator pool immediately — no deferred GC (§5.5).
    """

    __slots__ = ("nbytes", "_block", "stream_id")

    def __init__(self, nbytes: int, stream_id: int):
        self.nbytes = nbytes
        self.stream_id = stream_id
        self._block = _alloc.device_allocator().allocate(nbytes, stream_id)

    def __del__(self):
        try:
            _alloc.device_allocator().free(self._block)
        except Exception:  # noqa: BLE001 (interpreter shutdown)
            pass


def _nbytes_of(data: torch.Tensor) -> int:
    return data.numel() * data.element_size()


# ----------------------------------------------------------------------
# Tensor
# ----------------------------------------------------------------------

class Tensor:
    """Operator-overloaded eager tensor over a ``torch.Tensor``.

    The define-by-run surface of the framework: arithmetic/indexing
    build autograd tape nodes as they execute, ``backward()`` walks the
    tape, in-place ops bump a version counter so stale autograd
    references fail loudly, and views write through to their base.
    Inside ``with repro_torch.fuse.fusion():`` elementwise chains defer
    and flush as one fused kernel.
    """

    __slots__ = (
        "_d",           # the torch.Tensor (None while a fusion chain pends)
        "_pending",     # fuse.PendingOp when lazily enqueued, else None
        "requires_grad",
        "grad",
        "grad_fn",
        "_output_index",
        "_version",
        "_storage",
        "_base",        # for views: the viewed-into tensor
        "_view_index",  # the indexing expression creating the view
        "__weakref__",
    )

    # ``_data`` is the materialization funnel: reading it flushes any
    # pending fusion chain.
    @property
    def _data(self) -> torch.Tensor:
        if self._pending is not None:
            _fuse().flush_tensor(self)
        return self._d

    @_data.setter
    def _data(self, value) -> None:
        self._d = value
        self._pending = None

    def __init__(self, data: Any, requires_grad: bool = False,
                 _storage: Optional[Storage] = None,
                 _version: Optional[VersionCounter] = None):
        if isinstance(data, Tensor):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = _as_torch(data)
        if requires_grad and not _is_inexact(data.dtype):
            raise RuntimeError(
                "Only Tensors of floating point and complex dtype can "
                "require gradients"
            )
        self._data = data
        self.requires_grad = requires_grad
        self.grad: Optional[Tensor] = None
        self.grad_fn: Optional[Node] = None
        self._output_index = 0
        self._version = _version if _version is not None else VersionCounter()
        self._base: Optional[Tensor] = None
        self._view_index = None
        if _storage is None and not is_tracing():
            _storage = Storage(_nbytes_of(data),
                               _stream.current_stream().stream_id)
        self._storage = _storage

    # -- basic properties ----------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        return self._data

    @data.setter
    def data(self, value):
        self._data = value._data if isinstance(value, Tensor) else value

    @property
    def shape(self) -> Tuple[int, ...]:
        # metadata reads must not force a pending chain to materialize
        if self._pending is not None:
            return self._pending.shape
        return tuple(self._d.shape)

    @property
    def dtype(self) -> torch.dtype:
        if self._pending is not None:
            return self._pending.dtype
        return self._d.dtype

    @property
    def device(self) -> torch.device:
        if self._pending is not None:
            return self._pending.device
        return self._d.device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size_bytes(self) -> int:
        return self.numel() * torch.empty((), dtype=self.dtype).element_size()

    @property
    def is_leaf(self) -> bool:
        return self.grad_fn is None

    def size(self, dim: Optional[int] = None):
        return self.shape if dim is None else self.shape[dim]

    def numel(self) -> int:
        return math.prod(self.shape)

    def dim(self) -> int:
        return self.ndim

    def numpy(self) -> np.ndarray:
        """The values as a numpy array (bf16 and fp16 come back as
        float32: numpy has no bf16 without an extra package)."""
        d = self._data.detach()
        if d.dtype in (torch.bfloat16, torch.float16):
            d = d.float()
        return d.cpu().numpy()

    def item(self):
        return self._data.item()

    def tolist(self):
        return self.numpy().tolist()

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        grad_part = ""
        if self.grad_fn is not None:
            grad_part = f", grad_fn=<{self.grad_fn.name}>"
        elif self.requires_grad:
            grad_part = ", requires_grad=True"
        return f"Tensor({self.numpy()!r}{grad_part})"

    def __hash__(self):
        return id(self)

    def __bool__(self):
        return bool(self._data)

    # -- autograd --------------------------------------------------------
    def backward(self, gradient: Optional["Tensor"] = None,
                 retain_graph: bool = False) -> None:
        _backward(self, [gradient] if gradient is not None else None,
                  retain_graph=retain_graph)

    def _accumulate_grad(self, g: torch.Tensor) -> None:
        if self.grad is None:
            self.grad = Tensor(g)
        else:
            self.grad = Tensor(self.grad._data + g)

    def detach(self) -> "Tensor":
        return Tensor(self._data, _storage=self._storage,
                      _version=self._version)

    def detach_(self) -> "Tensor":
        self.grad_fn = None
        self.requires_grad = False
        return self

    def requires_grad_(self, flag: bool = True) -> "Tensor":
        if flag and not _is_inexact(self.dtype):
            raise RuntimeError(
                "Only Tensors of floating point and complex dtype can "
                "require gradients"
            )
        self.requires_grad = flag
        return self

    def clone(self) -> "Tensor":
        return _apply_op("clone", _clone, self, static=())

    def retain_grad(self) -> "Tensor":
        self.requires_grad = True
        return self

    # -- dtype / device movement ----------------------------------------
    def astype(self, dtype) -> "Tensor":
        dt = as_dtype(dtype)
        return _apply_op("astype", lambda x: x.to(dt), self,
                         static=(DTYPE_NAMES[dt],))

    def to(self, dtype=None) -> "Tensor":
        """``to(dtype)`` casts; ``to("cpu")`` / ``to("cuda")`` (or a
        ``torch.device``) moves, differentiably."""
        if dtype is None:
            return self
        if isinstance(dtype, torch.device) or (
                isinstance(dtype, str) and dtype.split(":")[0] in
                ("cpu", "cuda")):
            dev = torch.device(dtype)
            return _apply_op("to_device", lambda x: x.to(dev), self,
                             static=(str(dev),))
        return self.astype(dtype)

    def float(self):
        return self.astype(torch.float32)

    def bfloat16(self):
        return self.astype(torch.bfloat16)

    def half(self):
        return self.astype(torch.float16)

    def int(self):
        return self.astype(torch.int32)

    def bool(self):
        return self.astype(torch.bool)

    def cpu(self):
        return self.to("cpu")

    def cuda(self):
        return self.to("cuda")

    # -- arithmetic (operator overloading: the define-by-run surface) ----
    def __add__(self, other):
        return add(self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return sub(self, other)

    def __rsub__(self, other):
        return sub(_coerce(other, like=self), self)

    def __mul__(self, other):
        return mul(self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return div(self, other)

    def __rtruediv__(self, other):
        return div(_coerce(other, like=self), self)

    def __pow__(self, other):
        return pow_(self, other)

    def __rpow__(self, other):
        return pow_(_coerce(other, like=self), self)

    def __matmul__(self, other):
        return matmul(self, other)

    def __rmatmul__(self, other):
        return matmul(_coerce(other, like=self), self)

    def __neg__(self):
        return _apply_op("neg", torch.neg, self, static=())

    def __abs__(self):
        return _apply_op("abs", torch.abs, self, static=())

    def __mod__(self, other):
        return _apply_op("mod", torch.remainder, self,
                         _coerce(other, like=self), static=())

    # comparisons (non-differentiable)
    def __eq__(self, other):  # type: ignore[override]
        return Tensor(self._data == _raw(other))

    def __ne__(self, other):  # type: ignore[override]
        return Tensor(self._data != _raw(other))

    def __lt__(self, other):
        return Tensor(self._data < _raw(other))

    def __le__(self, other):
        return Tensor(self._data <= _raw(other))

    def __gt__(self, other):
        return Tensor(self._data > _raw(other))

    def __ge__(self, other):
        return Tensor(self._data >= _raw(other))

    # -- indexing ---------------------------------------------------------
    def __getitem__(self, index) -> "Tensor":
        index = _raw_index(index, self.device)
        tok = _hashable_index_token(index)
        out = _apply_op("getitem", lambda x: x[index], self,
                        static=(tok,) if tok is not None else None)
        # basic-indexing results are views: share version counter so
        # mutation through either side is detected / written through.
        if _is_basic_index(index):
            out._version = self._version
            out._base = self._base if self._base is not None else self
            out._view_index = index
            out._storage = self._storage
        return out

    def __setitem__(self, index, value) -> None:
        index = _raw_index(index, self.device)
        self._inplace_guard("__setitem__")
        val = _raw(value)
        self._write_through(lambda x: _set_at(x, index, val))

    # -- in-place ops (mutation; §4.3 versioning) -------------------------
    def _inplace_guard(self, opname: str) -> None:
        if self.requires_grad and self.grad_fn is None and is_grad_enabled():
            raise RuntimeError(
                f"a leaf Variable that requires grad is being used in an "
                f"in-place operation ({opname})"
            )

    def _write_through(self, fn: Callable[[torch.Tensor], torch.Tensor]
                       ) -> None:
        """Apply ``fn`` to this tensor's data, writing through views to the
        base storage, and bump the shared version counter."""
        # mutation is a fusion barrier: pending chains captured this
        # tensor's pre-mutation value, so they must materialize first
        _fuse().flush_all()
        if self._base is not None:
            base = self._base
            idx = self._view_index
            new_base = _set_at(base._data, idx, fn(base._data[idx]))
            base._data = new_base
            self._data = new_base[idx]
        else:
            self._data = fn(self._data)
        self._version.bump()

    def _inplace_binary(self, opname: str, fn, other, alpha=None):
        self._inplace_guard(opname)
        _fuse().flush_all()  # mutation is a fusion barrier
        o = _raw(other)
        if alpha is not None:
            o = o * alpha
        if (is_grad_enabled()
                and self.grad_fn is not None
                and _is_inexact(self.dtype)):
            # differentiable in-place: record as out-of-place op against a
            # snapshot of the pre-mutation value (so the new node points at
            # the OLD grad_fn, not at itself), then mutate this object.
            # The version bump happens BEFORE the node records its saved
            # versions: this very op is consistent with the new version,
            # while any later mutation is still caught.
            self._version.bump()
            snapshot = Tensor(self._data, _storage=self._storage,
                              _version=self._version)
            snapshot.grad_fn = self.grad_fn
            snapshot._output_index = self._output_index
            snapshot.requires_grad = self.requires_grad
            other_t = other if isinstance(other, Tensor) and alpha is None \
                else Tensor(_as_torch(o, self.device))
            res = _apply_op(opname, fn, snapshot, other_t, static=())
            self._data = res._data
            self.grad_fn = res.grad_fn
            self._output_index = res._output_index
            # the mutated tensor starts a fresh version lineage: the
            # recorded node holds the OLD counter via the snapshot, so
            # chained differentiable in-place ops don't trip each other
            self._version = VersionCounter()
        else:
            self._write_through(lambda x: fn(x, o))
        return self

    def add_(self, other, alpha=None):
        return self._inplace_binary("add_", torch.add, other, alpha)

    def sub_(self, other, alpha=None):
        return self._inplace_binary("sub_", torch.sub, other, alpha)

    def mul_(self, other):
        return self._inplace_binary("mul_", torch.mul, other)

    def div_(self, other):
        return self._inplace_binary("div_", torch.true_divide, other)

    def zero_(self):
        self._write_through(torch.zeros_like)
        return self

    def fill_(self, value):
        self._write_through(lambda x: torch.full_like(x, value))
        return self

    def copy_(self, other):
        src = _raw(other)
        self._write_through(lambda x: torch.broadcast_to(
            torch.as_tensor(src, device=x.device), x.shape).to(x.dtype))
        return self

    def clamp_(self, min=None, max=None):
        self._write_through(lambda x: _clip(x, min, max))
        return self

    # -- shape ops ---------------------------------------------------------
    def reshape(self, *shape) -> "Tensor":
        shape = _norm_shape(shape)
        return _apply_op("reshape", lambda x: x.reshape(shape), self,
                         static=(shape,))

    view = reshape

    def transpose(self, dim0: int, dim1: int) -> "Tensor":
        perm = list(range(self.ndim))
        perm[dim0], perm[dim1] = perm[dim1], perm[dim0]
        perm = tuple(perm)
        return _apply_op("transpose", lambda x: x.permute(perm), self,
                         static=(perm,))

    def permute(self, *dims) -> "Tensor":
        dims = _norm_shape(dims)
        return _apply_op("permute", lambda x: x.permute(dims), self,
                         static=(dims,))

    @property
    def T(self) -> "Tensor":
        return _apply_op("T", lambda x: x.permute(*range(x.ndim - 1, -1,
                                                            -1)),
                         self, static=())

    def squeeze(self, dim: Optional[int] = None) -> "Tensor":
        return _apply_op("squeeze", lambda x: x.squeeze() if dim is None
                         else x.squeeze(dim), self, static=(dim,))

    def unsqueeze(self, dim: int) -> "Tensor":
        return _apply_op("unsqueeze", lambda x: x.unsqueeze(dim),
                         self, static=(dim,))

    def flatten(self, start_dim: int = 0, end_dim: int = -1) -> "Tensor":
        shape = self.shape
        end = end_dim % self.ndim
        new = shape[:start_dim] + (-1,) + shape[end + 1:]
        return self.reshape(new)

    def expand(self, *sizes) -> "Tensor":
        sizes = _norm_shape(sizes)
        tgt = tuple(
            s if s != -1 else self.shape[i - (len(sizes) - self.ndim)]
            for i, s in enumerate(sizes)
        )
        return _apply_op("expand", lambda x: torch.broadcast_to(x, tgt),
                         self, static=(tgt,))

    def repeat(self, *reps) -> "Tensor":
        reps = _norm_shape(reps)
        return _apply_op("repeat", lambda x: torch.tile(x, reps), self,
                         static=(reps,))

    def chunk(self, chunks: int, dim: int = 0):
        return split(self, self.shape[dim] // chunks, dim)

    def split(self, size: int, dim: int = 0):
        return split(self, size, dim)

    # -- math methods -------------------------------------------------------
    def sum(self, dim=None, keepdim: bool = False):
        return _apply_op("sum", lambda x: _sum(x, dim, keepdim), self,
                         static=(_hashable_axis(dim), keepdim))

    def mean(self, dim=None, keepdim: bool = False):
        return _apply_op("mean", lambda x: _mean(x, dim, keepdim), self,
                         static=(_hashable_axis(dim), keepdim))

    def var(self, dim=None, keepdim: bool = False, unbiased: bool = True):
        ddof = 1 if unbiased else 0
        return _apply_op("var", lambda x: torch.var(
            _floating(x), dim=_axes(dim), correction=ddof, keepdim=keepdim),
            self, static=(_hashable_axis(dim), keepdim, ddof))

    def std(self, dim=None, keepdim: bool = False, unbiased: bool = True):
        ddof = 1 if unbiased else 0
        return _apply_op("std", lambda x: torch.std(
            _floating(x), dim=_axes(dim), correction=ddof, keepdim=keepdim),
            self, static=(_hashable_axis(dim), keepdim, ddof))

    def max(self, dim=None, keepdim: bool = False):
        if dim is None:
            return _apply_op("max", torch.amax, self, static=())
        values = _apply_op(
            "max", lambda x: torch.amax(x, dim=dim, keepdim=keepdim), self,
            static=(_hashable_axis(dim), keepdim))
        return values, self.argmax(dim)

    def min(self, dim=None, keepdim: bool = False):
        if dim is None:
            return _apply_op("min", torch.amin, self, static=())
        values = _apply_op(
            "min", lambda x: torch.amin(x, dim=dim, keepdim=keepdim), self,
            static=(_hashable_axis(dim), keepdim))
        return values, self.argmin(dim)

    def argmax(self, dim=None):
        return Tensor(torch.argmax(self._data, dim=dim).to(torch.int32))

    def argmin(self, dim=None):
        return Tensor(torch.argmin(self._data, dim=dim).to(torch.int32))

    def prod(self, dim=None, keepdim: bool = False):
        return _apply_op("prod", lambda x: _prod(x, dim, keepdim), self,
                         static=(_hashable_axis(dim), keepdim))

    def cumsum(self, dim: int):
        return _apply_op("cumsum", lambda x: torch.cumsum(
            x, dim, dtype=_acc_dtype(x.dtype)), self, static=(dim,))

    def exp(self):
        return _apply_op("exp", torch.exp, self, static=())

    def log(self):
        return _apply_op("log", torch.log, self, static=())

    def sqrt(self):
        return _apply_op("sqrt", torch.sqrt, self, static=())

    def rsqrt(self):
        return _apply_op("rsqrt", torch.rsqrt, self, static=())

    def abs(self):
        return _apply_op("abs", torch.abs, self, static=())

    def sin(self):
        return _apply_op("sin", torch.sin, self, static=())

    def cos(self):
        return _apply_op("cos", torch.cos, self, static=())

    def tanh(self):
        return _apply_op("tanh", torch.tanh, self, static=())

    def sigmoid(self):
        return _apply_op("sigmoid", torch.sigmoid, self, static=())

    def relu(self):
        return _apply_op("relu", torch.relu, self, static=())

    def erf(self):
        return _apply_op("erf", torch.erf, self, static=())

    def clamp(self, min=None, max=None):
        return _apply_op("clamp", lambda x: _clip(x, min, max), self,
                         static=(min, max))

    def softmax(self, dim: int = -1):
        return _apply_op("softmax", lambda x: torch.softmax(x, dim), self,
                         static=(dim,))

    def log_softmax(self, dim: int = -1):
        return _apply_op("log_softmax",
                         lambda x: torch.log_softmax(x, dim), self,
                         static=(dim,))

    def masked_fill(self, mask, value):
        return _apply_op("masked_fill",
                         lambda x, m: torch.where(_as_bool(m), value, x),
                         self, _coerce(mask, device=self.device),
                         static=(value,))

    def matmul(self, other):
        return matmul(self, other)

    mm = matmul
    bmm = matmul

    def dot(self, other):
        return matmul(self, other)

    def record_stream(self, s: "_stream.Stream") -> None:
        """Mark this tensor as used on stream ``s`` (cross-stream safety,
        §5.3): its storage free will then require a sync before reuse."""
        if self._storage is not None:
            self._storage.stream_id = s.stream_id


# ----------------------------------------------------------------------
# torch counterparts of the jnp semantics the reference relies on
# ----------------------------------------------------------------------

def _clone(x):
    # the reference clones as ``x + 0``, which turns bool into int32
    return x.to(torch.int32) if x.dtype == torch.bool else x.clone()


def _as_bool(m):
    return m if m.dtype == torch.bool else m != 0


def _clip(x, lo, hi):
    """``jnp.clip``: either bound may be None, and the result dtype
    promotes with the bounds as with weakly typed scalars."""
    if lo is None and hi is None:
        return x.clone()
    return torch.clamp(x, lo, hi)


def _acc_dtype(dtype):
    """Dtype of an integer sum or product: JAX keeps int32 (x64 off)
    where torch would widen to int64."""
    if dtype == torch.bool or (not _is_inexact(dtype)
                               and dtype != torch.uint8):
        return torch.int32
    return None


def _axes(dim):
    return tuple(dim) if isinstance(dim, (list, tuple)) else dim


def _floating(x):
    return x if _is_inexact(x.dtype) else x.to(torch.float32)


def _sum(x, dim, keepdim):
    if dim is None:
        dim = tuple(range(x.ndim))
    return torch.sum(x, dim=_axes(dim), keepdim=keepdim,
                     dtype=_acc_dtype(x.dtype))


def _mean(x, dim, keepdim):
    if dim is None:
        dim = tuple(range(x.ndim))
    return torch.mean(_floating(x), dim=_axes(dim), keepdim=keepdim)


def _prod(x, dim, keepdim):
    dt = _acc_dtype(x.dtype)
    if dim is None:
        out = torch.prod(x, dtype=dt)
        return out.reshape((1,) * x.ndim) if keepdim else out
    dims = sorted((d % x.ndim for d in (dim if isinstance(dim, (list, tuple))
                                        else (dim,))), reverse=True)
    for d in dims:
        x = torch.prod(x, d, keepdim=keepdim, dtype=dt)
    return x


def _set_at(x, index, value):
    """``x.at[index].set(value)``: a new tensor, ``x`` untouched."""
    y = x.clone()
    y[index] = value if not isinstance(value, torch.Tensor) \
        else value.to(device=y.device)
    return y


# ----------------------------------------------------------------------
# op dispatcher: forward + tape recording
# ----------------------------------------------------------------------

def _raw(x: Any) -> Any:
    return x._data if isinstance(x, Tensor) else x


def _raw_index_item(i, device):
    i = _raw(i)
    # torch allows list indices (`x[[0, 2]]`); they index as int64
    if isinstance(i, (list, np.ndarray)):
        return torch.as_tensor(np.asarray(i), device=device)
    return i


def _raw_index(index, device):
    if isinstance(index, tuple):
        return tuple(_raw_index_item(i, device) for i in index)
    return _raw_index_item(index, device)


def _is_basic_index(index) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return all(isinstance(i, (int, slice, type(Ellipsis), type(None)))
               for i in items)


def _hashable_axis(dim):
    """Reduction axes as a cache-key token (lists become tuples)."""
    return tuple(dim) if isinstance(dim, list) else dim


def _hashable_index_token(index):
    """A hashable token for a basic index expression, or ``None`` for
    advanced (tensor) indexing — which then dispatches uncached."""
    items = index if isinstance(index, tuple) else (index,)
    toks = []
    for i in items:
        if isinstance(i, (bool, np.bool_)):
            # bool is an int subclass: x[True] must not replay x[1]
            toks.append(("b", bool(i)))
        elif isinstance(i, (int, np.integer)):
            toks.append(("i", int(i)))
        elif i is None:
            toks.append(("n",))
        elif i is Ellipsis:
            toks.append(("e",))
        elif isinstance(i, slice):
            parts = (i.start, i.stop, i.step)
            if not all(isinstance(v, (int, np.integer, type(None)))
                       for v in parts):
                return None
            toks.append(("s",) + tuple(
                int(v) if v is not None else None for v in parts))
        else:
            return None
    return tuple(toks)


_scalar_cache: dict = {}
_SCALAR_DTYPES = {bool: torch.bool, int: torch.int32, float: torch.float32}


def _coerce(x: Any, like: Optional[Tensor] = None,
            device: Optional[torch.device] = None) -> Tensor:
    """``x`` as a Tensor.  A Python scalar becomes a cached 0-d tensor
    on ``like``'s device (else ``device``, else the current one): of
    ``like``'s dtype when that is floating, else bool / int32 / float32
    by its type, so that it promotes as JAX's weakly typed scalars do
    (a 0-d tensor never widens a tensor of its own kind in torch)."""
    if isinstance(x, Tensor):
        return x
    dev = like.device if like is not None else (
        device if device is not None else _device.current_device())
    if type(x) in (int, float, bool):
        dt = like.dtype if (like is not None and _is_inexact(like.dtype)) \
            else _SCALAR_DTYPES[type(x)]
        if is_tracing():  # a traced constant must not enter the cache
            return Tensor(torch.tensor(x, dtype=dt, device=dev))
        key = (type(x), x, dt, dev)
        arr = _scalar_cache.get(key)
        if arr is None:
            arr = torch.tensor(x, dtype=dt, device=dev)
            if len(_scalar_cache) > 1024:
                _scalar_cache.clear()
            _scalar_cache[key] = arr
        return Tensor(arr)
    arr = _as_torch(x, dev)
    if (like is not None and _is_inexact(like.dtype)
            and not _is_inexact(arr.dtype)):
        arr = arr.to(like.dtype)
    elif (like is not None and _is_inexact(like.dtype)
            and arr.dtype != like.dtype and np.isscalar(x)):
        arr = arr.to(like.dtype)
    return Tensor(arr)


def _wrap_outputs(raw, node: Optional[Node]):
    """Wrap raw torch outputs in Tensors attached to ``node``."""
    single = not isinstance(raw, tuple)
    outs = (raw,) if single else raw
    tensors = []
    for i, o in enumerate(outs):
        t = Tensor(o)
        if node is not None:
            t.grad_fn = node
            t._output_index = i
        tensors.append(t)
    if not is_tracing():
        _stream.current_stream().enqueue(*[t._d for t in tensors])
    return tensors[0] if single else tuple(tensors)


_STATIC_OK_TYPES = (int, float, bool, str, bytes, type(None), type,
                    type(Ellipsis), np.dtype, torch.dtype)


def _static_ok(static) -> bool:
    """True when a static descriptor is safe to use as a cache-key
    component: plain hashable scalars/axes/dtypes only.  Tensors are
    hashable (by id) but must NOT be baked into a cached closure — data
    would go stale under mutation — so they disqualify the key."""
    if isinstance(static, tuple):
        return all(_static_ok(s) for s in static)
    if isinstance(static, _STATIC_OK_TYPES):
        return True
    return isinstance(static, np.integer) or isinstance(static, np.floating)


def _apply_op(name: str, fn: Callable, *tensors: Tensor,
              num_outputs: int = 1, static=None):
    """Execute ``fn`` over tensor data; record a tape node when needed.

    The single funnel for every differentiable eager op.  ``static`` is
    the dispatch-cache contract: a hashable tuple naming everything
    ``fn``'s closure captures besides the tensor operands; ``None`` (or
    an unhashable one) takes the uncached path.
    """
    cacheable = static is not None and _static_ok(static)

    # Elementwise fusion queue: defer the op entirely, returning a
    # pending tensor that records the chain (flushed as ONE kernel at a
    # materialization point).  Must run before touching operand data.
    if cacheable and num_outputs == 1:
        pending = _fuse().try_enqueue(name, fn, static, tensors)
        if pending is not None:
            return pending

    datas = [t._data for t in tensors]
    diffable = [i for i, t in enumerate(tensors) if _is_inexact(t.dtype)]
    tracing = is_tracing()
    needs_grad = (
        not tracing
        and is_grad_enabled()
        and any(tensors[i].requires_grad or tensors[i].grad_fn is not None
                for i in diffable)
    )

    entry = None
    if tracing:
        # the dispatch-cache-aware compile: a trace under
        # ``dispatch.seeding`` pre-creates the eager entries of its ops
        if cacheable and _dispatch.seeding_enabled() \
                and _dispatch.is_enabled():
            _dispatch.seed_op(name, static, datas, fn, diffable)
    elif _dispatch.is_enabled():
        cache = _dispatch.dispatch_cache()
        if not cacheable:
            if static is not None:
                cache.record_fallback(name)
            else:
                cache.record_uncached(name)
        else:
            key = _dispatch.make_key(name, static, datas, needs_grad)
            if key is None:
                cache.record_fallback(name)
            else:
                entry = cache.get_or_create(key, fn, diffable)

    with op_range(name):
        if not needs_grad:
            raw = entry.fwd(*datas) if entry is not None else fn(*datas)
            return _wrap_outputs(raw, None)
        if entry is not None:
            out, vjp_fn = entry.vjp(datas)
        else:
            out, vjp_fn = _dispatch.partial_vjp(fn, datas, diffable)
    inputs = [tensors[i] for i in diffable]
    node = Node(name, vjp_fn, inputs, num_outputs=num_outputs)
    outs = out if isinstance(out, tuple) else (out,)
    node.metadata["out_avals"] = [(o.shape, o.dtype, o.device)
                                  for o in outs]
    for t in inputs:
        node.save_version(t)
    return _wrap_outputs(out, node)


# ----------------------------------------------------------------------
# module-level functional ops
# ----------------------------------------------------------------------

def add(a, b):
    a = _coerce(a)
    b = _coerce(b, like=a)
    return _apply_op("add", torch.add, a, b, static=())


def sub(a, b):
    a = _coerce(a)
    b = _coerce(b, like=a)
    return _apply_op("sub", torch.sub, a, b, static=())


def mul(a, b):
    a = _coerce(a)
    b = _coerce(b, like=a)
    return _apply_op("mul", torch.mul, a, b, static=())


def div(a, b):
    a = _coerce(a)
    b = _coerce(b, like=a)
    return _apply_op("div", torch.true_divide, a, b, static=())


def pow_(a, b):
    a = _coerce(a)
    b = _coerce(b, like=a)
    return _apply_op("pow", torch.pow, a, b, static=())


def matmul(a, b):
    """Matrix product ``a @ b`` (same as the ``@`` operator)."""
    a = _coerce(a)
    b = _coerce(b, like=a)
    return _apply_op("matmul", torch.matmul, a, b, static=())


def _device_of(*xs) -> Optional[torch.device]:
    for x in xs:
        if isinstance(x, Tensor):
            return x.device
    return None


def maximum(a, b):
    """Elementwise maximum of two tensors (broadcasting)."""
    dev = _device_of(a, b)
    a, b = _coerce(a, device=dev), _coerce(b, device=dev)
    return _apply_op("maximum", torch.maximum, a, b, static=())


def minimum(a, b):
    """Elementwise minimum of two tensors (broadcasting)."""
    dev = _device_of(a, b)
    a, b = _coerce(a, device=dev), _coerce(b, device=dev)
    return _apply_op("minimum", torch.minimum, a, b, static=())


def _where(c, a, b):
    return torch.where(_as_bool(c), a, b)


def where(cond, a, b):
    """Elementwise select: ``a`` where ``cond`` is true, else ``b``."""
    dev = _device_of(cond, a, b)
    cond = _coerce(cond, device=dev)
    a = _coerce(a, device=dev)
    b = _coerce(b, like=a)
    return _apply_op("where", _where, cond, a, b, static=())


def cat(tensors: Sequence[Tensor], dim: int = 0) -> Tensor:
    """Concatenate tensors along ``dim`` (alias: ``concat``)."""
    tensors = [_coerce(t) for t in tensors]
    return _apply_op("cat", lambda *xs: torch.cat(xs, dim),
                     *tensors, static=(dim,))


concat = cat


def stack(tensors: Sequence[Tensor], dim: int = 0) -> Tensor:
    """Stack tensors along a NEW axis ``dim``."""
    tensors = [_coerce(t) for t in tensors]
    return _apply_op("stack", lambda *xs: torch.stack(xs, dim),
                     *tensors, static=(dim,))


def split(t: Tensor, size: int, dim: int = 0):
    """Split ``t`` into chunks of ``size`` along ``dim`` (last chunk
    may be smaller).  Returns a tuple of views."""
    n = t.shape[dim]
    pieces = []
    for start in range(0, n, size):
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(start, min(start + size, n))
        pieces.append(t[tuple(idx)])
    return tuple(pieces)


def einsum(subscripts: str, *tensors) -> Tensor:
    """Einstein-summation contraction, e.g. ``einsum("ij,jk->ik", a, b)``."""
    tensors = [_coerce(t) for t in tensors]
    return _apply_op("einsum",
                     lambda *xs: torch.einsum(subscripts, *xs), *tensors,
                     static=(subscripts,))


def logsumexp(t: Tensor, dim=None, keepdim: bool = False) -> Tensor:
    """Numerically stable ``log(sum(exp(t)))`` over ``dim``."""
    def _lse(x):
        axes = tuple(range(x.ndim)) if dim is None else _axes(dim)
        return torch.logsumexp(x, dim=axes, keepdim=keepdim)

    return _apply_op("logsumexp", _lse, _coerce(t),
                     static=(_hashable_axis(dim), keepdim))


def exp(t):
    return _coerce(t).exp()


def log(t):
    return _coerce(t).log()


def sqrt(t):
    return _coerce(t).sqrt()


def tanh(t):
    return _coerce(t).tanh()


def sigmoid(t):
    return _coerce(t).sigmoid()


def relu(t):
    return _coerce(t).relu()


def softmax(t, dim: int = -1):
    """Softmax over ``dim``."""
    return _coerce(t).softmax(dim)


def tril(t, k: int = 0):
    """Lower-triangular part of ``t`` (zero above diagonal ``k``)."""
    return _apply_op("tril", lambda x: torch.tril(x, k), _coerce(t),
                     static=(k,))


def triu(t, k: int = 0):
    """Upper-triangular part of ``t`` (zero below diagonal ``k``)."""
    return _apply_op("triu", lambda x: torch.triu(x, k), _coerce(t),
                     static=(k,))


def take_along_dim(t, indices, dim: int):
    """Gather values along ``dim`` at ``indices`` (torch.take_along_dim;
    indices ride as a non-differentiable operand, never a static)."""
    t = _coerce(t)
    return _apply_op("take_along_dim",
                     lambda x, i: torch.take_along_dim(x, i.long(), dim),
                     t, _coerce(indices, device=t.device), static=(dim,))


def one_hot(t, num_classes: int, dtype=torch.float32):
    """One-hot encode integer tensor ``t`` to ``num_classes`` columns."""
    idx = _raw(t) if isinstance(t, Tensor) else _as_torch(t)
    return Tensor(torch.nn.functional.one_hot(
        idx.long(), num_classes).to(as_dtype(dtype)))


def _norm_shape(shape):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        return tuple(shape[0])
    return tuple(shape)


# ----------------------------------------------------------------------
# factories + RNG
# ----------------------------------------------------------------------

# every factory draws from one host numpy generator, as the reference
# does (tensor.py:1079-1178), so ``manual_seed(s)`` gives the same
# numbers (and the same initial weights) in both packages
_rng_lock = threading.Lock()
_np_rng = np.random.default_rng(0)


def manual_seed(seed: int) -> None:
    """Re-seed the host RNG behind ``randn``/``rand``/``randint``/
    ``normal``/``uniform`` (reproducible eager initialization)."""
    global _np_rng
    with _rng_lock:
        _np_rng = np.random.default_rng(seed)


def _factory(arr, dtype=None, requires_grad: bool = False) -> Tensor:
    data = _as_torch(arr)
    if dtype is not None:
        data = data.to(as_dtype(dtype))
    return Tensor(data, requires_grad=requires_grad)


def _on_device(fn, *args, dtype, **kw) -> torch.Tensor:
    return fn(*args, dtype=as_dtype(dtype), device=_device.current_device(),
              **kw)


def tensor(data, dtype=None, requires_grad: bool = False) -> Tensor:
    """Build a Tensor from array-like ``data`` (list, numpy, scalar)."""
    return _factory(data, dtype, requires_grad)


def zeros(*shape, dtype=torch.float32, requires_grad: bool = False) -> Tensor:
    """All-zeros tensor of ``shape``."""
    return Tensor(_on_device(torch.zeros, _norm_shape(shape), dtype=dtype),
                  requires_grad)


def ones(*shape, dtype=torch.float32, requires_grad: bool = False) -> Tensor:
    """All-ones tensor of ``shape``."""
    return Tensor(_on_device(torch.ones, _norm_shape(shape), dtype=dtype),
                  requires_grad)


def full(shape, fill_value, dtype=torch.float32,
         requires_grad: bool = False) -> Tensor:
    """Tensor of ``shape`` filled with ``fill_value``."""
    return Tensor(_on_device(torch.full, tuple(shape), fill_value,
                             dtype=dtype), requires_grad)


def empty(*shape, dtype=torch.float32, requires_grad: bool = False) -> Tensor:
    """Uninitialized-by-contract tensor (zeros, as in the reference)."""
    return zeros(*shape, dtype=dtype, requires_grad=requires_grad)


def zeros_like(t, dtype=None) -> Tensor:
    """All-zeros tensor with ``t``'s shape (and dtype unless given)."""
    d = _raw(t)
    return Tensor(torch.zeros_like(
        d, dtype=as_dtype(dtype) if dtype is not None else None))


def ones_like(t, dtype=None) -> Tensor:
    """All-ones tensor with ``t``'s shape (and dtype unless given)."""
    d = _raw(t)
    return Tensor(torch.ones_like(
        d, dtype=as_dtype(dtype) if dtype is not None else None))


def arange(*args, dtype=None) -> Tensor:
    """``arange(stop)`` / ``arange(start, stop[, step])`` range tensor."""
    return _factory(np.arange(*args), dtype)


def eye(n, m=None, dtype=torch.float32) -> Tensor:
    """Identity matrix of shape (n, m or n)."""
    return Tensor(_on_device(torch.eye, n, m if m is not None else n,
                             dtype=dtype))


def randn(*shape, dtype=torch.float32, requires_grad: bool = False) -> Tensor:
    """Standard-normal tensor of ``shape`` (host RNG; ``manual_seed``)."""
    with _rng_lock:
        arr = _np_rng.standard_normal(_norm_shape(shape), dtype=np.float32)
    return _factory(arr, dtype, requires_grad)


def rand(*shape, dtype=torch.float32, requires_grad: bool = False) -> Tensor:
    """Uniform-[0, 1) tensor of ``shape`` (host RNG; ``manual_seed``)."""
    with _rng_lock:
        arr = _np_rng.random(_norm_shape(shape), dtype=np.float32)
    return _factory(arr, dtype, requires_grad)


def randint(low, high, shape, dtype=torch.int32) -> Tensor:
    """Integer tensor uniform in [low, high) of ``shape``."""
    with _rng_lock:
        arr = _np_rng.integers(low, high, size=shape)
    return _factory(arr, dtype)


def normal(mean: float, std: float, shape, dtype=torch.float32,
           requires_grad: bool = False) -> Tensor:
    """Normal(mean, std) tensor of ``shape`` (host RNG; ``manual_seed``)."""
    with _rng_lock:
        arr = _np_rng.normal(mean, std, size=shape).astype(np.float32)
    return _factory(arr, dtype, requires_grad)


def uniform(low: float, high: float, shape, dtype=torch.float32,
            requires_grad: bool = False) -> Tensor:
    """Uniform-[low, high) tensor of ``shape`` (host RNG; ``manual_seed``)."""
    with _rng_lock:
        arr = _np_rng.uniform(low, high, size=shape).astype(np.float32)
    return _factory(arr, dtype, requires_grad)


def from_numpy(arr: np.ndarray) -> Tensor:
    """numpy interop (§4.2): shares the buffer on the CPU where dtype and
    layout allow; copies to the card otherwise."""
    return Tensor(_as_torch(torch.from_numpy(np.asarray(arr))))


# ----------------------------------------------------------------------
# pytree registration (the jit bridge and torch.func flatten Tensors)
# ----------------------------------------------------------------------

def _tensor_flatten(t: Tensor):
    return [t._data], t.requires_grad


def _tensor_unflatten(children, requires_grad) -> Tensor:
    """A Tensor around a flattened (or traced, or transformed) torch
    tensor, without allocator accounting, as the reference's unflatten
    makes one without a storage."""
    t = Tensor.__new__(Tensor)
    t._data = children[0]
    t.requires_grad = requires_grad
    t.grad = None
    t.grad_fn = None
    t._output_index = 0
    t._version = VersionCounter()
    t._base = None
    t._view_index = None
    t._storage = None
    return t


torch.utils._pytree.register_pytree_node(
    Tensor, _tensor_flatten, _tensor_unflatten,
    serialized_type_name="repro_torch.Tensor")
