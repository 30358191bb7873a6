"""The compiled path (the jit bridge) and the elementwise fusion queue.

Counterpart of ``repro/core/fuse.py``.  Two layers of the paper's
performance story live here:

1. **The jit bridge** (``compile``, ``value_and_grad``, ``grad``).  The
   reference traces unmodified eager code with ``jax.jit``, its Tensor a
   pytree node.  Here ``compile(fn)`` traces ``fn`` once per input
   signature with ``make_fx`` over fake tensors (the Python runs once,
   as under a JAX trace: control flow is resolved, the tape records
   nothing, the dispatch cache is seeded on request, and Python side
   effects happen once), then hands the traced graph, pure torch ops, to
   ``torch.compile(dynamic=False)``, Inductor by default.  Dynamo so
   sees one FX graph and never the port's Python, which has no graph
   break.  The flash kernel's launch is a ``torch.library.custom_op``
   with a fake (shape) function, so the graph keeps it as one node that
   launches the kernel, counted, on every call; Inductor does not
   replace it.  The other kernels have no such operator yet: inside the
   trace their wrappers fail at a fake tensor's ``data_ptr``, and no
   plain version stands in.  The fusion queue is bypassed inside the
   trace, as the reference's is under ``jax.jit``.  ``value_and_grad`` and ``grad`` sit on
   ``torch.func.grad_and_value`` / ``torch.func.grad``: differentiation
   is the functional engine's, not the tape's.

2. **The elementwise fusion queue** (the §5 small-op fast path).  Inside
``with repro_torch.fuse.fusion():`` every elementwise op (add, mul, exp,
relu, ...) returns a *pending* tensor recording (op, statics, parents)
instead of dispatching.  At a materialization point — ``.numpy()``,
``.item()``, a reduction, convolution or matmul consuming the chain,
``backward()``, any in-place mutation — the maximal pending subgraph is
flushed through the dispatch cache as ONE multi-output kernel:
``kernels.ops.fused_elementwise``, which on a CUDA tensor launches a
Triton kernel generated from the recorded chain (every step's output is
stored, intermediates included) and on the CPU replays the chain's
torch ops (its plain version).  Semantics are preserved exactly:

* parent values are snapshotted at enqueue (the wrapped torch tensors
  are never written in place, so holding the reference *is* the
  snapshot), and every in-place mutation flushes all pending chains
  first;
* autograd records one tape node per flushed chain (``fused[a+b+...]``)
  whose VJP is ``torch.func.vjp`` of the chain's plain version,
  recomputed from the chain's external inputs in the backward pass, as
  the reference's cached jitted VJP of ``fused_fn`` is; version counters
  are captured at enqueue time, so mutate-after-use is detected as in
  the per-op tape.

One rule differs from the reference, and only in how many chains a
program flushes, never in values: a chain's steps all have the
output's shape.  ``try_enqueue`` flushes a pending parent whose shape
differs from the new op's output (a broadcast of a pending value), where
the reference keeps both in one chain; so the generated kernel runs one
pass over one shape.  Operands of other shapes (0-d scalars, broadcast
rows) still enter a chain as external inputs.

"""

from __future__ import annotations

import functools
import os
import threading
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from ..kernels import fused_elementwise as _fe
from . import dispatch as _dispatch
from . import stream as _stream
from .autograd import (Node, VersionCounter, is_grad_enabled, is_tracing,
                       op_range, tracing)
from .tensor import Storage, Tensor, _is_inexact, _nbytes_of


# ----------------------------------------------------------------------
# the jit bridge (repro_torch.compile)
# ----------------------------------------------------------------------

class _Traced:
    """One traced signature of a compiled function: the compiled graph
    and how to rebuild the function's result from its tensor outputs."""

    __slots__ = ("run", "graph", "out_spec", "out_consts", "seconds")

    def __init__(self, run, graph, out_spec, out_consts, seconds):
        self.run = run
        self.graph = graph
        self.out_spec = out_spec
        self.out_consts = out_consts    # leaf index -> non-tensor leaf
        self.seconds = seconds          # trace seconds (compiling is lazy)

    def __call__(self, tensors):
        outs = iter(self.run(*tensors))
        leaves = [self.out_consts[i] if i in self.out_consts else next(outs)
                  for i in range(self.out_spec.num_leaves)]
        return pytree.tree_unflatten(leaves, self.out_spec)


def _trace(f, args, static_argnums, leaves, spec, seed_sink,
           compile_kwargs) -> _Traced:
    """Trace ``f`` at these arguments (the tensor ``leaves`` of its
    non-static arguments as graph inputs, every other leaf and the static
    arguments as constants) and compile the graph."""
    import time

    from torch.fx.experimental.proxy_tensor import make_fx

    is_tensor = [isinstance(x, torch.Tensor) for x in leaves]
    out_box = {}

    def flat_fn(*tensors):
        it = iter(tensors)
        full = [next(it) if t else x for x, t in zip(leaves, is_tensor)]
        dyn, kwargs = pytree.tree_unflatten(full, spec)
        it = iter(dyn)
        call = [a if i in static_argnums else next(it)
                for i, a in enumerate(args)]
        with tracing(), _dispatch.seeding(seed_sink is not None, seed_sink):
            out = f(*call, **kwargs)
        out_leaves, out_box["spec"] = pytree.tree_flatten(out)
        out_box["consts"] = {i: x for i, x in enumerate(out_leaves)
                             if not isinstance(x, torch.Tensor)}
        return [x for x in out_leaves if isinstance(x, torch.Tensor)]

    t0 = time.perf_counter()
    graph = make_fx(flat_fn, tracing_mode="fake",
                    _allow_non_fake_inputs=True)(
        *[x for x, t in zip(leaves, is_tensor) if t])
    seconds = time.perf_counter() - t0
    run = torch.compile(graph, **{"dynamic": False, **compile_kwargs})
    return _Traced(run, graph, out_box["spec"], out_box["consts"], seconds)


def compile(fn: Optional[Callable] = None, *, static_argnums=(),
            donate_argnums=(), seed_cache: bool = False,
            **compile_kwargs) -> Callable:
    """Trace-and-compile an eager function (models, train steps, ...).

    Works on any function whose tensor arguments are ``repro_torch.Tensor``
    / ``torch.Tensor`` or trees (lists, tuples, dicts) of them.  Each
    call signature (tensor shapes, dtypes and devices, the values of the
    ``static_argnums`` arguments and of every non-tensor leaf) is traced
    once and compiled by ``torch.compile(dynamic=False,
    **compile_kwargs)`` (Inductor unless ``backend=`` says otherwise);
    later calls of the signature replay it.  Inside the trace the tape
    is off; use :func:`value_and_grad` to compile a differentiated step.
    Tensors the function closes over (a module's parameters) are
    constants of the trace, as under ``jax.jit``: a function of changing
    weights takes them as arguments.  ``donate_argnums`` is accepted for
    the reference's signature and donates nothing: PyTorch's caching
    allocator reuses the memory.

    ``seed_cache=True`` makes the compile dispatch-cache-aware: while the
    function is traced, every op dispatched with a ``static=`` descriptor
    seeds its eager dispatch-cache entry (``dispatch.seeding``), once per
    signature, since the Python runs only while tracing.  The seeded op
    names are on ``wrapper.seeded_ops``.

    An unhashable static argument runs ``fn`` eagerly (uncached), warns
    once and bumps the dispatch cache's ``num_fallback_unhashable``
    counter instead of raising; every other failure raises.  The traced
    signatures are on ``wrapper._compiled``.
    """
    static_argnums = ((static_argnums,) if isinstance(static_argnums, int)
                      else tuple(static_argnums))
    del donate_argnums

    def wrap(f: Callable) -> Callable:
        traced: Dict[Any, _Traced] = {}
        warned = []
        seeded_ops: list = []

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            statics = tuple(args[i] for i in static_argnums
                            if i < len(args))
            leaves, spec = pytree.tree_flatten(
                ([a for i, a in enumerate(args) if i not in static_argnums],
                 kwargs))
            # tensors key by shape, dtype and device; other leaves and
            # the statics by value
            key = (statics, repr(spec), tuple(
                (tuple(x.shape), x.dtype, x.device)
                if isinstance(x, torch.Tensor) else (type(x), x)
                for x in leaves))
            try:
                hash(key)
            except TypeError:
                key = None
            if key is None:
                _dispatch.dispatch_cache().record_fallback("__compile__")
                if not warned:
                    warned.append(True)
                    warnings.warn(
                        f"repro_torch.compile({f.__name__}): non-hashable "
                        f"static argument; running uncompiled "
                        f"(cached counter: num_fallback_unhashable)")
                return f(*args, **kwargs)
            entry = traced.get(key)
            if entry is None:
                entry = traced[key] = _trace(
                    f, args, static_argnums, leaves, spec,
                    seeded_ops if seed_cache else None, compile_kwargs)
            return entry([x for x in leaves if isinstance(x, torch.Tensor)])

        wrapper._compiled = traced  # signature -> traced, compiled graph
        wrapper.seeded_ops = seeded_ops  # op names seeded at trace time
        return wrapper

    if fn is not None:
        return wrap(fn)
    return wrap


def _raw_output(fn: Callable, has_aux: bool) -> Callable:
    """``fn`` run as the bridge traces it, its (first) output unwrapped
    to a torch tensor."""
    def scalar_fn(*args, **kwargs):
        with tracing():
            out = fn(*args, **kwargs)
        if has_aux:
            out, aux = out
            return (out.data if isinstance(out, Tensor) else out), aux
        return out.data if isinstance(out, Tensor) else out

    return scalar_fn


def value_and_grad(fn: Callable, argnums=0, has_aux: bool = False) -> Callable:
    """Functional gradient of an eager-style function, for the compiled
    path: ``(value, grads)``, or ``((value, aux), grads)`` with
    ``has_aux``, as ``jax.value_and_grad`` returns them; grads have the
    structure of the ``argnums`` arguments (a Tensor's is a Tensor).
    Differentiation is ``torch.func``'s, not the tape's, as TorchScript
    code is differentiated by its own engine."""
    gv = torch.func.grad_and_value(_raw_output(fn, has_aux),
                                   argnums=argnums, has_aux=has_aux)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        grads, value = gv(*args, **kwargs)
        return value, grads

    return wrapper


def grad(fn: Callable, argnums=0, has_aux: bool = False) -> Callable:
    """Functional gradient (``torch.func.grad``): ``grads``, or
    ``(grads, aux)`` with ``has_aux``."""
    return functools.wraps(fn)(torch.func.grad(
        _raw_output(fn, has_aux), argnums=argnums, has_aux=has_aux))


def block_until_ready(tree: Any) -> Any:
    """Materialize every Tensor in a (nested list/tuple/dict) tree and
    wait for the card."""
    def walk(x):
        if isinstance(x, Tensor):
            x._data  # noqa: B018  (flushes a pending chain)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(tree)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return tree


# Ops that are safe to defer and fuse: one output, elementwise (or
# pure dtype-cast), no data-dependent shapes.  The second group is the
# nn.functional activation surface.  softmax/log_softmax stay out: they
# reduce over an axis.
ELEMENTWISE_OPS = frozenset({
    "add", "sub", "mul", "div", "pow", "mod", "neg", "abs", "clone",
    "astype", "exp", "log", "sqrt", "rsqrt", "sin", "cos", "tanh",
    "sigmoid", "relu", "erf", "clamp", "maximum", "minimum", "where",
    "masked_fill",
    "relu6", "gelu", "silu", "softplus", "hardswish", "leaky_relu",
    "elu", "dropout",
})

# Chains deeper than this flush eagerly — bounds pending-graph size and
# the generated kernel's length.
MAX_CHAIN_DEPTH = 32

_tls = threading.local()
_FUSION_DEFAULT = os.environ.get("REPRO_FUSION", "0") == "1"


def fusion_enabled() -> bool:
    return getattr(_tls, "fusion_on", _FUSION_DEFAULT)


def set_fusion(flag: bool) -> bool:
    """Enable/disable the fusion queue for this thread; returns the
    previous setting.  Disabling flushes outstanding chains."""
    prev = fusion_enabled()
    if not flag:
        flush_all()
    _tls.fusion_on = bool(flag)
    return prev


class fusion:
    """Context manager: batch elementwise chains into fused kernels.

    >>> with repro_torch.fuse.fusion():
    ...     y = (x * 2 + 1).tanh().exp()   # zero dispatches so far
    ... loss = y.sum()                      # one fused kernel + one sum
    """

    def __init__(self, enabled: bool = True):
        self._enabled = enabled

    def __enter__(self):
        self._prev = fusion_enabled()
        _tls.fusion_on = self._enabled
        return self

    def __exit__(self, *exc):
        flush_all()
        _tls.fusion_on = self._prev


class PendingOp:
    """One deferred elementwise op in a fusion chain."""

    __slots__ = ("name", "fn", "static", "parents", "parent_snap",
                 "shape", "dtype", "device", "needs_grad", "depth")

    def __init__(self, name, fn, static, parents, parent_snap, shape,
                 dtype, device, needs_grad, depth):
        self.name = name
        self.fn = fn
        self.static = static
        self.parents = parents          # tuple[Tensor]
        self.parent_snap = parent_snap  # torch.Tensor | None (None: pending)
        self.shape = shape              # inferred output shape
        self.dtype = dtype              # inferred output dtype
        self.device = device
        self.needs_grad = needs_grad
        self.depth = depth


def _registry() -> List:
    reg = getattr(_tls, "pending_reg", None)
    if reg is None:
        reg = _tls.pending_reg = []
    return reg


_aval_cache = {}


def _out_aval(name, static, fn, parent_sigs):
    """(shape, dtype) of an elementwise op's output: the broadcast of its
    operands' shapes, and the dtype ``fn`` gives on one-element CPU
    tensors of the operands' dtypes (0-d where the operand is, so that
    promotion sees the same dimensionality).  Running the op for real
    makes PyTorch refuse a dtype it does not take, as eager execution
    would (a ``meta`` run checks no dtype).  Cached by the op's
    signature, statics type-tagged: ``clamp(x, 0, 1)`` and
    ``clamp(x, 0.0, 1.0)`` give different dtypes."""
    key = (name, _dispatch._typed(static), parent_sigs)
    out = _aval_cache.get(key)
    if out is None:
        shape = tuple(torch.broadcast_shapes(*[s for s, _ in parent_sigs]))
        res = fn(*[torch.ones((1,) * min(len(s), 1), dtype=d)
                   for (s, d) in parent_sigs])
        out = (shape, res.dtype)
        _aval_cache[key] = out
    return out


def try_enqueue(name: str, fn: Callable, static, tensors) -> Optional[Tensor]:
    """Defer an elementwise op, returning its pending output tensor —
    or ``None`` when the op must dispatch immediately (fusion off,
    not elementwise, inside the jit bridge's trace, operands on several
    devices, or shapes the op refuses: the eager path then reports the
    error)."""
    if not fusion_enabled() or name not in ELEMENTWISE_OPS or \
            is_tracing() or torch.compiler.is_compiling():
        return None  # inside a trace: it takes the op as it comes
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        return None

    parent_sigs = tuple((t.shape, t.dtype) for t in tensors)
    try:
        out_shape, out_dtype = _out_aval(name, static, fn, parent_sigs)
    except (RuntimeError, TypeError, ValueError):
        return None  # shape inference failed: let the eager path report

    needs_grad = is_grad_enabled() and any(
        (t.requires_grad or t.grad_fn is not None
         or (t._pending is not None and t._pending.needs_grad))
        and _is_inexact(t.dtype)
        for t in tensors)
    # never fuse across a grad-mode boundary: a chain built under
    # no_grad must stay constant (no shared node), and a grad chain must
    # not differentiate through a constant subchain — flush mismatched
    # pending parents so they join as materialized ext inputs.  A pending
    # parent of another shape than this op's output is flushed too, so
    # every step of a chain has one shape (module docstring).
    for t in tensors:
        if t._pending is not None and (t._pending.needs_grad != needs_grad
                                       or t._pending.shape != out_shape):
            flush_tensor(t)
    depth = 1 + max(
        (t._pending.depth for t in tensors if t._pending is not None),
        default=0)
    pend = PendingOp(
        name, fn, static,
        parents=tuple(tensors),
        parent_snap=tuple(
            None if t._pending is not None else t._d for t in tensors),
        shape=out_shape,
        dtype=out_dtype,
        device=device,
        needs_grad=needs_grad,
        depth=depth,
    )

    out = Tensor.__new__(Tensor)
    out._d = None
    out._pending = pend
    out.requires_grad = False
    out.grad = None
    out.grad_fn = None
    out._output_index = 0
    out._version = VersionCounter()
    out._base = None
    out._view_index = None
    out._storage = None

    reg = _registry()
    reg.append(weakref.ref(out))
    if len(reg) > 4096:  # compact dead/flushed refs
        _tls.pending_reg = [r for r in reg
                            if (x := r()) is not None
                            and x._pending is not None]

    if depth >= MAX_CHAIN_DEPTH:
        flush_tensor(out)
    return out


def flush_all() -> None:
    """Materialize every pending chain in this thread (mutation barrier,
    explicit sync point).  Newest-first: flushing a chain's terminal
    materializes its whole subgraph in one fused kernel, so earlier
    registry entries are usually already done by the time we reach them."""
    reg = getattr(_tls, "pending_reg", None)
    if not reg:
        return
    for ref in reversed(list(reg)):
        t = ref()
        if t is not None and t._pending is not None:
            flush_tensor(t)
    reg.clear()


class _Subgraph:
    """The maximal pending subgraph feeding one tensor, in the order its
    steps run: each step's pending tensor, the chain descriptor, and the
    chain's external inputs with their enqueue-time values and
    versions."""

    def __init__(self, t: Tensor):
        self.steps = []          # (fn, arg_slots, name, static)
        self.by_slot: List[Tensor] = []  # tmp index -> its pending tensor
        self.ext_tensors: List[Tensor] = []
        self.ext_data: List = []
        self.version_records = {}  # ext index -> (counter, value)
        self._slot_of = {}       # id(pending tensor) -> tmp index
        self._ext_ids = {}
        self._visit(t)
        self.chain = _fe.FusedChain(
            steps=tuple((name, static, slots)
                        for (_, slots, name, static) in self.steps),
            fns=tuple(fn for (fn, _, _, _) in self.steps),
            dtypes=tuple(x._pending.dtype for x in self.by_slot))

    def _ext_slot(self, p: Tensor, snap) -> Tuple[str, int]:
        idx = self._ext_ids.get(id(p))
        if idx is None:
            idx = len(self.ext_tensors)
            self._ext_ids[id(p)] = idx
            self.ext_tensors.append(p)
            # enqueue-time snapshot; a parent that was pending at enqueue
            # but flushed since uses its materialized value (mutation
            # cannot have intervened: mutation flushes all chains first,
            # which also makes flush-time version records equal to
            # enqueue-time ones)
            self.ext_data.append(snap if snap is not None else p._d)
            self.version_records[idx] = (p._version, p._version.value)
        return ("e", idx)

    def _visit(self, x: Tensor) -> int:
        if id(x) in self._slot_of:
            return self._slot_of[id(x)]
        p = x._pending
        slots = []
        for parent, snap in zip(p.parents, p.parent_snap):
            if parent._pending is not None:
                slots.append(("t", self._visit(parent)))
            else:
                slots.append(self._ext_slot(parent, snap))
        idx = len(self.steps)
        self.steps.append((p.fn, tuple(slots), p.name, p.static))
        self.by_slot.append(x)
        self._slot_of[id(x)] = idx
        return idx


def capture_chain(fn: Callable, *args):
    """Run ``fn(*args)`` with the fusion queue on and return the chain
    its result is pending on, with the chain's external inputs:
    ``(FusedChain, [torch.Tensor, ...])``.  The chain is not run: the
    pending tensors are dropped.  How the tests and the chip check hold
    the generated kernel to the exact ops the runtime records."""
    with fusion():
        out = fn(*args)
        if out._pending is None:
            raise ValueError("capture_chain: the result is not pending "
                             "(no elementwise op of the fusion queue)")
        sub = _Subgraph(out)
        del out  # the only reference: nothing is left for the flush
        sub.by_slot.clear()
    return sub.chain, list(sub.ext_data)


def flush_tensor(t: Tensor) -> None:
    """Lower the maximal pending subgraph feeding ``t`` as ONE fused
    multi-output kernel (via the dispatch cache), execute it, and attach
    a single shared tape node.

    Every pending tensor in the subgraph — intermediates included — is
    materialized from the same kernel: tensor ``i`` becomes output ``i``
    of the fused node (the engine's multi-output cotangent accounting
    handles partial consumption, zero-filling unused outputs)."""
    if t._pending is None:
        return
    sub = _Subgraph(t)
    by_slot, chain = sub.by_slot, sub.chain
    ext_tensors, ext_data = sub.ext_tensors, sub.ext_data

    def fused_fn(*ext):
        return _fe.fused_elementwise_plain(chain, *ext)

    diffable = [i for i, d in enumerate(ext_data)
                if _is_inexact(d.dtype)]
    # any step needing grad means the shared node must exist (grad-mode
    # boundaries inside a chain are prevented at enqueue time)
    needs_grad = any(x._pending.needs_grad for x in by_slot)

    chain_name = "fused[" + "+".join(st[0] for st in chain.steps) + "]"
    key = _dispatch.make_key("__fused__", chain.steps, ext_data,
                             bool(needs_grad))
    entry = None
    with op_range(chain_name):
        if key is not None and _dispatch.is_enabled():
            entry = _dispatch.dispatch_cache().get_or_create(
                key, fused_fn, diffable,
                wrap=lambda _fn: _fe.make_fused_elementwise(chain))
            out_data = entry.fwd(*ext_data)
        else:
            if key is None:
                _dispatch.dispatch_cache().record_fallback("__fused__")
            out_data = _fe.fused_elementwise(chain, *ext_data)

    node = None
    if needs_grad:
        # the engine hands a bare cotangent for single-output nodes but
        # fused_fn always returns a tuple — normalize
        def _norm(cot):
            return cot if isinstance(cot, tuple) else (cot,)

        saved = tuple(ext_data)
        if entry is not None:
            bwd = entry.bwd()
            vjp_fn = lambda cot: bwd(saved, _norm(cot))  # noqa: E731
        else:
            vjp_fn = lambda cot: _dispatch.partial_vjp(  # noqa: E731
                fused_fn, saved, diffable)[1](_norm(cot))
        inputs = [ext_tensors[i] for i in diffable]
        node = Node(chain_name, vjp_fn, inputs,
                    num_outputs=len(chain.steps))
        node.metadata["out_avals"] = [
            (x._pending.shape, x._pending.dtype, x._pending.device)
            for x in by_slot]
        for i in diffable:
            node.saved_versions.append(sub.version_records[i])

    stream = _stream.current_stream()
    for idx, x in enumerate(by_slot):
        x._d = out_data[idx]
        x._pending = None
        x.grad_fn = node
        x._output_index = idx
        x._storage = Storage(_nbytes_of(out_data[idx]), stream.stream_id)
    stream.enqueue(*out_data)
