"""Define-by-run reverse-mode automatic differentiation (paper §4.3).

Counterpart of ``repro/core/autograd.py``: the same tape, engine, version
counters, grad modes and ``Function``, in pure Python over
``torch.Tensor`` data.  Every eager op records a :class:`Node` holding a
vector-Jacobian product closure obtained from ``torch.func.vjp`` (the
reference takes ``jax.vjp``), and the engine walks the recorded graph in
reverse topological order.  ``torch.autograd`` is never used to walk the
graph: node names (``mul``, ``fused[add+relu]``), error messages and
``retain_graph`` behaviour are the reference's.

* **Operator overloading** — the graph is rebuilt on every call, so
  arbitrary Python control flow works (§4.3 ¶1).
* **Tensor versioning for mutation** — in-place ops bump a version
  counter shared across views; saved-for-backward tensors snapshot the
  version and the engine raises if it changed (§4.3 ¶2).
* **Immediate graph release** — unless ``retain_graph=True``, node
  closures (and so the saved activations) are dropped as soon as they
  are consumed.

* **The compiled split** — inside the jit bridge's trace
  (``repro_torch.compile``, ``value_and_grad``, ``grad``: :func:`tracing`)
  no op records a node, as no op does under a ``jax.jit`` trace in the
  reference; the bridge differentiates with ``torch.func`` instead.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _profiler

# ----------------------------------------------------------------------
# Profiler ranges
# ----------------------------------------------------------------------

_NO_RANGE = contextlib.nullcontext()


def op_range(name: str):
    """A ``torch.profiler`` range ``repro_torch::<name>`` around an eager
    op (its forward, or ``<name>.bwd`` for its VJP in the engine) while a
    profiler session records, so device time can be read per op; a
    shared no-op context otherwise (one attribute read per op)."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(f"repro_torch::{name}")
    return _NO_RANGE


# ----------------------------------------------------------------------
# Grad mode (torch.no_grad / enable_grad)
# ----------------------------------------------------------------------

_tls = threading.local()


def is_grad_enabled() -> bool:
    """Whether ops currently record autograd tape nodes (thread-local)."""
    return getattr(_tls, "grad_enabled", True)


class _TraceState(threading.local):
    on = False      # a class default: no AttributeError on the hot path


_trace = _TraceState()


def is_tracing() -> bool:
    """Whether ops run inside the jit bridge (:class:`tracing`), where
    the reference's operands would be tracers: no tape node, no
    dispatch-cache entry (but seeding), no fusion queue, no allocator
    accounting.  (Dynamo never traces the port's Python: the bridge
    hands it an FX graph.)"""
    return _trace.on


class tracing:
    """Context manager: ops inside run as the jit bridge traces them
    (:func:`is_tracing`)."""

    def __enter__(self):
        self._prev = _trace.on
        _trace.on = True
        return self

    def __exit__(self, *exc):
        _trace.on = self._prev


class _GradMode:
    def __init__(self, enabled: bool):
        self._enabled = enabled
        self._prev: Optional[bool] = None

    def __enter__(self):
        self._prev = is_grad_enabled()
        _tls.grad_enabled = self._enabled
        return self

    def __exit__(self, *exc):
        _tls.grad_enabled = self._prev

    def __call__(self, fn):
        enabled = self._enabled

        def wrapped(*args, **kwargs):
            with _GradMode(enabled):
                return fn(*args, **kwargs)

        return wrapped


class no_grad(_GradMode):
    """Context manager / decorator disabling tape recording:
    ``with repro_torch.no_grad(): ...`` — inference runs allocate no
    graph."""

    def __init__(self):
        super().__init__(False)


class enable_grad(_GradMode):
    """Context manager / decorator re-enabling tape recording inside an
    outer ``no_grad`` scope."""

    def __init__(self):
        super().__init__(True)


# ----------------------------------------------------------------------
# Graph nodes
# ----------------------------------------------------------------------

class Node:
    """One recorded operation in the dynamic autograd graph."""

    __slots__ = (
        "name",
        "vjp_fn",
        "inputs",           # list[Optional[Tensor]] (leaves or intermediates)
        "saved_versions",   # list[(version_counter, snapshot)]
        "num_outputs",
        "output_grads",     # accumulated cotangents per output
        "pending",          # outputs not yet seen during backward
        "metadata",
    )

    def __init__(self, name: str, vjp_fn: Callable, inputs: Sequence[Any],
                 num_outputs: int = 1):
        self.name = name
        self.vjp_fn = vjp_fn
        self.inputs = list(inputs)
        self.saved_versions: List[Tuple[Any, int]] = []
        self.num_outputs = num_outputs
        self.output_grads: List[Optional[torch.Tensor]] = [None] * num_outputs
        self.pending = 0
        self.metadata: Dict[str, Any] = {}

    def save_version(self, tensor) -> None:
        self.saved_versions.append((tensor._version, tensor._version.value))

    def check_versions(self) -> None:
        for counter, snapshot in self.saved_versions:
            if counter.value != snapshot:
                raise RuntimeError(
                    f"one of the variables needed for gradient computation "
                    f"has been modified by an inplace operation (op "
                    f"{self.name}: saved version {snapshot}, current "
                    f"{counter.value})."
                )

    def release(self) -> None:
        """Drop the closure so saved activations are freed immediately."""
        self.vjp_fn = None  # type: ignore[assignment]
        self.inputs = []
        self.output_grads = [None] * self.num_outputs

    def __repr__(self):
        return f"<Node {self.name}>"


class VersionCounter:
    """Shared mutation counter (one per storage, shared by views)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def bump(self) -> None:
        self.value += 1


# ----------------------------------------------------------------------
# Backward engine
# ----------------------------------------------------------------------

def _accumulate(existing, update):
    if existing is None:
        return update
    return existing + update


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def backward(tensors, grads=None, retain_graph: bool = False) -> None:
    """Run reverse-mode AD from ``tensors`` back to all leaves.

    Multi-source capable (``autograd.backward([l1, l2])``), matching
    ``torch.autograd.backward``.
    """
    from .tensor import Tensor  # circular-safe

    if isinstance(tensors, Tensor):
        tensors = [tensors]
    if grads is None:
        grads = [None] * len(tensors)
    elif isinstance(grads, Tensor) or grads is Ellipsis:
        grads = [grads]

    # backward is a materialization point: flush pending fusion chains so
    # every root has its grad_fn recorded before the graph walk
    for t in tensors:
        t._data  # noqa: B018  (property read flushes)

    # Seed cotangents
    roots: List[Tuple[Node, int, torch.Tensor]] = []
    for t, g in zip(tensors, grads):
        if g is None:
            if t.shape != ():
                raise RuntimeError(
                    "grad can be implicitly created only for scalar outputs"
                )
            g_data = torch.ones((), dtype=t.dtype, device=t._d.device)
        else:
            g_data = g.data if isinstance(g, Tensor) else \
                torch.as_tensor(g, device=t._d.device)
        if t.grad_fn is None:
            if t.requires_grad:
                t._accumulate_grad(g_data)
            continue
        roots.append((t.grad_fn, t._output_index, g_data))

    if not roots:
        return

    # 1) Count in-graph dependencies of every node (how many cotangent
    #    contributions it will receive) with a forward pass over the graph.
    dependencies: Dict[Node, int] = {}
    seen = set()
    stack = [node for node, _, _ in roots]
    topo_nodes: List[Node] = []
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        topo_nodes.append(node)
        for inp in node.inputs:
            if inp is not None and inp.grad_fn is not None:
                dependencies[inp.grad_fn] = dependencies.get(inp.grad_fn, 0) + 1
                stack.append(inp.grad_fn)

    # 2) Ready-queue execution: a node runs once all its consumers have
    #    delivered cotangents (Kahn's algorithm over the reversed graph).
    ready: deque[Node] = deque()
    outstanding: Dict[Node, int] = dict(dependencies)

    for node, idx, g in roots:
        node.output_grads[idx] = _accumulate(node.output_grads[idx], g)
        if outstanding.get(node, 0) == 0 and not node.metadata.get("_queued"):
            node.metadata["_queued"] = True
            ready.append(node)

    executed = set()
    while ready:
        node = ready.popleft()
        if id(node) in executed:
            continue
        executed.add(id(node))
        node.metadata.pop("_queued", None)

        node.check_versions()
        if node.vjp_fn is None:
            raise RuntimeError(
                f"Trying to backward through the graph a second time (node "
                f"{node.name}); specify retain_graph=True if you need to."
            )

        # Fill missing output cotangents with zeros of the right shape:
        # the vjp takes full cotangents.
        avals = node.metadata["out_avals"]
        out_grads = node.output_grads
        if node.num_outputs == 1:
            cotangent = out_grads[0]
            if cotangent is None:
                cotangent = _zeros(*avals[0])
        else:
            cotangent = tuple(
                g if g is not None else _zeros(*aval)
                for g, aval in zip(out_grads, avals))

        with op_range(node.name + ".bwd"):
            input_grads = node.vjp_fn(cotangent)
        if not isinstance(input_grads, (tuple, list)):
            input_grads = (input_grads,)
        # cotangents are consumed: reset so a retained graph starts clean
        node.output_grads = [None] * node.num_outputs

        for inp, g in zip(node.inputs, input_grads):
            if inp is None or g is None:
                continue
            if inp.grad_fn is not None:
                producer = inp.grad_fn
                idx = inp._output_index
                producer.output_grads[idx] = _accumulate(
                    producer.output_grads[idx], g
                )
                outstanding[producer] = outstanding.get(producer, 1) - 1
                if outstanding[producer] <= 0 and not producer.metadata.get(
                    "_queued"
                ):
                    producer.metadata["_queued"] = True
                    ready.append(producer)
            elif inp.requires_grad:
                inp._accumulate_grad(g)

        if not retain_graph:
            node.release()

    # Nodes never reached (e.g. zero-fanout branches) still release.
    if not retain_graph:
        for node in topo_nodes:
            if id(node) not in executed:
                node.release()


def grad(outputs, inputs, grad_outputs=None, retain_graph: bool = False,
         allow_unused: bool = False):
    """``torch.autograd.grad`` analogue: returns grads w.r.t. ``inputs``
    without mutating ``.grad`` on other leaves."""
    from .tensor import Tensor

    single = isinstance(inputs, Tensor)
    if single:
        inputs = [inputs]
    stash = [(t, t.grad) for t in inputs]
    for t in inputs:
        t.grad = None
    backward(outputs, grad_outputs, retain_graph=retain_graph)
    results = []
    for t, old in stash:
        g = t.grad
        if g is None and not allow_unused:
            raise RuntimeError(
                "One of the differentiated Tensors appears to not have been "
                "used in the graph. Set allow_unused=True if this is the "
                "desired behavior."
            )
        results.append(g)
        t.grad = old
    return results[0] if single else tuple(results)


# ----------------------------------------------------------------------
# torch.autograd.Function analogue (paper §4.2 extensibility)
# ----------------------------------------------------------------------

class FunctionCtx:
    def __init__(self):
        self.saved_tensors: Tuple[Any, ...] = ()
        self._saved_versions: List[Tuple[Any, int]] = []

    def save_for_backward(self, *tensors) -> None:
        self.saved_tensors = tensors
        self._saved_versions = [
            (t._version, t._version.value)
            for t in tensors
            if hasattr(t, "_version")
        ]


class Function:
    """Subclass with ``forward(ctx, ...)`` and ``backward(ctx, *grads)`` to
    define a custom differentiable op, exactly as in torch.
    """

    @staticmethod
    def forward(ctx: FunctionCtx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx: FunctionCtx, *grad_outputs):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        from .tensor import Tensor, _wrap_outputs

        ctx = FunctionCtx()
        with no_grad():
            raw = cls.forward(ctx, *args, **kwargs)

        tensor_inputs = [a if isinstance(a, Tensor) else None for a in args]
        needs_grad = is_grad_enabled() and not is_tracing() and any(
            t is not None and (t.requires_grad or t.grad_fn is not None)
            for t in tensor_inputs
        )
        outputs = raw if isinstance(raw, tuple) else (raw,)

        if not needs_grad:
            return raw

        def vjp_fn(cotangent):
            for counter, snap in ctx._saved_versions:
                if counter.value != snap:
                    raise RuntimeError(
                        f"saved tensor modified by an inplace operation in "
                        f"custom Function {cls.__name__}"
                    )
            cots = cotangent if isinstance(cotangent, tuple) else (cotangent,)
            cots = tuple(
                c.data if isinstance(c, Tensor) else c for c in cots
            )
            with no_grad():
                grads = cls.backward(ctx, *[
                    Tensor(c) if c is not None else None for c in cots
                ])
            if not isinstance(grads, tuple):
                grads = (grads,)
            return tuple(
                g.data if isinstance(g, Tensor) else g for g in grads
            )

        node = Node(cls.__name__, vjp_fn, tensor_inputs,
                    num_outputs=len(outputs))
        node.metadata["out_avals"] = [
            (o.shape, o.dtype, o._d.device) for o in outputs
        ]
        return _wrap_outputs(tuple(o.data for o in outputs)
                             if isinstance(raw, tuple) else raw.data, node)
