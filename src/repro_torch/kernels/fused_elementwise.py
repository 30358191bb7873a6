"""Kernel B9: a fusion-queue chain as ONE generated Triton kernel.

Replaces ``repro/kernels/ops.py::fused_elementwise`` (the general form,
``pallas_call`` at ``ops.py:323``), which the reference's fusion queue
lowers every flushed chain to (``core/fuse.py:436-439``,
``make_fused_elementwise``, ``ops.py:354``).

What it computes.  A :class:`FusedChain` is the descriptor
``core.fuse.flush_tensor`` builds: ``(name, static, slots)`` per step,
where a slot reads an external input (``("e", i)``) or an earlier step
(``("t", j)``), plus each step's plain torch function and output dtype.
One pass over the output's elements computes every step and stores each
one: every pending tensor is materialized, intermediates included, as
the reference's multi-output kernel does.

Bound.  By bytes: each input is read once and each step output written
once; an H100 moves 3.35 TB/s, and the chains of the eager runtime do a
few operations per element.  So the kernel is one flat streaming pass
with no reuse (the TPU kernel's ``(rows, 128)`` lane-major view, sublane
rounding and padded tail do not carry over): one tile of ``BLOCK``
consecutive elements a program at ``NUM_WARPS`` warps, each thread
moving one 16-byte piece of each fp32 operand, with 64-bit offsets and
every access masked against ``n``.  On an H100 a persistent grid that
walked the tiles in turn ran 5% slower, and 32-bit offsets with unmasked
whole tiles moved the relu row's device time by 0.3% (PERF.md §6), so
neither is kept.
The host's share of a call is kept small instead: a :class:`ChainKernel`
keeps a plan per operand signature (shapes, strides, dtypes, devices),
so a repeated call derives no broadcast shape, layout or module again,
and it enters a device scope only when the current device is another.

Design.
  * Codegen.  :data:`EMITTERS` maps every name of the queue's
    ``ELEMENTWISE_OPS`` (32) to a Triton expression of ``(name,
    static)``; statics become literals written with ``repr`` so they
    round-trip exactly.  A name without an emitter raises; the chain is
    never run as torch ops on the card instead.  Each step computes in
    fp32 when its output is floating (PyTorch's ``opmath`` for bf16 and
    fp16) or in its own integer type, and is cast to its dtype before a
    later step reads it, so a bf16 chain rounds where eager execution
    rounds.  Transcendentals come from libdevice and division is
    ``div_rn``, as PyTorch's CUDA kernels compute them (no fast math).
  * Operands.  An operand of the output's shape is read flat; a 0-d (or
    one-element) operand is loaded once per program; any other broadcast,
    and any non-contiguous view, is read through its strides (at most 4
    collapsed dims); nothing is copied.  Bool operands and outputs travel
    as bytes.  Outputs are allocated contiguous by the wrapper.
  * Loading.  ``@triton.jit`` reads its function's source with
    ``inspect``, so source made with ``exec`` cannot be compiled: each
    generated module is written to ``build/repro_torch/fused/<hash>.py``
    and imported with ``importlib``, cached by the chain's descriptor,
    its dtypes and the operand kinds, not by shape (``n``, the sizes and
    the strides are runtime arguments).  Triton is imported only there.
  * Launches are counted by ``launch_counts()["fused_elementwise"]``.

:func:`fused_elementwise_plain` beside it replays the chain's torch ops
in order (the reference's ``fused_fn``).  :func:`fused_elementwise`
takes it for CPU tensors; on CUDA tensors it launches the kernel or
raises.  The chain's backward is ``torch.func.vjp`` of the plain version
(``core.fuse``), as the reference differentiates ``fused_fn``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import math
import os
import sys
import threading
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch

from ._build import BUILD_ROOT, LaunchCounter, launch_op

fused_counter = LaunchCounter("fused_elementwise")

BLOCK = 1024            # elements a program
NUM_WARPS = 8
MAX_DIMS = 4            # collapsed dims a strided operand may span


class FusedChain(NamedTuple):
    """``steps``: ``((name, static, slots), ...)``; ``fns``: each step's
    torch function; ``dtypes``: each step's output dtype."""
    steps: tuple
    fns: tuple
    dtypes: tuple


def fused_elementwise_plain(chain: FusedChain, *xs: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
    """The chain's torch ops replayed in order; returns every step's
    output."""
    tmp: List[torch.Tensor] = []
    for fn, (_, _, slots) in zip(chain.fns, chain.steps):
        tmp.append(fn(*[xs[i] if kind == "e" else tmp[i]
                        for kind, i in slots]))
    return tuple(tmp)


# ----------------------------------------------------------------------
# emitters: (name, static) -> Triton expression
# ----------------------------------------------------------------------

TL_TYPES = {
    torch.float32: "tl.float32", torch.bfloat16: "tl.bfloat16",
    torch.float16: "tl.float16", torch.int8: "tl.int8",
    torch.int16: "tl.int16", torch.int32: "tl.int32",
    torch.int64: "tl.int64", torch.uint8: "tl.uint8",
    torch.bool: "tl.int1",
}
F32 = "tl.float32"


def compute_type(dtype: torch.dtype) -> str:
    """The type a step computes in: fp32 for a floating output (fp16 and
    bf16 included, as PyTorch's ``opmath``), int32 for a bool output (the
    result is then compared with 0), else the output's own type."""
    if dtype not in TL_TYPES:
        raise NotImplementedError(
            f"fused_elementwise: no Triton type for {dtype}")
    if dtype.is_floating_point:
        return F32
    if dtype == torch.bool:
        return "tl.int32"
    return TL_TYPES[dtype]


def _lit(v, ct: str) -> str:
    """A static scalar as a Triton literal of compute type ``ct``."""
    if ct == F32:
        v = float(v)
        if math.isnan(v):
            return "_NAN"
        if math.isinf(v):
            return "_INF" if v > 0 else "_NINF"
        return repr(v)
    if isinstance(v, float) and not v.is_integer():
        raise NotImplementedError(
            f"fused_elementwise: non-integer static {v!r} in an {ct} step")
    return repr(int(v))


def _floating(ct: str) -> bool:
    return ct == F32


def _max(a, b, ct):
    return (f"tl.maximum({a}, {b}, propagate_nan=tl.PropagateNan.ALL)"
            if _floating(ct) else f"tl.maximum({a}, {b})")


def _min(a, b, ct):
    return (f"tl.minimum({a}, {b}, propagate_nan=tl.PropagateNan.ALL)"
            if _floating(ct) else f"tl.minimum({a}, {b})")


def _e_clamp(a, static, ct, od):
    lo, hi = static
    out = a
    if lo is not None:
        out = f"tl.where({out} < {_lit(lo, ct)}, {_lit(lo, ct)}, {out})"
    if hi is not None:
        out = f"tl.where({out} > {_lit(hi, ct)}, {_lit(hi, ct)}, {out})"
    return out


def _e_gelu(a, static, ct, od):
    if static[0] == "tanh":
        # kBeta = sqrt(2) * (2 / sqrt(pi)) * 0.5, kKappa = 0.044715
        beta = math.sqrt(2.0) * (2.0 / math.sqrt(math.pi)) * 0.5
        return (f"0.5 * {a} * (1.0 + libdevice.tanh({beta!r} * ({a} + "
                f"0.044715 * ({a} * {a} * {a}))))")
    return (f"{a} * 0.5 * (1.0 + libdevice.erf({a} * "
            f"{math.sqrt(0.5)!r}))")


def _e_relu(a, static, ct, od):
    if _floating(ct):   # NaN stays NaN, as torch.relu keeps it
        return f"tl.where(({a} > 0.0) | ({a} != {a}), {a}, 0.0)"
    return f"tl.where({a} > 0, {a}, 0)"


def _e_dropout(a, m, static, ct, od):
    # ``v * m * scale``: the product rounds to the output dtype before
    # the scale multiplies it, as the two eager ops round
    scale = 1.0 / (1.0 - static[0])
    return f"({a} * {m}).to({od}).to({ct}) * {_lit(scale, ct)}"


def _unary(fn: Callable[[str], str]):
    return lambda a, static, ct, od: fn(a)


def _binary(fn: Callable[[str, str, str], str]):
    return lambda a, b, static, ct, od: fn(a, b, ct)


# name -> (argument conversion, expression builder).  The conversion
# says how each argument reaches the expression: "ct" (cast to the step's
# compute type), "bool" (as an int1 condition) or "raw" (as stored).
EMITTERS: Dict[str, Tuple[Tuple[str, ...], Callable]] = {
    "add": (("ct", "ct"), _binary(lambda a, b, ct: f"{a} + {b}")),
    "sub": (("ct", "ct"), _binary(lambda a, b, ct: f"{a} - {b}")),
    "mul": (("ct", "ct"), _binary(lambda a, b, ct: f"{a} * {b}")),
    "div": (("ct", "ct"), _binary(lambda a, b, ct: f"tl.div_rn({a}, {b})")),
    "pow": (("ct", "ct"), _binary(
        lambda a, b, ct: f"libdevice.pow({a}, {b})" if _floating(ct)
        else f"_ipow({a}, {b})")),
    "mod": (("ct", "ct"), _binary(lambda a, b, ct: f"_floor_mod({a}, {b})")),
    "maximum": (("ct", "ct"), _binary(_max)),
    "minimum": (("ct", "ct"), _binary(_min)),
    "neg": (("ct",), _unary(lambda a: f"-{a}")),
    "abs": (("ct",), _unary(lambda a: f"tl.abs({a})")),
    "clone": (("ct",), _unary(lambda a: a)),
    "astype": (("raw",), None),      # handled in _step_expr
    "exp": (("ct",), _unary(lambda a: f"libdevice.exp({a})")),
    "log": (("ct",), _unary(lambda a: f"libdevice.log({a})")),
    "sqrt": (("ct",), _unary(lambda a: f"libdevice.sqrt({a})")),
    "rsqrt": (("ct",), _unary(lambda a: f"libdevice.rsqrt({a})")),
    "sin": (("ct",), _unary(lambda a: f"libdevice.sin({a})")),
    "cos": (("ct",), _unary(lambda a: f"libdevice.cos({a})")),
    "tanh": (("ct",), _unary(lambda a: f"libdevice.tanh({a})")),
    "sigmoid": (("ct",), _unary(
        lambda a: f"tl.div_rn(1.0, 1.0 + libdevice.exp(-{a}))")),
    "relu": (("ct",), _e_relu),
    "erf": (("ct",), _unary(lambda a: f"libdevice.erf({a})")),
    "clamp": (("ct",), _e_clamp),
    "where": (("bool", "ct", "ct"),
              lambda c, a, b, static, ct, od: f"tl.where({c}, {a}, {b})"),
    "masked_fill": (("ct", "bool"),
                    lambda a, m, static, ct, od:
                    f"tl.where({m}, {_lit(static[0], ct)}, {a})"),
    "relu6": (("ct",), _unary(
        lambda a: f"tl.where({a} <= 0.0, 0.0, tl.where({a} >= 6.0, 6.0, "
                  f"{a}))")),
    "gelu": (("ct",), _e_gelu),
    "silu": (("ct",), _unary(
        lambda a: f"tl.div_rn({a}, 1.0 + libdevice.exp(-{a}))")),
    "softplus": (("ct",), _unary(
        lambda a: f"tl.where({a} > 20.0, {a}, "
                  f"libdevice.log1p(libdevice.exp({a})))")),
    "hardswish": (("ct",), _unary(
        lambda a: f"{a} * tl.minimum(tl.maximum({a} + 3.0, 0.0), 6.0) * "
                  f"{1.0 / 6.0!r}")),
    "leaky_relu": (("ct",), lambda a, static, ct, od:
                   f"tl.where({a} > 0.0, {a}, {a} * {_lit(static[0], ct)})"),
    "elu": (("ct",), lambda a, static, ct, od:
            f"tl.where({a} <= 0.0, libdevice.expm1({a}) * "
            f"{_lit(static[0], ct)}, {a})"),
    "dropout": (("ct", "ct"), _e_dropout),
}


def _convert(var: str, dtype: torch.dtype, how: str, ct: str) -> str:
    if how == "raw":
        return var
    if how == "bool":
        return var if dtype == torch.bool else f"({var} != 0)"
    if dtype == torch.bool or TL_TYPES[dtype] != ct:
        return f"{var}.to({ct})"
    return var


def _step_expr(name, static, args, arg_dtypes, out_dtype) -> str:
    """The Triton expression of one step, already of ``out_dtype``'s
    storage type (int1 for bool)."""
    if name not in EMITTERS:
        raise NotImplementedError(
            f"fused_elementwise: no Triton emitter for op {name!r}")
    conv, build = EMITTERS[name]
    if name == "astype":
        (a,) = args
        if out_dtype == torch.bool:
            return f"({a} != 0)"
        return f"{a}.to({TL_TYPES[out_dtype]})"
    ct = compute_type(out_dtype)
    od = TL_TYPES[out_dtype]
    if len(conv) != len(args):
        raise ValueError(f"fused_elementwise: {name} takes {len(conv)} "
                         f"operands, got {len(args)}")
    xs = [_convert(a, d, how, ct) for a, d, how in zip(args, arg_dtypes,
                                                       conv)]
    expr = build(*xs, static, ct, od)
    if out_dtype == torch.bool:
        return f"(({expr}) != 0)"
    return f"({expr}).to({od})"


# ----------------------------------------------------------------------
# operands and source generation
# ----------------------------------------------------------------------

FLAT, SCALAR, STRIDED = "f", "s", "b"


def operand_layout(xs: Sequence[torch.Tensor], shape: Tuple[int, ...]
                   ) -> Tuple[Tuple[str, ...], List[int], List[List[int]]]:
    """Each operand's kind (flat, scalar or strided), and for the strided
    ones the collapsed sizes (padded to ``MAX_DIMS``) and their strides
    over the output shape (0 on broadcast dims)."""
    kinds, strided = [], []
    for x in xs:
        if x.numel() == 1:
            kinds.append(SCALAR)
        elif tuple(x.shape) == tuple(shape) and x.is_contiguous():
            kinds.append(FLAT)
        else:
            kinds.append(STRIDED)
            strided.append(list(x.expand(shape).stride()))
    if not strided:
        return tuple(kinds), [], []
    dims = [d for d in range(len(shape)) if shape[d] != 1]
    sizes: List[int] = []
    strides: List[List[int]] = [[] for _ in strided]
    for d in dims:
        if sizes and all(st[-1] == full[d] * shape[d]
                         for st, full in zip(strides, strided)):
            sizes[-1] *= shape[d]
            for st, full in zip(strides, strided):
                st[-1] = full[d]
        else:
            sizes.append(shape[d])
            for st, full in zip(strides, strided):
                st.append(full[d])
    if len(sizes) > MAX_DIMS:
        raise NotImplementedError(
            f"fused_elementwise: a broadcast over {len(sizes)} dims after "
            f"collapsing (at most {MAX_DIMS}); shape {tuple(shape)}")
    pad = MAX_DIMS - len(sizes)
    return (tuple(kinds), [1] * pad + sizes,
            [[0] * pad + st for st in strides])


# The index of each of the MAX_DIMS collapsed dims from the flat offset
# ``offs``, over the sizes ``S1``-``S3`` (``S0`` is implied); a strided
# operand ``k`` reads element ``sum(i{d} * st{k}_{d})``.
INDEX_LINES = ("i3 = offs % S3", "r = offs // S3", "i2 = r % S2",
               "r = r // S2", "i1 = r % S1", "i0 = r // S1")


_HEADER = '''"""Generated by repro_torch.kernels.fused_elementwise; do not edit."""
import triton
import triton.language as tl
try:  # Triton 3.x keeps libdevice here ...
    from triton.language.extra import libdevice
except ImportError:  # ... and, in its first releases, one level down
    from triton.language.extra.cuda import libdevice

_INF = tl.constexpr(float("inf"))
_NINF = tl.constexpr(float("-inf"))
_NAN = tl.constexpr(float("nan"))


@triton.jit
def _floor_mod(a, b):
    # torch.remainder / jnp.mod: the sign of the divisor (Triton's %
    # truncates)
    r = a % b
    return tl.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


@triton.jit
def _ipow(a, b):
    # integer power by squaring; a negative exponent gives 0 unless the
    # base is 1 or -1, as torch.pow does for integers
    r = a * 0 + 1
    base = a
    e = b
    for _ in tl.static_range(32):
        r = tl.where((e & 1) != 0, r * base, r)
        base = base * base
        e = e >> 1
    neg = tl.where(a == 1, 1, tl.where(a == -1, 1 - 2 * (b & 1), 0))
    return tl.where(b < 0, neg.to(r.dtype), r)

'''


def generate_source(chain: FusedChain, ext_dtypes: Sequence[torch.dtype],
                    kinds: Sequence[str]) -> str:
    """The Python source of the Triton module for ``chain`` over inputs
    of ``ext_dtypes`` and ``kinds``: a ``fused_chain_kernel`` and its
    ``launch(ins, outs, n, geometry, programs)`` (``geometry``'s
    arguments, ``programs`` = ceil(n / ``BLOCK``))."""
    n_in, n_out = len(ext_dtypes), len(chain.steps)
    strided = [i for i in range(n_in) if kinds[i] == STRIDED]
    params = [f"e{i}" for i in range(n_in)] + [f"o{j}" for j in
                                               range(n_out)] + ["n"]
    if strided:
        params += ["S1", "S2", "S3"]
        params += [f"st{i}_{d}" for i in strided for d in range(MAX_DIMS)]
    body = ["    pid = tl.program_id(0)",
            "    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)",
            "    mask = offs < n"]
    if strided:
        body += ["    " + line for line in INDEX_LINES]
    for i, (dt, kind) in enumerate(zip(ext_dtypes, kinds)):
        if kind == SCALAR:
            load = f"tl.load(e{i})"
        elif kind == FLAT:
            load = f"tl.load(e{i} + offs, mask=mask, other=1)"
        else:
            idx = " + ".join(f"i{d} * st{i}_{d}" for d in range(MAX_DIMS))
            load = f"tl.load(e{i} + ({idx}), mask=mask, other=1)"
        if dt == torch.bool:
            load = f"({load} != 0)"
        body.append(f"    x{i} = {load}")
    for j, ((name, static, slots), out_dt) in enumerate(
            zip(chain.steps, chain.dtypes)):
        args, arg_dts = [], []
        for kind, k in slots:
            args.append(f"x{k}" if kind == "e" else f"t{k}")
            arg_dts.append(ext_dtypes[k] if kind == "e" else chain.dtypes[k])
        expr = _step_expr(name, static, args, arg_dts, out_dt)
        body.append(f"    t{j} = {expr}")
        val = f"t{j}.to(tl.uint8)" if out_dt == torch.bool else f"t{j}"
        body.append(f"    tl.store(o{j} + offs, {val}, mask=mask)")
    sig = ", ".join(params + ["BLOCK: tl.constexpr"])
    return (_HEADER
            + "@triton.jit\n"
            + f"def fused_chain_kernel({sig}):\n"
            + "\n".join(body) + "\n\n\n"
            + "def launch(ins, outs, n, geometry, programs):\n"
            + "    fused_chain_kernel[(programs,)](*ins, *outs, n, "
            + f"*geometry, BLOCK={BLOCK}, num_warps={NUM_WARPS})\n")


def geometry(sizes: Sequence[int], strides: Sequence[Sequence[int]]
             ) -> List[int]:
    """The kernel's geometry arguments of an ``operand_layout``: ``S1``-
    ``S3``, then each strided operand's strides (none without one)."""
    return ([*sizes[1:], *[s for st in strides for s in st]]
            if strides else [])


FUSED_ROOT = BUILD_ROOT / "fused"
_lock = threading.Lock()
_modules: Dict[tuple, object] = {}


def _load(source: str):
    """Write ``source`` to ``build/repro_torch/fused/<hash>.py`` and
    import it (``@triton.jit`` needs a file it can read the source of)."""
    digest = hashlib.sha256(source.encode()).hexdigest()[:20]
    name = f"repro_torch_fused_{digest}"
    path = FUSED_ROOT / f"{name}.py"
    if not path.exists():
        FUSED_ROOT.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{name}.{os.getpid()}.py")
        tmp.write_text(source)
        os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def kernel_module(chain: FusedChain, ext_dtypes: Sequence[torch.dtype],
                  kinds: Sequence[str]):
    """The imported Triton module of ``chain`` (generated at first use;
    cached by descriptor, dtypes and operand kinds, not by shape)."""
    key = (chain.steps, chain.dtypes, tuple(ext_dtypes), tuple(kinds))
    with _lock:
        mod = _modules.get(key)
        if mod is None:
            mod = _modules[key] = _load(
                generate_source(chain, ext_dtypes, kinds))
        return mod


class _Plan(NamedTuple):
    """What a call with one set of operand shapes, strides, dtypes and
    devices launches: the output shape, element count and device (index),
    the operands travelling as bytes, and the bound launcher."""
    shape: Tuple[int, ...]
    n: int
    device: torch.device
    index: int
    as_bytes: Tuple[bool, ...]
    launch: Callable


# every chain that reached a CUDA launch, by the key its operator takes
_chain_keys: Dict[FusedChain, int] = {}
_chains: List["ChainKernel"] = []


def _chain_key(kernel: "ChainKernel") -> int:
    """The integer key of ``kernel``'s chain: the static argument of the
    ``repro_torch::fused_elementwise`` operator (a chain holds Python
    functions, which an operator cannot take), so a graph traced by
    ``repro_torch.compile`` keeps the launch as one node."""
    with _lock:
        try:
            key = _chain_keys.get(kernel.chain)
        except TypeError:          # an unhashable static: a key of its own
            _chains.append(kernel)
            return len(_chains) - 1
        if key is None:
            key = _chain_keys[kernel.chain] = len(_chains)
            _chains.append(kernel)
        return key


class ChainKernel:
    """A chain's kernel wrapper: ``ChainKernel(chain)(*xs)`` is
    ``fused_elementwise(chain, *xs)``.  It keeps a :class:`_Plan` per
    signature of its operands (shapes, strides, dtypes, devices), so a
    repeated call derives no broadcast shape, layout or module again.
    The launch is the ``repro_torch::fused_elementwise`` operator over
    the chain's key (:func:`_chain_key`)."""

    def __init__(self, chain: FusedChain):
        self.chain = chain
        self.plans: Dict[tuple, _Plan] = {}
        self.key: int = -1

    def plan(self, xs: Sequence[torch.Tensor]) -> _Plan:
        dev = xs[0].device
        if dev.type != "cuda":
            raise ValueError(f"fused_elementwise: unsupported device {dev}")
        shape = tuple(torch.broadcast_shapes(*[x.shape for x in xs]))
        kinds, sizes, strides = operand_layout(xs, shape)
        n = math.prod(shape)
        mod = kernel_module(self.chain, [x.dtype for x in xs], kinds)
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        args = (n, geometry(sizes, strides), -(-n // BLOCK))
        return _Plan(shape, n, torch.device("cuda", index), index,
                     tuple(x.dtype == torch.bool for x in xs) +
                     tuple(dt == torch.bool for dt in self.chain.dtypes),
                     lambda ins, outs: mod.launch(ins, outs, *args))

    def __call__(self, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if not xs:
            raise ValueError("fused_elementwise: a chain needs an input")
        dev = xs[0].device
        if any(x.device != dev for x in xs):
            raise ValueError("fused_elementwise: all operands must be on "
                             "one device")
        if dev.type == "cpu":
            return fused_elementwise_plain(self.chain, *xs)
        if self.key < 0:
            self.key = _chain_key(self)
        return tuple(_fused_launch(self.key, list(xs)))

    def launch(self, xs: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, ...]:
        """The operator's body: every step's output, one kernel launch."""
        dev = xs[0].device
        sig = tuple((x.shape, x.stride(), x.dtype) for x in xs) + (dev,)
        plan = self.plans.get(sig)
        if plan is None:
            plan = self.plans[sig] = self.plan(xs)
        outs = tuple(torch.empty(plan.shape, dtype=dt, device=plan.device)
                     for dt in self.chain.dtypes)
        if plan.n:
            ops = [t.view(torch.uint8) if b else t
                   for t, b in zip([*xs, *outs], plan.as_bytes)]
            if torch.cuda.current_device() == plan.index:
                plan.launch(ops[:len(xs)], ops[len(xs):])
            else:
                with torch.cuda.device(plan.index):
                    plan.launch(ops[:len(xs)], ops[len(xs):])
            fused_counter.bump()
        return outs


@launch_op("fused_elementwise")
def _fused_launch(key: int, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The launch of the chain registered under ``key``, as one operator
    (its shape function below)."""
    return list(_chains[key].launch(xs))


@_fused_launch.register_fake
def _(key, xs):
    chain = _chains[key].chain
    shape = tuple(torch.broadcast_shapes(*[x.shape for x in xs]))
    return [torch.empty(shape, dtype=dt, device=xs[0].device)
            for dt in chain.dtypes]


def fused_elementwise(chain: FusedChain, *xs: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """Every step of ``chain`` over ``xs`` (broadcast to one shape), each
    returned as a contiguous tensor of its step's dtype.  CPU tensors
    take :func:`fused_elementwise_plain`; CUDA tensors launch the
    generated Triton kernel.  A caller that runs one chain repeatedly
    keeps its :class:`ChainKernel` (``make_fused_elementwise``)."""
    return ChainKernel(chain)(*xs)


def make_fused_elementwise(chain: FusedChain) -> "ChainKernel":
    """Dispatch-cache ``wrap`` hook: the forward of a flushed chain, kept
    with the cache entry, so a repeated flush reuses its plans."""
    return ChainKernel(chain)


def merge_chains(chains: Sequence[Tuple[FusedChain, Sequence[torch.Tensor]]]
                 ) -> Tuple[FusedChain, List[torch.Tensor]]:
    """One chain that computes every step of ``chains``, each over its
    own inputs (the inputs concatenated in order), so that one generated
    kernel checks many chains of one output shape at once."""
    steps, fns, dtypes, ext = [], [], [], []
    for chain, xs in chains:
        e0, t0 = len(ext), len(steps)
        for (name, static, slots), fn, dt in zip(*chain):
            steps.append((name, static, tuple(
                (k, i + (e0 if k == "e" else t0)) for k, i in slots)))
            fns.append(fn)
            dtypes.append(dt)
        ext += list(xs)
    return FusedChain(tuple(steps), tuple(fns), tuple(dtypes)), ext
