"""The fusion queue and kernel B9 (``repro_torch.core.fuse``,
``repro_torch.kernels.fused_elementwise``) against the JAX package.

On the CPU the port's ``fused_elementwise`` runs its plain version (the
chain's torch ops replayed); it is held against the reference's Pallas
``fused_elementwise`` in interpret mode (``tests/test_dispatch_cache.py``
calls it the same way) on the chains both fusion queues record from the
same program, op by op and for multi-output chains.  The generated
Triton source is checked without Triton: every op has an emitter, each
module parses, an unknown op raises.  Cases that launch the kernel need
the card and skip elsewhere.

Tolerances: fp32 1e-6 relative (1e-6 absolute near 0), one ulp of a
transcendental between XLA's and PyTorch's CPU math; bf16 one bf16 step
(1e-2 relative); int32 and bool exact.  Kernel against plain version on
the card: fp32 1e-5 (+ 1e-5 relative), bf16 1e-2 + 1e-2 |ref|, ints and
bools exact (``chip_smoke.FUSED_TOL``).
"""

import ast
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.nn.functional as JF
from repro.core import fuse as JFuse
from repro.kernels import ops as jops
import repro_torch as rt
import repro_torch.nn.functional as TF
from repro_torch.core import fuse as TFuse
from repro_torch.core.tensor_mod import dtype_name
from repro_torch.kernels import fused_elementwise as FE
from repro_torch.kernels import launch_counts, reset_launch_counts
from torch_port_helpers import cuda_device, jax_array, port_cpu, \
    port_tensor, requires_cuda  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cpu")

TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
CARD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}


def arr(seed, shape=(6, 10), kind="any", dtype="float32"):
    rng = np.random.default_rng(seed)
    if dtype == "bool" or kind == "bool":
        return rng.random(shape) < 0.5
    if dtype == "int32":
        if kind == "nonzero":
            return (rng.integers(1, 9, shape)
                    * rng.choice([-1, 1], shape)).astype(np.int32)
        return rng.integers(-9, 9, shape).astype(np.int32)
    if kind == "pos":
        return (rng.random(shape) * 2 + 0.25).astype(np.float32)
    if kind == "nonzero":
        return ((rng.random(shape) + 0.5)
                * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def both(a, dtype="float32"):
    dt = "bool" if a.dtype == np.bool_ else dtype
    return repro.Tensor(jax_array(a, dt)), rt.Tensor(port_tensor(a, dt))


def close(port, ref, dtype) -> None:
    ref = np.asarray(ref)
    dt = str(ref.dtype)
    assert dtype_name(port.dtype) == dt, (port.dtype, dt)
    if dt in TOL:
        np.testing.assert_allclose(
            port.float().numpy(), ref.astype(np.float32), **TOL[dt])
    else:
        np.testing.assert_array_equal(port.numpy(), ref)


# (op, fn(P, F, *tensors), input kinds, dtype) — every op of the fusion
# queue, through its public function
OPS = [
    ("add", lambda P, F, a, b: a + b, ("any", "any")),
    ("sub", lambda P, F, a, b: a - b, ("any", "any")),
    ("mul", lambda P, F, a, b: a * b, ("any", "any")),
    ("div", lambda P, F, a, b: a / b, ("any", "nonzero")),
    ("pow", lambda P, F, a, b: a ** b, ("pos", "any")),
    ("mod", lambda P, F, a, b: a % b, ("any", "nonzero")),
    ("neg", lambda P, F, a: -a, ("any",)),
    ("abs", lambda P, F, a: a.abs(), ("any",)),
    ("clone", lambda P, F, a: a.clone(), ("any",)),
    ("astype", lambda P, F, a: a.astype(
        jnp.bfloat16 if P is repro else torch.bfloat16), ("any",)),
    ("exp", lambda P, F, a: a.exp(), ("any",)),
    ("log", lambda P, F, a: a.log(), ("pos",)),
    ("sqrt", lambda P, F, a: a.sqrt(), ("pos",)),
    ("rsqrt", lambda P, F, a: a.rsqrt(), ("pos",)),
    ("sin", lambda P, F, a: a.sin(), ("any",)),
    ("cos", lambda P, F, a: a.cos(), ("any",)),
    ("tanh", lambda P, F, a: a.tanh(), ("any",)),
    ("sigmoid", lambda P, F, a: a.sigmoid(), ("any",)),
    ("relu", lambda P, F, a: a.relu(), ("any",)),
    ("erf", lambda P, F, a: a.erf(), ("any",)),
    ("clamp", lambda P, F, a: a.clamp(-0.5, 0.7), ("any",)),
    ("maximum", lambda P, F, a, b: P.maximum(a, b), ("any", "any")),
    ("minimum", lambda P, F, a, b: P.minimum(a, b), ("any", "any")),
    ("where", lambda P, F, c, a, b: P.where(c, a, b),
     ("bool", "any", "any")),
    ("masked_fill", lambda P, F, a, m: a.masked_fill(m, -2.5),
     ("any", "bool")),
    ("relu6", lambda P, F, a: F.relu6(a), ("any",)),
    ("gelu", lambda P, F, a: F.gelu(a), ("any",)),
    ("silu", lambda P, F, a: F.silu(a), ("any",)),
    ("softplus", lambda P, F, a: F.softplus(a), ("any",)),
    ("hardswish", lambda P, F, a: F.hardswish(a), ("any",)),
    ("leaky_relu", lambda P, F, a: F.leaky_relu(a, 0.3), ("any",)),
    ("elu", lambda P, F, a: F.elu(a, 0.7), ("any",)),
    ("dropout", lambda P, F, a: F.dropout(a, 0.25), ("any",)),
]
OP_NAMES = [o[0] for o in OPS]


def ref_chain(out):
    """The reference's recorded chain feeding pending ``out``, as its
    ``flush_tensor`` builds it (``core/fuse.py:399-427``): (fused_fn,
    external inputs)."""
    steps, ext, ids, slot_of = [], [], {}, {}

    def visit(x):
        if id(x) in slot_of:
            return slot_of[id(x)]
        p = x._pending
        slots = []
        for parent, snap in zip(p.parents, p.parent_snap):
            if parent._pending is not None:
                slots.append(("t", visit(parent)))
            else:
                if id(parent) not in ids:
                    ids[id(parent)] = len(ext)
                    ext.append(snap if snap is not None else parent._d)
                slots.append(("e", ids[id(parent)]))
        steps.append((p.fn, tuple(slots)))
        slot_of[id(x)] = len(steps) - 1
        return slot_of[id(x)]

    visit(out)

    def fused_fn(*xs):
        tmp = []
        for fn, slots in steps:
            tmp.append(fn(*[xs[i] if k == "e" else tmp[i]
                            for k, i in slots]))
        return tuple(tmp)

    return fused_fn, ext


def record_both(fn, arrays, dtype="float32"):
    """The chain each package's fusion queue records for ``fn`` on the
    same inputs: (reference fused_fn, its inputs, port chain, its
    inputs)."""
    pairs = [both(a, dtype) for a in arrays]
    with JFuse.fusion():
        jout = fn(repro, JF, *[p[0] for p in pairs])
        jfn, jext = ref_chain(jout)
    tchain, text = TFuse.capture_chain(
        lambda *ts: fn(rt, TF, *ts), *[p[1] for p in pairs])
    return jfn, jext, tchain, text


@pytest.mark.parametrize("name", OP_NAMES)
def test_plain_version_matches_interpret_mode_pallas_per_op(name):
    """Each op alone, same-shape operands: the port's plain
    ``fused_elementwise`` against the reference's Pallas kernel run in
    interpret mode on the reference's recorded chain."""
    _, fn, kinds = next(o for o in OPS if o[0] == name)
    arrays = [arr(40 + i, kind=k) for i, k in enumerate(kinds)]
    jfn, jext, tchain, text = record_both(fn, arrays)
    assert [s[0] for s in tchain.steps] == [name]
    ref = jops.fused_elementwise(jfn, *jext, interpret=True)
    out = FE.fused_elementwise(tchain, *text)
    assert len(out) == len(ref) == 1
    close(out[0], ref[0], "float32")


MULTI = [
    ("add_relu", lambda P, F, a, b: F.relu(a + b), 2, "float32"),
    ("bf16_chain", lambda P, F, a, b: F.gelu((a * b).tanh()) - a, 2,
     "bfloat16"),
    ("int_chain", lambda P, F, a, b: P.maximum(a * b, a) % 5 + 1, 2,
     "int32"),
    ("mixed", lambda P, F, a, b: P.where(a > 0.0, (a * b).exp(),
                                         b.astype(
                                             jnp.int32 if P is repro
                                             else torch.int32) * 1.5),
     2, "float32"),
    ("shared", lambda P, F, a, b: (a * 2.0 + b) * (a * 2.0).sigmoid(), 2,
     "float32"),
]


@pytest.mark.parametrize("name", [m[0] for m in MULTI])
def test_multi_output_chain_matches_interpret_mode_pallas(name):
    """Multi-step chains materialize every step: all outputs, in step
    order, equal the reference kernel's (values and dtypes)."""
    _, fn, n, dtype = next(m for m in MULTI if m[0] == name)
    arrays = [arr(60 + i, dtype=dtype) for i in range(n)]
    jfn, jext, tchain, text = record_both(fn, arrays, dtype)
    ref = jops.fused_elementwise(jfn, *jext, interpret=True)
    out = FE.fused_elementwise(tchain, *text)
    assert len(out) == len(ref) == len(tchain.steps) > 1
    for o, r in zip(out, ref):
        close(o, r, dtype)


PROGRAMS = {
    "mlp_act": lambda P, F, x, w: (F.gelu(x @ w) * 2.0 + 1.0).tanh().sum(),
    "chain_and_reduction": lambda P, F, x, w: (
        ((x * 3.0).exp() + x).sum() + (w.relu() * w).mean()),
    "bottleneck_tail": lambda P, F, x, w: (
        F.relu((x * w.sum()) + x.sigmoid())).sum(),
    "shared_intermediate": lambda P, F, x, w: (
        (lambda m: m.exp().sum() + m.sum())(x * w[1] * 3.0)),
    "activations": lambda P, F, x, w: (
        F.silu(x) + F.elu(x, 0.5) + F.softplus(x) + F.hardswish(x)
        + F.leaky_relu(x, 0.1) + F.relu6(x * w[0])).sum(),
}


def run_program(P, F, fuse_mod, name, fused):
    """Value, grads, fused flushes and fused node names of one program."""
    x = P.tensor(arr(70, (4, 8)), requires_grad=True)
    w = P.tensor(arr(71, (8, 8)), requires_grad=True)
    P.reset_dispatch_cache()
    names = []
    with fuse_mod.fusion(fused):
        out = PROGRAMS[name](P, F, x, w)
        stack = [out.grad_fn]
        seen = set()
        while stack:
            node = stack.pop()
            if node is None or id(node) in seen:
                continue
            seen.add(id(node))
            if node.name.startswith("fused["):
                names.append(node.name)
            stack += [i.grad_fn for i in node.inputs if i is not None]
        out.backward()
    per_op = P.dispatch_cache_stats()["per_op"].get("__fused__", {})
    flushes = per_op.get("hits", 0) + per_op.get("misses", 0)
    return (float(out.item()), x.grad.numpy(), w.grad.numpy(), flushes,
            sorted(names))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_fusion_on_equals_off_and_matches_reference(name):
    """In both packages fusion on equals fusion off (value and grads);
    the port's fused node names and number of fused flushes equal the
    reference's (no pending value is broadcast in these programs)."""
    runs = {}
    for P, F, fm in ((repro, JF, JFuse), (rt, TF, TFuse)):
        for fused in (False, True):
            runs[(P.__name__, fused)] = run_program(P, F, fm, name, fused)
    for pkg in ("repro", "repro_torch"):
        off, on = runs[(pkg, False)], runs[(pkg, True)]
        np.testing.assert_allclose(on[0], off[0], rtol=1e-6)
        for a, b in zip(on[1:3], off[1:3]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        assert off[3] == 0
    j, t = runs[("repro", True)], runs[("repro_torch", True)]
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
    for a, b in zip(t[1:3], j[1:3]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert t[3] == j[3] > 0
    assert t[4] == j[4]


def test_pending_parent_of_another_shape_is_flushed_first():
    """The port's one rule that differs from the reference: a pending
    parent broadcast into a larger op is flushed on its own, so each
    chain has one shape.  Values are the reference's; the port flushes
    one chain more."""
    a, b = arr(80, (4, 1)), arr(81, (4, 5))
    flushes, values = {}, {}
    for P, fm in ((repro, JFuse), (rt, TFuse)):
        P.reset_dispatch_cache()
        with fm.fusion():
            y = P.tensor(a) * 2.0
            z = (y + P.tensor(b)).exp()
            values[P.__name__] = z.numpy()
        per_op = P.dispatch_cache_stats()["per_op"]["__fused__"]
        flushes[P.__name__] = per_op["hits"] + per_op["misses"]
    np.testing.assert_allclose(values["repro_torch"], values["repro"],
                               rtol=1e-6)
    assert flushes == {"repro": 1, "repro_torch": 2}


def test_chain_with_scalar_and_broadcast_operands_is_one_chain():
    """0-d and broadcast *external* inputs stay in the chain (the
    kernel reads them through strides); only pending parents of another
    shape split it."""
    x = rt.tensor(arr(82, (4, 5)))
    row = rt.tensor(arr(83, (5,)))
    chain, ext = TFuse.capture_chain(
        lambda x, r: ((x * 2.0 + r).tanh() - 1.0).relu(), x, row)
    assert [s[0] for s in chain.steps] == ["mul", "add", "tanh", "sub",
                                           "relu"]
    assert sorted(tuple(e.shape) for e in ext) == [(), (), (4, 5), (5,)]


# ----------------------------------------------------------------------
# code generation (no Triton needed)
# ----------------------------------------------------------------------

def test_every_queue_op_has_an_emitter():
    assert set(FE.EMITTERS) == set(TFuse.ELEMENTWISE_OPS)
    assert len(FE.EMITTERS) == 33


CODEGEN_DTYPES = ("float32", "bfloat16", "int32", "bool")


@pytest.mark.parametrize("name", OP_NAMES)
def test_generated_source_of_each_op_parses(name):
    """Each op's chain, in every dtype its public function takes here,
    with flat, 0-d and broadcast operands, generates a module that
    parses and defines the kernel and its launcher."""
    _, fn, kinds = next(o for o in OPS if o[0] == name)
    made = 0
    for dtype in CODEGEN_DTYPES:
        ts = []
        for i, k in enumerate(kinds):
            shape = (6, 10) if i == 0 else (10,)
            ts.append(rt.Tensor(port_tensor(
                arr(90 + i, shape, k, dtype),
                "bool" if k == "bool" else dtype)))
        try:
            chain, ext = TFuse.capture_chain(lambda *t: fn(rt, TF, *t), *ts)
        except (RuntimeError, TypeError):
            continue  # torch refuses the op for this dtype
        kinds_, _, _ = FE.operand_layout(ext, (6, 10))
        src = FE.generate_source(chain, [e.dtype for e in ext], kinds_)
        tree = ast.parse(src)
        defs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        assert {"fused_chain_kernel", "launch", "_floor_mod",
                "_ipow"} <= defs
        made += 1
    assert made >= 1


def test_unknown_op_raises_at_codegen():
    chain = FE.FusedChain(steps=(("no_such_op", (), (("e", 0),)),),
                          fns=(torch.neg,), dtypes=(torch.float32,))
    with pytest.raises(NotImplementedError, match="no_such_op"):
        FE.generate_source(chain, [torch.float32], [FE.FLAT])


def test_operand_layout_collapses_dims():
    x = torch.zeros(2, 3, 4, 5)
    kinds, sizes, strides = FE.operand_layout(
        [x, torch.zeros(()), torch.zeros(5), torch.zeros(3, 1, 1),
         x.transpose(2, 3).contiguous().transpose(2, 3)], (2, 3, 4, 5))
    assert kinds == ("f", "s", "b", "b", "b")
    assert sizes == [2, 3, 4, 5]
    assert strides == [[0, 0, 0, 1], [0, 1, 0, 0], [60, 20, 1, 4]]
    kinds, sizes, strides = FE.operand_layout(
        [torch.zeros(6, 1), torch.zeros(6, 7)], (6, 7))
    assert kinds == ("b", "f") and sizes == [1, 1, 6, 7]
    with pytest.raises(NotImplementedError, match="dims"):
        FE.operand_layout([torch.zeros(2, 1, 2, 1, 2, 1, 2)[:, :, :, :, :,
                                                           :, :1]],
                          (2, 3, 2, 3, 2, 3, 1))


LAYOUT_CASES = {
    # (operand views of a flat base, output shape)
    "row_bias": (lambda b: [b[:40].view(4, 10), b[40:50]], (4, 10)),
    "column_bias": (lambda b: [b[:40].view(4, 10), b[50:54].view(4, 1)],
                    (4, 10)),
    "transposed": (lambda b: [b[:60].view(6, 10).t(),
                              b[64:124].view(10, 6)], (10, 6)),
    "size_1_dims": (lambda b: [b[:60].view(3, 1, 4, 5),
                               b[60:65].view(1, 1, 1, 5),
                               b[70:73].view(3, 1, 1, 1)], (3, 1, 4, 5)),
    "sliced": (lambda b: [b[:120].view(6, 20)[:, 1::2],
                          b[130:136].view(6, 1)], (6, 10)),
    "four_dims": (lambda b: [b[:120].view(2, 3, 4, 5).permute(0, 2, 1, 3),
                             b[120:124].view(1, 4, 1, 1)], (2, 4, 3, 5)),
    # more than one element, every stride 0 (``Tensor.expand`` of a
    # one-element tensor)
    "expanded_0d": (lambda b: [b[:40].view(4, 10),
                               b[41].expand(4, 10)], (4, 10)),
    "expanded_1x1": (lambda b: [b[:60].view(3, 4, 5),
                                b[61:62].view(1, 1, 1).expand(3, 4, 5)],
                     (3, 4, 5)),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_generated_index_math_reads_each_operand(case):
    """The generated index lines and each strided operand's offset,
    evaluated over every flat offset with the launcher's geometry,
    address exactly the element of each strided operand that
    broadcasting puts there."""
    make, shape = LAYOUT_CASES[case]
    base = torch.arange(256)
    xs = make(base)
    kinds, sizes, strides = FE.operand_layout(xs, shape)
    strided = [x for x, k in zip(xs, kinds) if k == FE.STRIDED]
    assert len(strided) == len(strides) > 0
    geo = FE.geometry(sizes, strides)
    env = dict(zip(["S1", "S2", "S3"], geo))
    env["offs"] = np.arange(math.prod(shape))
    for line in FE.INDEX_LINES:
        name, expr = line.split(" = ", 1)
        env[name] = eval(expr, {}, env)
    src = FE.generate_source(
        FE.FusedChain(tuple(("neg", (), (("e", i),)) for i in
                            range(len(xs))), (torch.neg,) * len(xs),
                      (torch.int64,) * len(xs)),
        [x.dtype for x in xs], kinds)
    for k, x in enumerate(strided):
        i = [j for j, kind in enumerate(kinds) if kind == FE.STRIDED][k]
        (idx,) = [ln.split(f"tl.load(e{i} + (", 1)[1].split("), mask")[0]
                  for ln in src.splitlines() if f"tl.load(e{i} + (" in ln]
        env.update(zip([f"st{i}_{d}" for d in range(FE.MAX_DIMS)],
                       geo[3 + k * FE.MAX_DIMS:3 + (k + 1) * FE.MAX_DIMS]))
        got = base.numpy()[x.storage_offset() + eval(idx, {}, env)]
        np.testing.assert_array_equal(
            got, x.expand(shape).reshape(-1).numpy())


def test_size_1_dims_are_dropped_from_the_index_math():
    """A row bias over (64, 1, 4096): the size-1 dim is dropped, so the
    operand's collapsed dims are the output's two (padded to four)."""
    kinds, sizes, strides = FE.operand_layout(
        [torch.zeros(64, 1, 4096), torch.zeros(1, 1, 4096)], (64, 1, 4096))
    assert kinds == (FE.FLAT, FE.STRIDED)
    assert sizes == [1, 1, 64, 4096] and strides == [[0, 0, 0, 1]]
    assert FE.geometry(sizes, strides) == [1, 64, 4096, 0, 0, 0, 1]
    assert FE.geometry(*FE.operand_layout([torch.zeros(3)], (3,))[1:]) == []


def test_generated_source_compiles():
    """One chain over flat, 0-d and strided operands, and one over flat
    operands alone: each module compiles."""
    with rt.default_device("cpu"):
        x = rt.Tensor(torch.zeros(6, 10))
        b = rt.Tensor(torch.zeros(10))
        s = rt.Tensor(torch.tensor(2.0))
        for fn, ts in ((lambda x, b, s: ((x * s + b).tanh() > 0.5)
                        .astype("float32"), (x, b, s)),
                       (lambda x: TF.relu(x + x), (x,))):
            chain, ext = TFuse.capture_chain(fn, *ts)
            kinds, _, _ = FE.operand_layout(ext, (6, 10))
            compile(FE.generate_source(chain, [e.dtype for e in ext], kinds),
                    "<fused>", "exec")


def test_literals_round_trip():
    for v in (0.1, -1.5e-7, 1e30, 1.0 / 3.0, 7):
        assert float(FE._lit(v, FE.F32)) == float(v)
    assert FE._lit(float("inf"), FE.F32) == "_INF"
    assert FE._lit(-float("inf"), FE.F32) == "_NINF"
    assert FE._lit(3, "tl.int32") == "3"
    with pytest.raises(NotImplementedError):
        FE._lit(2.5, "tl.int32")


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    reset_launch_counts()
    x = rt.tensor(arr(95))
    with rt.fuse.fusion():
        y = (x * 2.0).relu()
        y.numpy()
    assert launch_counts()["fused_elementwise"] == 0
    np.testing.assert_allclose(y.numpy(), np.maximum(arr(95) * 2, 0))


# ----------------------------------------------------------------------
# card-only: the generated Triton kernel against its plain version
# ----------------------------------------------------------------------

def card_close(out, ref) -> None:
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        if r.dtype in CARD_TOL:
            atol, rtol = CARD_TOL[r.dtype]
            torch.testing.assert_close(o.float(), r.float(), atol=atol,
                                       rtol=rtol, equal_nan=True)
        else:
            assert torch.equal(o, r)


CARD_DTYPES = ("float32", "bfloat16", "int32")


@requires_cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
def test_cuda_kernel_matches_plain_every_op(dtype):
    """Every op (that torch takes in ``dtype``) as one merged chain over
    a ragged (1000, 37) shape with flat, 0-d, broadcast and transposed
    operands: one launch, outputs equal the plain version's."""
    cases = []
    with rt.default_device("cuda"):
        for name, fn, kinds in OPS:
            ts = []
            for i, k in enumerate(kinds):
                a = arr(100 + i, (37, 1000) if i == 1 else (1000, 37), k,
                        dtype)
                t = port_tensor(a, "bool" if k == "bool" else dtype).cuda()
                ts.append(rt.Tensor(t.t() if i == 1 else t))
            try:
                cases.append(TFuse.capture_chain(
                    lambda *t: fn(rt, TF, *t), *ts))
            except (RuntimeError, TypeError):
                continue
            if "bool" not in kinds and "nonzero" not in kinds:
                # the op on its first operand alone, then a Python scalar
                # (an integer divisor of 0 is undefined on the card)
                cases.append(TFuse.capture_chain(
                    lambda a: fn(rt, TF, *([a] * len(kinds))) * 2, ts[0]))
        chain, ext = FE.merge_chains(cases)
        reset_launch_counts()
        out = FE.fused_elementwise(chain, *ext)
        torch.cuda.synchronize()
        assert launch_counts()["fused_elementwise"] == 1
        card_close(out, FE.fused_elementwise_plain(chain, *ext))


def launch_one(chain, ext):
    reset_launch_counts()
    out = FE.fused_elementwise(chain, *ext)
    torch.cuda.synchronize()
    assert launch_counts()["fused_elementwise"] == 1
    return out


@requires_cuda
@pytest.mark.parametrize("extra", [1 - FE.BLOCK, -1, 0, 1, 2, None])
def test_cuda_ragged_tails_match_plain(extra):
    """add+relu with a 0-d bias over 1, BLOCK - 1, BLOCK, BLOCK + 1 and
    BLOCK + 2 elements, and over more whole tiles than the card holds
    programs at once, plus a tail of 3: values equal the plain
    version's."""
    n = (4096 * FE.BLOCK + 3 if extra is None else FE.BLOCK + extra)
    with rt.default_device("cuda"):
        x = rt.Tensor(torch.randn(n, device="cuda"))
        b = rt.Tensor(torch.randn((), device="cuda"))
        chain, ext = TFuse.capture_chain(lambda x, b: TF.relu(x + b), x, b)
    card_close(launch_one(chain, ext),
               FE.fused_elementwise_plain(chain, *ext))


@requires_cuda
def test_cuda_relu_over_2_31_elements_takes_64_bit_offsets():
    """relu over 2^31 + 5 fp32 elements (8.6 GB in, 8.6 GB out): offsets
    past 2^31 and the ragged tail, equal to ``torch.relu`` bit for
    bit."""
    n = 2 ** 31 + 5
    x = torch.randn(n, device="cuda")
    with rt.default_device("cuda"):
        chain, ext = TFuse.capture_chain(lambda a: TF.relu(a), rt.Tensor(x))
    (out,) = launch_one(chain, ext)
    ref = torch.relu(x)
    del x, ext
    assert torch.equal(out, ref)
    assert torch.equal(out[-5:], ref[-5:])


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_broadcast_with_size_1_dims_matches_plain(dtype):
    """x (3, 1, 257, 129) with a (1, 1, 1, 129) bias, a (3, 1, 1, 1)
    scale and a 0-d offset: the size-1 dims dropped from the index math,
    values equal the plain version's within the card tolerance."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(5)
    with rt.default_device("cuda"):
        ts = [rt.Tensor(torch.randn(s, generator=g, device="cuda").to(dt))
              for s in ((3, 1, 257, 129), (1, 1, 1, 129), (3, 1, 1, 1), ())]
        chain, ext = TFuse.capture_chain(
            lambda x, b, s, c: ((x + b) * s - c).sigmoid(), *ts)
    kinds, sizes, _ = FE.operand_layout(ext, (3, 1, 257, 129))
    assert kinds == ("f", "b", "b", "s")
    assert sizes == [1, 3, 257, 129]
    card_close(launch_one(chain, ext),
               FE.fused_elementwise_plain(chain, *ext))


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_expanded_one_element_operand_matches_plain(dtype):
    """relu(x + b.expand(...)) with b of one element: an operand of many
    elements whose strides are all 0, read through them, values equal
    the plain version's within the card tolerance."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(6)
    with rt.default_device("cuda"):
        x = rt.Tensor(torch.randn(33, 1027, generator=g,
                                  device="cuda").to(dt))
        b = rt.Tensor(torch.randn(1, 1, generator=g, device="cuda").to(dt))
        chain, ext = TFuse.capture_chain(
            lambda x, b: TF.relu(x + b.expand(33, 1027)), x, b)
    kinds, _, strides = FE.operand_layout(ext, (33, 1027))
    assert kinds == ("f", "b") and strides == [[0, 0, 0, 0]]
    card_close(launch_one(chain, ext),
               FE.fused_elementwise_plain(chain, *ext))


@requires_cuda
def test_cuda_unknown_op_raises_without_launching():
    chain = FE.FusedChain(steps=(("no_such_op", (), (("e", 0),)),),
                          fns=(torch.neg,), dtypes=(torch.float32,))
    reset_launch_counts()
    with pytest.raises(NotImplementedError):
        FE.fused_elementwise(chain, torch.zeros(8, device="cuda"))
    assert launch_counts()["fused_elementwise"] == 0


@requires_cuda
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_cuda_programs_launch_one_kernel_per_flush(name):
    """Every flushed chain of a program on CUDA tensors launches the
    kernel; values and grads equal the CPU run's."""
    x, w = arr(70, (4, 8)), arr(71, (8, 8))
    res = {}
    for dev in ("cpu", "cuda"):
        with rt.default_device(dev):
            xt = rt.tensor(x, requires_grad=True)
            wt = rt.tensor(w, requires_grad=True)
            rt.reset_dispatch_cache()
            reset_launch_counts()
            with TFuse.fusion():
                out = PROGRAMS[name](rt, TF, xt, wt)
                out.backward()
            per_op = rt.dispatch_cache_stats()["per_op"]["__fused__"]
            res[dev] = (out.item(), xt.grad.numpy(), wt.grad.numpy(),
                        per_op["hits"] + per_op["misses"],
                        launch_counts()["fused_elementwise"])
    assert res["cuda"][4] == res["cuda"][3] == res["cpu"][3] > 0
    assert res["cpu"][4] == 0
    np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=1e-5)
    for a, b in zip(res["cuda"][1:3], res["cpu"][1:3]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_pending_dtype_keyed_by_static_type():
    """``clamp(t, 0, 1)`` and ``clamp(t, 0.0, 1.0)`` of an int32 tensor
    are int32 and float32 while pending too.  (The reference's
    ``_out_aval`` cache keys the statics untyped, so its second pending
    tensor reports int32 until it is flushed.)"""
    t = rt.tensor(np.arange(6, dtype=np.int32))
    with TFuse.fusion():
        a, b = t.clamp(0, 1), t.clamp(0.0, 1.0)
        assert a._pending is not None and b._pending is not None
        assert (a.dtype, b.dtype) == (torch.int32, torch.float32)
        assert b.numpy().dtype == np.float32
