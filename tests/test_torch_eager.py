"""The port's eager runtime (``repro_torch.core``, ``nn.functional``)
against the JAX package's, op by op.

Inputs are made with numpy from a seed and handed to both packages.
Each op is run per dtype it takes (fp32, bf16, int32, bool), with tensor
and Python-scalar operands, and both the values and the output dtype
must equal the reference's.  Tolerances: fp32 1e-6 relative (1e-6
absolute near 0): XLA's and PyTorch's CPU math may differ by an ulp of
a transcendental; bf16 one bf16 step (1e-2 relative): both round the
same fp32 value, and an ulp of difference before rounding can flip a
tie; int32 and bool exact.  ``nn.functional``'s non-elementwise ops are
held at fp32 to 1e-5 (their reductions sum in another order).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.nn.functional as JF
import repro_torch as rt
import repro_torch.nn.functional as TF
from repro_torch.core.tensor_mod import dtype_name
from torch_port_helpers import jax_array, port_cpu, port_tensor  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cpu")

TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
SHAPE = (3, 7)


def inputs(kind: str, dtype: str, seed: int, shape=SHAPE) -> np.ndarray:
    """numpy values of one input kind: ``any`` N(0, 1), ``pos`` in
    [0.25, 2.25), ``nonzero`` |x| in [0.5, 1.5), ``bool``; integers for
    the int32 dtype (``any`` in [-20, 20), ``pos`` [0, 50), ``nonzero``
    +-[1, 10), ``exp`` [0, 6): JAX's integer power of a negative
    exponent is not defined)."""
    rng = np.random.default_rng(seed)
    if dtype == "bool" or kind == "bool":
        return rng.random(shape) < 0.5
    if dtype == "int32":
        lo_hi = {"any": (-20, 20), "pos": (0, 50), "base": (-3, 4),
                 "exp": (0, 6)}
        if kind == "nonzero":
            return (rng.integers(1, 10, shape)
                    * rng.choice([-1, 1], shape)).astype(np.int32)
        return rng.integers(*lo_hi.get(kind, (-20, 20)), shape).astype(
            np.int32)
    if kind == "pos":
        return (rng.random(shape) * 2 + 0.25).astype(np.float32)
    if kind == "nonzero":
        return ((rng.random(shape) + 0.5)
                * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    if kind == "base":
        return (rng.random(shape) * 1.5 + 0.5).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def both(a: np.ndarray, dtype: str):
    """The same values as a reference Tensor and a port Tensor."""
    dt = "bool" if a.dtype == np.bool_ else dtype
    return (repro.Tensor(jax_array(a, dt)), rt.Tensor(port_tensor(a, dt)))


def same(j, t, dtype=None) -> None:
    """Values and dtype of a reference result ``j`` equal the port's
    ``t``."""
    jd = str(j.dtype)
    assert dtype_name(t.dtype) == jd, (jd, t.dtype)
    a = np.asarray(j.data).astype(np.float64) if jd == "bfloat16" \
        else np.asarray(j.data)
    b = t.numpy()
    if jd in TOL:
        np.testing.assert_allclose(b, a, **TOL[jd])
    else:
        np.testing.assert_array_equal(b, a)


# (op, fn(P, F, *tensors), input kinds, dtypes it takes).  P is the
# package (repro or repro_torch), F its nn.functional.
FLOAT = ("float32", "bfloat16")
ALL = ("float32", "bfloat16", "int32")
OPS = [
    ("add", lambda P, F, a, b: a + b, ("any", "any"), ALL + ("bool",)),
    ("sub", lambda P, F, a, b: a - b, ("any", "any"), ALL),
    ("mul", lambda P, F, a, b: a * b, ("any", "any"), ALL + ("bool",)),
    ("div", lambda P, F, a, b: a / b, ("any", "nonzero"), ALL),
    ("pow", lambda P, F, a, b: a ** b, ("base", "exp"), ALL),
    ("mod", lambda P, F, a, b: a % b, ("any", "nonzero"), ALL),
    ("neg", lambda P, F, a: -a, ("any",), ALL),
    ("abs", lambda P, F, a: a.abs(), ("any",), ALL),
    ("clone", lambda P, F, a: a.clone(), ("any",), ALL + ("bool",)),
    ("exp", lambda P, F, a: a.exp(), ("any",), FLOAT),
    ("log", lambda P, F, a: a.log(), ("pos",), FLOAT),
    ("sqrt", lambda P, F, a: a.sqrt(), ("pos",), ALL),
    ("rsqrt", lambda P, F, a: a.rsqrt(), ("pos",), FLOAT),
    ("sin", lambda P, F, a: a.sin(), ("any",), FLOAT),
    ("cos", lambda P, F, a: a.cos(), ("any",), FLOAT),
    ("tanh", lambda P, F, a: a.tanh(), ("any",), FLOAT),
    ("sigmoid", lambda P, F, a: a.sigmoid(), ("any",), FLOAT),
    ("relu", lambda P, F, a: a.relu(), ("any",), ALL),
    ("erf", lambda P, F, a: a.erf(), ("any",), FLOAT),
    ("clamp", lambda P, F, a: a.clamp(-0.5, 0.5), ("any",), FLOAT),
    ("clamp_int", lambda P, F, a: a.clamp(-3, 5), ("any",), ALL),
    ("clamp_float_bounds", lambda P, F, a: a.clamp(0.0, 1.5), ("any",),
     ("int32",)),
    ("clamp_hi", lambda P, F, a: a.clamp(None, 0.3), ("any",), FLOAT),
    ("maximum", lambda P, F, a, b: P.maximum(a, b), ("any", "any"),
     ALL + ("bool",)),
    ("minimum", lambda P, F, a, b: P.minimum(a, b), ("any", "any"),
     ALL + ("bool",)),
    ("where", lambda P, F, c, a, b: P.where(c, a, b),
     ("bool", "any", "any"), ALL + ("bool",)),
    ("masked_fill", lambda P, F, a, m: a.masked_fill(m, -1.5),
     ("any", "bool"), FLOAT),
    ("masked_fill_int", lambda P, F, a, m: a.masked_fill(m, 7),
     ("any", "bool"), ALL),
    ("relu6", lambda P, F, a: F.relu6(a * 4.0), ("any",), FLOAT),
    ("gelu_tanh", lambda P, F, a: F.gelu(a), ("any",), FLOAT),
    ("gelu_none", lambda P, F, a: F.gelu(a, "none"), ("any",), FLOAT),
    ("silu", lambda P, F, a: F.silu(a), ("any",), FLOAT),
    ("softplus", lambda P, F, a: F.softplus(a), ("any",), FLOAT),
    ("hardswish", lambda P, F, a: F.hardswish(a * 3.0), ("any",), FLOAT),
    ("leaky_relu", lambda P, F, a: F.leaky_relu(a, 0.2), ("any",), FLOAT),
    ("elu", lambda P, F, a: F.elu(a, 1.5), ("any",), FLOAT),
]
ASTYPE_TARGETS = ("float32", "bfloat16", "int32", "bool")

CASES = [(name, dt) for name, _, _, dts in OPS for dt in dts]


@pytest.mark.parametrize("name,dtype", CASES,
                         ids=[f"{n}-{d}" for n, d in CASES])
def test_elementwise_op_matches_reference(name, dtype):
    _, fn, kinds, _ = next(o for o in OPS if o[0] == name)
    pairs = [both(inputs(k, dtype, 10 + i), dtype)
             for i, k in enumerate(kinds)]
    same(fn(repro, JF, *[p[0] for p in pairs]),
         fn(rt, TF, *[p[1] for p in pairs]))


@pytest.mark.parametrize("src", ("float32", "bfloat16", "int32", "bool"))
def test_astype_matches_reference(src):
    j, t = both(inputs("any", src, 3) * (4 if src != "bool" else 1), src)
    for to in ASTYPE_TARGETS:
        same(j.astype(getattr(jnp, to)), t.astype(to))


SCALAR_OPS = [
    ("add", lambda a: a + 2), ("add_float", lambda a: a + 2.5),
    ("radd", lambda a: 3 + a), ("sub", lambda a: a - 1.5),
    ("rsub", lambda a: 2.0 - a), ("mul", lambda a: a * 3),
    ("mul_float", lambda a: a * 0.5), ("div", lambda a: a / 4),
    ("rdiv", lambda a: 1.0 / (a + 100)), ("pow", lambda a: a ** 2),
    ("mod", lambda a: a % 3), ("true", lambda a: a + True),
]


# the reference refuses sub, mod, pow and the shifted rdiv on bool
SCALAR_CASES = [(n, d) for n, _ in SCALAR_OPS
                for d in ("float32", "bfloat16", "int32", "bool")
                if not (d == "bool" and n in ("sub", "rsub", "mod", "pow",
                                              "rdiv"))]


@pytest.mark.parametrize("name,dtype", SCALAR_CASES,
                         ids=[f"{n}-{d}" for n, d in SCALAR_CASES])
def test_python_scalar_operands_match_reference(name, dtype):
    """Python scalars become 0-d tensors at ``_coerce``; their promotion
    must give the reference's (weakly typed) result dtypes."""
    fn = dict(SCALAR_OPS)[name]
    j, t = both(inputs("any", dtype, 4), dtype)
    same(fn(j), fn(t))


def test_zero_d_tensors_match_reference():
    for dtype in ("float32", "int32"):
        j, t = both(np.asarray(inputs("any", dtype, 5)[0, 0]), dtype)
        same(j + 2, t + 2)
        same(j * 2.5, t * 2.5)
        same(repro.maximum(j, 1), rt.maximum(t, 1))


REDUCTIONS = [
    ("sum", lambda a: a.sum()), ("sum_dim", lambda a: a.sum(dim=1)),
    ("mean", lambda a: a.mean(dim=0, keepdim=True)),
    ("var", lambda a: a.var(dim=1)), ("std", lambda a: a.std()),
    ("max", lambda a: a.max()), ("max_dim", lambda a: a.max(dim=1)[0]),
    ("argmax", lambda a: a.argmax(dim=1)),
    ("prod", lambda a: a.prod(dim=1)), ("cumsum", lambda a: a.cumsum(1)),
]


RED_CASES = [(n, d) for n, _ in REDUCTIONS for d in ("float32", "int32")
             if not (d == "int32" and n in ("var", "std"))]


@pytest.mark.parametrize("name,dtype", RED_CASES,
                         ids=[f"{n}-{d}" for n, d in RED_CASES])
def test_reductions_match_reference(name, dtype):
    fn = dict(REDUCTIONS)[name]
    j, t = both(inputs("base" if name == "prod" else "any", dtype, 6),
                dtype)
    a, b = fn(j), fn(t)
    assert dtype_name(b.dtype) == str(a.dtype)
    np.testing.assert_allclose(b.numpy(), np.asarray(a.data), rtol=1e-5,
                               atol=1e-5)


SHAPE_OPS = [
    ("reshape", lambda P, a: a.reshape(7, 3)),
    ("transpose", lambda P, a: a.transpose(0, 1)),
    ("T", lambda P, a: a.T), ("unsqueeze", lambda P, a: a.unsqueeze(1)),
    ("flatten", lambda P, a: a.reshape(1, 3, 7).flatten(1)),
    ("expand", lambda P, a: a[None].expand(2, 3, 7)),
    ("repeat", lambda P, a: a.repeat(2, 1)),
    ("getitem", lambda P, a: a[1:, ::2]),
    ("advanced_index", lambda P, a: a[[0, 2]]),
    ("cat", lambda P, a: P.cat([a, a * 2], dim=1)),
    ("stack", lambda P, a: P.stack([a, a], dim=0)),
    ("matmul", lambda P, a: a @ a.T),
    ("einsum", lambda P, a: P.einsum("ij,kj->ik", a, a)),
    ("softmax", lambda P, a: a.softmax(-1)),
    ("log_softmax", lambda P, a: a.log_softmax(0)),
    ("logsumexp", lambda P, a: P.logsumexp(a, dim=1)),
    ("tril", lambda P, a: P.tril(a, 1)),
    ("take_along_dim", lambda P, a: P.take_along_dim(
        a, P.tensor(np.array([[0], [6], [3]], np.int32)), 1)),
]


@pytest.mark.parametrize("name", [n for n, _ in SHAPE_OPS])
def test_tensor_ops_match_reference(name):
    fn = dict(SHAPE_OPS)[name]
    j, t = both(inputs("any", "float32", 7), "float32")
    a, b = fn(repro, j), fn(rt, t)
    assert dtype_name(b.dtype) == str(a.dtype)
    np.testing.assert_allclose(b.numpy(), np.asarray(a.data), rtol=1e-5,
                               atol=1e-6)


FUNCTIONAL = [
    ("linear", lambda P, F, x, w, b: F.linear(x, w, b),
     [(2, 5), (3, 5), (3,)]),
    ("layer_norm", lambda P, F, x, w, b: F.layer_norm(x, (5,), w, b),
     [(2, 5), (5,), (5,)]),
    ("rms_norm", lambda P, F, x, w: F.rms_norm(x, w, offset=1.0),
     [(2, 5), (5,)]),
    ("batch_norm_eval", lambda P, F, x, m, v, w: F.batch_norm(
        x, m, v.abs() + 0.5, w, training=False), [(2, 3, 4, 4), (3,), (3,),
                                                  (3,)]),
    ("conv2d", lambda P, F, x, w, b: F.conv2d(x, w, b, stride=2,
                                              padding=1),
     [(1, 2, 7, 7), (4, 2, 3, 3), (4,)]),
    ("conv2d_same", lambda P, F, x, w: F.conv2d(x, w, stride=2,
                                                padding="same"),
     [(1, 2, 8, 8), (3, 2, 4, 4)]),
    ("conv2d_groups", lambda P, F, x, w: F.conv2d(x, w, groups=2,
                                                  dilation=2, padding=2),
     [(1, 4, 8, 8), (4, 2, 3, 3)]),
    ("conv1d", lambda P, F, x, w: F.conv1d(x, w, padding=1),
     [(1, 2, 8), (3, 2, 3)]),
    ("max_pool2d", lambda P, F, x: F.max_pool2d(x, 3, 2, 1),
     [(1, 2, 7, 7)]),
    ("avg_pool2d", lambda P, F, x: F.avg_pool2d(x, 2), [(1, 2, 6, 6)]),
    ("adaptive_avg_pool2d", lambda P, F, x: F.adaptive_avg_pool2d(x, 2),
     [(1, 2, 6, 6)]),
    ("mse_loss", lambda P, F, a, b: F.mse_loss(a, b), [(3, 4), (3, 4)]),
    ("bce_logits", lambda P, F, a, b: F.binary_cross_entropy_with_logits(
        a, b.abs() % 1.0), [(3, 4), (3, 4)]),
    ("normalize", lambda P, F, x: F.normalize(x, dim=0), [(3, 4)]),
    ("pad", lambda P, F, x: F.pad(x, (1, 2), value=0.5), [(3, 4)]),
    ("sdpa", lambda P, F, q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), [(1, 2, 5, 8)] * 3),
]


@pytest.mark.parametrize("name", [n for n, _, _ in FUNCTIONAL])
def test_functional_matches_reference(name):
    """Value and gradient of each non-elementwise ``nn.functional`` op."""
    _, fn, shapes = next(f for f in FUNCTIONAL if f[0] == name)
    arrays = [inputs("any", "float32", 20 + i, s)
              for i, s in enumerate(shapes)]
    jx = [repro.tensor(a, requires_grad=True) for a in arrays]
    tx = [rt.tensor(a, requires_grad=True) for a in arrays]
    a, b = fn(repro, JF, *jx), fn(rt, TF, *tx)
    np.testing.assert_allclose(b.numpy(), np.asarray(a.data), rtol=1e-5,
                               atol=1e-5)
    a.sum().backward()
    b.sum().backward()
    for j, t in zip(jx, tx):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad.data),
                                   rtol=1e-4, atol=1e-5)


def test_losses_with_integer_targets_match_reference():
    lg = inputs("any", "float32", 30, (5, 7))
    tgt = np.array([1, 2, -100, 4, 6], np.int32)
    for kw in ({}, {"label_smoothing": 0.1}, {"reduction": "sum"},
               {"reduction": "none"}):
        a = JF.cross_entropy(repro.tensor(lg), repro.tensor(tgt), **kw)
        b = TF.cross_entropy(rt.tensor(lg), rt.tensor(tgt), **kw)
        np.testing.assert_allclose(b.numpy(), np.asarray(a.data),
                                   rtol=1e-6, atol=1e-6)
    lp = inputs("any", "float32", 31, (3, 6))
    t3 = np.array([1, 3, 0], np.int32)
    np.testing.assert_allclose(
        TF.nll_loss(rt.tensor(lp), rt.tensor(t3)).numpy(),
        np.asarray(JF.nll_loss(repro.tensor(lp), repro.tensor(t3)).data),
        rtol=1e-6)
    idx = np.array([[0, 2], [3, 1]], np.int32)
    w = inputs("any", "float32", 32, (5, 3))
    np.testing.assert_allclose(
        TF.embedding(rt.tensor(idx), rt.tensor(w)).numpy(),
        np.asarray(JF.embedding(repro.tensor(idx), repro.tensor(w)).data))


def test_batch_norm_train_updates_running_stats_as_reference():
    x = inputs("any", "float32", 33, (4, 3, 5, 5))
    stats = {}
    for P, F in ((repro, JF), (rt, TF)):
        m, v = P.zeros(3), P.ones(3)
        out = F.batch_norm(P.tensor(x), m, v, training=True, momentum=0.2)
        stats[P.__name__] = (np.asarray(out.data), np.asarray(m.data),
                             np.asarray(v.data), m._version.value)
    for a, b in zip(stats["repro"], stats["repro_torch"]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_dropout_draws_the_reference_mask():
    """Both packages draw the keep mask from a host generator seeded
    1234, so the n-th eager dropout call keeps the same elements."""
    x = np.ones((16, 16), np.float32)
    for p in (0.25, 0.5):
        a = JF.dropout(repro.tensor(x), p)
        b = TF.dropout(rt.tensor(x), p)
        np.testing.assert_allclose(b.numpy(), np.asarray(a.data))
        assert b.grad_fn is None and str(b.dtype) == "torch.float32"


def test_factories_and_seed_match_reference():
    repro.manual_seed(7)
    rt.manual_seed(7)
    draws = [(repro.randn(3, 4), rt.randn(3, 4)),
             (repro.rand(5), rt.rand(5)),
             (repro.randint(0, 9, (4,)), rt.randint(0, 9, (4,))),
             (repro.normal(1.0, 2.0, (3,)), rt.normal(1.0, 2.0, (3,))),
             (repro.uniform(-1, 1, (2, 2)), rt.uniform(-1, 1, (2, 2))),
             (repro.arange(5), rt.arange(5)),
             (repro.arange(0.0, 1.0, 0.25), rt.arange(0.0, 1.0, 0.25)),
             (repro.eye(3, 4), rt.eye(3, 4)),
             (repro.full((2,), 3.5), rt.full((2,), 3.5)),
             (repro.tensor([1, 2]), rt.tensor([1, 2])),
             (repro.tensor(np.arange(3.0)), rt.tensor(np.arange(3.0)))]
    for a, b in draws:
        assert dtype_name(b.dtype) == str(a.dtype)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a.data))


def test_factories_default_to_cuda():
    """Outside a ``default_device`` scope the factories place tensors on
    CUDA, and raise where there is none: no fallback to the CPU."""
    if torch.cuda.is_available():
        with rt.default_device(None):
            assert rt.zeros(2).device.type == "cuda"
        return
    with rt.default_device(None):
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.randn(3)
    assert rt.randn(3).device.type == "cpu"


def test_inplace_and_views_match_reference():
    x = inputs("any", "float32", 40, (3, 4))
    out = {}
    for P in (repro, rt):
        t = P.tensor(x)
        row = t[1]
        row.fill_(7.0)
        t[2] = 5.0
        t.mul_(2.0)
        t.clamp_(-1.0, 9.0)
        out[P.__name__] = (np.asarray(t.data), t._version.value)
    np.testing.assert_allclose(out["repro_torch"][0], out["repro"][0])
    assert out["repro_torch"][1] == out["repro"][1]


def test_port_imports_neither_jax_nor_repro():
    """``repro_torch`` (every module of the eager slice) runs with ``jax``
    and ``repro`` unimportable."""
    code = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import repro_torch as rt
import repro_torch.nn as nn
import repro_torch.nn.functional as F
import repro_torch.optim as optim
from repro_torch.kernels import fused_elementwise, ops
from repro_torch.models.paper_models import Bottleneck
with rt.default_device("cpu"):
    rt.manual_seed(0)
    m = Bottleneck(8, 2)
    opt = optim.SGD(list(m.parameters()), lr=0.1, momentum=0.9)
    with rt.fuse.fusion():
        loss = F.relu(m(rt.randn(2, 8, 4, 4))).sum()
        loss.backward()
        opt.step()
assert not any(k.split(".")[0] in ("jax", "repro") for k in sys.modules)
print("ok")
"""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
