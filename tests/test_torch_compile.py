"""The jit bridge (``repro_torch.compile``, ``value_and_grad``, ``grad``)
and trace-time seeding of the dispatch cache, on the CPU, against the
JAX package: the ports of ``tests/test_autograd.py::TestCompiledPath``,
``tests/test_dispatch_cache.py::test_compile_unhashable_static_falls_back``
and ``::test_fusion_inside_jit_is_bypassed``, and
``tests/test_functional_conformance.py::TestCompileSeeding``; the
functional gradients with ``argnums`` and ``has_aux`` against
``repro.value_and_grad`` / ``repro.fuse.grad`` on the same function; a
compiled train step against the eager tape; and the graph a CUDA call
traces to (fake CUDA tensors: the flash kernel stays one operator).

Inductor compiles take seconds each on a CPU, so most cases pass
``backend="aot_eager"`` (the same traced graph, run by PyTorch's eager
kernels); ``test_compile_matches_eager`` and the flash card case run
the default backend.  Tolerances: 1e-6 relative where both sides run
the same fp32 ops, 1e-5 where the ops or their order differ (Inductor's
fused reductions, the tape against ``torch.func``, the port against
JAX).
"""

import warnings

import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
import repro_torch.nn as nn
import repro_torch.nn.functional as F
from repro_torch.core import dispatch as D
from repro_torch.core import fuse
from repro_torch.kernels import launch_counts, reset_launch_counts
from torch_port_helpers import cuda_device, port_cpu, \
    requires_cuda  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cpu")

EAGERLY = dict(backend="aot_eager")


class TestCompiledPath:
    def test_compile_matches_eager(self):
        f = lambda x, w: (x @ w).relu().sum()  # noqa: E731
        cf = rt.compile(f)                     # Inductor
        x = rt.randn(4, 8)
        w = rt.randn(8, 3)
        np.testing.assert_allclose(float(cf(x, w).data),
                                   float(f(x, w).data), rtol=1e-5)
        assert len(cf._compiled) == 1

    def test_tape_disabled_under_trace(self):
        @rt.compile(**EAGERLY)
        def f(x):
            y = x * 2.0
            assert y.grad_fn is None  # tracing: no tape
            return y.sum()

        x = rt.randn(3, requires_grad=True)
        out = f(x)
        assert out.grad_fn is None

    def test_value_and_grad(self):
        vg = rt.value_and_grad(lambda x: (x.exp()).sum())
        x = rt.randn(4)
        v, g = vg(x)
        np.testing.assert_allclose(g.data.numpy(), np.exp(x.numpy()),
                                   rtol=1e-5)


def test_compile_unhashable_static_falls_back():
    calls = []

    @rt.compile(static_argnums=(1,), **EAGERLY)
    def f(x, flag):
        calls.append(1)
        return x * 2.0 if flag else x

    x = rt.randn(4)
    before = rt.dispatch_cache_stats()["num_fallback_unhashable"]
    with pytest.warns(UserWarning):
        out = f(x, [1, 2])  # unhashable static -> eager fallback
    assert isinstance(out, rt.Tensor)
    assert rt.dispatch_cache_stats()["num_fallback_unhashable"] \
        == before + 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # warned once only
        f(x, [3])
    assert not f._compiled


def test_statics_key_the_compiled_callables():
    """Each static value, and each new shape, traces once; a repeated
    signature replays (the function's Python does not run again)."""
    calls = []

    @rt.compile(static_argnums=(1,), **EAGERLY)
    def f(x, scale):
        calls.append(scale)
        return x * scale

    x = rt.randn(4)
    for scale in (2.0, 3.0, 2.0):
        np.testing.assert_allclose(f(x, scale).numpy(), x.numpy() * scale,
                                   rtol=1e-6)
    f(rt.randn(5), 2.0)
    assert calls == [2.0, 3.0, 2.0] and len(f._compiled) == 3


def test_fusion_inside_jit_is_bypassed():
    @rt.compile(**EAGERLY)
    def f(t):
        with fuse.fusion():
            return (t * 2.0).exp()

    x = rt.randn(4)
    out = f(x)
    np.testing.assert_allclose(out.numpy(), np.exp(x.numpy() * 2),
                               rtol=1e-5)
    assert "__fused__" not in rt.dispatch_cache_stats()["per_op"]


class TestCompileSeeding:
    def test_compile_seeds_eager_entries(self):
        lin = nn.Linear(8, 8)

        @rt.compile(seed_cache=True, **EAGERLY)
        def fwd(t):
            return F.gelu(lin(t))

        _ = fwd(rt.randn(3, 8))
        assert "linear" in fwd.seeded_ops and "gelu" in fwd.seeded_ops
        stats = rt.dispatch_cache_stats()
        assert stats["num_seeded"] > 0

        # the eager dispatch of the same signature starts warm: no miss
        misses_before = stats["num_misses"]
        _ = F.gelu(lin(rt.randn(3, 8)))
        stats = rt.dispatch_cache_stats()
        assert stats["num_misses"] == misses_before, stats
        assert stats["per_op"]["gelu"]["hits"] >= 1
        assert stats["per_op"]["linear"]["hits"] >= 1
        assert stats["per_op"]["gelu"]["seeded"] == 2   # both grad keys

    def test_seeded_entry_value_matches_uncached(self):
        lin = nn.Linear(6, 6)
        x = rt.randn(2, 6)

        with D.cache_disabled():
            expected = F.silu(lin(x)).numpy()

        @rt.compile(seed_cache=True, **EAGERLY)
        def fwd(t):
            return F.silu(lin(t))

        _ = fwd(x)
        got = F.silu(lin(x)).numpy()  # replays seeded entries
        np.testing.assert_allclose(got, expected, rtol=2e-6, atol=1e-7)


def _loss(P, w, x, b):
    """The same function on either package: a tanh layer's mean square,
    with the pre-activation's mean as aux."""
    z = x @ w + b
    return (z.tanh() * z.tanh()).mean(), z.mean()


@pytest.mark.parametrize("argnums", [0, 1, (0, 2)])
def test_value_and_grad_matches_reference(argnums):
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((5, 3), (4, 5), (3,))]
    jargs = [repro.tensor(a) for a in arrs]
    targs = [rt.tensor(a) for a in arrs]
    (jv, jaux), jg = repro.value_and_grad(
        lambda *a: _loss(repro, *a), argnums=argnums, has_aux=True)(*jargs)
    (tv, taux), tg = rt.value_and_grad(
        lambda *a: _loss(rt, *a), argnums=argnums, has_aux=True)(*targs)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux.data),
                               rtol=1e-5, atol=1e-6)
    jg = jg if isinstance(argnums, tuple) else (jg,)
    tg = tg if isinstance(argnums, tuple) else (tg,)
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        assert isinstance(a, rt.Tensor)
        np.testing.assert_allclose(a.numpy(), np.asarray(b.data),
                                   rtol=1e-5, atol=1e-6)
    # grad: the same gradients, (grads, aux) with has_aux
    g_only, aux = fuse.grad(lambda *a: _loss(rt, *a), argnums=argnums,
                            has_aux=True)(*targs)
    g_only = g_only if isinstance(argnums, tuple) else (g_only,)
    for a, b in zip(g_only, tg):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(aux.numpy(), taux.numpy())
    # no aux: a bare value, a bare gradient
    v, g = rt.value_and_grad(lambda w: _loss(rt, w, *targs[1:])[0])(
        targs[0])
    np.testing.assert_allclose(float(v), float(tv), rtol=1e-6)
    np.testing.assert_allclose(
        fuse.grad(lambda w: _loss(rt, w, *targs[1:])[0])(targs[0]).numpy(),
        g.numpy(), rtol=1e-6)


def test_compiled_train_step_matches_tape():
    """``compile(value_and_grad(loss))`` of an NCF step over its
    parameters (``functional_call``) against ``loss.backward()`` on the
    eager tape, with the fusion queue on around the compiled call."""
    from repro_torch.models.paper_models import NCF

    rt.manual_seed(4)
    model = NCF(n_users=30, n_items=20, mf_dim=4, mlp_dims=(8, 8, 4))
    rng = np.random.default_rng(5)
    users = rt.tensor(rng.integers(0, 30, 16).astype(np.int32))
    items = rt.tensor(rng.integers(0, 20, 16).astype(np.int32))
    labels = rt.tensor(rng.integers(0, 2, 16).astype(np.float32))

    def loss_fn(params, u, i, y):
        logits = nn.functional_call(model, params, u, i)
        return F.binary_cross_entropy_with_logits(logits, y)

    step = rt.compile(rt.value_and_grad(loss_fn), **EAGERLY)
    params = {k: p.detach() for k, p in model.named_parameters()}
    with fuse.fusion():
        value, grads = step(params, users, items, labels)
    loss = loss_fn(dict(model.named_parameters()), users, items, labels)
    loss.backward()
    np.testing.assert_allclose(float(value), loss.item(), rtol=1e-6)
    assert set(grads) == set(params)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(grads[k].numpy(), p.grad.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_cuda_graph_keeps_the_flash_operator():
    """The graph ``compile`` traces for CUDA tensors (fake ones here)
    holds the flash kernel as one ``repro_torch::flash_attention``
    operator, and no elementwise chain: the fused pass is bypassed."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    with FakeTensorMode():
        q = torch.empty(1, 8, 64, 32, device="cuda", dtype=torch.bfloat16)
        kv = torch.empty(1, 2, 64, 32, device="cuda", dtype=torch.bfloat16)

    def f(q, k, v):
        with fuse.fusion():
            out = F.scaled_dot_product_attention(
                rt.Tensor(q), rt.Tensor(k), rt.Tensor(v), is_causal=True)
            return (out * out).tanh().data

    with rt.autograd.tracing():
        graph = make_fx(f, tracing_mode="fake")(q, kv, kv)
    targets = [str(n.target) for n in graph.graph.nodes
               if n.op == "call_function"]
    assert targets.count("repro_torch.flash_attention.default") == 1
    assert targets.count("aten.tanh.default") == 1
    assert targets.count("aten.mul.Tensor") == 1


@requires_cuda
def test_cuda_compiled_sdpa_launches_flash_once():
    """On the card: a compiled unmasked SDPA launches the flash kernel
    once a call, counted, and gives the eager call's bits."""
    with rt.default_device("cuda"):
        gen = torch.Generator().manual_seed(6)
        q, k, v = (rt.Tensor(torch.randn(1, 4, 256, 64, generator=gen)
                             .to("cuda", torch.bfloat16)) for _ in range(3))

        def attend(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        eager = attend(q, k, v).data
        cf = rt.compile(attend)
        cf(q, k, v)
        reset_launch_counts()
        out = cf(q, k, v).data
        torch.cuda.synchronize()
        assert launch_counts()["flash_attention"] == 1
        assert torch.equal(out, eager)
