"""The reference's eager gates, re-run on the port: the define-by-run
tape (``tests/test_autograd.py``) and numeric gradient checks of the
``nn.functional`` surface (``tests/test_gradcheck.py``), written against
``repro_torch`` on the CPU.  The oracle is PyTorch's own autograd and
``torch.nn.functional`` where the reference's is ``jax.grad`` and
``jax.nn``.

``test_multi_output_node`` is in ``test_torch_rnn.py`` (beside the
LSTM it needs) and ``TestCompiledPath`` in ``test_torch_compile.py``
(with the rest of the jit bridge).  The dropout collision draws its
masks from a ``torch.Generator`` where the reference takes a JAX key.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as TNF
from hypothesis import given, settings, strategies as st

import repro_torch as rt
import repro_torch.nn.functional as F
from repro_torch.core import dispatch as D
from repro_torch.core.autograd import Function, grad as autograd_grad
from torch_port_helpers import port_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cpu")


def assert_grads_match(fn_port, fn_torch, *arrays, rtol=1e-5, atol=1e-6):
    tensors = [rt.tensor(a, requires_grad=True) for a in arrays]
    out = fn_port(*tensors)
    out.backward()
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    torch_grads = torch.autograd.grad(fn_torch(*leaves), leaves)
    for t, g in zip(tensors, torch_grads):
        np.testing.assert_allclose(t.grad.numpy(), g.numpy(), rtol=rtol,
                                   atol=atol)


class TestTapeVsTorch:
    def test_matmul_relu_sum(self):
        a = np.random.randn(4, 8).astype(np.float32)
        b = np.random.randn(8, 3).astype(np.float32)
        assert_grads_match(
            lambda x, y: (x @ y).relu().sum(),
            lambda x, y: torch.relu(x @ y).sum(), a, b)

    def test_broadcast_arith(self):
        a = np.random.randn(4, 8).astype(np.float32)
        b = np.random.randn(8).astype(np.float32)
        assert_grads_match(
            lambda x, y: ((x + y) * (x - y) / 2.0).sum(),
            lambda x, y: ((x + y) * (x - y) / 2.0).sum(), a, b)

    def test_softmax_logsumexp(self):
        a = np.random.randn(5, 7).astype(np.float32)
        assert_grads_match(
            lambda x: (x.softmax(-1) * x.log_softmax(-1)).sum(),
            lambda x: (torch.softmax(x, -1)
                       * torch.log_softmax(x, -1)).sum(), a)

    def test_reductions_and_reshapes(self):
        a = np.random.randn(2, 3, 4).astype(np.float32)
        assert_grads_match(
            lambda x: x.reshape(6, 4).transpose(0, 1).mean(),
            lambda x: x.reshape(6, 4).T.mean(), a)

    def test_indexing(self):
        a = np.random.randn(6, 5).astype(np.float32)
        assert_grads_match(
            lambda x: (x[1:4] ** 2).sum(),
            lambda x: (x[1:4] ** 2).sum(), a)

    @settings(max_examples=25, deadline=None)
    @given(
        n=st.integers(2, 6), m=st.integers(2, 6),
        ops=st.lists(st.sampled_from(
            ["exp", "tanh", "sigmoid", "relu", "sqrtabs", "square"]),
            min_size=1, max_size=4),
    )
    def test_random_unary_chains(self, n, m, ops):
        """Property: tape gradients equal torch.autograd's for arbitrary
        chains."""
        a = np.random.randn(n, m).astype(np.float32)

        def chain(x, port):
            for op in ops:
                if op == "sqrtabs":
                    x = (x.abs() + 1.0).sqrt()
                elif op == "square":
                    x = x * x
                elif port:
                    x = getattr(x, op)()
                else:
                    x = getattr(torch, op)(x)
            return x.sum()

        assert_grads_match(lambda x: chain(x, True),
                           lambda x: chain(x, False), a,
                           rtol=1e-4, atol=1e-5)

    def test_shared_subexpression_accumulates(self):
        a = rt.randn(4, requires_grad=True)
        b = a * 2.0
        out = (b * b).sum() + b.sum()
        out.backward()
        expect = 2 * (2 * a.numpy() * 2.0) + 2.0
        np.testing.assert_allclose(a.grad.numpy(), expect, rtol=1e-5)


class TestVersioning:
    def test_mutation_after_save_errors(self):
        a = rt.randn(4, requires_grad=True)
        c = a * 2.0
        d = c.exp()
        with rt.no_grad():
            c.mul_(3.0)
        with pytest.raises(RuntimeError, match="inplace"):
            d.sum().backward()

    def test_leaf_inplace_guard(self):
        a = rt.randn(4, requires_grad=True)
        with pytest.raises(RuntimeError, match="leaf"):
            a.add_(1.0)

    def test_differentiable_inplace(self):
        a = rt.randn(4, requires_grad=True)
        b = a * 2.0
        b.add_(1.0)
        b.mul_(3.0)
        b.sum().backward()
        np.testing.assert_allclose(a.grad.numpy(), np.full(4, 6.0),
                                   rtol=1e-6)

    def test_view_writes_through(self):
        v = rt.zeros(3, 4)
        row = v[1]
        row.fill_(7.0)
        assert v.numpy()[1].tolist() == [7.0] * 4
        v[2] = 5.0
        assert v.numpy()[2].tolist() == [5.0] * 4

    def test_view_shares_version(self):
        v = rt.zeros(3, 4)
        row = v[0]
        assert row._version is v._version
        row.fill_(1.0)
        assert v._version.value > 0


class TestGraphLifecycle:
    def test_double_backward_without_retain_errors(self):
        p = rt.randn(3, requires_grad=True)
        q = (p * p).sum()
        q.backward()
        with pytest.raises(RuntimeError, match="second time"):
            q.backward()

    def test_retain_graph(self):
        p = rt.randn(3, requires_grad=True)
        q = (p * p).sum()
        q.backward(retain_graph=True)
        q.backward()
        np.testing.assert_allclose(p.grad.numpy(), 4 * p.numpy(),
                                   rtol=1e-5)

    def test_no_grad(self):
        a = rt.randn(3, requires_grad=True)
        with rt.no_grad():
            b = a * 2.0
        assert b.grad_fn is None

    def test_grad_fn_named(self):
        a = rt.randn(3, requires_grad=True)
        assert (a * 2.0).grad_fn.name == "mul"

    def test_autograd_grad_api(self):
        a = rt.randn(3, requires_grad=True)
        b = rt.randn(3, requires_grad=True)
        out = (a * b).sum()
        ga, gb = autograd_grad(out, [a, b])
        np.testing.assert_allclose(ga.numpy(), b.numpy(), rtol=1e-6)
        assert a.grad is None  # .grad not polluted

    def test_implicit_scalar_only(self):
        a = rt.randn(3, requires_grad=True)
        with pytest.raises(RuntimeError, match="scalar"):
            (a * 2.0).backward()


class TestCustomFunction:
    def test_function_forward_backward(self):
        class Cube(Function):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return rt.Tensor(x.data ** 3)

            @staticmethod
            def backward(ctx, g):
                (x,) = ctx.saved_tensors
                return rt.Tensor(3 * x.data ** 2) * g

        a = rt.randn(5, requires_grad=True)
        out = Cube.apply(a)
        out.sum().backward()
        np.testing.assert_allclose(a.grad.numpy(), 3 * a.numpy() ** 2,
                                   rtol=1e-5)

    def test_function_version_check(self):
        class Identity(Function):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return rt.Tensor(x.data + 0)

            @staticmethod
            def backward(ctx, g):
                return g

        a = rt.randn(4, requires_grad=True)
        b = a * 1.0
        out = Identity.apply(b)
        with rt.no_grad():
            b.mul_(2.0)
        with pytest.raises(RuntimeError, match="inplace"):
            out.sum().backward()


# ----------------------------------------------------------------------
# numeric gradient checks (tests/test_gradcheck.py)
# ----------------------------------------------------------------------

def _rng(seed=0):
    return np.random.default_rng(seed)


def _randn(*shape, seed=0, scale=1.0):
    return _rng(seed).standard_normal(shape, dtype=np.float32) * scale


def _randn_away_from(kinks, *shape, seed=0, margin=0.08):
    """Standard normals pushed ``margin`` away from each kink point."""
    a = _rng(seed).standard_normal(shape).astype(np.float64)
    for k in kinks:
        near = np.abs(a - k) < margin
        a = np.where(near, k + np.sign(a - k + 1e-12) * margin, a)
    return a.astype(np.float32)


def _distinct_grid(*shape, seed=0, step=0.1):
    n = int(np.prod(shape))
    vals = _rng(seed).permutation(n).astype(np.float32) * step
    return vals.reshape(shape)


def gradcheck(fn, inputs, eps=1e-2, rtol=5e-2, atol=1e-2, seed=123):
    """``backward()`` of ``fn(*inputs)`` against central differences of
    ``<fn(x), v>`` for a fixed random cotangent ``v``."""
    tensors = [rt.tensor(a, requires_grad=True) for a in inputs]
    out = fn(*tensors)
    cot = _rng(seed).standard_normal(out.shape).astype(np.float32)
    out.backward(rt.tensor(cot))
    analytic = [np.zeros(t.shape) if t.grad is None
                else t.grad.numpy().astype(np.float64) for t in tensors]

    def eval_dot(arrays):
        with rt.no_grad():
            o = fn(*[rt.tensor(a) for a in arrays])
        return float(np.vdot(o.numpy().astype(np.float64), cot))

    arrays = [np.asarray(a, dtype=np.float64) for a in inputs]
    for ai, a in enumerate(arrays):
        numeric = np.zeros(a.size)
        flat = a.ravel()
        for i in range(a.size):
            orig = flat[i]
            flat[i] = orig + eps
            plus = eval_dot([x.astype(np.float32) for x in arrays])
            flat[i] = orig - eps
            minus = eval_dot([x.astype(np.float32) for x in arrays])
            flat[i] = orig
            numeric[i] = (plus - minus) / (2 * eps)
        np.testing.assert_allclose(
            numeric.reshape(a.shape), analytic[ai], rtol=rtol, atol=atol,
            err_msg=f"input {ai}: analytic vjp disagrees with central "
                    f"differences")
    return True


def _gen(seed):
    return torch.Generator().manual_seed(seed)


GRAD_CASES = {
    "relu": lambda: gradcheck(
        F.relu, [_randn_away_from((0.0,), 4, 5, seed=1)]),
    "relu6": lambda: gradcheck(
        F.relu6, [_randn_away_from((0.0, 6.0), 4, 5, seed=2, margin=0.1)]),
    "leaky_relu": lambda: gradcheck(
        lambda t: F.leaky_relu(t, 0.2),
        [_randn_away_from((0.0,), 4, 5, seed=3)]),
    "elu": lambda: gradcheck(
        lambda t: F.elu(t, alpha=1.5), [_randn(4, 5, seed=4)]),
    "gelu_tanh": lambda: gradcheck(
        lambda t: F.gelu(t, "tanh"), [_randn(4, 5, seed=5)]),
    "gelu_none": lambda: gradcheck(
        lambda t: F.gelu(t, "none"), [_randn(4, 5, seed=6)]),
    "silu": lambda: gradcheck(F.silu, [_randn(4, 5, seed=7)]),
    "sigmoid": lambda: gradcheck(F.sigmoid, [_randn(4, 5, seed=8)]),
    "tanh": lambda: gradcheck(F.tanh, [_randn(4, 5, seed=9)]),
    "softplus": lambda: gradcheck(F.softplus, [_randn(4, 5, seed=10)]),
    "hardswish": lambda: gradcheck(
        F.hardswish,
        [_randn_away_from((-3.0, 3.0), 4, 5, seed=11, margin=0.1)]),
    "softmax": lambda: gradcheck(
        lambda t: F.softmax(t, dim=-1), [_randn(3, 6, seed=12)]),
    "softmax_dim0": lambda: gradcheck(
        lambda t: F.softmax(t, dim=0), [_randn(3, 6, seed=12)]),
    "log_softmax": lambda: gradcheck(
        lambda t: F.log_softmax(t, dim=-1), [_randn(3, 6, seed=13)]),
    "linear": lambda: gradcheck(
        F.linear, [_randn(3, 4, seed=14), _randn(2, 4, seed=15),
                   _randn(2, seed=16)]),
    "embedding": lambda: gradcheck(
        lambda w: F.embedding(rt.tensor(np.array([[0, 2], [3, 1]])), w),
        [_randn(5, 3, seed=17)]),
    "layer_norm": lambda: gradcheck(
        lambda x, w, b: F.layer_norm(x, (6,), w, b),
        [_randn(3, 6, seed=18), _randn(6, seed=19), _randn(6, seed=20)]),
    "rms_norm": lambda: gradcheck(
        lambda x, w: F.rms_norm(x, w, offset=1.0),
        [_randn(3, 6, seed=21), _randn(6, seed=22)]),
    "batch_norm_train": lambda: gradcheck(
        lambda x, w, b: F.batch_norm(x, None, None, w, b, training=True),
        [_randn(2, 3, 4, 4, seed=23), _randn(3, seed=24),
         _randn(3, seed=25)], eps=2e-2, rtol=8e-2, atol=2e-2),
    "batch_norm_eval": lambda: gradcheck(
        lambda x, w, b: F.batch_norm(
            x, rt.tensor(_randn(3, seed=26) * 0.1),
            rt.tensor(np.abs(_randn(3, seed=27)) + 0.5),
            w, b, training=False),
        [_randn(2, 3, 4, 4, seed=28), _randn(3, seed=29),
         _randn(3, seed=30)]),
    "conv2d": lambda: gradcheck(
        lambda x, w, b: F.conv2d(x, w, b, stride=2, padding=1),
        [_randn(1, 2, 6, 6, seed=31), _randn(2, 2, 3, 3, seed=32),
         _randn(2, seed=33)]),
    "conv1d": lambda: gradcheck(
        lambda x, w: F.conv1d(x, w, padding=1),
        [_randn(1, 2, 8, seed=34), _randn(3, 2, 3, seed=35)]),
    "max_pool2d": lambda: gradcheck(
        lambda x: F.max_pool2d(x, 2), [_distinct_grid(1, 2, 6, 6, seed=36)]),
    "avg_pool2d": lambda: gradcheck(
        lambda x: F.avg_pool2d(x, 2), [_randn(1, 2, 6, 6, seed=37)]),
    "adaptive_avg_pool2d": lambda: gradcheck(
        lambda x: F.adaptive_avg_pool2d(x, 2), [_randn(1, 2, 6, 6, seed=38)]),
    "dropout": lambda: gradcheck(
        lambda x: F.dropout(x, p=0.25, rng=_gen(3)), [_randn(5, 5, seed=39)]),
    "cross_entropy": lambda: gradcheck(
        lambda lg: F.cross_entropy(
            lg, rt.tensor(np.array([1, 3, -100, 0])), label_smoothing=0.1),
        [_randn(4, 6, seed=40)]),
    "nll_loss": lambda: gradcheck(
        lambda lp: F.nll_loss(lp, rt.tensor(np.array([1, 3, 0]))),
        [_randn(3, 6, seed=41)]),
    "mse_loss": lambda: gradcheck(
        F.mse_loss, [_randn(3, 4, seed=42), _randn(3, 4, seed=43)]),
    "bce_logits": lambda: gradcheck(
        lambda lg, t: F.binary_cross_entropy_with_logits(lg, t),
        [_randn(3, 4, seed=44), np.abs(_randn(3, 4, seed=45)) % 1.0]),
    "sdpa": lambda: gradcheck(
        lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True),
        [_randn(1, 1, 4, 16, seed=46), _randn(1, 1, 4, 16, seed=47),
         _randn(1, 1, 4, 16, seed=48)]),
    "pad": lambda: gradcheck(
        lambda x: F.pad(x, (1, 1), value=0.5), [_randn(3, 4, seed=49)]),
    "normalize": lambda: gradcheck(
        lambda x: F.normalize(x, dim=-1), [_randn(3, 4, seed=50)]),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradcheck(case):
    assert GRAD_CASES[case]()


def test_gradcheck_warm_replay_matches_cold():
    x = _randn(3, 6, seed=60)
    assert gradcheck(lambda t: F.softmax(t, dim=-1), [x])
    hits_before = rt.dispatch_cache_stats()["num_hits"]
    assert gradcheck(lambda t: F.softmax(t, dim=-1), [x])
    assert rt.dispatch_cache_stats()["num_hits"] > hits_before


class TestKwargCollisions:
    """Same op name, same operand shapes, different closure kwargs: if a
    ``static=`` tuple dropped a kwarg these would replay a stale entry."""

    def test_softmax_dim_collision(self):
        xd = _randn(4, 4, seed=70)
        x = rt.tensor(xd, requires_grad=True)
        a, b = F.softmax(x, dim=0), F.softmax(x, dim=-1)
        np.testing.assert_allclose(a.numpy(), torch.softmax(
            torch.tensor(xd), 0).numpy(), rtol=1e-6)
        np.testing.assert_allclose(b.numpy(), torch.softmax(
            torch.tensor(xd), -1).numpy(), rtol=1e-6)

    def test_softmax_dim_collision_gradients(self):
        xd = _randn(4, 4, seed=71)
        F.softmax(rt.tensor(xd, requires_grad=True), dim=0).sum().backward()
        x = rt.tensor(xd, requires_grad=True)
        (F.softmax(x, dim=-1) * rt.tensor(xd)).sum().backward()
        leaf = torch.tensor(xd, requires_grad=True)
        (ref,) = torch.autograd.grad(
            (torch.softmax(leaf, -1) * torch.tensor(xd)).sum(), leaf)
        np.testing.assert_allclose(x.grad.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-6)

    def test_gelu_approximate_collision(self):
        xd = _randn(4, 4, seed=72)
        a, b = F.gelu(rt.tensor(xd), "tanh"), F.gelu(rt.tensor(xd), "none")
        np.testing.assert_allclose(a.numpy(), TNF.gelu(
            torch.tensor(xd), approximate="tanh").numpy(), rtol=1e-6)
        np.testing.assert_allclose(b.numpy(), TNF.gelu(
            torch.tensor(xd)).numpy(), rtol=1e-6)
        assert not np.allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)

    def test_leaky_relu_slope_collision(self):
        xd = _randn(4, 4, seed=73)
        for slope in (0.01, 0.5):
            np.testing.assert_allclose(
                F.leaky_relu(rt.tensor(xd), slope).numpy(),
                TNF.leaky_relu(torch.tensor(xd), slope).numpy(), rtol=1e-6)

    def test_elu_alpha_collision(self):
        xd = _randn(4, 4, seed=74)
        for alpha in (1.0, 2.0):
            np.testing.assert_allclose(
                F.elu(rt.tensor(xd), alpha=alpha).numpy(),
                TNF.elu(torch.tensor(xd), alpha).numpy(), rtol=1e-6)

    def test_norm_eps_collision(self):
        xd = _randn(3, 6, seed=75)
        for eps in (1e-6, 0.5):
            got = F.rms_norm(rt.tensor(xd), eps=eps)
            var = np.mean(np.square(xd), axis=-1, keepdims=True)
            np.testing.assert_allclose(got.numpy(), xd / np.sqrt(var + eps),
                                       rtol=1e-6)

    def test_conv2d_padding_dilation_collision(self):
        xd, wd = _randn(1, 2, 8, 8, seed=76), _randn(2, 2, 3, 3, seed=77)
        a = F.conv2d(rt.tensor(xd), rt.tensor(wd), padding=1)
        b = F.conv2d(rt.tensor(xd), rt.tensor(wd), padding=2, dilation=2)
        assert a.shape == b.shape
        for got, pad, dil in ((a, 1, 1), (b, 2, 2)):
            ref = TNF.conv2d(torch.tensor(xd), torch.tensor(wd),
                             padding=pad, dilation=dil)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5,
                                       atol=1e-6)

    def test_cross_entropy_kwarg_collisions(self):
        lg = _randn(5, 7, seed=78)
        tgt = np.array([1, 2, 3, 4, 5])
        mean = F.cross_entropy(rt.tensor(lg), rt.tensor(tgt))
        summed = F.cross_entropy(rt.tensor(lg), rt.tensor(tgt),
                                 reduction="sum")
        np.testing.assert_allclose(summed.item(), mean.item() * 5,
                                   rtol=1e-5)
        smooth = F.cross_entropy(rt.tensor(lg), rt.tensor(tgt),
                                 label_smoothing=0.2)
        assert not np.isclose(smooth.item(), mean.item())
        ignored = F.cross_entropy(rt.tensor(lg),
                                  rt.tensor(np.array([1, 2, 3, 4, 1])),
                                  ignore_index=1)
        assert not np.isclose(ignored.item(), mean.item())
        ref = TNF.cross_entropy(torch.tensor(lg), torch.tensor(tgt),
                                label_smoothing=0.2)
        np.testing.assert_allclose(smooth.item(), ref.item(), rtol=1e-5)

    def test_dropout_p_collision(self):
        xd = np.ones((64, 64), np.float32)
        for p in (0.25, 0.5):
            got = F.dropout(rt.tensor(xd), p=p, rng=_gen(11)).numpy()
            keep = (torch.rand((64, 64), generator=_gen(11)) < 1.0 - p)
            np.testing.assert_allclose(got, keep.float().numpy() / (1 - p),
                                       rtol=1e-6)

    def test_normalize_dim_collision(self):
        xd = _randn(4, 6, seed=79)
        for dim in (0, -1):
            np.testing.assert_allclose(
                F.normalize(rt.tensor(xd), dim=dim).numpy(),
                TNF.normalize(torch.tensor(xd), dim=dim).numpy(), rtol=1e-5,
                atol=1e-7)

    def test_pad_value_collision(self):
        xd = _randn(3, 3, seed=80)
        for val in (0.0, -7.0):
            np.testing.assert_allclose(
                F.pad(rt.tensor(xd), (1, 1), value=val).numpy(),
                np.pad(xd, ((0, 0), (1, 1)), constant_values=val))

    def test_missing_static_is_caught_by_this_harness(self):
        """Negative control: the same op name with an emptied static
        tuple and different closures replays the first closure."""
        from repro_torch.core.tensor_mod import _apply_op
        xd = _randn(4, 4, seed=81)

        def buggy_softmax(dim):
            return _apply_op("buggy_softmax",
                             lambda v: torch.softmax(v, dim),
                             rt.tensor(xd), static=())

        a, b = buggy_softmax(0).numpy(), buggy_softmax(-1).numpy()
        np.testing.assert_allclose(a, b, rtol=1e-6)
        assert not np.allclose(b, torch.softmax(torch.tensor(xd), -1)
                               .numpy(), rtol=1e-3)
        D.reset_dispatch_cache()
