"""The reference's module, layer and optimizer gates
(``tests/test_nn_optim_data.py`` TestModule, TestLayers, TestOptim)
re-run on the port on the CPU, plus Adafactor and ``cosine_schedule``
against the JAX package's values, and the masked ``sdpa`` path
(``models.attention.sdpa_masked``) against ``repro.models.attention.
sdpa`` with the same mask.

Where the reference holds a result to ``jax.grad`` or ``jax.lax``, the
port holds it to its own functional engine (``repro_torch.fuse.grad``)
or to the JAX function on the same numpy inputs.  Tolerances are the
reference's, stated per case; Adafactor against the reference: 1e-6
relative (1e-7 absolute), the ulps of the same fp32 ops; masked
attention: 1e-5 relative in fp32, the bf16 tier ``1e-2 + 1e-2|ref|``
of PERF.md in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.optim as joptim
from repro.models import attention as JA
import repro_torch as rt
import repro_torch.nn as nn
import repro_torch.nn.functional as F
import repro_torch.optim as optim
from repro_torch.models import attention as TA
from repro_torch.nn import functional_call, param_dict
from torch_port_helpers import cuda_device, port_cpu, \
    requires_cuda  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cpu")


class TestModule:
    def make(self):
        class Net(nn.Module):
            def __init__(self):
                super().__init__()
                self.fc1 = nn.Linear(8, 16)
                self.fc2 = nn.Linear(16, 4)
                self.register_buffer("scale", rt.ones(1))

            def forward(self, x):
                return self.fc2(F.relu(self.fc1(x))) * self.scale

        return Net()

    def test_named_parameters(self):
        net = self.make()
        names = dict(net.named_parameters())
        assert set(names) == {"fc1.weight", "fc1.bias", "fc2.weight",
                              "fc2.bias"}
        assert dict(net.named_buffers()).keys() == {"scale"}

    def test_state_dict_roundtrip(self):
        net, net2 = self.make(), self.make()
        x = rt.randn(2, 8)
        net2.load_state_dict(net.state_dict())
        np.testing.assert_allclose(net(x).numpy(), net2(x).numpy(),
                                   rtol=1e-6)

    def test_train_eval_mode(self):
        net = self.make()
        net.eval()
        assert all(not m.training for m in net.modules())

    def test_functional_call_matches_eager(self):
        net = self.make()
        x = rt.randn(3, 8)
        eager = net(x)
        params = {k: v.data for k, v in param_dict(net).items()}
        out = functional_call(net, params, x)
        np.testing.assert_allclose(out.numpy(), eager.numpy(), rtol=1e-6)

        # compiled, with swapped params (the reference's jax.jit)
        def f(p, xd):
            return functional_call(net, p, rt.Tensor(xd)).data.sum()
        cf = rt.compile(f, backend="aot_eager")
        v1 = cf(params, x.data)
        # params restored after functional_call
        assert isinstance(net.fc1.weight, nn.Parameter)
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        assert float(cf(zeros, x.data)) == 0.0
        assert float(v1) != 0.0

    def test_tape_grads_equal_functional_grads_through_module(self):
        net = self.make()
        x = rt.randn(4, 8)
        y = rt.randint(0, 4, (4,))
        loss = F.cross_entropy(net(x), y)
        loss.backward()
        params = {k: v.data for k, v in param_dict(net).items()}
        fg = rt.fuse.grad(lambda p: F.cross_entropy(
            functional_call(net, p, x), y))(params)
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), fg[name].numpy(),
                                       rtol=2e-4, atol=1e-5)


class TestLayers:
    def test_layer_norm_matches_formula(self):
        ln = nn.LayerNorm(16)
        x = rt.randn(4, 16)
        out = ln(x).numpy()
        xd = x.numpy()
        ref = (xd - xd.mean(-1, keepdims=True)) / np.sqrt(
            xd.var(-1, keepdims=True) + 1e-5)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)

    def test_batchnorm_updates_running_stats(self):
        bn = nn.BatchNorm2d(3)
        x = rt.randn(8, 3, 4, 4) * 2.0 + 1.0
        bn(x)
        assert not np.allclose(bn._buffers["running_mean"].numpy(), 0.0)
        bn.eval()
        before = bn._buffers["running_mean"].numpy().copy()
        bn(x)
        np.testing.assert_allclose(bn._buffers["running_mean"].numpy(),
                                   before)

    def test_conv2d_matches_lax(self):
        conv = nn.Conv2d(2, 5, 3, stride=2, padding=1)
        x = rt.randn(2, 2, 9, 9)
        out = conv(x)
        ref = jax.lax.conv_general_dilated(
            jnp.asarray(x.numpy()), jnp.asarray(conv.weight.numpy()),
            (2, 2), ((1, 1), (1, 1)),
            dimension_numbers=("NCHW", "OIHW", "NCHW"))
        ref = ref + jnp.asarray(conv.bias.numpy()).reshape(1, -1, 1, 1)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)

    def test_embedding_gather(self):
        emb = nn.Embedding(10, 4)
        idx = rt.tensor([1, 3, 1])
        out = emb(idx).numpy()
        w = emb.weight.numpy()
        np.testing.assert_allclose(out, w[[1, 3, 1]])

    def test_dropout_train_eval(self):
        d = nn.Dropout(0.5)
        x = rt.ones(1000)
        out = d(x)
        frac = float((out.data == 0).float().mean())
        assert 0.3 < frac < 0.7
        d.eval()
        np.testing.assert_allclose(d(x).numpy(), x.numpy())

    def test_sdpa_gqa_matches_manual(self):
        q = rt.randn(2, 8, 16, 4)
        k = rt.randn(2, 2, 16, 4)
        v = rt.randn(2, 2, 16, 4)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             backend="ref")
        assert out.shape == (2, 8, 16, 4)
        # causality: output at position 0 ignores later keys
        vd = v.data.clone()
        vd[:, :, 1:] = 0.0
        out2 = F.scaled_dot_product_attention(q, k, rt.Tensor(vd),
                                              is_causal=True, backend="ref")
        np.testing.assert_allclose(out.numpy()[:, :, 0],
                                   out2.numpy()[:, :, 0], rtol=1e-5)


class TestOptim:
    def _fit(self, opt_cls, steps=200, **kw):
        rt.manual_seed(0)
        m = nn.Linear(2, 1)
        opt = opt_cls(m.parameters(), **kw)
        x = rt.randn(128, 2)
        w_true = rt.tensor([[1.5], [-2.0]])
        y = x @ w_true
        for _ in range(steps):
            opt.zero_grad()
            loss = F.mse_loss(m(x), y)
            loss.backward()
            opt.step()
        return float(loss.numpy())

    def test_sgd_momentum(self):
        assert self._fit(optim.SGD, lr=0.05, momentum=0.9) < 1e-3

    def test_adam(self):
        assert self._fit(optim.Adam, lr=0.05) < 1e-3

    def test_adamw(self):
        assert self._fit(optim.AdamW, lr=0.05, weight_decay=0.0) < 1e-3

    def test_adafactor(self):
        assert self._fit(optim.Adafactor, lr=0.05, steps=400) < 1e-2

    def test_adam_matches_reference_formula(self):
        p = rt.tensor([1.0], requires_grad=True)
        opt = optim.Adam([p], lr=0.1)
        (p * 3.0).sum().backward()
        opt.step()
        # after one step, update = -lr * mhat/(sqrt(vhat)+eps) ≈ -lr
        np.testing.assert_allclose(float(p.numpy()[0]), 1.0 - 0.1,
                                   rtol=1e-4)

    def test_state_dict_roundtrip(self):
        m = nn.Linear(3, 3)
        opt = optim.Adam(m.parameters(), lr=0.1)
        F.mse_loss(m(rt.randn(4, 3)), rt.randn(4, 3)).backward()
        opt.step()
        sd = opt.state_dict()
        opt2 = optim.Adam(m.parameters(), lr=0.1)
        opt2.load_state_dict(sd)
        assert len(opt2.state) == len(opt.state)


@pytest.mark.parametrize("foreach", [False, True])
@pytest.mark.parametrize("kw", [dict(lr=1e-2),
                                dict(lr=3e-2, decay=0.5, clip_threshold=0.5,
                                     weight_decay=1e-2)])
def test_adafactor_matches_reference(foreach, kw):
    """Factored (2-D, 3-D) and unfactored (1-D) leaves, 4 steps of the
    same gradients, as large as the RMS clip bites: parameters and
    factored moments equal the reference's."""
    res = []
    for P, O in ((repro, joptim), (rt, optim)):
        P.manual_seed(3)
        ps = [P.randn(16, 8, requires_grad=True),
              P.randn(2, 4, 3, requires_grad=True),
              P.randn(8, requires_grad=True)]
        opt = O.Adafactor(ps, foreach=foreach, **kw)
        for s in range(4):
            rng = np.random.default_rng(s)
            for p in ps:
                p.grad = P.tensor(rng.standard_normal(
                    p.shape, dtype=np.float32) * (10.0 if s == 2 else 1.0))
            opt.step()
        fac = [opt.state[id(p)]["fac"] for p in ps]
        res.append(([np.asarray(p.numpy()) for p in ps],
                    [{k: np.asarray(v) for k, v in f.items()} for f in fac]))
    (jp, jf), (tp, tf) = res
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    for a, b in zip(tf, jf):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k].cpu().numpy() if isinstance(
                a[k], torch.Tensor) else a[k], b[k], rtol=1e-6, atol=1e-12)


def test_cosine_schedule_matches_reference():
    jf = joptim.cosine_schedule(0.1, 10, 100, min_ratio=0.05)
    tf = optim.cosine_schedule(0.1, 10, 100, min_ratio=0.05)
    steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]
    got = [float(tf(s)) for s in steps]
    np.testing.assert_allclose(got, [float(jf(s)) for s in steps],
                               rtol=1e-6)
    assert float(tf(torch.tensor(50))) == got[6]
    # a schedule drives an optimizer's lr, as launch.train's does
    p = rt.tensor([1.0], requires_grad=True)
    opt = optim.SGD([p], lr=float(tf(0)))
    for s in range(3):
        opt.param_groups[0]["lr"] = float(tf(s))
        p.grad = rt.tensor([1.0])
        opt.step()
    np.testing.assert_allclose(float(p.numpy()[0]),
                               1.0 - sum(got[:2]) - float(tf(2)),
                               rtol=1e-6)


def _attention_inputs(rng, dtype, mask_kind, heads_in_mask):
    q = rng.standard_normal((2, 4, 9, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 11, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 11, 16)).astype(np.float32)
    shape = (2, 4 if heads_in_mask else 1, 9, 11)
    if mask_kind == "bool":
        mask = rng.random(shape) > 0.3
        mask[..., -1] = True           # every query sees a key
    else:
        mask = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    return q, k, v, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind", ["bool", "float"])
@pytest.mark.parametrize("heads_in_mask", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_masked_sdpa_matches_reference(dtype, mask_kind, heads_in_mask,
                                       causal):
    """The masked path (GQA 4:2, Sq 9 against Skv 11) against the
    reference's ``sdpa`` with the same mask, bool or additive."""
    q, k, v, mask = _attention_inputs(np.random.default_rng(21), dtype,
                                      mask_kind, heads_in_mask)
    jd = getattr(jnp, dtype)
    exp = JA.sdpa(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                  mask=jnp.asarray(mask), is_causal=causal)
    td = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    out = TA.sdpa(*args, mask=torch.from_numpy(mask), is_causal=causal)
    assert out.dtype == td
    got = out.float().numpy()
    ref = np.asarray(exp.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - ref) <= 1e-2 + 1e-2 * np.abs(ref))
    # the masked path is its own function: the oracle by name agrees
    oracle = TA.sdpa_ref(*args, mask=torch.from_numpy(mask),
                         is_causal=causal)
    np.testing.assert_allclose(got, oracle.float().numpy(), rtol=1e-5,
                               atol=1e-5 if dtype == "float32" else 1e-2)


def test_masked_sdpa_through_the_functional_surface():
    """``F.scaled_dot_product_attention`` with ``attn_mask`` takes the
    masked path, differentiably: its tape gradients equal those of the
    oracle's torch autograd."""
    q, k, v, mask = _attention_inputs(np.random.default_rng(22), "float32",
                                      "bool", False)
    ts = [rt.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = F.scaled_dot_product_attention(*ts, attn_mask=rt.tensor(mask))
    (out * out).sum().backward()
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ref = TA.sdpa_ref(*leaves, mask=torch.from_numpy(mask))
    grads = torch.autograd.grad((ref * ref).sum(), leaves)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-5)


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_masked_sdpa_matches_cpu(dtype):
    """On the card the masked path computes (it raised before) and
    agrees with the CPU: fp32 within 2e-3 absolute, bf16 within
    ``1e-2 + 1e-2|ref|`` (PERF.md's tiers)."""
    q, k, v, mask = _attention_inputs(np.random.default_rng(23), dtype,
                                      "bool", True)
    td = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    cpu = TA.sdpa(*args, mask=torch.from_numpy(mask)).float()
    cuda = TA.sdpa(*(a.cuda() for a in args),
                   mask=torch.from_numpy(mask).cuda()).float().cpu()
    err = (cuda - cpu).abs()
    if dtype == "float32":
        assert err.max().item() <= 2e-3
    else:
        assert bool((err <= 1e-2 + 1e-2 * cpu.abs()).all())
