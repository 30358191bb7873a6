"""The port's recurrent layers (``repro_torch.nn.rnn``: LSTM, LSTMCell)
against the JAX package's (``repro.nn.rnn``) on the CPU: the same
weights (crossed by ``state_dict``), the same numpy inputs, outputs and
tape gradients at fp32 within 1e-5 (relative and absolute: both sides
sum the same fp32 products in different orders, and the port hoists
every step's input projection into one matmul).  Plus the port of
``tests/test_autograd.py::test_multi_output_node``.
"""

import numpy as np
import pytest

import repro
import repro.nn as jnn
import repro_torch as rt
import repro_torch.nn as tnn
from torch_port_helpers import load_reference_state, port_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cpu")

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, D, H = 3, 5, 6, 4


def run_lstm(P, model, x, state, weights):
    """Forward and backward of ``sum(out * w0) + sum(h * w1) + sum(c *
    w2)``; returns (out, h, c, grads of the input, the state and every
    parameter by name)."""
    xt = P.tensor(x, requires_grad=True)
    st = None
    if state is not None:
        st = tuple(P.tensor(s, requires_grad=True) for s in state)
    out, (h, c) = model(xt, st)
    loss = ((out * P.tensor(weights[0])).sum()
            + (h * P.tensor(weights[1])).sum()
            + (c * P.tensor(weights[2])).sum())
    loss.backward()
    grads = {"x": xt.grad.numpy()}
    if st is not None:
        grads["h0"], grads["c0"] = st[0].grad.numpy(), st[1].grad.numpy()
    grads.update({k: p.grad.numpy() for k, p in model.named_parameters()})
    return out.numpy(), h.numpy(), c.numpy(), grads


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_matches_reference(layers, bidirectional, with_state):
    repro.manual_seed(11)
    jm = jnn.LSTM(D, H, layers, bidirectional=bidirectional)
    tm = tnn.LSTM(D, H, layers, bidirectional=bidirectional)
    load_reference_state(tm, jm)
    assert [k for k, _ in tm.named_parameters()] == \
        [k for k, _ in jm.named_parameters()]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    state = None
    if with_state:
        state = [rng.standard_normal((layers, B, H)).astype(np.float32)
                 for _ in range(2)]
    dirs = 2 if bidirectional else 1
    weights = [rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, S, dirs * H), (layers * dirs, B, H),
                             (layers * dirs, B, H))]
    jo, jh, jc, jg = run_lstm(repro, jm, x, state, weights)
    to, th, tc, tg = run_lstm(rt, tm, x, state, weights)
    np.testing.assert_allclose(to, np.asarray(jo), **TOL)
    np.testing.assert_allclose(th, np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc, np.asarray(jc), **TOL)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], np.asarray(jg[k]), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_cell_matches_reference(with_state):
    repro.manual_seed(13)
    jm, tm = jnn.LSTMCell(D, H), tnn.LSTMCell(D, H)
    load_reference_state(tm, jm)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((B, D)).astype(np.float32)
    hc = [rng.standard_normal((B, H)).astype(np.float32) for _ in range(2)]
    w = [rng.standard_normal((B, H)).astype(np.float32) for _ in range(2)]
    res = []
    for P, m in ((repro, jm), (rt, tm)):
        xt = P.tensor(x, requires_grad=True)
        st = tuple(P.tensor(a, requires_grad=True) for a in hc) \
            if with_state else None
        h, c = m(xt, st)
        ((h * P.tensor(w[0])).sum() + (c * P.tensor(w[1])).sum()).backward()
        out = [np.asarray(h.numpy()), np.asarray(c.numpy()),
               np.asarray(xt.grad.numpy())]
        out += [np.asarray(p.grad.numpy()) for _, p in m.named_parameters()]
        if with_state:
            out += [np.asarray(t.grad.numpy()) for t in st]
        res.append(out)
    for a, b in zip(*res):
        np.testing.assert_allclose(b, a, **TOL)


def test_same_seed_gives_the_reference_weights():
    repro.manual_seed(5)
    jm = jnn.LSTM(D, H, 2, bidirectional=True)
    rt.manual_seed(5)
    tm = tnn.LSTM(D, H, 2, bidirectional=True)
    js, ts = jm.state_dict(), tm.state_dict()
    assert list(js) == list(ts)
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k].data),
                                      err_msg=k)


def test_lstm_is_one_tape_node_per_direction():
    """The recurrence of a layer and direction is one ``lstm`` node with
    three outputs, as the reference's scan is."""
    m = tnn.LSTM(D, H, 2, bidirectional=True)
    out, (h, c) = m(rt.randn(B, S, D, requires_grad=True))
    names = []
    seen, todo = set(), [out.grad_fn, h.grad_fn, c.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        names.append(node.name)
        todo += [t.grad_fn for t in node.inputs if t is not None]
    assert names.count("lstm") == 4
    stats = rt.dispatch_cache_stats()["per_op"]["lstm"]
    assert stats["misses"] == 4          # (layer 0 / 1) x (fwd / reverse)


def test_multi_output_node():
    """``tests/test_autograd.py::test_multi_output_node`` on the port."""
    lstm_in = rt.randn(2, 5, 3, requires_grad=True)
    lstm = tnn.LSTM(3, 4)
    out, (h, c) = lstm(lstm_in)
    (out.sum() + h.sum()).backward()
    assert lstm_in.grad is not None
    assert lstm_in.grad.shape == (2, 5, 3)
