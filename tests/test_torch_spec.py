"""The port's ``sample_ref`` and ``DraftModelProposer`` against the JAX
package, and draft-model speculation in the port's engine.

``sample_ref``: greedy rows (and stochastic rows whose filtered support
is one token) give the reference's token exactly.  Elsewhere the two
packages draw different noise by design (the port hashes (seed,
position, lane), the reference folds threefry keys: see
``repro_torch/serving/sampling.py``), so a stochastic row is held to the
reference's host recomputation (tests/test_sampling.py) fed the port's
own uniforms: the same filter, the same Gumbel-max, the same token.

``DraftModelProposer``: the reference's ``propose`` indexes what
``repro.models.lm.forward`` returns as if it were the logits, but
``forward`` returns ``(logits, aux)``, so the reference's proposer
raises a ``TypeError`` at its first call.  The port unpacks the pair.
The parity tests run the reference's own ``propose`` code with
``forward`` narrowed to its logits (``ref_forward_logits``), which is
what that code expects.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as JLM
from repro.serving import sampling as jsampling
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.spec import DraftModelProposer as JDraft
from repro_torch.serving import sampling as tsampling
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.spec import DraftModelProposer as TDraft
from test_sampling import fixed_logits, ref_filter
from torch_port_helpers import tiny_models, to_torch

V = 41


def port_sample(logits, sp, pos):
    return tsampling.sample_ref(to_torch(logits), sp, pos)


def ref_sample(logits, sp, pos):
    return jsampling.sample_ref(jnp.asarray(logits),
                                jsampling.SamplingParams(
                                    sp.temperature, sp.top_k, sp.top_p,
                                    sp.seed), pos)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.5),
                                         (3, 0.8)])
def test_sample_ref_greedy_identical_to_jax(top_k, top_p):
    logits = fixed_logits(seed=top_k + 7, rows=8)
    sp = tsampling.SamplingParams(temperature=0.0, top_k=top_k,
                                  top_p=top_p, seed=4)
    for i, row in enumerate(logits):
        assert port_sample(row, sp, i) == ref_sample(row, sp, i)


def test_sample_ref_single_token_support_identical_to_jax():
    """top_k=1 over tie-free logits, or a top_p small enough to keep only
    the top token: the draw is forced, whatever the noise."""
    rng = np.random.RandomState(3)
    for pos in range(16):
        row = rng.randn(V).astype(np.float32) * 2.0
        for sp in (tsampling.SamplingParams(temperature=1.3, top_k=1,
                                            seed=pos),
                   tsampling.SamplingParams(temperature=0.7, top_p=1e-3,
                                            seed=9)):
            assert port_sample(row, sp, pos) == ref_sample(row, sp, pos)


@pytest.mark.parametrize("temp,top_k,top_p", [(1.0, 0, 1.0), (0.7, 5, 1.0),
                                              (1.5, 0, 0.6), (0.9, 8, 0.9)])
def test_sample_ref_matches_host_gumbel_recomputation(temp, top_k, top_p):
    """The reference's host recomputation (tests/test_sampling.py): keep
    ``ref_filter``'s support, add the Gumbel noise of the same uniforms,
    take the argmax — with the port's position-keyed uniforms."""
    logits = fixed_logits(seed=11, rows=6)
    sp = tsampling.SamplingParams(temperature=temp, top_k=top_k,
                                  top_p=top_p, seed=9)
    for i, row in enumerate(logits):
        pos = 3 * i + 1
        tok = port_sample(row, sp, pos)
        u = tsampling.position_uniforms(torch.tensor([9]),
                                        torch.tensor([pos]), V)
        u = u[0].double().numpy()
        keep = ref_filter(row, temp, top_k, top_p)
        scored = np.where(keep, row / temp - np.log(-np.log(u)), -np.inf)
        assert keep[tok]
        assert tok == int(np.argmax(scored)), f"row {i}"


def test_sample_ref_position_keyed_determinism():
    row = fixed_logits(seed=31, rows=1)[0]
    sp = tsampling.SamplingParams(temperature=1.0, seed=77)
    a = [port_sample(row, sp, pos) for pos in range(8)]
    assert a == [port_sample(row, sp, pos) for pos in range(8)]
    assert len(set(a)) > 1
    assert tsampling.sample_ref(to_torch(row), sp, 5, seed=78) == \
        port_sample(row, tsampling.SamplingParams(temperature=1.0,
                                                  seed=78), 5)


# ----------------------------------------------------------------------
# draft-model speculation
# ----------------------------------------------------------------------

@pytest.fixture
def ref_forward_logits(monkeypatch):
    """The reference's ``forward`` narrowed to its logits, for the
    reference's ``DraftModelProposer.propose`` (module docstring)."""
    forward = JLM.forward
    monkeypatch.setattr(JLM, "forward", lambda *a, **kw: forward(*a, **kw)[0])


@pytest.mark.parametrize("window", [4, 64])
def test_draft_proposer_identical_to_jax(window, ref_forward_logits):
    cfg, params, tcfg, tparams = tiny_models(n_layers=1, seed=5)
    jd = JDraft(cfg, params, window=window)
    td = TDraft(tcfg, tparams, window=window)
    for i, n in enumerate((1, 3, 9, 20)):
        hist = [(3 + 7 * i + 5 * j) % 97 for j in range(n)]
        assert td.propose(hist, 3) == jd.propose(hist, 3)
    assert td.propose([], 3) == [] and td.propose([1, 2], 0) == []


def _prompts():
    return [[(5 + 13 * i + j) % 97 for j in range(n)]
            for i, n in enumerate((6, 11, 4))]


def _serve(eng, n_new=8):
    ids = [eng.submit(p, max_new_tokens=n_new) for p in _prompts()]
    eng.run()
    return [eng.result(i).out_tokens for i in ids]


def test_draft_spec_engine_exact_and_same_acceptance_as_jax(
        ref_forward_logits):
    """spec_k=2 with a 1-layer draft: greedy output equals spec_k=0's, and
    the port's engine proposes and accepts exactly what the reference's
    does (same drafts, same targets)."""
    cfg, params, tcfg, tparams = tiny_models()
    dcfg, dparams, tdcfg, tdparams = tiny_models(n_layers=1, seed=5)
    kw = dict(page_size=4, num_pages=64, max_batch=4)
    plain = _serve(TEngine(tcfg, tparams, device="cpu", **kw))
    teng = TEngine(tcfg, tparams, device="cpu", spec_k=2,
                   proposer=TDraft(tdcfg, tdparams, window=8), **kw)
    assert _serve(teng) == plain
    jeng = JEngine(cfg, params, spec_k=2,
                   proposer=JDraft(dcfg, dparams, window=8), **kw)
    assert _serve(jeng) == plain
    assert teng.metrics["proposed_tokens"] > 0
    for key in ("proposed_tokens", "accepted_tokens", "steps"):
        assert teng.metrics[key] == jeng.metrics[key], key
