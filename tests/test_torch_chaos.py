"""The reference's deterministic fault-injection chaos matrix
(tests/test_chaos.py) replayed on the port's engine on the CPU.

Every scenario injects a scheduled fault from
``repro_torch.serving.faults`` into a live continuous-batching engine and
gates on graceful degradation:

  * every HEALTHY request finishes with its full token budget,
  * the faulted request retires FAILED (pages freed, error recorded)
    — one request fails, never the step loop,
  * ``watchdog_trips == injected`` for the quarantine fault classes
    (nan_logits / executor_crash / table_corruption) and ``== 0`` for
    pool_exhaustion (absorbed by backpressure + preemption alone),
  * refcount conservation holds after recovery: the pool drains to
    empty (``allocated == freed``, zero live refs),
  * no zero-decode step ever happens while decodable sequences exist.

The matrix is seeded and fixed — the same (spec, seed) always picks the
same victim at the same step; the port's engine picks the reference
engine's victim.  The weights are the reference's, carried across.
"""

import jax
import jax.numpy as jnp
import pytest

from repro.models.lm import LMConfig, init_params
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.faults import FaultInjector as JFaultInjector
from repro.serving.faults import FaultSpec as JFaultSpec
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.errors import FaultInjected, RequestFailed
from repro_torch.serving.faults import FaultInjector, FaultSpec
from repro_torch.serving.scheduler import RequestState
from torch_port_helpers import port_cfg, port_params

CFG = LMConfig(name="chaos-tiny", n_layers=2, d_model=64, n_heads=4,
               n_kv_heads=2, d_ff=128, vocab_size=97,
               param_dtype=jnp.float32, remat="none", attn_backend="ref")
TCFG = port_cfg(CFG)

QUARANTINE_KINDS = ("nan_logits", "executor_crash", "table_corruption")
SEEDS = (0, 1)


@pytest.fixture(scope="module")
def jparams():
    return init_params(CFG, jax.random.key(0))


@pytest.fixture(scope="module")
def params(jparams):
    return port_params(CFG, jparams)


def make_engine(params, faults=None, **kw):
    kw.setdefault("page_size", 4)
    kw.setdefault("num_pages", 64)
    kw.setdefault("max_batch", 4)
    kw.setdefault("watchdog_interval", 1)    # audit every step
    return ServingEngine(TCFG, params, faults=faults, device="cpu", **kw)


def serve(eng, n=6, max_new=6):
    prompts = [[(7 + 13 * i + j) % 97 for j in range(10)]
               for i in range(n)]
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = {r.req_id: r for r in eng.run()}
    return rids, done


def assert_drained(eng):
    st = eng.kv.pool.stats
    assert st.allocated_pages == st.freed_pages
    assert len(eng.kv.pool.refs) == 0
    assert eng.kv.pool.num_free == eng.kv.pool.num_pages
    assert eng.kv.external_refs == {}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", QUARANTINE_KINDS)
def test_single_fault_fails_one_request_not_the_loop(params, kind, seed):
    inj = FaultInjector([FaultSpec(kind, step=6)], seed=seed)
    eng = make_engine(params, faults=inj)
    rids, done = serve(eng)
    assert inj.injected == 1
    failed = [r for r in eng.aborted if r.state is RequestState.FAILED]
    assert len(failed) == 1
    assert failed[0].error                   # cause recorded
    assert len(done) == len(rids) - 1        # every healthy one finished
    for r in done.values():
        assert len(r.out_tokens) == 6        # full budget, no truncation
    assert eng.metrics["watchdog_trips"] == inj.injected
    assert eng.metrics["zero_decode_steps"] == 0
    with pytest.raises(RequestFailed):
        eng.result(failed[0].req_id)
    assert_drained(eng)


@pytest.mark.parametrize("seed", SEEDS)
def test_pool_exhaustion_absorbed_without_failures(params, seed):
    """Stealing EVERY free page mid-serve must cost only latency:
    backpressure + preemption absorb it, no request fails, and the
    watchdog stays silent (external holds are accounted refs, not
    leaks)."""
    inj = FaultInjector([FaultSpec("pool_exhaustion", step=4,
                                   hold_steps=6)], seed=seed)
    eng = make_engine(params, faults=inj, num_pages=32)
    rids, done = serve(eng)
    assert inj.injected == 1
    assert len(done) == len(rids)            # nobody failed, just delayed
    assert eng.aborted == []
    assert eng.metrics["watchdog_trips"] == 0
    assert eng.metrics["zero_decode_steps"] == 0
    assert_drained(eng)


def test_combined_fault_storm(params):
    """Three distinct fault classes in one serve: three requests fail
    (one per fault), everyone else finishes, trips match injections."""
    inj = FaultInjector.parse(
        "nan_logits@5;executor_crash@9;table_corruption@13", seed=0)
    eng = make_engine(params, faults=inj)
    rids, done = serve(eng, n=8, max_new=8)
    assert inj.injected == 3
    failed = [r for r in eng.aborted if r.state is RequestState.FAILED]
    assert len(failed) == 3
    assert len({r.req_id for r in failed}) == 3   # distinct victims
    assert len(done) == len(rids) - 3
    assert eng.metrics["watchdog_trips"] == inj.injected
    assert eng.metrics["executor_failures"] == 1
    assert eng.metrics["zero_decode_steps"] == 0
    assert_drained(eng)


def test_same_seed_same_victim(params, jparams):
    """Determinism: identical (spec, seed) picks the identical victim —
    chaos failures must bisect, not flake — and the reference engine,
    given the same spec and seed, picks the same one."""
    def run_once(engine, injector, spec, p, **kw):
        inj = injector([spec("executor_crash", step=7)], seed=3)
        eng = engine(p, faults=inj, page_size=4, num_pages=64,
                     max_batch=4, watchdog_interval=1, **kw)
        serve(eng)
        failed = [r for r in eng.aborted
                  if r.state.value == RequestState.FAILED.value]
        assert len(failed) == 1
        return failed[0].req_id

    def port(p, **kw):
        return ServingEngine(TCFG, p, device="cpu", **kw)

    def ref(p, **kw):
        return JEngine(CFG, p, **kw)

    victim = run_once(port, FaultInjector, FaultSpec, params)
    assert victim == run_once(port, FaultInjector, FaultSpec, params)
    assert victim == run_once(ref, JFaultInjector, JFaultSpec, jparams)


class TestSpecGrammar:
    def test_parse_spec_string(self):
        inj = FaultInjector.parse(
            "pool_exhaustion@4:pages=8,hold=6; nan_logits@9:seq=2",
            seed=5)
        assert [(s.kind, s.step) for s in inj.specs] == [
            ("pool_exhaustion", 4), ("nan_logits", 9)]
        assert inj.specs[0].pages == 8
        assert inj.specs[0].hold_steps == 6
        assert inj.specs[1].seq == 2

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            FaultInjector.parse("meteor_strike@3")

    def test_fault_injected_is_typed(self):
        e = FaultInjected("boom", req_id=7)
        assert isinstance(e, RequestFailed)
        assert e.req_id == 7


def test_corrupted_table_never_reaches_the_device():
    """A page id outside the pool in a host table goes up to the device
    mirror as page 0 (the port's paged kernel would read outside the
    page tensors; the watchdog then quarantines the sequence)."""
    import torch
    from repro_torch.serving.kv_cache import PagedKVCache
    kv = PagedKVCache(n_layers=1, n_kv_heads=1, head_dim=8, page_size=4,
                      num_pages=8, dtype=torch.float32, device="cpu")
    assert kv.create(0, list(range(10)))
    good = list(kv.tables[0])
    kv.tables[0][-1] = kv.pool.num_pages + 3
    kv._bump(0)
    row = kv.device_tables([0], 4)[0].tolist()
    assert row == good[:2] + [0, 0]
