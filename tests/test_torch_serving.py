"""Port serving stack against the JAX package: quantization, the paged
KV cache, the scheduler, sampling and the engine end to end; plus the
port's own contracts (no JAX import, CUDA by default, seeded sampling,
exact speculation)."""

import ast
import pathlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import init_params
from repro.serving import quant as jquant
from repro.serving import sampling as jsampling
from repro.kernels import ops as jops
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.kv_cache import PagedKVCache as JKV
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.spec import NgramProposer as JNgram
import repro_torch
from repro_torch.serving import quant as tquant
from repro_torch.serving import sampling as tsampling
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.faults import FaultInjector, FaultSpec
from repro_torch.serving.kv_cache import PagedKVCache as TKV
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Scheduler as TScheduler
from repro_torch.serving.spec import NgramProposer as TNgram
from torch_port_helpers import (port_cfg, port_params, tiny_cfg, to_numpy,
                                to_torch)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ----------------------------------------------------------------------
# quantization
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_quantize_codes_and_scales_match(mode):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 3, 16)) * 2).astype(np.float32)
    x[0, 0] = 0.0                                 # all-zero vector
    x[1, 1, :4] = [0.5, -0.5, 1.5, 2.5]           # round-half-even ties
    jc, js = jquant.quantize(jnp.asarray(x), mode)
    tc, ts = tquant.quantize(to_torch(x), mode)
    assert tc.dtype == tquant.storage_dtype(mode)
    # int8 codes equal exactly; fp8 codes equal as cast (compare values)
    np.testing.assert_array_equal(to_numpy(tc),
                                  np.asarray(jc).astype(np.float32))
    np.testing.assert_array_equal(to_numpy(ts), np.asarray(js))
    np.testing.assert_array_equal(
        to_numpy(tquant.dequantize(tc, ts)),
        np.asarray(jquant.dequantize(jc, js)))
    assert tquant.canonical("fp8") == jquant.canonical("fp8")
    assert tquant.canonical("bf16") is None


# ----------------------------------------------------------------------
# paged KV cache: one op sequence replayed on both packages
# ----------------------------------------------------------------------

def _kv_state(kv):
    p = kv.pool
    return dict(tables=kv.tables, lengths=kv.lengths, refs=p.refs,
                free=p.free, gen=p.gen, filled=p.filled,
                stats=vars(p.stats), reused=kv.reused_prefix)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_kv_cache_replay_matches(kv_dtype):
    kw = dict(n_layers=2, n_kv_heads=2, head_dim=8, page_size=4,
              num_pages=16, kv_dtype=kv_dtype)
    jkv = JKV(dtype=jnp.float32, **kw)
    tkv = TKV(dtype=torch.float32, device="cpu", **kw)
    # the reference pools start as zeros; give both the same content so
    # COW copies and the recover() scrub are visible in the comparison
    rng = np.random.default_rng(1)
    for i in range(2):
        for name in ("k", "v") + (("k_scale", "v_scale") if kv_dtype
                                  else ()):
            ref = getattr(jkv, name)
            data = rng.standard_normal(ref[i].shape).astype(np.float32)
            if name in ("k", "v") and kv_dtype:
                data = np.clip(np.round(data * 40), -127, 127)
            ref[i] = jnp.asarray(data, ref[i].dtype)
            getattr(tkv, name)[i].copy_(to_torch(np.asarray(ref[i])))

    def both(fn):
        a, b = fn(jkv), fn(tkv)
        assert a == b
        assert _kv_state(jkv) == _kv_state(tkv)

    def mirror(seq_ids):
        a = np.asarray(jkv.device_tables(seq_ids, 4))
        b = tkv.device_tables(seq_ids, 4).numpy()
        np.testing.assert_array_equal(a, b)

    prompt = list(range(8))
    both(lambda kv: kv.create(0, prompt))
    both(lambda kv: kv.advance(0, 8))
    both(lambda kv: kv.create(1, prompt + [99, 98]))     # prefix hits
    both(lambda kv: kv.create(2, [5, 6, 7]))
    mirror([0, 1, 2, -1])
    both(lambda kv: kv.ensure_capacity(0, 12))
    both(lambda kv: kv.make_writable(1, 6, 9, divergent=True))  # COW
    both(lambda kv: kv.truncate(0, 9))
    mirror([0, 1, 2, -1])                                   # delta rows
    both(lambda kv: kv.quarantine_seq(2))
    both(lambda kv: kv.recover())                        # scrub page
    both(lambda kv: kv.free_seq(1))
    both(lambda kv: kv.create(3, prompt))                # stale-gen hit
    mirror([3, 0, -1, -1])
    for a, b in zip(jkv.k + jkv.v, tkv.k + tkv.v):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      to_numpy(b))
    if kv_dtype is not None:
        for a, b in zip(jkv.k_scale + jkv.v_scale,
                        tkv.k_scale + tkv.v_scale):
            np.testing.assert_array_equal(np.asarray(a), to_numpy(b))
    assert jkv.memory_stats() == tkv.memory_stats()


def test_take_kv_is_single_owner():
    kv = TKV(n_layers=1, n_kv_heads=1, head_dim=8, num_pages=4,
             device="cpu")
    ks, vs = kv.take_kv()
    with pytest.raises(AssertionError):
        kv.take_kv()
    kv.put_kv(ks, vs)
    assert kv.k[0] is ks[0]


# ----------------------------------------------------------------------
# scheduler: the same StepPlans for the same submits
# ----------------------------------------------------------------------

PLAN_FIELDS = ("slot_seqs", "tokens", "seg_ids", "positions", "write_idx",
               "sample_idx", "sample_pos", "temps", "top_ks", "top_ps",
               "seeds", "n_tokens", "t_bucket", "p_bucket")


def test_scheduler_plans_match():
    kw = dict(n_layers=1, n_kv_heads=1, head_dim=8, page_size=4,
              num_pages=24)
    jkv, tkv = JKV(dtype=jnp.float32, **kw), TKV(device="cpu", **kw)
    js = JScheduler(jkv, max_batch=3, chunk_size=6, spec_k=2,
                    proposer=JNgram())
    ts = TScheduler(tkv, max_batch=3, chunk_size=6, spec_k=2,
                    proposer=TNgram())
    rng = random.Random(2)
    prompts = [[rng.randrange(20) for _ in range(n)] for n in (9, 4, 13, 7)]
    prompts.append(prompts[0][:8] + [1, 2])          # shares a prefix
    for i, p in enumerate(prompts):
        js.submit(p, 6, sampling=jsampling.SamplingParams(seed=i))
        ts.submit(p, 6, sampling=SamplingParams(seed=i))
    steps = 0
    while True:
        jp, tp = js.plan(), ts.plan()
        assert (jp is None) == (tp is None)
        if jp is None:
            break
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                          np.asarray(getattr(tp, f)), f)
        assert [(s.req.req_id, s.start, s.end, s.drafts)
                for s in jp.spans] == [(s.req.req_id, s.start, s.end,
                                        s.drafts) for s in tp.spans]
        # a fake model: cycles so the n-gram drafts get accepted too
        nxt = ((jp.sample_pos[:, None] + np.arange(3)[None]) % 5
               ).astype(np.int32)
        js.commit(jp, nxt)
        ts.commit(tp, nxt)
        steps += 1
    assert steps > 5 and js.metrics == ts.metrics
    assert {i: r.out_tokens for i, r in js.done.items()} == \
        {i: r.out_tokens for i, r in ts.done.items()}


# ----------------------------------------------------------------------
# sampling
# ----------------------------------------------------------------------

def _sampling_rows():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((6, 50)) * 2).astype(np.float32)
    logits[1, 5] = logits[1, 7] = logits[1].max() + 1.0   # a top-k tie
    temps = np.array([0.0, 0.7, 1.0, 1.3, 0.9, 2.0], np.float32)
    top_ks = np.array([0, 2, 5, 0, 50, 1], np.int32)
    top_ps = np.array([1.0, 1.0, 0.9, 0.5, 0.3, 1.0], np.float32)
    return logits, temps, top_ks, top_ps


def test_filter_logits_matches():
    logits, temps, top_ks, top_ps = _sampling_rows()
    exp = np.asarray(jax.vmap(jsampling.filter_logits)(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps)))
    out = to_numpy(tsampling.filter_logits(
        to_torch(logits), to_torch(temps), to_torch(top_ks),
        to_torch(top_ps)))
    neg = np.finfo(np.float32).min
    np.testing.assert_array_equal(out == neg, exp == neg)
    np.testing.assert_allclose(out, exp, rtol=1e-6, atol=0)


def test_sample_tokens_with_injected_uniforms_matches():
    logits, temps, top_ks, top_ps = _sampling_rows()
    u = np.random.default_rng(4).uniform(1e-20, 1, logits.shape).astype(
        np.float32)
    filt = jax.vmap(jsampling.filter_logits)(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps))
    pert = jops.gumbel_perturb(filt, jnp.asarray(u))
    exp = np.where(temps > 0, np.asarray(jnp.argmax(pert, -1)),
                   np.argmax(logits, -1))
    out = tsampling.sample_tokens(
        to_torch(logits), to_torch(temps), to_torch(top_ks),
        to_torch(top_ps), torch.zeros(6, dtype=torch.int64),
        torch.arange(6), uniform=to_torch(u))
    np.testing.assert_array_equal(out.numpy(), exp)


def _keyed_rows():
    logits, temps, top_ks, top_ps = (to_torch(a) for a in _sampling_rows())
    seeds = torch.tensor([3, 3, 11, 2 ** 35, -4, 9])
    positions = torch.tensor([5, 6, 5, 130, 7, 2 ** 32 + 1])
    return logits, temps, top_ks, top_ps, seeds, positions


def test_sample_tokens_keyed_equals_injected_position_uniforms():
    """Without ``uniform`` the keyed perturbation draws the same tokens
    as the uniform one fed ``position_uniforms`` of the same keys."""
    logits, temps, top_ks, top_ps, seeds, positions = _keyed_rows()
    keyed = tsampling.sample_tokens(logits, temps, top_ks, top_ps, seeds,
                                    positions)
    u = tsampling.position_uniforms(seeds, positions, logits.shape[1])
    fed = tsampling.sample_tokens(logits, temps, top_ks, top_ps, seeds,
                                  positions, uniform=u)
    assert torch.equal(keyed, fed)


def test_sample_tokens_draws_its_noise_in_the_keyed_kernel(monkeypatch):
    """``uniform=None`` goes through ``gumbel_perturb_keyed`` once and
    never through ``gumbel_perturb`` with a uniform tensor: the (R, V)
    uniforms are not made on the serving path."""
    from repro_torch.kernels import ops as kops
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        monkeypatch.setattr(kops, name, wrapped)
    spy("gumbel_perturb_keyed", kops.gumbel_perturb_keyed)
    spy("gumbel_perturb", kops.gumbel_perturb)
    logits, temps, top_ks, top_ps, seeds, positions = _keyed_rows()
    tsampling.sample_tokens(logits, temps, top_ks, top_ps, seeds,
                            positions)
    assert calls == ["gumbel_perturb_keyed"]
    tsampling.sample_tokens(logits, temps, top_ks, top_ps, seeds,
                            positions, uniform=torch.full_like(logits, 0.5))
    assert calls == ["gumbel_perturb_keyed", "gumbel_perturb"]


def test_position_uniforms_depend_on_seed_and_position_only():
    seeds = torch.tensor([7, 7, 8, 7])
    pos = torch.tensor([3, 4, 3, 3])
    u = tsampling.position_uniforms(seeds, pos, 1000)
    assert u.dtype == torch.float32 and (u > 0).all() and (u < 1).all()
    torch.testing.assert_close(u[0], u[3], rtol=0, atol=0)
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    alone = tsampling.position_uniforms(seeds[1:2], pos[1:2], 1000)
    torch.testing.assert_close(alone[0], u[1], rtol=0, atol=0)
    assert abs(float(u.mean()) - 0.5) < 0.02


# ----------------------------------------------------------------------
# the engine end to end
# ----------------------------------------------------------------------

def _prompts():
    rng = random.Random(5)
    ps = [[rng.randrange(97) for _ in range(n)] for n in (5, 23, 9, 14)]
    ps.append(ps[1][:16] + [3, 4, 5])              # shared 4-page prefix
    return ps


def _run(engine, prompts, n_new=8, sampling=None):
    ids = [engine.submit(p, max_new_tokens=n_new, sampling=sampling)
           for p in prompts]
    engine.run()
    return [engine.result(i).out_tokens for i in ids]


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg()
    params = init_params(cfg, jax.random.key(0))
    return cfg, params, port_cfg(cfg), port_params(cfg, params)


@pytest.mark.parametrize("spec_k", [0, 2])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_greedy_tokens_identical_to_jax(tiny, kv_dtype, spec_k):
    cfg, params, tcfg, tparams = tiny
    kw = dict(page_size=4, num_pages=64, max_batch=4, kv_dtype=kv_dtype,
              spec_k=spec_k)
    exp = _run(JEngine(cfg, params, **kw), _prompts())
    eng = TEngine(tcfg, tparams, device="cpu", **kw)
    assert _run(eng, _prompts()) == exp
    m = eng.metrics
    assert m["bucket_compiles"] <= eng.bucket_count
    assert m["kv_dtype"] == (kv_dtype or "float32")
    assert m["failed_requests"] == 0


def test_engine_seeded_sampling_reproducible_and_spec_exact(tiny):
    _, _, tcfg, tparams = tiny
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=11)
    kw = dict(page_size=4, num_pages=64, max_batch=4, sampling=sp)
    a = _run(TEngine(tcfg, tparams, device="cpu", **kw), _prompts(), 10)
    b = _run(TEngine(tcfg, tparams, device="cpu", **kw), _prompts(), 10)
    spec = TEngine(tcfg, tparams, device="cpu", spec_k=3, **kw)
    c = _run(spec, _prompts(), 10)
    greedy = _run(TEngine(tcfg, tparams, device="cpu", page_size=4,
                          num_pages=64, max_batch=4), _prompts(), 10)
    assert a == b == c
    assert a != greedy
    assert spec.metrics["proposed_tokens"] > 0


def test_engine_quarantines_nan_request(tiny):
    _, _, tcfg, tparams = tiny
    faults = FaultInjector([FaultSpec("nan_logits", step=4, seq=1)])
    eng = TEngine(tcfg, tparams, device="cpu", page_size=4, num_pages=64,
                  max_batch=4, faults=faults)
    ids = [eng.submit(p, max_new_tokens=8) for p in _prompts()[:3]]
    eng.run()
    assert faults.injected == 1
    assert eng.metrics["failed_requests"] == 1
    assert [eng.scheduler.done[i].state.value for i in ids] == \
        ["finished", "failed", "finished"]


# ----------------------------------------------------------------------
# the port's own contracts
# ----------------------------------------------------------------------

def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{f.relative_to(ROOT)}: {n}")
    assert not bad, bad


def test_entry_points_need_cuda_unless_cpu_asked(tiny, monkeypatch):
    _, _, tcfg, tparams = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError):
        TEngine(tcfg, tparams, num_pages=16)
    with pytest.raises(RuntimeError):
        TKV(n_layers=1, n_kv_heads=1, head_dim=8, num_pages=4)
    eng = TEngine(tcfg, tparams, num_pages=16, device="cpu")
    assert eng.device.type == "cpu"
    # data replicas serve (no longer refused); a bad count still raises
    eng = TEngine(tcfg, tparams, num_pages=16, n_replicas=2, device="cpu")
    assert eng.device.type == "cpu" and eng.n_replicas == 2
    assert eng.kv.pool.num_pages == 32
    with pytest.raises(ValueError):
        TEngine(tcfg, tparams, num_pages=16, n_replicas=0, device="cpu")
