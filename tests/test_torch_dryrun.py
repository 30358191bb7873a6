"""The port's dry run (``repro_torch.launch.dryrun``), roofline, report,
production meshes and kernel oracles, against the JAX package where it
has the same function.

A fake process group lives only in a process of its own: the dry run's
cells spawn theirs (``dryrun.in_process``), and so does the production
mesh check here (``torch_dist_workers.production_meshes_child``); no
group is left in the test process.
"""

import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import torch_dist_workers as W
from repro.configs import get_config as jax_config
from repro.configs import get_shapes as jax_shapes
from repro.kernels import ref as jref
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro_torch import resolve_device
from repro_torch.configs import ARCHS, SkipSpec, get_config, get_shapes
from repro_torch.configs.common import DECODE_32K, PREFILL_32K, TRAIN_4K
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba as MB
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6 as RW
from repro_torch.launch import dryrun, report, roofline

KINDS = {"train": TRAIN_4K, "prefill": PREFILL_32K, "decode": DECODE_32K}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_matches_reference(arch, kind):
    """6·N_active·D from the parameters' shapes, as the reference counts
    it from its own abstract parameters."""
    spec = KINDS[kind]
    want = jroofline.model_flops(jax_config(arch), spec, kind)
    assert roofline.model_flops(get_config(arch), spec, kind) == want


def _records():
    """Record dicts for every non-skipped (arch, shape) but one (the
    MISSING row), with the keys both packages' tables read (the port's
    ``trace_s`` beside the reference's ``compile_s``)."""
    rng = np.random.default_rng(3)
    recs, missing = {}, None
    for arch in ARCHS:
        for shape, spec in get_shapes(arch).items():
            if isinstance(spec, SkipSpec):
                continue
            if missing is None:
                missing = (arch, shape)
                continue
            x = rng.uniform(0.5, 2.0, 8)
            secs = round(float(x[7]) * 10, 2)
            recs[(arch, shape)] = {
                "arch": arch, "shape": shape, "compile_s": secs,
                "trace_s": secs, "memory": {"bytes": float(x[0]) * 1e10},
                "roofline": {
                    "flops_per_device": float(x[1]) * 1e14,
                    "bytes_per_device": float(x[2]) * 1e11,
                    "collective_bytes_per_device": float(x[3]) * 1e9,
                    "compute_s": float(x[4]) * 0.1,
                    "memory_s": float(x[5]) * 0.1,
                    "collective_s": float(x[6]) * 0.1,
                    "dominant": ("compute", "memory",
                                 "collective")[int(x[0] * 10) % 3],
                    "model_flops": float(x[1]) * 2e16,
                    "useful_ratio": float(x[2]) / 3}}
    return recs, missing


def test_report_tables_match_reference():
    """The same lines as the reference's tables on the same records, the
    8 SKIP rows and a MISSING row among them; the dry-run matrix's last
    column is the trace's seconds where the reference's is XLA's
    compile seconds."""
    recs, missing = _records()
    skips = sum(isinstance(s, SkipSpec) for a in ARCHS
                for s in get_shapes(a).values())
    assert skips == 8
    got = report.roofline_table(recs).splitlines()
    want = jreport.roofline_table(recs).splitlines()
    assert got == want
    assert sum("SKIP" in line for line in got) == 8
    assert sum("MISSING" in line for line in got) == 1
    half = {k: r for i, (k, r) in enumerate(sorted(recs.items())) if i % 2}
    got = report.dryrun_table(recs, half).splitlines()
    want = jreport.dryrun_table(recs, half).splitlines()
    assert got[0] == want[0].replace("compile s/m", "trace s/m")
    assert got[1:] == want[1:]
    assert any(f"| {missing[0]} | {missing[1]} | MISSING | MISSING"
               in line for line in got)


def _flash_inputs(dev):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(6, 12, 32, generator=g)
    k = torch.randn(3, 20, 32, generator=g)
    v = torch.randn(3, 20, 32, generator=g)
    return (q.to(dev), k.to(dev), v.to(dev)), {"causal": False,
                                                "scale": 32 ** -0.5}


def _decode_inputs(dev):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 2, 3, 32, generator=g)
    kc = torch.randn(2, 2, 24, 32, generator=g)
    vc = torch.randn(2, 2, 24, 32, generator=g)
    lens = torch.full((2,), 24, dtype=torch.int32)
    return ((q.to(dev), kc.to(dev), vc.to(dev), lens.to(dev)),
            {"scale": 32 ** -0.5})


def _mamba_inputs(dev):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 9, 24, generator=g)
    dt = torch.rand(2, 9, 24, generator=g) * 0.1
    bm = torch.randn(2, 9, 16, generator=g)
    cm = torch.randn(2, 9, 16, generator=g)
    a = -torch.rand(24, 16, generator=g)
    d = torch.randn(24, generator=g)
    return tuple(t.to(dev) for t in (x, dt, bm, cm, a, d)), {}


def _rwkv_inputs(dev):
    g = torch.Generator().manual_seed(3)
    r, k, v = (torch.randn(2, 3, 7, 32, generator=g) for _ in range(3))
    w = torch.rand(2, 3, 7, 32, generator=g) * 0.5 + 0.4
    u = torch.randn(3, 32, generator=g)
    return tuple(t.to(dev) for t in (r, k, v, w, u)), {}


# kernel: (wrapper, plain version, inputs, cost of the wrapper's launch,
# the output shapes of the kernel)
KERNELS = {
    "flash_attention": (
        FA.flash_attention_fwd, FA.flash_attention_plain, _flash_inputs,
        lambda a, kw: FA.flash_cost(*a, kw["scale"], kw["causal"], 0),
        [(6, 12, 32)]),
    "decode_attention": (
        DA.decode_attention_fwd, DA.decode_attention_plain, _decode_inputs,
        lambda a, kw: DA.decode_cost(*a, kw["scale"], 0, False),
        [(2, 2, 3, 32)]),
    "mamba_scan": (
        MB.mamba_scan_fwd, MB.mamba_scan_plain, _mamba_inputs,
        lambda a, kw: MB.mamba_cost(*a, None), [(2, 9, 24), (2, 24, 16)]),
    "rwkv6_scan": (
        RW.rwkv6_scan_fwd, RW.rwkv6_scan_plain, _rwkv_inputs,
        lambda a, kw: RW.rwkv6_cost(*a, None),
        [(2, 3, 7, 32), (2, 3, 32, 32)]),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_formula_counts_the_plain_version(name):
    """The kernel's registered FLOP formula equals ``FlopCounterMode``'s
    count of its plain version, at shapes where that version does the
    kernel's work (no mask, no window, every cache row full), and a call
    of the wrapper under ``FlopCounterMode`` on ``meta`` counts it."""
    wrapper, plain, inputs, cost, _ = KERNELS[name]
    args, kw = inputs("cpu")
    with FlopCounterMode(display=False) as fc:
        plain(*args, **kw)
    flops, nbytes = cost(args, kw)
    assert flops == fc.get_total_flops() > 0
    assert nbytes >= sum(t.numel() * t.element_size() for t in args)
    meta, kw = inputs("meta")
    with FlopCounterMode(display=False) as fc:
        wrapper(*meta, **kw)
    assert fc.get_total_flops() == flops


@pytest.mark.parametrize("name", list(KERNELS))
def test_meta_route_gives_shapes_and_cpu_the_plain_values(name):
    wrapper, plain, inputs, _, shapes = KERNELS[name]
    meta, kw = inputs("meta")
    out = wrapper(*meta, **kw)
    outs = list(out) if isinstance(out, tuple) else [out]
    assert [tuple(t.shape) for t in outs] == shapes
    assert all(t.is_meta for t in outs)
    args, kw = inputs("cpu")
    got, want = wrapper(*args, **kw), plain(*args, **kw)
    got = list(got) if isinstance(got, tuple) else [got]
    want = list(want) if isinstance(want, tuple) else [want]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_resolve_device_names_meta_and_still_needs_cuda(monkeypatch):
    assert resolve_device("meta") == torch.device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(ValueError):
        resolve_device("xpu")


def test_production_meshes():
    """(16, 16) over (data, model) on 256 fake ranks, (2, 16, 16) over
    (pod, data, model) on 512, ``MeshConfigError`` on a group of another
    size; the reference's shapes and names."""
    got = dryrun.in_process(W.production_meshes_child, timeout=240)
    assert got[(256, False)] == ((16, 16), ("data", "model"))
    assert got[(512, True)] == ((2, 16, 16), ("pod", "data", "model"))
    for key in ((256, True), (512, False), (4, False), (4, True)):
        assert got[key][0] == "MeshConfigError", key


MEMORY_KEYS = {"bytes", "temp_bytes", "argument_bytes", "output_bytes",
               "alias_bytes"}
ROOFLINE_KEYS = {"arch", "shape", "mesh", "n_devices", "flops_per_device",
                 "bytes_per_device", "collective_bytes_per_device",
                 "collective_breakdown", "compute_s", "memory_s",
                 "collective_s", "dominant", "model_flops", "useful_ratio",
                 "bytes_per_device_peak", "note"}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_run_cell_gemma(shape):
    """An ``ok`` record with the reference's keys, ``fits_80gb`` and the
    collectives tally; the roofline's MODEL_FLOPS is the reference's."""
    rec = dryrun.run_cell("gemma-2b", shape, "single")
    assert rec["status"] == "ok"
    assert {"arch", "shape", "mesh", "n_devices", "optimizer",
            "accum_steps", "trace_s", "memory", "cost", "roofline",
            "fits_80gb"} <= set(rec)
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["cost"]) == {"flops", "bytes accessed"}
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert rec["n_devices"] == 256 and rec["fits_80gb"] is True
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] < mem["bytes"] < 80e9
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["collectives"]["calls"] > 0
    rl = rec["roofline"]
    spec = jax_shapes("gemma-2b")[shape]
    assert rl["model_flops"] == jroofline.model_flops(
        jax_config("gemma-2b"), spec, spec.kind)
    if shape == "train_4k":
        # the state is updated in place: every argument but the batch
        assert mem["alias_bytes"] > 0.8 * mem["argument_bytes"]


@pytest.mark.parametrize("name", ["jamba", "rwkv6"])
def test_scan_memo_counts_what_the_full_backward_does(name):
    """The memoized Mamba and WKV6 backward (every layer after the first
    replayed) gives the FLOPs, bytes, memory and collectives of running
    each layer's plain backward in full."""
    got = dryrun.in_process(W.scan_memo_child, name, (1, 2), (2, 16),
                            timeout=240)
    memo, full = got[True], got[False]
    assert memo["scan_replays"] > 0 and full["scan_replays"] == 0
    for key in ("memory", "cost", "collectives"):
        assert memo[key] == full[key], key


def _np(seed):
    return np.random.default_rng(seed)


def _pair(a):
    import jax.numpy as jnp
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_ref_flash_attention():
    rng = _np(seed=4)
    q = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 8, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 8, 16)).astype(np.float32)
    for causal, window in ((True, None), (False, None), (True, 3)):
        want = jref.flash_attention(*(_pair(x)[0] for x in (q, k, v)),
                                    causal=causal, window=window)
        got = tref.flash_attention(*(_pair(x)[1] for x in (q, k, v)),
                                   causal=causal, window=window)
        _close(got, want, 1e-5)


def test_ref_decode_attention():
    rng = _np(seed=5)
    q = rng.standard_normal((2, 4, 1, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    for cache_len, window in ((9, None), (np.array([5, 12]), 4)):
        want = jref.decode_attention(*(_pair(x)[0] for x in (q, kc, vc)),
                                     cache_len, window=window)
        got = tref.decode_attention(*(_pair(x)[1] for x in (q, kc, vc)),
                                    torch.as_tensor(cache_len),
                                    window=window)
        _close(got, want, 1e-5)


def test_ref_paged_attention():
    rng = _np(seed=6)
    t, hq, hkv, d, ps, n = 5, 4, 2, 16, 4, 8
    q = rng.standard_normal((t, hq, d)).astype(np.float32)
    kp = rng.standard_normal((n, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n, ps, hkv, d)).astype(np.float32)
    tables = np.array([[3, 1, 5], [0, 7, 2]], dtype=np.int32)
    seg = np.array([0, 0, 1, 1, -1], dtype=np.int32)
    pos = np.array([2, 9, 0, 11, 0], dtype=np.int32)
    want = np.asarray(jref.paged_attention(
        *(_pair(x)[0] for x in (q, kp, vp, tables, seg, pos))))
    got = tref.paged_attention(
        *(_pair(x)[1] for x in (q, kp, vp, tables, seg, pos)))
    live = seg >= 0
    _close(got[live], want[live], 1e-5)


def test_ref_rwkv6_scan():
    rng = _np(seed=7)
    r, k, v = (rng.standard_normal((2, 2, 16, 32)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.4, 0.95, (2, 2, 16, 32)).astype(np.float32)
    u = rng.standard_normal((2, 32)).astype(np.float32)
    want = jref.rwkv6_scan(*(_pair(x)[0] for x in (r, k, v, w, u)))
    got = tref.rwkv6_scan(*(_pair(x)[1] for x in (r, k, v, w, u)))
    for g, w_ in zip(got, want):
        _close(g, w_, 1e-5)


def test_ref_mamba_scan():
    rng = _np(seed=8)
    x = rng.standard_normal((2, 16, 24)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, (2, 16, 24)).astype(np.float32)
    bm = rng.standard_normal((2, 16, 8)).astype(np.float32)
    cm = rng.standard_normal((2, 16, 8)).astype(np.float32)
    a = -rng.uniform(0.5, 1.5, (24, 8)).astype(np.float32)
    d = rng.standard_normal(24).astype(np.float32)
    want = jref.mamba_scan(*(_pair(t)[0] for t in (x, dt, bm, cm, a, d)))
    got = tref.mamba_scan(*(_pair(t)[1] for t in (x, dt, bm, cm, a, d)))
    assert got.shape == (2, 16, 24)
    _close(got, want, 1e-5)


def test_roofline_constants_are_the_h100s():
    """The HBM and FLOP rates are those of chip_smoke.py's kernel bounds;
    the production mesh's axes cross nodes of 8 (InfiniBand), a (2, 2)
    mesh's stay inside one (NVLink)."""
    assert roofline.HBM_BW == 3.35e12
    assert roofline.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12,
                                   "tf32x3": 494.7e12 / 3}
    prod = {"data": 16, "model": 16}
    assert roofline.axis_link_bw(prod, "model") == roofline.IB_BW
    assert roofline.axis_link_bw(prod, "data") == roofline.IB_BW
    small = {"data": 2, "model": 2}
    assert roofline.axis_link_bw(small, "model") == roofline.NVLINK_BW
    assert roofline.axis_link_bw(small, "data") == roofline.NVLINK_BW
    assert math.isclose(roofline.IB_BW, 400e9 / 8)
