"""Sharded serving, DDP and the pipeline, on gloo ranks on the CPU.

Each group of ranks is started by ``repro_torch.launch.mesh.run_ranks``
(``torch.multiprocessing`` spawn, a file rendezvous in a temporary
directory, every group joined under a timeout); the rank functions are
in ``tests/torch_dist_workers.py``, which imports no JAX.  One group of
1, 2 and 4 ranks each runs every check of its size, once for the file.

  * The meshed engine against the port's no-mesh engine, on the
    reference's ``TestShardedParity`` workload (tiny config, 4 heads):
    (1,1), (2,1), (1,2) and (2,2), greedy and sampled (temperature 0.8,
    top_k 20, seed 42), with 2 KV heads (heads split over ``model``) and
    with 1 (at tp = 2 the context-parallel branch: pages over ``model``,
    partials merged by their log-sum-exps).  The reference's own meshed
    engine fails on every mesh (ROADMAP.md queue C), so it is no oracle;
    the port is held to the JAX package through ``n_replicas``: the
    port's ``n_replicas=2`` equals its ``n_replicas=1`` and the JAX
    package's ``n_replicas=2`` (greedy, with the same per-replica page
    high-water marks).
  * A meshed pool's host writes, copy-on-write (across model ranks when
    the pages are split) and ``gather`` read back what was written.
  * ``merge_attention_partials`` over two halves of the keys equals the
    whole within 1e-5; the plain lse is ``torch.logsumexp`` of the
    masked logits.
  * DDP's synced gradients (2 ranks, each half of the batch) equal one
    process's full-batch gradient within 1e-5; its int8 compression is
    the JAX package's ``_compress_int8`` on the same buffer.
  * ``pipeline_apply`` (4 stages of ``tanh(x @ w)``, 4 microbatches)
    equals the sequential composition and the JAX package's
    ``pipeline_apply`` (a subprocess with 4 forced host devices) within
    the reference's 2e-4 / 2e-5.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from repro_torch.distributed.ddp import _compress_int8
from repro_torch.distributed.pipeline import stages_from_groups
from repro_torch.kernels import decode_attention as DA
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import lm as TLM
from repro_torch.models.attention import merge_attention_partials
from torch_port_helpers import cuda_device, requires_cuda  # noqa: F401

GROUP_TIMEOUT = 240          # seconds a group of ranks may take
KV_HEADS = (2, 1)
DDP_WIDTH = 64
PIPE = dict(width=16, batch=32, n_micro=4)


@pytest.fixture(scope="module")
def groups():
    """Every check's rank results, by world size: one group of 1, 2 and
    4 gloo ranks each."""
    one = run_ranks(W.jobs_rank, 1, ([
        ("mesh_parity_rank", ([(1, 1)], KV_HEADS)),
        ("mesh_basics_rank", ())],), backend="gloo", timeout=GROUP_TIMEOUT)
    two = run_ranks(W.jobs_rank, 2, ([
        ("mesh_parity_rank", ([(2, 1), (1, 2)], KV_HEADS)),
        ("kv_gather_rank", ([(2, 1), (1, 2)], KV_HEADS)),
        ("ddp_rank", (DDP_WIDTH, "cpu"))],), backend="gloo",
        timeout=GROUP_TIMEOUT)
    four = run_ranks(W.jobs_rank, 4, ([
        ("mesh_parity_rank", ([(2, 2)], KV_HEADS)),
        ("kv_gather_rank", ([(2, 2)], KV_HEADS)),
        ("pipeline_rank", (PIPE["width"], PIPE["batch"], PIPE["n_micro"],
                           "cpu"))],), backend="gloo",
        timeout=GROUP_TIMEOUT)
    return {1: one, 2: two, 4: four}


@pytest.fixture(scope="module")
def no_mesh():
    """The port's single-process engine on the same workload."""
    out = {}
    for hkv in KV_HEADS:
        cfg = W.tiny_port_cfg(hkv)
        params = TLM.init_params(cfg, seed=0, device="cpu")
        for sampled in (False, True):
            out[(hkv, sampled)] = W.serve_parity(cfg, params,
                                                 sampled=sampled)[0]
    return out


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("hkv", KV_HEADS)
@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_mesh_matches_no_mesh(groups, no_mesh, shape, hkv, sampled):
    """Every rank of every mesh commits the no-mesh engine's finished
    outputs; the context-parallel branch (1 KV head over tp = 2) merges
    partials, the others never do."""
    world = shape[0] * shape[1]
    for rank, res in enumerate(groups[world]):
        got = res["mesh_parity_rank"][(shape, hkv, sampled)]
        assert got["outs"] == no_mesh[(hkv, sampled)], (shape, rank)
        assert got["n_replicas"] == shape[0]
        assert len(got["page_hwm_per_replica"]) == shape[0]
        context_parallel = hkv % shape[1] != 0
        assert (got["lse_merges"] > 0) == context_parallel


def test_mesh_shards_the_pool(groups):
    """A rank's pool bytes: the replica's pages over ``data``, and halved
    again over ``model`` (heads or pages)."""
    base = groups[1][0]["mesh_parity_rank"][((1, 1), 2, False)]["kv_bytes"]
    for shape, world in (((2, 1), 2), ((1, 2), 2), ((2, 2), 4)):
        for hkv in KV_HEADS:
            one = groups[1][0]["mesh_parity_rank"][((1, 1), hkv, False)]
            got = groups[world][0]["mesh_parity_rank"][(shape, hkv, False)]
            assert got["kv_bytes"] * shape[1] == one["kv_bytes"]
    assert base > 0


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_meshed_pool_writes_copies_and_gathers(groups, shape):
    """Every rank reads back through ``gather`` exactly the K/V written
    through the host path, after a copy-on-write, in each placement
    (pages of a replica over ``data``; heads, or for 1 KV head the pages,
    over ``model``)."""
    world = shape[0] * shape[1]
    modes = set()
    for res in groups[world]:
        for hkv in KV_HEADS:
            r = res["kv_gather_rank"][(shape, hkv)]
            modes.add(r["mode"])
            for sid, (k, v) in r["written"].items():
                gk, gv, n = r["got"][sid]
                assert n == k.shape[0]
                assert torch.equal(gk[:n], k) and torch.equal(gv[:n], v)
    assert modes == ({"full"} if shape[1] == 1 else {"heads", "pages"})


def test_mesh_for_serving_in_a_group(groups):
    res = groups[1][0]["mesh_basics_rank"]
    assert res["shape"] == {"data": 1, "model": 1}
    assert res["info"] == {"axis_names": ("data", "model"),
                           "shape": {"data": 1, "model": 1},
                           "n_devices": 1}
    assert res["refused"] == [(2, 1), (1, 2), (0, 1)]
    assert res["coords"] == {"data": 0, "model": 0}


def test_replicas_match_one_replica_and_jax():
    """n_replicas=2 on one device: one paged launch serves both replicas;
    greedy tokens equal n_replicas=1's and the JAX package's
    n_replicas=2 (and its per-replica page high-water marks); sampled
    tokens equal the port's n_replicas=1."""
    import jax.numpy as jnp
    from repro.models.lm import LMConfig, init_params
    from repro.serving.engine import ServingEngine as JEngine
    from torch_port_helpers import port_cfg, port_params
    jcfg = LMConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_ff=128, vocab_size=97,
                    param_dtype=jnp.float32, remat="none",
                    attn_backend="ref")
    jparams = init_params(jcfg, jax.random.key(0))
    cfg, params = port_cfg(jcfg), port_params(jcfg, jparams)
    one, _ = W.serve_parity(cfg, params)
    two, m = W.serve_parity(cfg, params, n_replicas=2)
    assert two == one
    assert m["n_replicas"] == 2 and len(m["page_hwm_per_replica"]) == 2

    eng = JEngine(jcfg, jparams, n_replicas=2, **W.PARITY_ENGINE)
    ids = [eng.submit(p, max_new_tokens=8) for p in W.parity_requests()]
    fin = {r.req_id: r.out_tokens for r in eng.run()}
    assert [fin[i] for i in ids] == two
    assert eng.metrics["page_hwm_per_replica"] == m["page_hwm_per_replica"]
    one_s, _ = W.serve_parity(cfg, params, sampled=True)
    two_s, _ = W.serve_parity(cfg, params, sampled=True, n_replicas=2)
    assert two_s == one_s


def _attention_case(seed=21, t=12, hkv=2, g=2, length=40, d=16):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(t, hkv, g, d, generator=gen)
    k = torch.randn(3, hkv, length, d, generator=gen)
    v = torch.randn(3, hkv, length, d, generator=gen)
    seg = torch.randint(0, 3, (t,), generator=gen, dtype=torch.int32)
    pos = torch.randint(0, length, (t,), generator=gen, dtype=torch.int32)
    return q, k, v, seg, pos


def test_merge_attention_partials_over_two_halves():
    """Attention over keys [0, L/2) and [L/2, L) separately, each with its
    lse (a token before the second half sees none of it: -inf), merged,
    equals attention over all L keys within 1e-5."""
    q, k, v, seg, pos = _attention_case()
    half = k.shape[2] // 2
    whole = DA.mixed_attention_plain(q, k, v, seg, pos, scale=0.25)
    o1, l1 = DA.mixed_attention_plain(
        q, k[:, :, :half], v[:, :, :half], seg,
        torch.clamp(pos, max=half - 1), scale=0.25, return_lse=True)
    o2, l2 = DA.mixed_attention_plain(
        q, k[:, :, half:], v[:, :, half:], seg, pos - half, scale=0.25,
        return_lse=True)
    assert bool(torch.isneginf(l2[pos < half]).all())
    merged = merge_attention_partials([o1, o2], [l1, l2])
    torch.testing.assert_close(merged, whole, rtol=1e-5, atol=1e-5)
    # a row no part sees merges to zeros, not NaN
    none = merge_attention_partials([o1[:1], o2[:1]],
                                    [torch.full_like(l1[:1], -np.inf)] * 2)
    assert bool((none == 0).all())


def test_plain_lse_is_logsumexp_of_the_masked_logits():
    q, k, v, seg, pos = _attention_case(seed=22)
    _, lse = DA.mixed_attention_plain(q, k, v, seg, pos, scale=0.3,
                                      return_lse=True)
    kk = k[seg.long()]                                   # (T, Hkv, L, D)
    logits = torch.einsum("thgd,thld->thgl", q, kk) * 0.3
    vis = torch.arange(k.shape[2])[None, :] <= pos.long()[:, None]
    want = torch.logsumexp(logits.masked_fill(~vis[:, None, None, :],
                                              float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)
    # the paged plain version passes it through
    pool_k = k.transpose(1, 2).reshape(3 * 10, 4, 2, 16)
    pool_v = v.transpose(1, 2).reshape(3 * 10, 4, 2, 16)
    tables = torch.arange(30, dtype=torch.int32).reshape(3, 10)
    _, plse = DA.paged_attention_plain(q, pool_k, pool_v, tables, seg, pos,
                                       scale=0.3, return_lse=True)
    torch.testing.assert_close(plse, want, rtol=1e-6, atol=1e-6)


def _full_batch_grads():
    import repro_torch as rt
    with rt.default_device("cpu"):
        model = W.ddp_model(DDP_WIDTH)
        x, y = W.ddp_batch()
        return W.ddp_grads(model, x, y)


def test_ddp_syncs_to_the_full_batch_gradient(groups):
    full = _full_batch_grads()
    for rank in range(2):
        res = groups[2][rank]["ddp_rank"][None]
        for step in res["grads"]:
            for name, g in full.items():
                torch.testing.assert_close(step[name], g, rtol=1e-5,
                                           atol=1e-6)
        assert res["stats"]["num_allreduce"] == 2 * res["n_buckets"]
        assert res["n_buckets"] >= 2
        assert res["stats"]["compressed_bytes"] == 0


def test_ddp_int8_follows_the_reference_arithmetic(groups):
    """The port's ``_compress_int8`` is the JAX package's on the same
    buffers; each rank's synced int8 gradient is the reference's
    arithmetic on its bucket (every rank's codes summed, times the rank's
    own scale) and its residual the quantization error it keeps."""
    import repro_torch as rt
    from repro.distributed.ddp import _compress_int8 as jcompress
    from repro_torch.distributed.ddp import DistributedDataParallel
    rng = np.random.RandomState(4)
    flat = rng.randn(1000).astype(np.float32)
    res0 = rng.randn(1000).astype(np.float32) * 1e-3
    for residual in (None, res0):
        q, sc, r = _compress_int8(torch.from_numpy(flat),
                                  None if residual is None
                                  else torch.from_numpy(residual))
        jq, js, jr = jcompress(flat, residual)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(sc), float(js), rtol=1e-7)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6,
                                   atol=1e-7)
    # the first step's buckets, from each rank's half of the batch
    with rt.default_device("cpu"):
        x, y = W.ddp_batch()
        local = []
        for rank in range(2):
            model = W.ddp_model(DDP_WIDTH)
            local.append(W.ddp_grads(model, x[rank * 8:(rank + 1) * 8],
                                     y[rank * 8:(rank + 1) * 8]))
        ddp = DistributedDataParallel(model, bucket_mb=0.001)
        names = {id(p): n for n, p in model.named_parameters()}
    for bi, bucket in enumerate(ddp.buckets):
        keys = [names[id(p)] for p in bucket]
        parts = [_compress_int8(torch.cat([g[k].reshape(-1) for k in keys])
                                / 2, None) for g in local]
        codes = sum(q.float() for q, _, _ in parts)
        for rank in range(2):
            res = groups[2][rank]["ddp_rank"]["int8"]
            assert res["stats"]["compressed_bytes"] > 0
            got = torch.cat([res["grads"][0][k].reshape(-1) for k in keys])
            torch.testing.assert_close(got, codes * parts[rank][1],
                                       rtol=1e-6, atol=1e-7)
            # after two steps the residual is the second step's error;
            # it is never larger than half an int8 step of that bucket
            resid = res["residuals"][bi]
            assert resid.shape == got.shape
            assert float(resid.abs().max()) <= \
                0.5 * float(parts[rank][1]) * 1.5 + 1e-7


def test_pipeline_matches_sequential(groups):
    w, x = W.pipeline_inputs(4, PIPE["width"], PIPE["batch"])
    ref = x
    for i in range(4):
        ref = W.tanh_stage(w[i], ref)
    for rank in range(4):
        torch.testing.assert_close(groups[4][rank]["pipeline_rank"], ref,
                                   rtol=2e-4, atol=2e-5)


def test_pipeline_matches_jax(groups, tmp_path):
    """The JAX package's ``pipeline_apply`` over 4 forced host devices on
    the same inputs, in a subprocess."""
    w, x = W.pipeline_inputs(4, PIPE["width"], PIPE["batch"])
    np.save(tmp_path / "w.npy", w.numpy())
    np.save(tmp_path / "x.npy", x.numpy())
    code = textwrap.dedent(f"""
        import numpy as np, jax, jax.numpy as jnp
        from repro.distributed.pipeline import pipeline_apply
        w = jnp.asarray(np.load("{tmp_path}/w.npy"))
        x = jnp.asarray(np.load("{tmp_path}/x.npy"))
        mesh = jax.make_mesh((4,), ("pod",))
        out = pipeline_apply(lambda p, h: jnp.tanh(h @ p), w, x,
                             mesh=mesh, n_microbatches={PIPE["n_micro"]})
        np.save("{tmp_path}/out.npy", np.asarray(out))
    """)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-2000:]
    ref = torch.from_numpy(np.load(tmp_path / "out.npy"))
    torch.testing.assert_close(groups[4][0]["pipeline_rank"], ref,
                               rtol=2e-4, atol=2e-5)


def test_stages_from_groups():
    tree = {"w": torch.arange(8 * 3).reshape(8, 3), "b": [torch.zeros(8)]}
    out = stages_from_groups(tree, 4)
    assert out["w"].shape == (4, 2, 3) and out["b"][0].shape == (4, 2)
    assert torch.equal(out["w"][1], tree["w"][2:4])
    with pytest.raises(ValueError):
        stages_from_groups(tree, 3)


@requires_cuda
def test_cuda_two_gloo_ranks_on_one_card_match_one_rank(cuda_device):
    """A (1, 2) mesh of two gloo ranks sharing cuda:0 (the paged kernel on
    the card, the collectives staged through host memory) commits the
    single-rank engine's outputs, context-parallel (1 KV head) and
    heads-split (2)."""
    from repro_torch.kernels import _build
    _build.build_all()
    res = run_ranks(W.jobs_rank, 2, ([
        ("mesh_parity_rank_cuda", ([(1, 2), (2, 1)], KV_HEADS))],),
        backend="gloo", timeout=GROUP_TIMEOUT)
    for hkv in KV_HEADS:
        cfg = W.tiny_port_cfg(hkv)
        params = TLM.init_params(cfg, seed=0, device="cpu")
        for sampled in (False, True):
            base, _ = W.serve_parity(cfg, params, sampled=sampled,
                                     device="cuda")
            for shape in ((1, 2), (2, 1)):
                for rank in range(2):
                    got = res[rank]["mesh_parity_rank_cuda"][
                        (shape, hkv, sampled)]
                    assert got["outs"] == base, (shape, hkv, sampled, rank)
                    assert got["paged_launches"] > 0
