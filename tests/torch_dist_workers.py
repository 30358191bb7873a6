"""Rank functions for the port's multi-process tests.

Each runs inside a process group that ``repro_torch.launch.mesh.
run_ranks`` started (gloo on the CPU, a file rendezvous); they import
torch and the port only, never JAX, so a spawned rank starts quickly.
They are module-level functions so that ``spawn`` can pickle them.
"""

from __future__ import annotations

import numpy as np
import torch

# the reference's TestShardedParity workload (tests/test_serving.py)
PARITY_ENGINE = dict(page_size=4, num_pages=64, max_batch=4, chunk_size=8,
                     token_budget=16)
SAMPLED = dict(temperature=0.8, top_k=20, seed=42)


def tiny_port_cfg(n_kv_heads: int):
    from repro_torch.models.lm import LMConfig
    return LMConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=n_kv_heads, d_ff=128, vocab_size=97,
                    param_dtype=torch.float32, remat="none",
                    attn_backend="ref")


def parity_requests(n: int = 10):
    rng = np.random.RandomState(0)
    return [[int(x) for x in rng.randint(1, 97, rng.randint(3, 12))]
            for _ in range(n)]


def serve_parity(cfg, params, *, mesh=None, n_replicas=1, sampled=False,
                 device="cpu", requests=None, max_new_tokens=8,
                 engine_kw=None):
    """The finished outputs of the parity workload, in submit order, and
    the engine's metrics."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampling import SamplingParams
    kw = dict(PARITY_ENGINE, **(engine_kw or {}))
    sp = SamplingParams(**SAMPLED) if sampled else SamplingParams()
    eng = ServingEngine(cfg, params, mesh=mesh, n_replicas=n_replicas,
                        sampling=sp, device=device, **kw)
    ids = [eng.submit(p, max_new_tokens=max_new_tokens)
           for p in (requests or parity_requests())]
    fin = eng.run()
    outs = {r.req_id: r.out_tokens for r in fin}
    assert len(outs) == len(ids), (len(outs), len(ids))
    m = eng.metrics
    assert m["bucket_compiles"] <= eng.bucket_count
    return [outs[i] for i in ids], m


def mesh_parity_rank(rank, world, shapes, kv_heads, device="cpu"):
    """Every (mesh shape, KV head count, greedy/sampled) run's outputs on
    this rank, with its metrics that the tests read."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as LM
    res = {}
    for shape in shapes:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        for hkv in kv_heads:
            cfg = tiny_port_cfg(hkv)
            params = LM.init_params(cfg, seed=0, device="cpu")
            for sampled in (False, True):
                reset_launch_counts()
                outs, m = serve_parity(cfg, params, mesh=mesh,
                                       sampled=sampled, device=device)
                res[(tuple(shape), hkv, sampled)] = {
                    "outs": outs, "lse_merges": m["lse_merges"],
                    "page_hwm_per_replica": m["page_hwm_per_replica"],
                    "kv_bytes": m["kv_bytes"], "n_replicas": m["n_replicas"],
                    "paged_launches": launch_counts()["paged_attention"]}
    return res


def mesh_parity_rank_cuda(rank, world, shapes, kv_heads):
    return mesh_parity_rank(rank, world, shapes, kv_heads, device="cuda")


def mesh_basics_rank(rank, world):
    """mesh_for_serving's refusals inside a live group, and the mesh."""
    from repro_torch.launch import mesh as M
    from repro_torch.serving.errors import MeshConfigError
    out = {}
    mesh = M.mesh_for_serving(world, tp=1)
    out["shape"] = dict(M.axis_sizes(mesh))
    out["info"] = M.mesh_info(mesh)
    refused = []
    for args in ((world + 1, 1), (world, world + 1), (0, 1)):
        try:
            M.mesh_for_serving(*args)
        except MeshConfigError:
            refused.append(args)
    out["refused"] = refused
    out["coords"] = dict(M.coords(mesh))
    return out


def kv_gather_rank(rank, world, shapes, kv_heads):
    """A meshed pool's host writes (``write_batch``: each rank keeps the
    pages and heads it holds), copy-on-write across model ranks, and
    ``gather`` (the ranks' parts summed over the mesh): returns what
    ``gather`` reads back, and what was written."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.kv_cache import PagedKVCache
    res = {}
    for shape in shapes:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        for hkv in kv_heads:
            r = shape[0]
            kv = PagedKVCache(n_layers=1, n_kv_heads=hkv, head_dim=4,
                              page_size=2, num_pages=8 * r, n_replicas=r,
                              dtype=torch.float32, device="cpu", mesh=mesh)
            gen = torch.Generator().manual_seed(3)
            written = {}
            for sid in range(2 * r):
                n = 5 + sid
                kv.create(sid, list(range(100 + sid, 100 + sid + n)),
                          replica=sid % r)
                k = torch.randn(n, hkv, 4, generator=gen)
                v = torch.randn(n, hkv, 4, generator=gen)
                assert kv.write_batch(sid, [(k, v)], 0, n)
                written[sid] = (k, v)
            # a shared page written divergently is copied first (COW),
            # here across the replica's model ranks
            kv.pool.retain(kv.tables[0][0])
            assert kv.make_writable(0, 0, 1)
            got = {}
            for sid in written:
                k, v, lens = kv.gather([sid], 0)
                got[sid] = (k[0].transpose(0, 1), v[0].transpose(0, 1),
                            int(lens[0]))
            res[(tuple(shape), hkv)] = {"got": got, "written": written,
                                        "mode": kv.shard.mode}
    return res


# ----------------------------------------------------------------------
# DDP
# ----------------------------------------------------------------------

def ddp_model(width: int, seed: int = 0):
    """The reference test's Linear(16, 32) -> ReLU -> Linear(32, 4), its
    hidden width ``width``, same weights on every rank."""
    from repro_torch import nn
    gen = torch.Generator().manual_seed(seed)
    model = nn.Sequential(nn.Linear(16, width), nn.ReLU(),
                          nn.Linear(width, 4))
    for p in model.parameters():
        p.data.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return model


def ddp_batch(n: int = 16, seed: int = 1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(n, 16, generator=gen), torch.randn(n, 4, generator=gen)


def ddp_grads(model, x, y):
    import repro_torch as rt
    out = model(rt.Tensor(x))
    loss = ((out - rt.Tensor(y)) ** 2).mean()
    loss.backward()
    return {k: p.grad.data.clone() for k, p in model.named_parameters()}


def ddp_rank(rank, world, width, device):
    """Each rank's half of the batch, synced (and int8-compressed) DDP
    gradients, and the stats."""
    import repro_torch as rt
    from repro_torch.distributed.ddp import DistributedDataParallel
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("data",))
    res = {}
    with rt.default_device(device):
        x, y = ddp_batch()
        n = x.shape[0] // world
        xs, ys = x[rank * n:(rank + 1) * n], y[rank * n:(rank + 1) * n]
        for compress in (None, "int8"):
            model = ddp_model(width)
            ddp = DistributedDataParallel(model, mesh=mesh, bucket_mb=0.001,
                                          compress=compress)
            steps = []
            for _ in range(2):
                model.zero_grad()
                ddp_grads(ddp, xs.to(device), ys.to(device))
                ddp.sync_gradients()
                steps.append({k: p.grad.data.cpu().clone()
                              for k, p in model.named_parameters()})
            res[compress] = {
                "grads": steps, "stats": dict(ddp.stats),
                "n_buckets": len(ddp.buckets),
                "residuals": {k: v.cpu() for k, v in ddp._residuals.items()}}
    return res


# ----------------------------------------------------------------------
# pipeline
# ----------------------------------------------------------------------

def pipeline_inputs(n_stages, width, batch, seed=3):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(n_stages, width, width, generator=gen) / width ** 0.5
    x = torch.randn(batch, width, generator=gen)
    return w, x


def tanh_stage(w, x):
    return torch.tanh(x @ w)


def pipeline_rank(rank, world, width, batch, n_micro, device):
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("pod",))
    w, x = pipeline_inputs(world, width, batch)
    out = pipeline_apply(tanh_stage, w.to(device), x.to(device),
                         mesh=mesh, n_microbatches=n_micro)
    return out.cpu()



def jobs_rank(rank, world, jobs):
    """Several rank functions of this module in one process group, in
    order: ``jobs`` is ``[(name, args), ...]``; returns ``{name: result}``.
    One group for many checks saves the ranks' start-up."""
    import sys
    mod = sys.modules[__name__]
    return {name: getattr(mod, name)(rank, world, *args)
            for name, args in jobs}
