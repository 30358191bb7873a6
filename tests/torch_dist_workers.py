"""Rank functions for the port's multi-process tests.

Each runs inside a process group that ``repro_torch.launch.mesh.
run_ranks`` started (gloo on the CPU, a file rendezvous); they import
torch and the port only, never JAX, so a spawned rank starts quickly.
They are module-level functions so that ``spawn`` can pickle them.
"""

from __future__ import annotations

import copy
from contextlib import contextmanager

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



# ----------------------------------------------------------------------
# meshed training and step builders
# ----------------------------------------------------------------------

TRAIN_BATCH = (4, 16)          # global (batch, sequence) of a train step
TRAIN_LR = 1e-2


SMOKE_ARCHS = {"gemma": "gemma-2b", "gemma3": "gemma3-1b",
               "jamba": "jamba-1.5-large-398b", "rwkv6": "rwkv6-1.6b",
               "qwen2moe": "qwen2-moe-a2.7b", "arctic": "arctic-480b",
               "minicpm3": "minicpm3-4b", "yi": "yi-34b"}


def train_cfg(name: str):
    """The meshed-training configs: ``tiny`` (4 heads, 2 KV heads, which
    split over model = 2), ``gemma`` (gemma-2b's SMOKE: 4 heads, 1 KV
    head, GeGLU, tied embeddings), ``gemma3`` (gemma3-1b's SMOKE: 1 KV
    head, sliding layers whose decode ring of 8 slots splits over
    model = 2), ``odd`` (3 heads: the context-parallel attention at
    model = 2), the SMOKE configs of ``jamba`` (mamba, attention, MoE
    and dense layers), ``rwkv6``, ``qwen2moe`` (a shared expert),
    ``arctic`` (a dense residual beside the MoE; 1 KV head),
    ``minicpm3`` (MLA) and ``yi`` (7 heads, 1 KV head), and ``moe3``
    (qwen2-moe's SMOKE with 3 experts, which do not divide model = 2:
    the experts' hidden columns split), all fp32."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import LMConfig
    if name in SMOKE_ARCHS:
        return get_smoke_config(SMOKE_ARCHS[name])
    if name == "moe3":
        return dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b"),
                                   name="moe3", n_experts=3)
    heads = {"tiny": (4, 2), "odd": (3, 3)}[name]
    return LMConfig(name=name, n_layers=2, d_model=48 if name == "odd"
                    else 64, n_heads=heads[0], n_kv_heads=heads[1],
                    head_dim=16, d_ff=128, vocab_size=96,
                    param_dtype=torch.float32, remat="none")


MOE_GROUP_TOKENS = "32"     # the global 4 x 16 batch: a group a data rank


@contextmanager
def moe_groups(cfg, tokens: str):
    """``REPRO_MOE_GROUP_TOKENS`` set to ``tokens`` while a config with
    MoE layers runs, so that a meshed run, each data rank routing its own
    rows, and the one-process run group the same rows."""
    import os
    old = os.environ.get("REPRO_MOE_GROUP_TOKENS")
    if cfg.n_experts:
        os.environ["REPRO_MOE_GROUP_TOKENS"] = tokens
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_MOE_GROUP_TOKENS", None)
        else:
            os.environ["REPRO_MOE_GROUP_TOKENS"] = old


def moe_train(mesh=None):
    """``run_train`` of qwen2-moe's SMOKE config (AdamW), its MoE groups
    ``MOE_GROUP_TOKENS`` tokens: on (2,1) each rank's rows are one group,
    as the one-process run's two groups."""
    return run_train(train_cfg("qwen2moe"), "adamw", 1, mesh)


def moe_train_rank(rank, world):
    from repro_torch.launch.mesh import make_mesh
    return moe_train(make_mesh((2, 1), ("data", "model")))


def train_batches(cfg, n: int = 2, seed: int = 11, shape=TRAIN_BATCH):
    gen = torch.Generator().manual_seed(seed)
    b, s = shape
    out = []
    for _ in range(n):
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
        labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
        mask = (torch.rand(b, s, generator=gen) > 0.2).float()
        out.append({"tokens": tokens, "labels": labels, "mask": mask})
    return out


def run_train(cfg, optimizer, accum, mesh=None, device="cpu",
              shape=TRAIN_BATCH):
    """Two steps of ``optimizer`` from seed-0 parameters on batches of
    ``shape``: the first step's gradients, each step's loss, grad norm,
    parameters and optimizer state (the rank's pieces on a mesh), and
    the coordinates.  MoE layers group ``MOE_GROUP_TOKENS`` tokens."""
    with moe_groups(cfg, MOE_GROUP_TOKENS):
        return _run_train(cfg, optimizer, accum, mesh, device, shape)


def _run_train(cfg, optimizer, accum, mesh, device, shape):
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import coords
    from repro_torch.optim.functional import tree_leaves
    kw = {"momentum": 0.9} if optimizer == "sgd" else {}
    # on a mesh the rank's pieces are drawn leaf by leaf
    state = T.init_train_state(cfg, optimizer=optimizer, lr=TRAIN_LR,
                               device=device, mesh=mesh)
    if kw:
        from repro_torch.optim.functional import make_optimizer
        state["opt"] = make_optimizer(optimizer, lr=TRAIN_LR, **kw)[0](
            state["params"])
    step = T.make_train_step(cfg, optimizer=optimizer, lr=TRAIN_LR,
                             accum_steps=accum, opt_kwargs=kw,
                             device=device, mesh=mesh)
    batches = train_batches(cfg, shape=shape)
    _, grads = step.compute(state["params"], batches[0])
    out = {"grads": [g.cpu() for g in grads], "steps": [],
           "coords": None if mesh is None else dict(coords(mesh))}
    for batch in batches:
        state, m = step(state, batch)
        out["steps"].append({
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": [p.cpu().clone() for p in tree_leaves(
                state["params"])],
            "opt": {k: [x.cpu().clone() for x in tree_leaves(v)]
                    for k, v in state["opt"].items() if k != "step"}})
    return out


def mesh_train_rank(rank, world, shapes, cases, device="cpu"):
    """``run_train`` on each mesh of ``shapes`` for each (config,
    optimizer, accum_steps) of ``cases``."""
    from repro_torch.launch.mesh import make_mesh
    res = {}
    for shape in shapes:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        for name, optimizer, accum in cases:
            res[(tuple(shape), name, optimizer, accum)] = run_train(
                train_cfg(name), optimizer, accum, mesh, device)
    return res


def seq_train_rank(rank, world, shapes, cases):
    """``mesh_train_rank`` with ``REPRO_SEQ_SHARD=1``, each run with the
    rows of the residual stream each block took (``"rows"``)."""
    from repro_torch.distributed import act_sharding as AS
    from repro_torch.launch.mesh import make_mesh
    res = {}
    for shape in shapes:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        for name, optimizer, accum in cases:
            rows = []
            with AS.sequence_sharding(), AS.record_rows(rows):
                out = run_train(train_cfg(name), optimizer, accum, mesh)
            res[(tuple(shape), name, optimizer, accum)] = dict(
                out, rows=sorted(set(rows)))
    return res


ODD_LENGTH = (4, 15)    # a sequence no model axis > 1 of these tests divides


def seq_odd_length_rank(rank, world, shape, name):
    """``run_train`` of ``name`` on ``ODD_LENGTH`` batches on ``shape``,
    with ``REPRO_SEQ_SHARD=1`` and without: {on: result}."""
    from repro_torch.distributed import act_sharding as AS
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(tuple(shape), ("data", "model"))
    res = {}
    for on in (True, False):
        rows = []
        with AS.sequence_sharding(on), AS.record_rows(rows):
            out = run_train(train_cfg(name), "adamw", 1, mesh,
                            shape=ODD_LENGTH)
        res[on] = dict(out, rows=sorted(set(rows)))
    return res


CONTEXT_SHAPE = (2, 4, 2, 16, 16)    # B, Hq, Hkv, S, D
CONTEXT_CASES = ((True, None), (True, 5), (False, None))  # causal, window


def context_inputs(seed: int = 21):
    """q, k, v over the whole sequence and the weights of the loss
    ``sum(out * w)`` whose gradients the tests compare."""
    b, hq, hkv, s, d = CONTEXT_SHAPE
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, hq, s, d, generator=gen)
    k = torch.randn(b, hkv, s, d, generator=gen)
    v = torch.randn(b, hkv, s, d, generator=gen)
    w = torch.randn(b, hq, s, d, generator=gen)
    return q, k, v, w


def context_sdpa_rank(rank, world, shape):
    """``context_sdpa`` on this rank's sequence pieces of q/k/v (mesh
    ``shape``, the sequence over ``model``) for each case of
    ``CONTEXT_CASES``: the output piece and the gradients of the pieces."""
    from repro_torch.distributed import act_sharding as AS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import context_sdpa
    mesh = make_mesh(tuple(shape), ("data", "model"))
    n, r = shape[1], mesh.get_local_rank("model")
    full = context_inputs()
    s_loc = full[0].shape[2] // n
    res = {}
    for causal, window in CONTEXT_CASES:
        q, k, v, w = (x[:, :, r * s_loc:(r + 1) * s_loc].clone()
                      for x in full)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        with AS.scope(mesh):
            out = context_sdpa(q, k, v, None, causal, window)
            (out * w).sum().backward()
        res[(causal, window)] = {"out": out.detach(), "dq": q.grad,
                                 "dk": k.grad, "dv": v.grad}
    return res


DECODE_PROMPT, DECODE_STEPS, DECODE_ROWS = 8, 6, 4


def decode_prompts(cfg, seed: int = 31):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (DECODE_ROWS, DECODE_PROMPT),
                         generator=gen)


# the prefill's MoE groups: a data rank's rows of the (2,2) mesh
DECODE_GROUP_TOKENS = str(DECODE_ROWS * DECODE_PROMPT // 2)


def greedy_run(cfg, params, mesh=None, device="cpu", dtype=torch.float32):
    """The meshed (or one-process) prefill's greedy token after the
    prompt, then the prompt fed through the serve step one token a step
    and ``DECODE_STEPS`` greedy tokens: (the prefill's tokens, the
    decode's, the serve step's log-sum-exp merges).  On a mesh the cache
    is the rank's pieces (``init_cache(mesh=)``)."""
    from repro_torch.launch import train as T
    from repro_torch.models import lm as LM
    prompts = decode_prompts(cfg).to(device)
    max_seq = DECODE_PROMPT + DECODE_STEPS
    prefill = T.make_prefill_step(cfg, device=device, mesh=mesh)
    serve = T.make_serve_step(cfg, batch=DECODE_ROWS, max_seq=max_seq,
                              cache_dtype=dtype, device=device, mesh=mesh)
    cache = LM.init_cache(cfg, DECODE_ROWS, max_seq, dtype, device, mesh)
    with moe_groups(cfg, DECODE_GROUP_TOKENS):
        logits = prefill(params, {"tokens": prompts})
    first = T.greedy_tokens(logits[:, -1], mesh, cfg.vocab_size)
    for t in range(DECODE_PROMPT):
        logits, _ = serve(params, cache, prompts[:, t:t + 1], t)
    out = [T.greedy_tokens(logits[:, -1], mesh, cfg.vocab_size)]
    for i in range(DECODE_STEPS - 1):
        logits, _ = serve(params, cache, out[-1][:, None],
                          DECODE_PROMPT + i)
        out.append(T.greedy_tokens(logits[:, -1], mesh, cfg.vocab_size))
    return (first.cpu(), torch.stack(out, 1).cpu(),
            getattr(serve, "lse_merges", 0))


FILL_PROMPT, FILL_STEPS = 12, 6     # the prompt wraps gemma3's 8-slot ring


def fill_prompts(cfg):
    gen = torch.Generator().manual_seed(33)
    return torch.randint(0, cfg.vocab_size, (DECODE_ROWS, FILL_PROMPT),
                         generator=gen)


def filled_run(cfg, params, mesh=None, device="cpu", fill=True,
               max_seq=FILL_PROMPT + FILL_STEPS, record=None):
    """The prefill step filling the cache (``make_prefill_step(max_seq=)``)
    on ``FILL_PROMPT``-token prompts, then ``FILL_STEPS - 1`` greedy
    steps of the serve step from there: (the greedy tokens, the serve
    step's log-sum-exp merges).  The prefill's MoE groups a data rank's
    rows at (2,2).  ``fill=False``: the prompts go through the serve step
    one token a step instead of the prefill.  ``record``, a dict, gets
    the first layer's cache entry shapes (``"cache"``)."""
    from repro_torch.launch import train as T
    from repro_torch.models import lm as LM
    prompts = fill_prompts(cfg)
    serve = T.make_serve_step(cfg, batch=DECODE_ROWS, max_seq=max_seq,
                              cache_dtype=torch.float32, device=device,
                              mesh=mesh)
    cache = LM.init_cache(cfg, DECODE_ROWS, max_seq, torch.float32, device,
                          mesh)
    if record is not None:
        record["cache"] = {k: tuple(v.shape) for k, v in cache[0].items()}
    if fill:
        prefill = T.make_prefill_step(cfg, device=device, mesh=mesh,
                                      max_seq=max_seq)
        with moe_groups(cfg, str(DECODE_ROWS * FILL_PROMPT // 2)):
            logits = prefill(params, {"tokens": prompts}, cache)
    else:
        for t in range(FILL_PROMPT):
            logits, _ = serve(params, cache, prompts[:, t:t + 1], t)
    out = [T.greedy_tokens(logits[:, -1], mesh, cfg.vocab_size)]
    for i in range(FILL_STEPS - 1):
        logits, _ = serve(params, cache, out[-1][:, None], FILL_PROMPT + i)
        out.append(T.greedy_tokens(logits[:, -1], mesh, cfg.vocab_size))
    return torch.stack(out, 1).cpu(), serve.lse_merges


def seq_decode_rank(rank, world, shape, names):
    """``filled_run`` on ``shape`` for each config, the parameters the
    rank's pieces, with ``REPRO_SEQ_SHARD=1`` and without: {(name, on):
    (tokens, merges, rows of the prefill's blocks)}."""
    from repro_torch.distributed import act_sharding as AS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import init_pieces
    mesh = make_mesh(tuple(shape), ("data", "model"))
    res = {}
    for name in names:
        cfg = train_cfg(name)
        for on in (True, False):
            rows = []
            with AS.sequence_sharding(on), AS.record_rows(rows):
                params = init_pieces(cfg, mesh, seed=0, device="cpu")
                toks, merges = filled_run(cfg, params, mesh)
            res[(name, on)] = (toks, merges, sorted(set(rows)))
    return res


# MLA decode: a latent cache whose slots model = 2 and 4 divide, and one
# they do not (held whole on every rank)
MLA_MAX_SEQS = (20, 19)


def mla_decode_rank(rank, world, shapes):
    """``filled_run`` of minicpm3's SMOKE (MLA) on each mesh of
    ``shapes``, the parameters the rank's pieces: for each max_seq of
    ``MLA_MAX_SEQS``, with ``REPRO_SEQ_SHARD=1`` and without (the whole
    cache without it): {(shape, max_seq, on): (tokens, merges, rows of
    the prefill's blocks, the first layer's cache entry shapes)}."""
    from repro_torch.distributed import act_sharding as AS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import init_pieces
    cfg = train_cfg("minicpm3")
    res = {}
    for shape in shapes:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        for max_seq in MLA_MAX_SEQS:
            turns = (True, False) if max_seq % shape[1] == 0 else (False,)
            for on in turns:
                rows, record = [], {}
                with AS.sequence_sharding(on), AS.record_rows(rows):
                    params = init_pieces(cfg, mesh, seed=0, device="cpu")
                    toks, merges = filled_run(cfg, params, mesh,
                                              max_seq=max_seq,
                                              record=record)
                res[(tuple(shape), max_seq, on)] = (
                    toks, merges, sorted(set(rows)), record["cache"])
    return res


MLA_FORCED = 4      # decode steps fed fixed tokens after the prompt


def mla_forced_tokens(cfg):
    gen = torch.Generator().manual_seed(35)
    return torch.randint(0, cfg.vocab_size, (DECODE_ROWS, MLA_FORCED),
                         generator=gen)


def mla_reference_rank(rank, world, shape, tree):
    """minicpm3 SMOKE from the reference's parameter pytree ``tree`` on
    ``shape``: the prefill filling a slot-split cache with
    ``fill_prompts``, then the serve step fed ``mla_forced_tokens``: the
    logits (gathered whole over ``model``) of the prompt's last position
    and of each step."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as LM
    mesh = make_mesh(tuple(shape), ("data", "model"))
    cfg = train_cfg("minicpm3")
    full = LM.params_from_numpy(cfg, tree, device="cpu")
    params = T.shard_tree(mesh, S.param_specs(cfg, full, mesh), full)
    max_seq = FILL_PROMPT + MLA_FORCED
    prefill = T.make_prefill_step(cfg, device="cpu", mesh=mesh,
                                  max_seq=max_seq)
    serve = T.make_serve_step(cfg, batch=DECODE_ROWS, max_seq=max_seq,
                              cache_dtype=torch.float32, device="cpu",
                              mesh=mesh)
    cache = LM.init_cache(cfg, DECODE_ROWS, max_seq, torch.float32, "cpu",
                          mesh)
    logits = [prefill(params, {"tokens": fill_prompts(cfg)}, cache)[:, -1:]]
    forced = mla_forced_tokens(cfg)
    for i in range(MLA_FORCED):
        logits.append(serve(params, cache, forced[:, i:i + 1],
                            FILL_PROMPT + i)[0])
    whole = lambda x: (x if x.shape[-1] == cfg.vocab_size else
                       S.gather_leaf(mesh, S.P(None, None, "model"), x))
    return {"logits": [whole(x) for x in logits],
            "merges": serve.lse_merges}


def mesh_decode_rank(rank, world, shapes, names):
    """``greedy_run`` on each mesh of ``shapes`` for each config, the
    parameters drawn as the rank's pieces (``init_pieces``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import init_pieces
    res = {}
    for shape in shapes:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        for name in names:
            cfg = train_cfg(name)
            params = init_pieces(cfg, mesh, seed=0, device="cpu")
            res[(tuple(shape), name)] = greedy_run(cfg, params, mesh)
    return res


ELASTIC_CFG = "gemma"


def _copy(tree):
    """A copy of every leaf (the step updates a state in place, and a
    leaf no axis splits gathers to itself)."""
    from repro_torch.optim.functional import tree_map
    return tree_map(lambda x: x.clone(), tree)


def elastic_save_rank(rank, world, directory):
    """(2,2): step 1, a save, step 2; the step-2 loss and the whole
    parameters after it (assembled on every rank)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as LM
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = train_cfg(ELASTIC_CFG)
    specs = T.state_specs(cfg, mesh, lr=TRAIN_LR)
    state = T.init_train_state(cfg, lr=TRAIN_LR, device="cpu", mesh=mesh,
                               params=LM.init_params(cfg, device="cpu"))
    step = T.make_train_step(cfg, lr=TRAIN_LR, device="cpu", mesh=mesh)
    b1, b2 = train_batches(cfg)
    state, _ = step(state, b1)
    CheckpointManager(directory).save(state, 1, mesh, specs)
    saved = _copy(gather_tree(mesh, specs, state))
    state, m = step(state, b2)
    return {"loss": float(m["loss"]), "saved": saved,
            "params": gather_tree(mesh, specs["params"], state["params"])}


def elastic_restore_rank(rank, world, directory, shape):
    """Restore step 1 onto ``shape``, then step 2: the restored state
    (assembled), and the step's loss and the whole parameters after
    it."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(tuple(shape), ("data", "model"))
    cfg = train_cfg(ELASTIC_CFG)
    specs = T.state_specs(cfg, mesh, lr=TRAIN_LR)
    like = T.init_train_state(cfg, lr=TRAIN_LR, device="cpu", mesh=mesh)
    state = CheckpointManager(directory).restore(1, like, mesh, specs)
    restored = _copy(gather_tree(mesh, specs, state))
    step = T.make_train_step(cfg, lr=TRAIN_LR, device="cpu", mesh=mesh)
    state, m = step(state, train_batches(cfg)[1])
    return {"loss": float(m["loss"]), "step": int(state["step"]),
            "restored": restored,
            "params": gather_tree(mesh, specs["params"], state["params"])}


LOOP_STEPS = 3


def train_loop_rank(rank, world, shape, directory):
    """``train_loop`` over the meshed step on ``shape`` for LOOP_STEPS
    steps, checkpointing into ``directory``: its result."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train_loop
    mesh = make_mesh(tuple(shape), ("data", "model"))
    return train_loop(train_cfg("tiny"), steps=LOOP_STEPS, batch_size=4,
                      seq_len=16, checkpoint_dir=directory,
                      checkpoint_every=2, log_every=100, device="cpu",
                      mesh=mesh)


def adafactor_update_rank(rank, world, shape, tree, grads):
    """The meshed Adafactor update (``launch.train.make_update``) of
    jamba's SMOKE on ``shape``: the rank's pieces of the reference's
    parameter pytree ``tree``, updated in place from its pieces of each
    gradient pytree of ``grads`` (numpy, the reference's layout): after
    each update the parameters and the factors, assembled whole, and the
    step; and the update's reductions."""
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as LM
    from repro_torch.optim.functional import make_optimizer, tree_leaves
    mesh = make_mesh(tuple(shape), ("data", "model"))
    cfg = train_cfg("jamba")
    specs = T.state_specs(cfg, mesh, optimizer="adafactor", lr=TRAIN_LR)
    params = T.shard_tree(mesh, specs["params"],
                          LM.params_from_numpy(cfg, tree, device="cpu"))
    opt = make_optimizer("adafactor", lr=TRAIN_LR)[0](params)
    update = T.make_update(cfg, optimizer="adafactor", lr=TRAIN_LR,
                           mesh=mesh)
    out = []
    for g in grads:
        pieces = T.shard_tree(mesh, specs["params"],
                              LM.params_from_numpy(cfg, g, device="cpu"))
        update(params, tree_leaves(pieces), opt)
        out.append({"params": _copy(gather_tree(mesh, specs["params"],
                                                params)),
                    "fac": _copy(gather_tree(mesh, specs["opt"]["fac"],
                                             opt["fac"])),
                    "step": int(opt["step"])})
    return {"steps": out, "reductions": dict(update.reductions)}


def adafactor_elastic_rank(rank, world, directory):
    """Adafactor on gemma's SMOKE: step 1 on (1,2), a save, step 2; the
    state restored onto (2,1), then step 2 there.  Returns the saved and
    the restored state (assembled whole) and both step-2 losses."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    cfg = train_cfg(ELASTIC_CFG)
    kw = dict(optimizer="adafactor", lr=TRAIN_LR)
    b1, b2 = train_batches(cfg)
    mesh = make_mesh((1, 2), ("data", "model"))
    specs = T.state_specs(cfg, mesh, **kw)
    state = T.init_train_state(cfg, device="cpu", mesh=mesh, **kw)
    step = T.make_train_step(cfg, device="cpu", mesh=mesh, **kw)
    state, _ = step(state, b1)
    CheckpointManager(directory).save(state, 1, mesh, specs)
    saved = _copy(gather_tree(mesh, specs, state))
    losses = [float(step(state, b2)[1]["loss"])]
    mesh = make_mesh((2, 1), ("data", "model"))
    specs = T.state_specs(cfg, mesh, **kw)
    like = T.init_train_state(cfg, device="cpu", mesh=mesh, **kw)
    state = CheckpointManager(directory).restore(1, like, mesh, specs)
    restored = _copy(gather_tree(mesh, specs, state))
    step = T.make_train_step(cfg, device="cpu", mesh=mesh, **kw)
    losses.append(float(step(state, b2)[1]["loss"]))
    return {"saved": saved, "restored": restored, "losses": losses}


def adafactor_loop_rank(rank, world, shapes):
    """``train_loop(optimizer="adafactor")`` of the tiny config for
    ``LOOP_STEPS`` steps on each mesh of ``shapes``: {shape: losses}."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train_loop
    return {tuple(shape): train_loop(
        train_cfg("tiny"), steps=LOOP_STEPS, batch_size=4, seq_len=16,
        optimizer="adafactor", lr=TRAIN_LR, log_every=100, device="cpu",
        mesh=make_mesh(tuple(shape), ("data", "model")))["losses"]
        for shape in shapes}


FORWARD_TOKENS = (2, 16)


def forward_tokens(cfg, seed: int = 41) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, FORWARD_TOKENS).astype(np.int32)


def mesh_forward_rank(rank, world, shape, name, tree):
    """The meshed prefill step's logits (gathered whole over ``model``) of
    config ``name`` from the reference's parameter pytree ``tree`` (numpy
    arrays), on the tokens of ``forward_tokens``."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as LM
    mesh = make_mesh(tuple(shape), ("data", "model"))
    cfg = train_cfg(name)
    full = LM.params_from_numpy(cfg, tree, device="cpu")
    params = T.shard_tree(mesh, S.param_specs(cfg, full, mesh), full)
    prefill = T.make_prefill_step(cfg, device="cpu", mesh=mesh)
    tokens = torch.from_numpy(forward_tokens(cfg)).long()
    logits = prefill(params, {"tokens": tokens})
    if logits.shape[-1] != cfg.vocab_size:
        logits = S.gather_leaf(mesh, S.P(None, None, "model"), logits)
    return logits


def encoder_cfg():
    """hubert-xlarge's SMOKE (bidirectional, layer norm, embeddings in, a
    classification head) cut to 3 heads of 16: heads that do not divide
    model = 2."""
    import dataclasses
    from repro_torch.configs import hubert_xlarge
    return dataclasses.replace(hubert_xlarge.SMOKE, name="enc3", d_model=48,
                               n_heads=3, n_kv_heads=3, head_dim=16)


def encoder_embeds(cfg, seed: int = 43):
    return torch.randn(FORWARD_TOKENS + (cfg.d_model,),
                       generator=torch.Generator().manual_seed(seed))


def seq_encoder_rank(rank, world, shape):
    """The meshed prefill step's logits (gathered whole over ``model``) of
    ``encoder_cfg`` under ``REPRO_SEQ_SHARD=1`` from the rank's seed-0
    pieces on ``encoder_embeds``, and the rows each block took."""
    from repro_torch.distributed import act_sharding as AS
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(tuple(shape), ("data", "model"))
    cfg = encoder_cfg()
    rows = []
    with AS.sequence_sharding(), AS.record_rows(rows):
        params = T.init_pieces(cfg, mesh, seed=0, device="cpu")
        logits = T.make_prefill_step(cfg, device="cpu", mesh=mesh)(
            params, {"embeds": encoder_embeds(cfg)})
    if logits.shape[-1] != cfg.n_classes:
        logits = S.gather_leaf(mesh, S.P(None, None, "model"), logits)
    return logits, sorted(set(rows))


def seq_forward_rank(rank, world, shape, trees):
    """``mesh_forward_rank`` under ``REPRO_SEQ_SHARD=1`` for each config
    of ``trees`` ({name: the reference's parameter pytree})."""
    from repro_torch.distributed import act_sharding as AS
    with AS.sequence_sharding():
        return {name: mesh_forward_rank(rank, world, shape, name, tree)
                for name, tree in trees.items()}


def dryrun_tally_rank(rank, world, shape, name):
    """The collectives tally (``collectives.stats``: calls, and calls and
    result bytes by kind and by mesh axis) of one AdamW train step of
    ``name`` on ``shape``, on a batch of tokens and labels of
    ``TRAIN_BATCH``: what the dry run predicts for the same step."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(tuple(shape), ("data", "model"))
    cfg = train_cfg(name)
    state = T.init_train_state(cfg, device="cpu", mesh=mesh)
    step = T.make_train_step(cfg, device="cpu", mesh=mesh)
    batch = train_batches(cfg, n=1)[0]
    del batch["mask"]
    C.reset_stats()
    step(state, batch)
    return copy.deepcopy({k: v for k, v in C.stats.items()
                          if k != "staged_bytes"})


def production_meshes_child() -> dict:
    """In a process of its own: for fake process groups of 256, 512 and
    4 ranks, what ``make_production_mesh`` gives for each ``multi_pod``:
    (shape, axis names), or the ``MeshConfigError`` it raised."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.serving.errors import MeshConfigError
    out = {}
    for world in (256, 512, 4):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            for multi in (False, True):
                try:
                    mesh = make_production_mesh(multi_pod=multi)
                    out[(world, multi)] = (tuple(mesh.mesh.shape),
                                           tuple(mesh.mesh_dim_names))
                except MeshConfigError as e:
                    out[(world, multi)] = ("MeshConfigError", str(e))
        finally:
            dist.destroy_process_group()
    return out


def scan_memo_child(name, shape, batch) -> dict:
    """In a process of its own, rank 0 of a fake group of ``shape``'s
    ranks: ``dryrun.trace_step`` of one AdamW train step of ``name`` on
    a ``batch`` (B, S), with the scans' backward memoized (the dry run's
    way) and run in full: {memoized: result}."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    spec = ShapeSpec("train", batch[1], batch[0])
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=shape[0] * shape[1])
    out = {}
    try:
        mesh = make_mesh(tuple(shape), ("data", "model"), device_type="cpu")
        for memoized in (True, False):
            funcs = dryrun._ScanMemo.FUNCTIONS
            if not memoized:
                dryrun._ScanMemo.FUNCTIONS = ()
            try:
                out[memoized] = dryrun.trace_step(train_cfg(name), spec,
                                                  mesh)
            finally:
                dryrun._ScanMemo.FUNCTIONS = funcs
    finally:
        dist.destroy_process_group()
    return out


def jobs_rank(rank, world, jobs):
    """Several rank functions of this module in one process group, in
    order: ``jobs`` is ``[(name, args), ...]``; returns ``{name: result}``
    (a name given twice merges its dict results).  One group for many
    checks saves the ranks' start-up."""
    import sys
    mod = sys.modules[__name__]
    out = {}
    for name, args in jobs:
        res = getattr(mod, name)(rank, world, *args)
        out[name] = {**out[name], **res} if name in out else res
    return out
