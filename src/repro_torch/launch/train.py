"""Step builders and the trainer: train, prefill and decode steps, and
``train_loop`` (counterpart of ``repro/launch/train.py``).

The reference wraps each step in ``jax.jit`` with parameter, optimizer
and cache shardings over a device mesh, and donates the state.  The port
runs eagerly on one device: meshes and shardings are dropped (sharding
is ROADMAP.md queue A7b), and donation becomes updates in place: the
train step writes the new parameters and optimizer state into the
tensors it was given, leaf by leaf, so the model never has a second copy
of its parameters, and the decode step writes the cache in place.

``train_loop`` is the runnable trainer on synthetic LM data (data
loader, checkpoint/restart, straggler-aware step timing), and
``python -m repro_torch.launch.train`` its command line, the counterpart
of ``examples/train_lm.py``::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --size 2m --steps 20
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import default_device, resolve_device
from ..configs import ARCHS, get_smoke_config
from ..models import lm as LM
from ..optim.functional import (clip_by_global_norm, make_optimizer,
                                tree_leaves, tree_map)

# the profiler range around the gradient clip and the optimizer update
OPT_RANGE = "train_step::optimizer"


def _leaves_like(tree, like) -> list:
    """``tree``'s subtrees at the positions of ``like``'s leaves, in
    order: a parameter-shaped optimizer entry flattened down to the
    parameters (Adafactor's per-leaf factor dicts stay whole)."""
    if isinstance(like, dict):
        return [x for k in like for x in _leaves_like(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for t, l in zip(tree, like) for x in _leaves_like(t, l)]
    return [tree]


def _copy_into(dst, src) -> None:
    tree_map(lambda d, s: d.copy_(s), dst, src)


def make_train_step(cfg: LM.LMConfig, *, optimizer: str = "adamw",
                    lr: float = 3e-4, grad_clip: float = 1.0,
                    accum_steps: int = 1, foreach: bool = False,
                    opt_kwargs: Optional[Dict] = None,
                    device=None) -> Callable:
    """Returns ``step(state, batch) -> (state, {"loss", "grad_norm"})``
    over ``state = {"params", "opt", "step"}``: ``lm.lm_loss``, its
    gradients, ``clip_by_global_norm`` to ``grad_clip``, then the update
    of ``make_optimizer(optimizer, foreach=foreach, lr=lr,
    **opt_kwargs)``.  The state's tensors are updated in place and the
    same dict is returned; ``loss`` and ``grad_norm`` are fp32 tensors
    on the device.  ``batch`` holds ``"tokens"`` (or ``"embeds"``),
    ``"labels"`` and an optional ``"mask"``; inputs on another device
    are moved to ``device`` (default CUDA).

    ``accum_steps > 1`` splits the batch into that many microbatches
    along its first axis; their losses and fp32 gradients are summed and
    divided by ``accum_steps``, as the reference's scan does.  The
    optimizer runs leaf by leaf (each leaf's update is made and written
    before the next), except ``foreach=True`` for SGD and Adam, whose
    bucketed update takes every leaf at once; Adafactor's foreach update
    is its per-leaf one."""
    LM._check_supported(cfg)
    dev = resolve_device(device)
    kw = dict(opt_kwargs or {})
    kw.setdefault("lr", lr)
    _, update_opt = make_optimizer(optimizer, foreach=foreach, **kw)
    whole_list = foreach and optimizer != "adafactor"

    def loss_and_grads(params, batch):
        tree = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(tree)
        loss = LM.lm_loss(cfg, tree, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def microbatch(batch, i: int):
        def part(x):
            if x.dim() == 0:
                return x
            if x.shape[0] % accum_steps:
                raise ValueError(f"train_step: batch of {x.shape[0]} does "
                                 f"not split into {accum_steps} "
                                 f"microbatches")
            return x.reshape(accum_steps, x.shape[0] // accum_steps,
                             *x.shape[1:])[i]
        return {k: part(v) for k, v in batch.items()}

    def update(params, grads, opt) -> None:
        # (params, grads, optimizer state) of one update: every leaf at
        # once for the bucketed updates, else one leaf at a time
        leaves = tree_leaves(params)
        state = {k: v if k == "step" else _leaves_like(v, params)
                 for k, v in opt.items()}
        if whole_list:
            parts = [(leaves, grads, state)]
        else:
            parts = (([p], [g], {k: v if k == "step" else [v[i]]
                                 for k, v in state.items()})
                     for i, (p, g) in enumerate(zip(leaves, grads)))
        for ps, gs, st in parts:
            new_ps, new_st = update_opt(gs, st, ps)
            _copy_into(ps, new_ps)
            for k, v in new_st.items():
                if k != "step":
                    _copy_into(st[k], v)
        # every leaf's update read the old step; it moves once, after all
        if "step" in opt:
            opt["step"].copy_(new_st["step"])

    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        batch = {k: v.to(dev) for k, v in batch.items()}
        params = state["params"]
        if accum_steps <= 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for p in tree_leaves(params)]
            for i in range(accum_steps):
                l, g = loss_and_grads(params, microbatch(batch, i))
                loss = loss + l
                grads = [a + b for a, b in zip(grads, g)]
            loss = loss / accum_steps
            grads = [g / accum_steps for g in grads]
        with torch.no_grad(), torch.profiler.record_function(OPT_RANGE):
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            update(params, grads, state["opt"])
            state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return step


def init_train_state(cfg: LM.LMConfig, *, optimizer: str = "adamw",
                     lr: float = 3e-4, seed: int = 0, device=None
                     ) -> Dict[str, Any]:
    """``{"params", "opt", "step"}``: ``lm.init_params(cfg, seed)`` on
    ``device``, the optimizer's ``init`` of them (both packages start
    the optimizer from ``init_opt(params)``) and an int32 step of 0."""
    dev = resolve_device(device)
    params = LM.init_params(cfg, seed=seed, device=dev)
    init_opt, _ = make_optimizer(optimizer, lr=lr)
    return {"params": params, "opt": init_opt(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_prefill_step(cfg: LM.LMConfig, device=None) -> Callable:
    """Returns ``prefill(params, batch) -> logits (B, S, V)``, where
    ``batch`` holds ``"tokens"`` (B, S) or ``"embeds"`` (B, S, D).  Runs
    ``lm.forward`` without autograd on ``device`` (default CUDA); inputs
    on another device are moved there."""
    LM._check_supported(cfg)
    dev = resolve_device(device)

    def prefill(params: LM.Params, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        tokens, embeds = batch.get("tokens"), batch.get("embeds")
        with torch.no_grad():
            logits, _ = LM.forward(
                cfg, params,
                tokens=None if tokens is None else tokens.to(dev),
                embeds=None if embeds is None else embeds.to(dev))
        return logits

    return prefill


def make_serve_step(cfg: LM.LMConfig, *, batch: int, max_seq: int,
                    cache_dtype: torch.dtype = torch.bfloat16,
                    device=None) -> Callable:
    """Returns ``serve_step(params, cache, tokens, pos) -> (logits (B, 1,
    V), cache)``: one token per row at the host int position ``pos``,
    written into the cache in place.  The cache is
    ``lm.init_cache(cfg, batch, max_seq, cache_dtype, device)``.  Each
    step checks its layer count, and the entries (names, shapes, dtypes,
    device) of the first layer of each kind of block against that layout,
    whatever the mixer.  Where a layer caches keys by position, ``pos``
    must lie inside ``max_seq``, where the reference's
    ``dynamic_update_slice`` would clamp the write (a sliding layer's
    ring of ``min(max_seq, window)`` slots needs no more than that); a
    recurrent state (rwkv) holds no positions, and there ``pos`` need
    only be >= 0.  An encoder (``lm_head=False``) has no decode step and
    raises here."""
    if not cfg.lm_head:
        raise ValueError(f"{cfg.name}: an encoder (lm_head=False) has no "
                         f"decode step")
    layout = LM.cache_layout(cfg, batch, max_seq, cache_dtype)
    dev = resolve_device(device)
    probes = [i for i, entry in enumerate(layout)
              if entry not in layout[:i]]
    positional = any(spec.mixer not in ("rwkv", "mamba")
                     for spec in cfg.layer_specs())

    def check(cache: LM.Cache) -> None:
        got = {i: {n: (tuple(t.shape), t.dtype)
                   for n, t in cache[i].items()}
               for i in probes if i < len(cache)}
        if len(cache) != len(layout) or \
                any(got[i] != layout[i] for i in probes) or \
                any(t.device.type != dev.type
                    for i in probes for t in cache[i].values()):
            raise ValueError(f"serve_step: cache ({len(cache)} layers, "
                             f"first {got.get(0)}) is not the {cfg.name} "
                             f"cache ({len(layout)} layers, first "
                             f"{layout[0]}) on {dev} this step was built "
                             f"for")

    def serve_step(params: LM.Params, cache: LM.Cache,
                   tokens: torch.Tensor, pos: int):
        check(cache)
        if pos < 0 or (positional and pos >= max_seq):
            raise ValueError(f"serve_step: position {pos} outside the "
                             f"cache (max_seq {max_seq})")
        with torch.no_grad():
            return LM.decode_step(cfg, params, cache, tokens.to(dev), pos)

    return serve_step


# ----------------------------------------------------------------------
# the runnable trainer
# ----------------------------------------------------------------------

def train_loop(cfg: LM.LMConfig, *, steps: int, batch_size: int,
               seq_len: int, optimizer: str = "adamw", lr: float = 3e-4,
               foreach: bool = False,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 100,
               log_every: int = 10, seed: int = 0,
               straggler_threshold: float = 3.0,
               device=None) -> Dict[str, Any]:
    """Training on synthetic LM data (``SyntheticLMDataset`` through a
    ``DataLoader`` with the reference's settings: 2 workers, shuffled by
    ``seed``, the last partial batch dropped).  Restores from the latest
    checkpoint in ``checkpoint_dir`` if there is one (the first step is
    the restored ``state["step"]``), saves asynchronously every
    ``checkpoint_every`` steps and once at the end.  As in the
    reference, a restarted run draws its batches from the start of
    epoch 0 again.

    Returns the reference's ``{"losses", "steps" (run in this call),
    "wall_time_s", "final_loss"}`` and, besides, each step's
    ``"grad_norms"`` and ``"step_times_s"`` (host seconds from the
    step's call to its loss on the host)."""
    from ..checkpoint import CheckpointManager
    from ..data import DataLoader, SyntheticLMDataset

    dev = resolve_device(device)
    step_fn = make_train_step(cfg, optimizer=optimizer, lr=lr,
                              foreach=foreach, device=dev)
    state = init_train_state(cfg, optimizer=optimizer, lr=lr, seed=seed,
                             device=dev)
    ckpt = None
    start_step = 0
    if checkpoint_dir:
        ckpt = CheckpointManager(checkpoint_dir)
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state = restored
            start_step = int(state["step"])

    ds = SyntheticLMDataset(cfg.vocab_size, seq_len, size=1 << 20,
                            seed=seed)
    loader = DataLoader(ds, batch_size=batch_size, shuffle=True,
                        num_workers=2, seed=seed, drop_last=True)

    history: List[float] = []
    grad_norms: List[float] = []
    step_times: List[float] = []
    t_loop = time.perf_counter()
    with default_device(dev):
        it = iter(loader)
        for step in range(start_step, steps):
            try:
                tokens, labels = next(it)
            except StopIteration:
                it = iter(loader)
                tokens, labels = next(it)
            batch = {"tokens": tokens.data, "labels": labels.data}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            grad_norms.append(float(metrics["grad_norm"]))
            step_times.append(dt)
            # straggler watchdog: flag steps >> median
            if len(step_times) > 10:
                med = float(np.median(step_times[-50:]))
                if dt > straggler_threshold * med:
                    print(f"[straggler] step {step}: {dt:.3f}s "
                          f"(median {med:.3f}s)")
            history.append(loss)
            if step % log_every == 0:
                tok_s = batch_size * seq_len / dt
                print(f"step {step:5d}  loss {loss:.4f}  "
                      f"{dt*1e3:6.1f} ms/step  {tok_s:,.0f} tok/s")
            if ckpt and step > 0 and step % checkpoint_every == 0:
                ckpt.save_async(state, step)
        it.close()
    if ckpt:
        ckpt.save(state, steps)
        ckpt.wait()
    wall = time.perf_counter() - t_loop
    return {"losses": history, "steps": steps - start_step,
            "wall_time_s": wall,
            "final_loss": history[-1] if history else None,
            "grad_norms": grad_norms, "step_times_s": step_times}


# ----------------------------------------------------------------------
# the command line (counterpart of examples/train_lm.py)
# ----------------------------------------------------------------------

SIZES = {
    # name: (layers, d_model, heads, kv, d_ff, vocab)
    "2m": (4, 128, 4, 2, 512, 2048),
    "20m": (8, 384, 8, 4, 1536, 8192),
    "100m": (12, 768, 12, 4, 3072, 16384),
}

def build_config(size: str) -> LM.LMConfig:
    l, d, h, kv, ff, v = SIZES[size]
    return LM.LMConfig(
        name=f"gpt-{size}", n_layers=l, d_model=d, n_heads=h,
        n_kv_heads=kv, d_ff=ff, vocab_size=v,
        pattern=(LM.BlockSpec("attn", "dense"),),
        param_dtype=torch.float32, remat="none", attn_backend="ref",
        tie_embeddings=True)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(
        description="Train an LM on synthetic data (checkpoint/resume).")
    ap.add_argument("--size", choices=SIZES, default="2m")
    ap.add_argument("--arch", choices=ARCHS, default=None,
                    help="train an assigned arch's reduced config instead")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adam", "sgd", "adafactor"])
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # an arch's SMOKE is fed tokens whatever its input_mode, as the
    # reference's trainer does: an embeddings-mode arch embeds them
    cfg = (get_smoke_config(args.arch) if args.arch
           else build_config(args.size))
    print(f"training {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} on {dev}")
    result = train_loop(
        cfg, steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, optimizer=args.optimizer, lr=args.lr,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, log_every=10, device=dev)
    final = result["final_loss"]
    print(f"\ndone: {result['steps']} steps in "
          f"{result['wall_time_s']:.1f}s, final loss "
          f"{'none' if final is None else f'{final:.4f}'}")
    return result


if __name__ == "__main__":
    main()
