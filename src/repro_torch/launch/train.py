"""Step builders and the trainer: train, prefill and decode steps, and
``train_loop`` (counterpart of ``repro/launch/train.py``).

The reference wraps each step in ``jax.jit`` with parameter, optimizer
and cache shardings over a device mesh, and donates the state.  The port
runs eagerly, and donation becomes updates in place: the train step
writes the new parameters and optimizer state into the tensors it was
given, leaf by leaf, so the model never has a second copy of its
parameters, and the decode step writes the cache in place.

Without a mesh every step runs in one process.  With ``mesh=`` (a
``DeviceMesh`` of ``data`` and ``model`` over the ranks of a process
group; every rank calls the step: SPMD) each rank holds its
``sharding.local_shard`` of every parameter (``param_specs``), optimizer
leaf (:func:`opt_state_specs`) and cache entry (``cache_specs``):
:func:`init_train_state` and :func:`shard_tree` cut them.  The steps take
the global batch (the same on every rank) and cut the rank's rows
(``batch_specs``); inside, ``distributed/act_sharding.py`` runs the
layers (FSDP over ``data``, tensor parallelism over ``model``, the
vocab-parallel loss), and the steps return the rank's pieces.

``train_loop`` is the runnable trainer on synthetic LM data (data
loader, checkpoint/restart, straggler-aware step timing), and
``python -m repro_torch.launch.train`` its command line, the counterpart
of ``examples/train_lm.py``::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --size 2m --steps 20
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import default_device, resolve_device
from ..configs import ARCHS, get_smoke_config
from ..distributed import act_sharding as AS
from ..distributed import collectives as C
from ..distributed import sharding as S
from ..models import lm as LM
from ..optim.functional import (LeafMeans, clip_by_global_norm,
                                make_optimizer, tree_leaves, tree_map)
from .mesh import axis_sizes, coords

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


def _update(update_opt, whole_list: bool, params, grads, opt,
            means: Optional[list] = None) -> None:
    """One optimizer update written in place: (params, grads, optimizer
    state) every leaf at once for the bucketed updates, else one leaf at
    a time.  ``means``: Adafactor's :class:`~repro_torch.optim.
    functional.LeafMeans` of each leaf (a meshed step's)."""
    leaves = tree_leaves(params)
    state = {k: v if k == "step" else _leaves_like(v, params)
             for k, v in opt.items()}
    if whole_list:
        parts = [(leaves, grads, state, means)]
    else:
        parts = (([p], [g], {k: v if k == "step" else [v[i]]
                             for k, v in state.items()},
                  None if means is None else [means[i]])
                 for i, (p, g) in enumerate(zip(leaves, grads)))
    for ps, gs, st, ms in parts:
        new_ps, new_st = update_opt(gs, st, ps,
                                    **({} if ms is None else {"means": ms}))
        _copy_into(ps, new_ps)
        for k, v in new_st.items():
            if k != "step":
                _copy_into(st[k], v)
    # every leaf's update read the old step; it moves once, after all
    if "step" in opt:
        opt["step"].copy_(new_st["step"])


def _microbatch(batch, accum_steps: int, i: int):
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


# ----------------------------------------------------------------------
# specs and shards of a state (the mesh half)
# ----------------------------------------------------------------------

def opt_state_specs(opt_state_abs, param_spec_tree):
    """Optimizer-state specs (the reference's ``opt_state_specs``):
    moment tensors (``m``, ``v``, ``momentum``) inherit the parameter's
    spec; Adafactor's ``row`` drops the last dimension's entry and
    ``col`` the second to last (the dimension each reduces); scalars
    replicate."""
    P = S.P

    def fac_spec(p_spec, fac):
        t = tuple(p_spec)
        out = {}
        for k in fac:
            if k == "row":
                out[k] = P(*t[:-1]) if len(t) else P()
            elif k == "col":
                out[k] = P(*(t[:-2] + t[-1:])) if len(t) >= 2 else P()
            else:
                out[k] = P(*t)
        return out

    def like(sub, specs, leaf_fn):
        if isinstance(sub, dict) and not _is_fac(sub):
            return {k: like(v, specs[k], leaf_fn) for k, v in sub.items()}
        if isinstance(sub, (list, tuple)):
            return [like(v, sp, leaf_fn) for v, sp in zip(sub, specs)]
        return leaf_fn(specs, sub)

    specs = {}
    for key, sub in opt_state_abs.items():
        if key in ("m", "v", "momentum"):
            specs[key] = like(sub, param_spec_tree, lambda sp, _: sp)
        elif key == "fac":
            specs[key] = like(sub, param_spec_tree, fac_spec)
        else:
            specs[key] = tree_map(lambda _: P(), sub)
    return specs


def _is_fac(d: dict) -> bool:
    return "row" in d or ("v" in d and not isinstance(d["v"], dict))


def shard_tree(mesh, spec_tree, tree):
    """This rank's pieces of ``tree`` (full tensors) on ``mesh``: each
    leaf's ``sharding.local_shard`` under its spec, copied into memory of
    its own, so the full tree can be freed."""
    here = coords(mesh)
    return S.with_specs(
        lambda x, spec: S.local_shard(x, spec, mesh, here).clone(
            memory_format=torch.contiguous_format), tree, spec_tree)


def init_pieces(cfg: LM.LMConfig, mesh, *, seed: int = 0, device=None,
                here=None) -> LM.Params:
    """This rank's pieces of ``lm.init_params(cfg, seed)`` on ``mesh``,
    equal to :func:`shard_tree` of the whole tree bit for bit, made
    without it: each leaf is drawn whole from the same seed stream, cut
    to the piece (a copy of its own) and dropped before the next is
    drawn, so the rank holds its pieces and one whole leaf at most (the
    counterpart of the reference's ``jax.jit(init, out_shardings=...)``).
    ``here``: the coordinates of the pieces (default the rank's on a
    ``DeviceMesh``; a ``MeshShape`` needs them)."""
    here = coords(mesh) if here is None else here
    rules = S.AxisRules.for_mesh(mesh)

    def cut(path: str, leaf: torch.Tensor) -> torch.Tensor:
        spec = S.param_spec(path, leaf, cfg, mesh, rules)
        piece = S.local_shard(leaf, spec, mesh, here)
        return leaf if piece.shape == leaf.shape else piece.clone(
            memory_format=torch.contiguous_format)

    return LM.init_params(cfg, seed=seed, device=device, cut=cut)


def spec_leaves(spec_tree, params) -> list:
    """The specs of ``params``'s leaves, in ``tree_leaves`` order."""
    return _leaves_like(spec_tree, params)


def state_specs(cfg: LM.LMConfig, mesh, *, optimizer: str = "adamw",
                lr: float = 3e-4, opt_kwargs: Optional[Dict] = None):
    """The spec tree of a train state ``{"params", "opt", "step"}`` on
    ``mesh``: ``param_specs`` of the parameters, :func:`opt_state_specs`
    of the optimizer's state, the step replicated."""
    kw = dict(opt_kwargs or {})
    kw.setdefault("lr", lr)
    init_opt, _ = make_optimizer(optimizer, **kw)
    params_abs = LM.abstract_params(cfg)
    p_specs = S.param_specs(cfg, params_abs, mesh)
    return {"params": p_specs,
            "opt": opt_state_specs(init_opt(params_abs), p_specs),
            "step": S.P()}


class PieceMeans(LeafMeans):
    """Adafactor's means over a leaf from this rank's piece of it (spec
    ``spec`` of the leaf's whole ``shape`` on ``mesh``): along a
    dimension the spec splits over mesh axes, the piece's fp32 sums are
    summed over those axes' groups and divided by the whole size; a
    dimension the piece holds whole takes the piece's own mean.  An axis
    over which the leaf is replicated is never summed over (that would
    count it once a replica).  ``tally`` counts the sums' collectives and
    the fp32 bytes each reduced."""

    def __init__(self, spec, shape, mesh, tally: Dict[str, int]):
        sizes = axis_sizes(mesh)
        self.axes = [[a for a in sizes if sizes[a] > 1
                      and a in _spec_axes((e,))] for e in spec]
        self.shape, self.mesh, self.tally = tuple(shape), mesh, tally

    def _sum(self, s: torch.Tensor, axes, n: int) -> torch.Tensor:
        for a in axes:
            C.all_reduce_sum(s, self.mesh.get_group(a))
            self.tally["calls"] += 1
            self.tally["bytes"] += s.numel() * s.element_size()
        return s / n

    def mean(self, x, dim, pdim, keepdim=False):
        axes = self.axes[pdim]
        if not axes:
            return x.mean(dim=dim, keepdim=keepdim)
        return self._sum(x.sum(dim=dim, keepdim=keepdim), axes,
                         self.shape[pdim])

    def mean_all(self, x):
        axes = [a for ax in self.axes for a in ax]
        if not axes:
            return torch.mean(x)
        return self._sum(torch.sum(x), axes, math.prod(self.shape))


def _local_batch(cfg, batch, mesh, here, dev):
    specs = S.batch_specs(cfg, batch, mesh)
    return {k: S.local_shard(v, specs[k], mesh, here).to(dev)
            for k, v in batch.items()}


def _batch_groups(mesh) -> list:
    return [mesh.get_group(a) for a in axis_sizes(mesh)
            if a in ("pod", "data")]


def make_train_step(cfg: LM.LMConfig, *, optimizer: str = "adamw",
                    lr: float = 3e-4, grad_clip: float = 1.0,
                    accum_steps: int = 1, foreach: bool = False,
                    opt_kwargs: Optional[Dict] = None,
                    device=None, mesh=None) -> Callable:
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
    is its per-leaf one.

    With ``mesh``, every rank of it calls the step with its pieces of the
    state (:func:`init_train_state` with the mesh) and the global batch;
    microbatches are cut from the global batch as without a mesh, then
    each rank takes its rows.  The gradients reach each rank's pieces
    already reduced (``distributed/act_sharding.py``); the global norm
    sums each piece's squares once (a leaf held whole by several ranks
    counts once) over every rank, and the update is the one-process
    update on the pieces (:func:`make_update`: Adafactor's row and column
    means and its RMS clip complete the pieces' sums over the axes that
    split each leaf; ``step.update_reductions`` counts their collectives
    and bytes).  ``loss`` and ``grad_norm`` are the global values on
    every rank.  Every block, switch and optimizer runs on any mesh.

    ``step.compute(params, batch)`` returns the step's (loss, gradients
    of the leaves in order) without the clip and the update."""
    LM._check_supported(cfg)
    dev = resolve_device(device)
    update = make_update(cfg, optimizer=optimizer, lr=lr, foreach=foreach,
                         opt_kwargs=opt_kwargs, mesh=mesh)
    specs = None
    if mesh is not None:
        params_abs = LM.abstract_params(cfg)
        specs = S.param_specs(cfg, params_abs, mesh)
        here = coords(mesh)
        sizes = axis_sizes(mesh)
        # how many ranks hold each leaf's piece whole (its norm's share)
        copies = [math.prod(n for a, n in sizes.items()
                            if a not in _spec_axes(sp))
                  for sp in spec_leaves(specs, params_abs)]

    def loss_and_grads(params, batch):
        tree = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(tree)
        with AS.scope(mesh, specs):
            # (the backward re-runs remat groups: it needs the scope too)
            loss = LM.lm_loss(cfg, tree, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), list(grads)

    def compute(params, batch: Dict[str, torch.Tensor]):
        """(loss, gradients of the leaves in order) of the step, before
        the clip; with a mesh the rank's reduced gradients of its pieces
        and the global loss."""
        if mesh is None:
            micro = lambda b: {k: v.to(dev) for k, v in b.items()}
        else:
            micro = lambda b: _local_batch(cfg, b, mesh, here, dev)
        if accum_steps <= 1:
            loss, grads = loss_and_grads(params, micro(batch))
        else:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for p in tree_leaves(params)]
            for i in range(accum_steps):
                l, g = loss_and_grads(
                    params, micro(_microbatch(batch, accum_steps, i)))
                loss = loss + l
                grads = [a + b for a, b in zip(grads, g)]
            loss = loss / accum_steps
            grads = [g / accum_steps for g in grads]
        if mesh is not None:
            for group in _batch_groups(mesh):
                C.all_reduce_sum(loss, group)
        return loss, grads

    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        loss, grads = compute(params, batch)
        with torch.no_grad(), torch.profiler.record_function(OPT_RANGE):
            if mesh is None:
                grads, gnorm = clip_by_global_norm(grads, grad_clip)
            else:
                grads, gnorm = _clip_meshed(grads, copies, grad_clip, mesh)
            update(params, grads, state["opt"])
            state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    step.compute = compute
    step.update_reductions = update.reductions
    return step


def make_update(cfg: LM.LMConfig, *, optimizer: str = "adamw",
                lr: float = 3e-4, foreach: bool = False,
                opt_kwargs: Optional[Dict] = None, mesh=None) -> Callable:
    """Returns ``update(params, grads, opt) -> None``, the optimizer
    update :func:`make_train_step`'s step runs after the clip: the
    parameters and the state ``opt`` written in place from ``grads`` (the
    leaves' gradients in order).  With ``mesh`` they are the rank's
    pieces: Adafactor takes its means over each whole leaf through
    :class:`PieceMeans`, whose collectives and bytes ``update.
    reductions`` counts; the other optimizers are elementwise."""
    kw = dict(opt_kwargs or {})
    kw.setdefault("lr", lr)
    _, update_opt = make_optimizer(optimizer, foreach=foreach, **kw)
    whole_list = foreach and optimizer != "adafactor"
    reductions = {"calls": 0, "bytes": 0}
    factored = mesh is not None and optimizer == "adafactor"
    if factored:
        params_abs = LM.abstract_params(cfg)
        specs = S.param_specs(cfg, params_abs, mesh)

    def update(params, grads, opt) -> None:
        means = None
        if factored:
            # each leaf's spec and whole shape, in the order of params
            means = [PieceMeans(sp, whole.shape, mesh, reductions)
                     for sp, whole in zip(spec_leaves(specs, params),
                                          _leaves_like(params_abs, params))]
        _update(update_opt, whole_list, params, grads, opt, means)

    update.reductions = reductions
    return update


def _spec_axes(spec) -> set:
    out = set()
    for e in spec:
        if isinstance(e, tuple):
            out.update(e)
        elif e is not None:
            out.add(e)
    return out


def _clip_meshed(grads, copies, max_norm: float, mesh):
    """``clip_by_global_norm`` over the ranks' pieces: each piece's
    squares divided by the ranks that hold it whole, summed over every
    axis of the mesh."""
    sq = torch.stack([torch.sum(torch.square(g.float())) / n
                      for g, n in zip(grads, copies)]).sum()
    for a in axis_sizes(mesh):
        C.all_reduce_sum(sq, mesh.get_group(a))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-6), max=1.0)
    return [g * scale for g in grads], norm


def init_train_state(cfg: LM.LMConfig, *, optimizer: str = "adamw",
                     lr: float = 3e-4, seed: int = 0, device=None,
                     mesh=None, params: Optional[LM.Params] = None
                     ) -> Dict[str, Any]:
    """``{"params", "opt", "step"}``: ``lm.init_params(cfg, seed)`` on
    ``device`` (or ``params``, full tensors, when given), the optimizer's
    ``init`` of them (both packages start the optimizer from
    ``init_opt(params)``) and an int32 step of 0.  With ``mesh``, the
    parameters are this rank's pieces and the optimizer starts from
    them: the pieces of the one-process state.  Made here, they are cut
    leaf by leaf as they are drawn (:func:`init_pieces`: a rank holds its
    pieces and one whole leaf at most); given, they are
    :func:`shard_tree` of the full ones, which can then be freed.  On
    ``meta`` (the dry run) they are :func:`shard_tree` of
    ``lm.abstract_params``: shapes alone, no number drawn."""
    dev = resolve_device(device)
    if params is None and dev.type == "meta":
        params = LM.abstract_params(cfg)
        if mesh is not None:
            params = shard_tree(mesh, S.param_specs(cfg, params, mesh),
                                params)
    elif params is None:
        params = (LM.init_params(cfg, seed=seed, device=dev)
                  if mesh is None else init_pieces(cfg, mesh, seed=seed,
                                                   device=dev))
    elif mesh is not None:
        params = shard_tree(mesh, S.param_specs(cfg, params, mesh), params)
    init_opt, _ = make_optimizer(optimizer, lr=lr)
    return {"params": params, "opt": init_opt(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_prefill_step(cfg: LM.LMConfig, device=None, mesh=None, *,
                      max_seq: Optional[int] = None) -> Callable:
    """Returns ``prefill(params, batch) -> logits (B, S, V)``, where
    ``batch`` holds ``"tokens"`` (B, S) or ``"embeds"`` (B, S, D).  Runs
    ``lm.forward`` without autograd on ``device`` (default CUDA); inputs
    on another device are moved there.  With ``mesh``, ``params`` are the
    rank's pieces, ``batch`` the global batch, and the result the rank's
    piece of the logits: its batch rows, and its vocabulary slice where
    the head splits the vocabulary over ``model`` (:func:`greedy_tokens`
    reads the argmax across the slices).

    With ``max_seq`` the step is ``prefill(params, batch, cache)``: it
    also writes the S positions' entries into ``cache``
    (``lm.init_cache(cfg, B, max_seq, dtype)`` of any dtype; with
    ``mesh`` the rank's pieces, ``init_cache(..., mesh=mesh)``), cast to
    the cache's dtype, as S calls of :func:`make_serve_step`'s step from
    position 0 would, so that the serve step built with the same
    ``batch`` and ``max_seq`` continues at position S.  An encoder
    (``lm_head=False``) has no cache and raises here."""
    LM._check_supported(cfg)
    dev = resolve_device(device)
    if max_seq is not None and not cfg.lm_head:
        raise ValueError(f"{cfg.name}: an encoder (lm_head=False) has no "
                         f"cache to fill")
    specs = None
    if mesh is not None:
        specs = S.param_specs(cfg, LM.abstract_params(cfg), mesh)
        here = coords(mesh)

    def prefill(params: LM.Params, batch: Dict[str, torch.Tensor],
                cache: Optional[LM.Cache] = None) -> torch.Tensor:
        if (cache is None) != (max_seq is None):
            raise ValueError("prefill: a cache goes with a step built with "
                             "max_seq, and only with one")
        fill_specs = None
        if mesh is not None:
            if cache is not None:
                rows = next(iter(batch.values())).shape[0]
                fill_specs = S.cache_specs(cfg, LM.abstract_cache(
                    cfg, rows, max_seq), mesh)
            batch = _local_batch(cfg, batch, mesh, here, dev)
        tokens, embeds = batch.get("tokens"), batch.get("embeds")
        with torch.no_grad(), AS.scope(mesh, specs,
                                       fill_specs=fill_specs):
            logits, _ = LM.forward(
                cfg, params,
                tokens=None if tokens is None else tokens.to(dev),
                embeds=None if embeds is None else embeds.to(dev),
                cache=cache)
        return logits

    return prefill


def greedy_tokens(logits: torch.Tensor, mesh=None,
                  vocab_size: Optional[int] = None) -> torch.Tensor:
    """The argmax over the vocabulary of ``logits`` (..., V), the lower
    index first among equal values.  With ``mesh``, ``logits`` is a
    rank's piece from a meshed step: its batch rows, and, when it is
    narrower than ``vocab_size``, its vocabulary slice (each rank's best
    value and index are gathered over ``model``, and the first rank
    holding the maximum wins); every rank gets the global batch's tokens
    (the rows gathered over the batch axes)."""
    if mesh is None:
        return logits.argmax(-1)
    sizes = axis_sizes(mesh)
    if logits.shape[-1] != vocab_size:
        group = mesh.get_group("model")
        idx = logits.argmax(-1, keepdim=True)
        best = logits.float().gather(-1, idx)[..., 0]
        idx = idx[..., 0] + mesh.get_local_rank("model") * logits.shape[-1]
        vals = torch.stack(C.all_gather(best.contiguous(), group))
        ids = torch.stack(C.all_gather(idx.contiguous(), group))
        tokens = ids.gather(0, vals.argmax(0, keepdim=True))[0]
    else:
        tokens = logits.argmax(-1)
    for a in reversed([a for a in sizes if a in ("pod", "data")]):
        tokens = C.all_gather_cat(tokens.contiguous(), mesh.get_group(a),
                                  0)
    return tokens


def make_serve_step(cfg: LM.LMConfig, *, batch: int, max_seq: int,
                    cache_dtype: torch.dtype = torch.bfloat16,
                    device=None, mesh=None) -> Callable:
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
    raises here.

    With ``mesh``, ``params`` are the rank's pieces, ``cache`` the
    rank's pieces of the cache under ``cache_specs`` (:func:`shard_tree`
    of ``init_cache``; the layout checked is the pieces'), ``tokens`` the
    global (B, 1) batch, and the logits the rank's piece (its rows, its
    vocabulary slice).  Where the KV heads do not divide ``model`` the
    cache's slots are split over it, and each layer merges the ranks'
    partial attention by their log-sum-exps (the decode kernel's
    ``return_lse``); so does an MLA layer, whose latent cache's slots
    split over ``model`` whenever ``max_seq`` divides it
    (``layers.mla_attention``)."""
    if not cfg.lm_head:
        raise ValueError(f"{cfg.name}: an encoder (lm_head=False) has no "
                         f"decode step")
    layout = LM.cache_layout(cfg, batch, max_seq, cache_dtype)
    dev = resolve_device(device)
    if mesh is not None:
        p_specs = S.param_specs(cfg, LM.abstract_params(cfg), mesh)
        c_specs = S.cache_specs(
            cfg, LM.abstract_cache(cfg, batch, max_seq, cache_dtype), mesh)
        here = coords(mesh)
        held: Dict = {}
        layout = [{n: (S.local_shape(shape, c_specs[i][n], mesh), dt)
                   for n, (shape, dt) in entry.items()}
                  for i, entry in enumerate(layout)]
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
        if mesh is None:
            with torch.no_grad():
                return LM.decode_step(cfg, params, cache, tokens.to(dev),
                                      pos)
        tokens = _local_batch(cfg, {"tokens": tokens}, mesh, here,
                              dev)["tokens"]
        with torch.no_grad(), AS.scope(mesh, p_specs, c_specs,
                                       held) as scope:
            out = LM.decode_step(cfg, params, cache, tokens, pos)
            serve_step.lse_merges += scope.merges
        return out

    serve_step.lse_merges = 0
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
               device=None, mesh=None) -> Dict[str, Any]:
    """Training on synthetic LM data (``SyntheticLMDataset`` through a
    ``DataLoader`` with the reference's settings: 2 workers, shuffled by
    ``seed``, the last partial batch dropped).  Restores from the latest
    checkpoint in ``checkpoint_dir`` if there is one (the first step is
    the restored ``state["step"]``), saves asynchronously every
    ``checkpoint_every`` steps and once at the end.  As in the
    reference, a restarted run draws its batches from the start of
    epoch 0 again.

    With ``mesh`` every rank of it runs the loop over the meshed step
    (each draws the same global batches), the state is the rank's pieces,
    the checkpoints are saved whole (the mesh's first rank writes) and a
    restore hands each rank its pieces on this mesh, whatever mesh saved
    them; only the first rank prints.

    Returns the reference's ``{"losses", "steps" (run in this call),
    "wall_time_s", "final_loss"}`` and, besides, each step's
    ``"grad_norms"`` and ``"step_times_s"`` (host seconds from the
    step's call to its loss on the host)."""
    from ..checkpoint import CheckpointManager
    from ..data import DataLoader, SyntheticLMDataset

    dev = resolve_device(device)
    step_fn = make_train_step(cfg, optimizer=optimizer, lr=lr,
                              foreach=foreach, device=dev, mesh=mesh)
    state = init_train_state(cfg, optimizer=optimizer, lr=lr, seed=seed,
                             device=dev, mesh=mesh)
    specs = None if mesh is None else state_specs(
        cfg, mesh, optimizer=optimizer, lr=lr)
    speaks = mesh is None or not any(coords(mesh).values())
    ckpt = None
    start_step = 0
    if checkpoint_dir:
        ckpt = CheckpointManager(checkpoint_dir)
        restored = ckpt.restore_latest(state, mesh, specs)
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
            if len(step_times) > 10 and speaks:
                med = float(np.median(step_times[-50:]))
                if dt > straggler_threshold * med:
                    print(f"[straggler] step {step}: {dt:.3f}s "
                          f"(median {med:.3f}s)")
            history.append(loss)
            if step % log_every == 0 and speaks:
                tok_s = batch_size * seq_len / dt
                print(f"step {step:5d}  loss {loss:.4f}  "
                      f"{dt*1e3:6.1f} ms/step  {tok_s:,.0f} tok/s")
            if ckpt and step > 0 and step % checkpoint_every == 0:
                ckpt.save_async(state, step, mesh, specs)
        it.close()
    if ckpt:
        ckpt.save(state, steps, mesh, specs)
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
