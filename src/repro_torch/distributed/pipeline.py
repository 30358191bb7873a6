"""Pipeline parallelism over the ``pod`` axis (GPipe fill-drain).

Counterpart of ``repro/distributed/pipeline.py``: stages of a layer stack
live on different ranks and microbatches stream through them.  The
reference moves activations with ``ppermute`` inside ``shard_map``; the
port's ranks are processes, so stage s receives microbatch i from stage
s - 1 and sends its output to stage s + 1 with ``send`` / ``recv``
(``distributed.collectives``: staged through host memory for a CUDA
tensor on a gloo group).  Schedule: GPipe fill-drain over M microbatches
and S stages, tick t running microbatch t - s on stage s (bubble
fraction (S-1)/(M+S-1)).  The last stage's outputs are broadcast over
the axis, so every rank returns the full result, as the reference's
``psum`` of the masked buffer makes its replicated out spec true.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..launch.mesh import axis_sizes
from . import collectives as C


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh, n_microbatches: int,
                   axis: str = "pod") -> torch.Tensor:
    """Run ``x`` through S pipeline stages, one a rank of ``axis``.

    stage_fn(params_i, x) -> x        (same shape in and out)
    stage_params: a tree whose leaves have a leading stage axis S ==
                  the axis size; rank s uses slice s
    x: (B, ...) the global batch (the same on every rank);
       B % n_microbatches == 0.
    Returns the (B, ...) output on every rank."""
    n_stages = axis_sizes(mesh)[axis]
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not split into {n_microbatches} "
                         f"microbatches")
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    params = _tree_map(lambda a: a[stage], stage_params)
    micro = x.reshape((n_microbatches, b // n_microbatches) + x.shape[1:])
    prev = C.global_rank(group, stage - 1) if stage > 0 else None
    nxt = C.global_rank(group, stage + 1) if stage < n_stages - 1 else None
    out = torch.zeros_like(micro)
    for t in range(n_microbatches + n_stages - 1):
        i = t - stage
        if not 0 <= i < n_microbatches:
            continue
        if prev is None:
            inp = micro[i]
        else:
            inp = C.recv(torch.empty_like(micro[i]), prev, group)
        y = stage_fn(params, inp)
        if nxt is None:
            out[i] = y
        else:
            C.send(y, nxt, group)
    last = C.global_rank(group, n_stages - 1)
    return C.broadcast(out, last, group).reshape(x.shape)


def stages_from_groups(params_groups, n_stages: int):
    """Re-slice group-stacked params (leading n_groups axis) into
    n_stages contiguous chunks with a leading stage axis."""
    def slice_leaf(a):
        g = a.shape[0]
        if g % n_stages:
            raise ValueError(f"{g} groups do not split into {n_stages} "
                             f"stages")
        return a.reshape((n_stages, g // n_stages) + tuple(a.shape[1:]))

    return _tree_map(slice_leaf, params_groups)
