"""The collectives the port's distributed code calls, over a process
group of either backend.

NCCL moves CUDA tensors card to card.  Gloo moves host memory: its
``all_gather``, ``send`` and ``recv`` take no CUDA tensor at all, so for
a CUDA tensor on a gloo group every collective here stages explicitly
through a pinned host buffer: copy out, run the collective on the host
copy, copy back.  That is the route when several ranks share one card
(NCCL refuses two ranks on one GPU): the compute and the kernels stay on
the card, and only the exchange crosses the host.  A CPU tensor goes to
gloo as it is.  No call here catches an error: a failed collective
raises.

The autograd functions at the end wrap these calls for the meshed train
step (``distributed/act_sharding.py``): Megatron's pair
(:func:`copy_to` and :func:`reduce_from`), the all-gather whose backward
sums the ranks' gradients (:func:`gather`, FSDP's gather-on-use and the
K/V of context-parallel attention), the all-gather whose backward takes
the rank's slice (:func:`gather_whole`) and the slice whose backward
gathers (:func:`split`), and the reduce-scatter whose backward gathers
(:func:`reduce_split`, the end of a row-parallel product under a
sequence-sharded residual stream); the reduce-scatter is gloo's and
NCCL's ``reduce_scatter_tensor`` (:func:`reduce_scatter`).

``stats`` counts the calls and the bytes each staged through the host,
and tallies each call by kind (``"kinds"``) and by mesh axis
(``"axes"``): its calls and its result buffer's bytes, the sizes the
reference's roofline sums over the collectives of its compiled program
(``repro/launch/roofline.py``), here summed where each call is made.
The kinds are the reference's: all-gather (the gathered whole),
all-reduce (the reduced tensor), reduce-scatter (the rank's slice),
all-to-all (none is called yet) and send/recv, the reference's
collective-permute (each message, counted by the rank that sends and
by the rank that receives it), and broadcast besides.  A group's axis
is the name :func:`label_axes` gave it (``launch/mesh.make_mesh`` labels
every mesh it builds), else ``"world"`` for the default group and
``"other"``.  A group of one rank makes no call and counts nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist


KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "send/recv", "broadcast")

# collectives called (group size > 1), bytes staged through the host
# (each copy out and back counted once), and each kind's and each mesh
# axis's calls and result bytes; reset with reset_stats()
stats: Dict = {}

# process group name -> the mesh axis it spans (label_axes)
_axis_names: Dict[str, str] = {}


def reset_stats() -> None:
    stats.update(calls=0, staged_bytes=0,
                 kinds={k: {"calls": 0, "bytes": 0} for k in KINDS},
                 axes={})


reset_stats()


def label_axes(mesh) -> None:
    """Name each axis group of the ``DeviceMesh`` ``mesh`` after its axis
    in the per-axis tally of ``stats``."""
    for axis in mesh.mesh_dim_names:
        _axis_names[mesh.get_group(axis).group_name] = axis


def _axis(group) -> str:
    if group is None or group == dist.group.WORLD:
        return _axis_names.get(dist.group.WORLD.group_name, "world")
    return _axis_names.get(group.group_name, "other")


def _count(kind: str, group, nbytes: int) -> None:
    stats["calls"] += 1
    stats["kinds"][kind]["calls"] += 1
    stats["kinds"][kind]["bytes"] += nbytes
    axis = stats["axes"].setdefault(_axis(group), {"calls": 0, "bytes": 0})
    axis["calls"] += 1
    axis["bytes"] += nbytes


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    stats["staged_bytes"] += x.numel() * x.element_size()
    return out


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in place; returns ``x``.  A group of
    one rank is a no-op."""
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s elementwise maximum over ``group``, in place; returns
    ``x``."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    _count("all-reduce", group, _nbytes(x))
    if _staged(x, group):
        h = _host(x)
        dist.all_reduce(h, op=op, group=group)
        x.copy_(h)
    else:
        dist.all_reduce(x, op=op, group=group)
    return x


class _Pending:
    """An in-flight ``all_reduce``: ``wait()`` returns the summed tensor
    (copied back to the card when the reduction was staged)."""

    def __init__(self, work, host: Optional[torch.Tensor], x: torch.Tensor):
        self.work, self.host, self.x = work, host, x

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        if self.host is not None:
            self.x.copy_(self.host)
        return self.x


def all_reduce_sum_async(x: torch.Tensor, group) -> _Pending:
    """Start summing ``x`` over ``group`` in place (``async_op=True``);
    the result's ``wait()`` returns ``x`` once it holds the sum."""
    if group_size(group) == 1:
        return _Pending(None, None, x)
    _count("all-reduce", group, _nbytes(x))
    if _staged(x, group):
        h = _host(x)
        return _Pending(dist.all_reduce(h, group=group, async_op=True), h, x)
    return _Pending(dist.all_reduce(x, group=group, async_op=True), None, x)


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (one shape and dtype on every rank), in group
    rank order, on ``x``'s device."""
    n = group_size(group)
    if n == 1:
        return [x]
    x = x.contiguous()
    _count("all-gather", group, n * _nbytes(x))
    if _staged(x, group):
        h = _host(x)
        outs = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(outs, h, group=group)
        return [o.to(x.device, non_blocking=True) for o in outs]
    outs = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(outs, x, group=group)
    return outs


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group rank order."""
    parts = all_gather(x, group)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` summed over ``group``, and of the sum this rank's slice along
    ``dim`` (the group's ranks in order); ``x`` is not changed."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split {n} ways")
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] // n,) + front.shape[1:],
                      dtype=x.dtype, device=x.device)
    _count("reduce-scatter", group, _nbytes(out))
    if _staged(x, group):
        h = _host(front)
        ho = torch.empty(out.shape, dtype=x.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(ho, h, group=group)
        out.copy_(ho)
    else:
        dist.reduce_scatter_tensor(out, front, group=group)
    return out.movedim(0, dim).contiguous()


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of the global rank ``src`` on every rank of ``group``, in
    place; returns ``x``."""
    if group_size(group) == 1:
        return x
    _count("broadcast", group, _nbytes(x))
    if _staged(x, group):
        h = _host(x)
        dist.broadcast(h, src=src, group=group)
        x.copy_(h)
    else:
        dist.broadcast(x, src=src, group=group)
    return x


def send(x: torch.Tensor, dst: int, group=None) -> None:
    """Send ``x`` to the global rank ``dst`` (blocking)."""
    _count("send/recv", group, _nbytes(x))
    if _staged(x, group):
        x = _host(x)
    dist.send(x.contiguous(), dst=dst, group=group)


def recv(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Receive into ``x`` from the global rank ``src`` (blocking);
    returns ``x``."""
    _count("send/recv", group, _nbytes(x))
    if _staged(x, group):
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        dist.recv(h, src=src, group=group)
        x.copy_(h)
    else:
        dist.recv(x, src=src, group=group)
    return x


def global_rank(group, group_rank: int) -> int:
    """The global rank of ``group_rank`` in ``group``."""
    return dist.get_global_rank(group, group_rank)


# ----------------------------------------------------------------------
# autograd-aware collectives (the meshed train step)
# ----------------------------------------------------------------------

def group_rank(group) -> int:
    return dist.get_rank(group)


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split {n} ways")
    step = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * step, step).contiguous()


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    return all_reduce_sum(x.contiguous().clone(), group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sum_grads):
        ctx.group, ctx.dim, ctx.sum_grads = group, dim, sum_grads
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        return _slice(g, ctx.group, ctx.dim), None, None, None


class _ReduceSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g.contiguous(), ctx.group, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g.contiguous(), ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, gradient summed over ``group`` (Megatron's f):
    where a tensor whole on every rank enters a computation each rank
    does its own part of."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' partial ``x`` summed over ``group``; gradient passed
    through (Megatron's g): the end of a row-parallel product."""
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def reduce_both(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, and its gradient summed too: a value
    every rank's share of the loss reads whole (the MoE balance loss's
    means over the data ranks)."""
    return x if group_size(group) == 1 else _ReduceBoth.apply(x, group)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' pieces concatenated along ``dim``; backward sums the
    ranks' gradients of the whole and returns this rank's slice (a
    reduce-scatter): for a whole tensor each rank uses for its own part
    of the work (FSDP's gathered weight, context-parallel K/V)."""
    if group_size(group) == 1:
        return x
    return _Gather.apply(x.contiguous(), group, dim, True)


def gather_whole(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' pieces concatenated along ``dim``; backward takes this
    rank's slice of the gradient: for a whole tensor every rank then
    computes the same function of."""
    if group_size(group) == 1:
        return x
    return _Gather.apply(x.contiguous(), group, dim, False)


def reduce_split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' partial ``x`` summed over ``group``, and of the sum this
    rank's slice along ``dim`` (a reduce-scatter); backward gathers the
    slices' gradients (Megatron's sequence-parallel g)."""
    return x if group_size(group) == 1 else _ReduceSplit.apply(x, group,
                                                               dim)


def split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (the rank's group rank
    picks it); backward gathers the slices' gradients."""
    return x if group_size(group) == 1 else _Split.apply(x, group, dim)
