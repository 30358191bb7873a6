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
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in place; returns ``x``.  A group of
    one rank is a no-op."""
    if group_size(group) == 1:
        return x
    if _staged(x, group):
        h = _host(x)
        dist.all_reduce(h, group=group)
        x.copy_(h)
    else:
        dist.all_reduce(x, group=group)
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


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of the global rank ``src`` on every rank of ``group``, in
    place; returns ``x``."""
    if group_size(group) == 1:
        return x
    if _staged(x, group):
        h = _host(x)
        dist.broadcast(h, src=src, group=group)
        x.copy_(h)
    else:
        dist.broadcast(x, src=src, group=group)
    return x


def send(x: torch.Tensor, dst: int, group=None) -> None:
    """Send ``x`` to the global rank ``dst`` (blocking)."""
    if _staged(x, group):
        x = _host(x)
    dist.send(x.contiguous(), dst=dst, group=group)


def recv(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Receive into ``x`` from the global rank ``src`` (blocking);
    returns ``x``."""
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
