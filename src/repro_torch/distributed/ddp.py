"""DistributedDataParallel for the port's eager ``nn.Module`` (paper §5.4,
§7).

Counterpart of ``repro/distributed/ddp.py``: "users can easily implement
heavily parallel programs that operate on independent GPUs but later
synchronize gradients using all-reduce style primitives", packaged the
way PyTorch's DDP does:

  * gradient BUCKETING: gradients are packed into ~``bucket_mb`` flat
    fp32 buffers in reverse parameter order (the order backward makes
    them ready), and each bucket's ``all_reduce`` is started as soon as
    it is packed (``async_op=True``), so it runs while the next bucket
    packs; every one is waited for before ``sync_gradients`` returns,
    which is before the optimizer step;
  * one ``all_reduce`` a bucket over the mesh's ``data`` group, divided
    by the group size (a mean);
  * optional INT8 compression with error feedback, by the reference's
    arithmetic (:func:`_compress_int8`): the bucket over the world size,
    plus last step's residual, is quantized with a per-bucket scale; the
    codes are summed, times the rank's own scale; the quantization error
    is fed back next step.

``torch.nn.parallel.DistributedDataParallel`` is not wrapped: it takes a
``torch.nn.Module``, and the port's modules are its own eager ones.  At
world size 1 (no mesh, or a ``data`` axis of 1) the sync is a no-op.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..core.tensor import Tensor
from ..launch.mesh import axis_sizes
from ..nn.module import Module
from . import collectives as C


def _compress_int8(flat: torch.Tensor, residual: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback int8 quantization: (codes, scale, new residual)."""
    if residual is not None:
        flat = flat + residual
    scale = torch.clamp(flat.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, flat - deq


class DistributedDataParallel(Module):
    """Wrap an eager module; ``sync_gradients()`` after backward averages
    the gradients over the mesh's ``axis`` with bucketed (optionally
    compressed) all-reduces."""

    def __init__(self, module: Module, mesh=None, axis: str = "data",
                 bucket_mb: float = 25.0, compress: Optional[str] = None):
        super().__init__()
        if compress not in (None, "int8"):
            raise ValueError(f"compress must be None or 'int8', got "
                             f"{compress!r}")
        self.module = module
        self.mesh = mesh
        self.axis = axis
        self.compress = compress
        self._residuals: Dict[int, torch.Tensor] = {}
        # buckets in REVERSE parameter order (grads become ready in
        # reverse order during backward: earliest-ready bucket first)
        params = list(module.parameters())[::-1]
        self.buckets: List[List[Tensor]] = []
        cur: List[Tensor] = []
        cur_bytes = 0
        limit = int(bucket_mb * 1e6)
        for p in params:
            cur.append(p)
            cur_bytes += p.size_bytes
            if cur_bytes >= limit:
                self.buckets.append(cur)
                cur, cur_bytes = [], 0
        if cur:
            self.buckets.append(cur)
        self.stats = {"synced_bytes": 0, "compressed_bytes": 0,
                      "num_allreduce": 0}

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    def world_size(self) -> int:
        if self.mesh is None:
            return 1
        return axis_sizes(self.mesh).get(self.axis, 1)

    def sync_gradients(self) -> None:
        world = self.world_size()
        if world <= 1:
            return
        group = self.mesh.get_group(self.axis)
        pending = []
        for bi, bucket in enumerate(self.buckets):
            grads = [p.grad for p in bucket]
            if all(g is None for g in grads):
                continue
            flat = torch.cat([
                (g.data if g is not None else
                 torch.zeros(p.shape, dtype=p.dtype, device=p.device)
                 ).reshape(-1).to(torch.float32)
                for p, g in zip(bucket, grads)])
            scale = None
            if self.compress == "int8":
                q, scale, residual = _compress_int8(
                    flat / world, self._residuals.get(bi))
                self._residuals[bi] = residual
                self.stats["compressed_bytes"] += int(q.numel())
                flat = q.to(torch.float32)
            pending.append((bucket, scale,
                            C.all_reduce_sum_async(flat, group)))
            self.stats["synced_bytes"] += int(flat.numel() * 4)
            self.stats["num_allreduce"] += 1
        for bucket, scale, work in pending:
            flat = work.wait()
            flat = flat * scale if scale is not None else flat / world
            offset = 0
            for p in bucket:
                n = p.numel()
                piece = flat[offset:offset + n].reshape(p.shape)
                p.grad = Tensor(piece.to(p.dtype))
                offset += n
