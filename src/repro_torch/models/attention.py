"""Attention for the serving path, in PyTorch.

Counterpart of ``repro/models/attention.py`` for paged attention only.
``sdpa``, ``mixed_attention`` and ``decode_attention`` come with the
next slices (the contiguous-cache path and training).

There is one path: :func:`paged_attention` is ``kernels.ops.
paged_attention``, whose wrapper launches the CUDA kernel for CUDA
tensors (or raises) and runs the plain version for CPU tensors.  Unlike
the reference there is no ``try``/``except`` around the kernel, no
``d % 128`` rule (the kernel takes every instantiated head_dim and raises
on any other), and no backend that would send CUDA tensors to the plain
version.
"""

from __future__ import annotations

from ..kernels import ops as kops

paged_attention = kops.paged_attention


def select_paged_backend(requested: str, *, sharded: bool) -> str:
    """The reference pins its jnp path under a replica axis or a mesh; the
    port has no sharded serving yet, so that case raises.  Otherwise the
    config's ``attn_backend`` is returned as given: the tensor's device
    decides the path (module docstring)."""
    if sharded:
        raise NotImplementedError(
            "sharded serving (replicas / meshes) is not ported yet; see "
            "ROADMAP.md queue A, item 9")
    return requested
