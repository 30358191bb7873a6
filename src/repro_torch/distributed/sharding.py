"""Sharding rules: parameter / cache / batch trees -> partition specs.

Counterpart of ``repro/distributed/sharding.py``, with the same table:

  * batch dims          -> ('pod', 'data')            (DP across pods+data)
  * column-parallel w   -> (..., 'data', 'model')     (TP out-dim, FSDP in)
  * row-parallel w      -> (..., 'model', 'data')     (TP in-dim -> sum)
  * experts             -> expert axis over 'model' when divisible (EP),
                           otherwise expert-FFN hidden dim over 'model'
  * embeddings          -> vocab over 'model' (vocab-parallel logits)
  * norms/scalars/small -> replicated
  * KV caches (decode)  -> heads over 'model' when divisible, else the
                           sequence dim over 'model' (context parallel)

The functions are pure functions of leaf shapes, the config and the
mesh's shape (a ``DeviceMesh`` or a ``launch.mesh.MeshShape``): they
read its axis names and sizes and nothing else.  A spec is a
:class:`PartitionSpec`, a tuple with one entry per dimension, each
``None``, an axis name or a tuple of axis names, as
``jax.sharding.PartitionSpec`` reads.

The port keeps parameters per layer (``models/lm.py``) where the
reference stacks them per group, so a port leaf's spec is the
reference's with the leading stack axis dropped; that axis is never
sharded.  The reference's two switches for attention heads that do not
divide the ``model`` axis, ``REPRO_ATTN_FALLBACK=replicate`` and
``REPRO_SEQ_SHARD=1``, are read by name in :func:`param_spec`.

Unlike GSPMD, nothing here moves data: :func:`local_shard` cuts a rank's
shard from a full tensor by its spec and mesh coordinates (each axis
tuple taken major to minor, as GSPMD lays out a multi-axis dimension),
:func:`assemble` puts shards back together, and the serving executor
makes its collectives explicit.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from ..launch.mesh import axis_names as _axis_names
from ..launch.mesh import axis_sizes
from ..models.lm import LMConfig

Params = Dict[str, Any]


class PartitionSpec(tuple):
    """One entry per dimension: ``None`` (replicated), an axis name, or a
    tuple of axis names (the dimension split over their product); a
    one-name tuple is kept as the name, as JAX's spec keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class AxisRules:
    data: Tuple[str, ...] = ("data",)
    model: Optional[str] = "model"
    batch: Tuple[str, ...] = ("pod", "data")

    @classmethod
    def for_mesh(cls, mesh) -> "AxisRules":
        names = _axis_names(mesh)
        batch = tuple(a for a in ("pod", "data") if a in names)
        return cls(data=("data",) if "data" in names else (),
                   model="model" if "model" in names else None,
                   batch=batch)


def _divides(n: int, mesh, axis: Optional[str]) -> bool:
    sizes = axis_sizes(mesh)
    if axis is None or axis not in sizes:
        return False
    return n % sizes[axis] == 0


def _fsdp_ok(dim: int, mesh, rules: AxisRules) -> bool:
    sizes = axis_sizes(mesh)
    return bool(rules.data) and all(a in sizes for a in rules.data) and \
        dim % math.prod(sizes[a] for a in rules.data) == 0


def param_spec(path: str, leaf, cfg: LMConfig, mesh,
               rules: AxisRules) -> PartitionSpec:
    """Name-based sharding table.  ``path`` is the '/'-joined tree path
    (``layers/3/attn/wq``)."""
    shape = tuple(leaf.shape)
    ndim = len(shape)
    mdl = rules.model
    dat = rules.data if rules.data else None
    sizes = axis_sizes(mesh)

    def lead(spec_tail: Tuple) -> PartitionSpec:
        pad = ndim - len(spec_tail)
        return P(*([None] * pad + list(spec_tail)))

    def col() -> PartitionSpec:  # (..., in, out): FSDP in, TP out
        in_dim, out_dim = shape[-2], shape[-1]
        return lead(((dat if _fsdp_ok(in_dim, mesh, rules) else None),
                     (mdl if _divides(out_dim, mesh, mdl) else None)))

    def row() -> PartitionSpec:  # (..., in, out): TP in, FSDP out
        in_dim, out_dim = shape[-2], shape[-1]
        return lead(((mdl if _divides(in_dim, mesh, mdl) else None),
                     (dat if _fsdp_ok(out_dim, mesh, rules) else None)))

    if ndim <= 1:
        return P(*([None] * ndim))

    # embeddings / heads
    if re.search(r"(^|/)embed$", path):
        v, d = shape
        return P((mdl if _divides(v, mesh, mdl) else None),
                 (dat if _fsdp_ok(d, mesh, rules) else None))
    if re.search(r"(lm_head|cls_head)$", path):
        return col()

    # MoE (the expert weights are (E, in, out); the shared expert's are
    # 2-D here and take the mlp rules below.  The reference reads
    # shape[-3] of its group-stacked shared weight as an expert count, so
    # it splits the stack axis over model instead: ROADMAP.md queue C)
    if "/moe/" in path and "/moe/shared/" not in path:
        if path.endswith("router"):
            return P(*([None] * ndim))
        if path.endswith(("w_up", "w_gate", "w_down")):
            e = shape[-3]
            if _divides(e, mesh, mdl):                 # EP
                return lead((mdl,
                             (dat if _fsdp_ok(shape[-2], mesh, rules)
                              else None),
                             None))
            if path.endswith("w_down"):
                return lead((None,
                             (mdl if _divides(shape[-2], mesh, mdl)
                              else None),
                             (dat if _fsdp_ok(shape[-1], mesh, rules)
                              else None)))
            return lead((None,
                         (dat if _fsdp_ok(shape[-2], mesh, rules)
                          else None),
                         (mdl if _divides(shape[-1], mesh, mdl)
                          else None)))

    # attention; heads that do not divide the model axis keep only FSDP
    # under either switch (attention replicated, or the residual stream
    # sequence-sharded)
    _nondivisible = (mdl is not None
                     and cfg.n_heads % sizes.get(mdl, 1) != 0)
    _no_head_tp = _nondivisible and (
        os.environ.get("REPRO_ATTN_FALLBACK") == "replicate"
        or os.environ.get("REPRO_SEQ_SHARD") == "1")
    if re.search(r"/attn/w[qkv]$", path) or path.endswith(("wq_b", "wkv_b")):
        if _no_head_tp:
            in_dim = shape[-2]
            return lead(((dat if _fsdp_ok(in_dim, mesh, rules) else None),
                         None))
        return col()
    if path.endswith(("/attn/wo", "wo")):
        if _no_head_tp:
            out_dim = shape[-1]
            return lead((None,
                         (dat if _fsdp_ok(out_dim, mesh, rules)
                          else None)))
        return row()
    if path.endswith(("wq_a", "wkv_a")):
        return col()

    # dense MLP / shared expert
    if path.endswith(("w_up", "w_gate", "cm_k")):
        return col()
    if path.endswith(("w_down", "cm_v")):
        return row()

    # mamba
    if path.endswith("in_proj"):
        return col()
    if path.endswith("out_proj"):
        return row()
    if path.endswith("x_proj"):
        return lead(((mdl if _divides(shape[-2], mesh, mdl) else None),
                     None))
    if path.endswith("dt_proj"):
        return lead((None,
                     (mdl if _divides(shape[-1], mesh, mdl) else None)))
    if path.endswith("A_log"):
        return lead(((mdl if _divides(shape[-2], mesh, mdl) else None),
                     None))

    # rwkv
    if re.search(r"/rwkv/w_[rkvg]$", path) or path.endswith(
            ("decay_a", "cm_r")):
        return col()
    if path.endswith(("/rwkv/w_o", "decay_b")):
        return row()

    return P(*([None] * ndim))


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, prefix=""):
    """``fn(path, leaf)`` over a tree of dicts and lists, paths
    '/'-joined (dict keys, list indices), the tree's structure kept."""
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def param_specs(cfg: LMConfig, params: Params, mesh) -> Params:
    rules = AxisRules.for_mesh(mesh)
    return tree_map_with_path(
        lambda p, l: param_spec(p, l, cfg, mesh, rules), params)


# ----------------------------------------------------------------------
# batch + cache specs
# ----------------------------------------------------------------------

def batch_specs(cfg: LMConfig, batch: Dict[str, Any], mesh) -> Dict:
    rules = AxisRules.for_mesh(mesh)
    bt = rules.batch

    def spec(name, leaf):
        nd = len(leaf.shape)
        if name == "pos" or nd == 0:
            return P()
        if leaf.shape[0] == 1:   # batch 1 cannot shard
            return P(*([None] * nd))
        return P(bt, *([None] * (nd - 1)))

    return {k: spec(k, v) for k, v in batch.items()}


def cache_specs(cfg: LMConfig, cache, mesh):
    """KV cache sharding for decode: batch over ('pod', 'data'); heads
    over 'model' when divisible, else sequence over 'model' (context-
    parallel decode); mamba/rwkv states shard their channel dim over
    'model'.  The port's cache is per layer (no leading group axis)."""
    rules = AxisRules.for_mesh(mesh)
    mdl = rules.model
    bt = rules.batch
    sizes = axis_sizes(mesh)

    def spec(path: str, leaf) -> PartitionSpec:
        shape = tuple(leaf.shape)
        nd = len(shape)
        pad = [None] * (nd - 4) if nd > 4 else []
        batch_dim = shape[nd - 4] if nd >= 4 else (
            shape[nd - 3] if nd >= 3 else None)
        b_ax = bt if (batch_dim is not None and batch_dim > 1
                      and batch_dim % math.prod(
                          sizes[a] for a in bt) == 0) else None

        if path.endswith(("/k", "/v")):           # (..., B, H, S, D)
            _, h, s, _ = shape[-4:]
            if _divides(h, mesh, mdl):
                return P(*pad, b_ax, mdl, None, None)
            if _divides(s, mesh, mdl):
                return P(*pad, b_ax, None, mdl, None)
            return P(*pad, b_ax, None, None, None)
        if path.endswith("c_kv"):                 # (..., B, S, rank)
            s = shape[-2]
            return P(*([None] * (nd - 3)), b_ax,
                     (mdl if _divides(s, mesh, mdl) else None), None)
        if path.endswith("k_rope"):               # (..., B, 1, S, r)
            s = shape[-2]
            return P(*pad, b_ax, None,
                     (mdl if _divides(s, mesh, mdl) else None), None)
        if path.endswith("/ssm"):                 # (..., B, Di, N)
            return P(*([None] * (nd - 3)), b_ax,
                     (mdl if _divides(shape[-2], mesh, mdl) else None),
                     None)
        if path.endswith("/conv"):                # (..., B, K-1, Di)
            return P(*([None] * (nd - 3)), b_ax, None,
                     (mdl if _divides(shape[-1], mesh, mdl) else None))
        if path.endswith("/wkv"):                 # (..., B, H, D, D)
            return P(*pad, b_ax,
                     (mdl if _divides(shape[-3], mesh, mdl) else None),
                     None, None)
        if path.endswith(("shift", "cm_shift")):  # (..., B, 1, D)
            return P(*([None] * (nd - 3)), b_ax, None,
                     (mdl if _divides(shape[-1], mesh, mdl) else None))
        return P(*([None] * nd))

    return tree_map_with_path(spec, cache)


# ----------------------------------------------------------------------
# serving (paged-pool) specs: the (data, model) serving mesh
# ----------------------------------------------------------------------

def serving_rules(mesh) -> AxisRules:
    """Serving axis rules: tensor parallel over ``model``, no FSDP (a
    decode step is bound by bytes, and gathering weight shards every
    layer would put an all-gather on the latency path every step).
    Parameters replicate over ``data``; each data replica serves its own
    slot lanes against its own page range."""
    return AxisRules(
        data=(), batch=(),
        model="model" if "model" in _axis_names(mesh) else None)


def serving_param_specs(cfg: LMConfig, params: Params, mesh) -> Params:
    """:func:`param_spec`'s col/row table under :func:`serving_rules`:
    the head/MLP split training uses, without the FSDP axis."""
    rules = serving_rules(mesh)
    return tree_map_with_path(
        lambda p, l: param_spec(p, l, cfg, mesh, rules), params)


def serving_kv_spec(n_kv_heads: int, mesh, *,
                    pages_per_replica: int) -> PartitionSpec:
    """Spec of one per-layer page pool (num_pages_total, page_size,
    n_kv_heads, head_dim).  The page axis splits over ``data``: replica r
    owns the contiguous page range [r*ppr, (r+1)*ppr).  The KV head axis
    splits over ``model`` when it divides; when it does not, the page
    (sequence) axis also takes ``model`` (context-parallel KV): each
    model rank attends the pages it holds, and the partials are merged
    by their log-sum-exps (``serving.executor``)."""
    names = _axis_names(mesh)
    dat = "data" if "data" in names else None
    mdl = "model" if "model" in names else None
    tp = axis_sizes(mesh).get("model", 1) if mdl else 1
    if tp > 1 and n_kv_heads % tp == 0:
        return P(dat, None, mdl, None)
    if tp > 1 and pages_per_replica % tp == 0:
        return P((dat, mdl) if dat else mdl, None, None, None)
    return P(dat, None, None, None)


def serving_kv_scale_spec(n_kv_heads: int, mesh, *,
                          pages_per_replica: int) -> PartitionSpec:
    """Spec of a quantized pool's per-layer scales (num_pages_total,
    page_size, n_kv_heads): :func:`serving_kv_spec` without head_dim, so
    every scale lives with its page's codes."""
    spec = serving_kv_spec(n_kv_heads, mesh,
                           pages_per_replica=pages_per_replica)
    return P(*spec[:3])


def serving_mirror_spec(mesh) -> PartitionSpec:
    """Block-table mirror (R*S, W): slot rows split over ``data`` (replica
    r's S rows on its own ranks), widths replicated."""
    return P("data" if "data" in _axis_names(mesh) else None, None)


# ----------------------------------------------------------------------
# shards
# ----------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_range(dim: int, entry, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> Tuple[int, int]:
    """[lo, hi) of a dimension of ``dim`` split by ``entry`` that the rank
    at ``coords`` holds: the entry's axes taken major to minor.  Raises
    when the dimension does not divide."""
    axes = _axes(entry)
    n = math.prod(sizes[a] for a in axes)
    if dim % n:
        raise ValueError(f"dimension {dim} does not split {n} ways "
                         f"over {axes}")
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    step = dim // n
    return idx * step, (idx + 1) * step


def local_shard(x: torch.Tensor, spec, mesh, coords: Mapping[str, int]
                ) -> torch.Tensor:
    """The rank's shard of the full tensor ``x`` under ``spec``: a view,
    one slice a sharded dimension."""
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        lo, hi = shard_range(x.shape[d], entry, sizes, coords)
        x = x.narrow(d, lo, hi - lo)
    return x


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's piece of a tensor of ``shape`` under
    ``spec``."""
    sizes = axis_sizes(mesh)
    return tuple(n // math.prod(sizes[a] for a in _axes(e))
                 for n, e in zip(shape, spec))


def all_coords(mesh):
    """Every mesh position as an axis -> coordinate dict, row-major."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    for flat in range(math.prod(sizes.values())):
        c, rest = {}, flat
        for a in reversed(names):
            c[a] = rest % sizes[a]
            rest //= sizes[a]
        yield {a: c[a] for a in names}


def assemble(shard_of: Callable[[Mapping[str, int]], torch.Tensor],
             full_shape, spec, mesh) -> torch.Tensor:
    """The inverse of :func:`local_shard`: the full tensor from
    ``shard_of(coords)`` for every mesh position.  Raises when two
    positions that hold one element disagree on it."""
    sizes = axis_sizes(mesh)
    out, seen = None, None
    for c in all_coords(mesh):
        piece = shard_of(c)
        if out is None:
            out = torch.zeros(tuple(full_shape), dtype=piece.dtype)
            seen = torch.zeros(tuple(full_shape), dtype=torch.bool)
        idx = tuple(slice(*shard_range(full_shape[d], e, sizes, c))
                    if e is not None else slice(None)
                    for d, e in enumerate(spec))
        held = seen[idx]
        if bool(held.any()) and not torch.equal(out[idx][held],
                                                piece.cpu()[held]):
            raise ValueError(f"replicas of a shard disagree at {c}")
        out[idx] = piece.cpu()
        seen[idx] = True
    return out


def with_specs(fn: Callable[[Any, Any], Any], tree, specs):
    """``fn(leaf, spec)`` over ``tree``'s leaves (dicts and lists), the
    spec tree ``specs`` read at the same positions (its specs are
    tuples, so ``tree`` decides where the leaves are)."""
    if isinstance(tree, Mapping):
        return {k: with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(with_specs(fn, v, sp)
                          for v, sp in zip(tree, specs))
    return fn(tree, specs)


def gather_leaf(mesh, spec, x: torch.Tensor) -> torch.Tensor:
    """The whole leaf from this rank's piece ``x`` under ``spec`` (every
    rank calls): all-gathered over each axis of the spec, an entry of
    several axes minor axis first, as :func:`local_shard` cut it."""
    from . import collectives as C
    for d, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            x = C.all_gather_cat(x.contiguous(), mesh.get_group(a), d)
    return x


def gather_tree(mesh, specs, tree):
    """The inverse of ``launch.train.shard_tree`` over a ``DeviceMesh``
    (every rank calls): every leaf :func:`gather_leaf`; every rank gets
    the whole tree."""
    return with_specs(lambda x, spec: gather_leaf(mesh, spec, x), tree,
                      specs)
