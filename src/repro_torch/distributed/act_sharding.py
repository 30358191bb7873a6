"""Activation sharding inside the model, and what each rank computes
under a mesh (counterpart of ``repro/distributed/act_sharding.py``).

The model code calls ``constrain(x, kind)`` where the reference does;
the step builders open a :func:`scope` over the mesh.  Outside a scope
(one process, the tests, serving) ``constrain`` is the identity.

Kinds, and the spec :func:`spec_for` picks for them (the reference's
choice, the same pure function of the global shape and the mesh):

  btd     (B, S, D) residual stream     -> P(batch, None, None); with
          ``REPRO_SEQ_SHARD=1`` P(batch, model, None)
  btf     (B, S, F) FFN hidden          -> P(batch, None, model) (F
          divides), or the sequence under ``REPRO_SEQ_SHARD=1``
  bhsd    (B, H, S, Dh) attention       -> heads over model when they
          divide, else (``REPRO_ATTN_FALLBACK``, default ``context``)
          the sequence over model, or replicated (``replicate``)
  logits  (B, S, V)                     -> P(batch, None, model)
  ecd/ecf, gecd/gecf                    -> the MoE's expert layouts

``None`` means the reference leaves the tensor unconstrained.

GSPMD moves data to meet a spec; the port runs one process a mesh
position (eager SPMD), so a rank's tensor is its local piece and
``constrain`` puts the piece into the kind's layout: a slice where the
spec shards a dimension the piece holds whole, an all-gather where the
piece is split and the spec wants it whole (``have`` says how it is
split).  Its gradients follow the same rule backwards, so the tensor the
pieces assemble to, and its gradient, never change value.

What each rank computes in a scope over a ``DeviceMesh`` of ``data`` and
``model`` (the meshed train, prefill and serve steps):

  * parameters are held as the rank's ``sharding.local_shard``
    (``param_specs``); :func:`use_params` gathers a layer's leaves when
    the layer runs: over ``data`` always (FSDP's gather-on-use; the
    backward reduce-scatters the gradients to the shards, or sums them
    for a leaf ``data`` does not split), over ``model`` where the layer
    needs the leaf whole;
  * tensor parallelism over ``model`` (Megatron): attention with its
    query heads split (``wq``/``wk``/``wv`` by columns, ``wo`` by rows
    and an all-reduce), the dense MLP (``w_up``/``w_gate`` by columns,
    ``w_down`` by rows), the embedding and LM head by vocabulary.  K/V
    whose heads do not divide ``model`` (gemma's one KV head) are
    computed whole on every rank from the gathered ``wk``/``wv``, for
    the rank's query heads; their gradient is summed over ``model``;
  * query heads that do not divide ``model``: under the ``context``
    fallback each rank attends its slice of the queries through
    ``models.attention.context_sdpa`` (K/V all-gathered along the
    sequence); otherwise the attention runs whole on every rank;
  * MoE: expert parallelism where the expert slots divide ``model``
    (each rank runs its experts on its rows of the dispatched tokens;
    the experts' outputs are gathered whole, and the router, dispatch
    and combine run whole on every rank), else the experts' hidden
    width split (Megatron: ``w_down``'s partial products summed over
    ``model``); the shared expert and a dense residual run as the dense
    MLP does;
  * mamba: the rank's channels of d_inner.  ``in_proj``, stored split by
    the columns of its ``[x | z]`` output, is gathered and re-cut to the
    rank's x and z columns; the replicated per-channel leaves
    (``conv_w``, ``conv_b``, ``dt_bias``, ``D``, ``norm``) are sliced to
    them; ``x_proj``'s partial product (rows) is summed over ``model``;
    the gated RMSNorm sums its squares over ``model``; ``out_proj``
    (rows) is reduced;
  * rwkv: the rank's heads (``w_r``/``w_k``/``w_v``/``w_g`` by columns,
    ``w_o`` by rows); ``bonus``, ``decay_base`` and ``ln_out`` sliced to
    them, the decay LoRA's two small leaves gathered (the rank computes
    its columns), ``ln_out``'s squares summed over ``model``; the
    channel mix splits ``cm_k``/``cm_v`` as the dense MLP does and
    gathers ``cm_r`` whole.  In decode the token-shift rows, split over
    ``model`` by ``cache_specs``, are gathered to read and sliced to
    write.  A mamba or rwkv layer whose channels or heads do not divide
    ``model`` runs whole on every rank;
  * MLA runs whole on every rank (its weights gathered over ``model``),
    in training and in a prefill.  In decode, where ``cache_specs``
    splits the latent cache's slots over ``model`` (``max_seq``
    divisible), rank r holds slots [r L, (r + 1) L) of ``c_kv`` and
    ``k_rope``: the step's latent and roped key go to the rank that holds
    slot ``cache_pos``, each rank expands its own live slots through
    ``wkv_b`` for every head and attends them through the decode kernel
    with its log-sum-exp, and the ranks' partials are merged by their
    log-sum-exps, as for a slot-split K/V cache (``"context"``).  The
    reference splits the heads instead (``wq_b``/``wkv_b`` by columns)
    and gathers the latent; both give the same values, and the slot
    split keeps a rank's cache to its own slots.  A whole cache (``max_seq``
    not divisible) decodes as one process does, on every rank;
  * Adafactor's factored statistics are means over a whole leaf: the
    meshed step's update (``launch.train.PieceMeans``) sums a piece's
    row sums (over the last dimension), column sums and the RMS clip's
    sum of squares over the axes that split the dimensions reduced, in
    fp32, and divides by the whole sizes; a leaf replicated over an axis
    is never summed over it.

Under ``REPRO_SEQ_SHARD=1``, in a forward whose sequence S a ``model``
axis of m > 1 ranks divides (:func:`seq_sharded`: the meshed train and
prefill steps), the residual stream is sequence-sharded as
``spec_for("btd")`` says: between blocks, and through the norms and the
residual adds, a rank holds its S/m positions (rank i the positions
[i S/m, (i+1) S/m)).  Inside a block it computes:

  * Megatron's sequence parallelism where the layer is tensor parallel
    (attention whose query heads divide ``model``, the split dense MLP,
    mamba's channels): the input is all-gathered along S where the plan
    above would copy it to the model group (:func:`copy_to_model` with
    ``seq``; the backward reduce-scatters), and the partial output
    reduce-scattered to the rank's rows where the plan would all-reduce
    it (:func:`reduce_from_model` with ``seq``; the backward gathers).
    ``param_specs``' layouts stay as they are and no weight is gathered
    over ``model``;
  * attention whose query heads do not divide ``model`` (``param_spec``
    then leaves its weights unsplit over ``model``), the ``"rows"``
    plan: the rank projects its own rows, ropes them at their absolute
    positions and attends through ``models.attention.context_sdpa``
    (K/V gathered along S); causal, sliding-window and bidirectional
    alike.  A dense MLP whose hidden width does not divide ``model``
    runs on the rows too.  A replicated weight used on the rank's rows
    (these, and every norm's) has its gradient summed over ``model``;
  * MoE (and its dense residual), MLA, rwkv, and a mamba layer that runs
    whole: the input is gathered whole along S (:func:`whole_sequence`),
    the layer runs its plan above on the whole sequence, and the rank
    keeps its rows of the output (:func:`own_rows`).  So MoE's capacity
    dispatch, token groups and aux loss, the scans, the token shift and
    the causal conv see the whole sequence, as under GSPMD;
  * the embedding's vocabulary-parallel lookup is reduce-scattered to
    the rank's rows (a whole table's lookup is sliced); the rows are
    gathered whole along S before the final norm and the head, since
    ``logits`` keeps S whole, so the vocab-parallel loss takes the labels
    and mask whole.

Where the ``btf`` layout departs from :func:`spec_for`: under the switch
the spec puts the FFN hidden's sequence over ``model``, but a block that
holds the whole sequence keeps its hidden split by columns (the split
MLP, the experts), which the port leaves as it is (it has no partitioner
to move data between the two); only an MLP that runs on the rows is
constrained, and that is a no-op.  A forward whose S the axis does not
divide (every decode step: S = 1) runs the path above unchanged.  A
prefill that fills a cache (``launch.train.make_prefill_step(max_seq=)``)
writes each layer's entries in ``cache_specs``' layout: a head-split
cache takes the rank's heads of K/V over the whole sequence (gathered
along S first on the ``"rows"`` plan), a slot-split one the positions
of the rank's slots.

The gradient convention: a tensor a ``model`` group holds whole has the
whole true gradient on every rank of the group; the ranks of a data
group each hold the gradient of their own share of the loss, and the
parameter gathers sum them.
"""

from __future__ import annotations

import math
import os
from contextlib import contextmanager
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import collectives as C

# The active scope.  A module global, not a thread-local as in the
# reference: autograd runs a CUDA backward, and with it the remat
# recompute of a checkpointed group, on its own device thread, which must
# see the step's scope.  One step runs in a process at a time.
_active: list = [None]


class _Scope:
    """The mesh's axes as the reference's scope reads them, and on a
    ``DeviceMesh`` the rank's process groups and coordinates."""

    def __init__(self, mesh, param_specs=None, cache_specs=None,
                 held=None, fill_specs=None):
        from ..launch.mesh import axis_sizes
        sizes = axis_sizes(mesh)
        self.batch = tuple(a for a in ("pod", "data") if a in sizes)
        self.model = "model" if "model" in sizes else None
        self.model_size = sizes.get("model", 1)
        self.data_size = math.prod(sizes[a] for a in self.batch)
        self.param_specs = param_specs
        self.cache_specs = cache_specs
        self.fill_specs = fill_specs
        self.held = held
        self.seq_pieces = False
        self.merges = 0
        self.used: Dict[str, torch.Tensor] = {}
        self.groups: Dict[str, object] = {}
        self.coords: Dict[str, int] = {}
        if hasattr(mesh, "get_group"):
            for a in sizes:
                self.groups[a] = mesh.get_group(a)
                self.coords[a] = mesh.get_local_rank(a)

    @property
    def spmd(self) -> bool:
        return bool(self.groups)


@contextmanager
def scope(mesh, param_specs=None, cache_specs=None, held=None,
          fill_specs=None):
    """Activate ``mesh`` (a ``DeviceMesh`` or a ``MeshShape``; ``None``
    deactivates) for :func:`constrain` and the meshed layers;
    ``param_specs`` is the parameter tree's spec tree, ``cache_specs``
    the decode cache's and ``fill_specs`` that of the cache a prefill
    fills, which :func:`use_params` reads.
    ``held``, a dict the caller keeps across scopes (no autograd), holds
    each leaf's gathered form until the leaf changes (its version
    counter), as FSDP's ``reshard_after_forward=False``: the meshed serve
    step gathers its weights once, not every token.  Yields the scope."""
    prev = _active[0]
    _active[0] = (_Scope(mesh, param_specs, cache_specs, held, fill_specs)
                  if mesh is not None else None)
    try:
        yield _active[0]
    finally:
        _active[0] = prev


def _get() -> Optional[_Scope]:
    return _active[0]


def active() -> bool:
    return _get() is not None


@contextmanager
def sequence_sharding(on: bool = True):
    """``REPRO_SEQ_SHARD=1`` inside when ``on`` (else unset), restored
    after.  A step reads the switch where it is built (the parameter
    specs) and where it runs (:func:`seq_sharded`), so both belong
    inside."""
    old = os.environ.pop("REPRO_SEQ_SHARD", None)
    if on:
        os.environ["REPRO_SEQ_SHARD"] = "1"
    try:
        yield
    finally:
        os.environ.pop("REPRO_SEQ_SHARD", None)
        if old is not None:
            os.environ["REPRO_SEQ_SHARD"] = old


# Where :func:`note_rows` appends, while :func:`record_rows` is open
# (a module global like the scope, for remat's recompute on the backward
# thread).
_rows: list = [None]


@contextmanager
def record_rows(record: list):
    """Inside, every block appends the rows (dimension 1) of the residual
    stream it takes to ``record``: under the switch a rank's S/m between
    blocks, the whole S without it, 1 in a decode step.  Yields
    ``record``."""
    prev = _rows[0]
    _rows[0] = record
    try:
        yield record
    finally:
        _rows[0] = prev


def note_rows(x: torch.Tensor) -> None:
    """A block's input ``x`` (B, S, D) for :func:`record_rows`."""
    if _rows[0] is not None:
        _rows[0].append(x.shape[1])


# ----------------------------------------------------------------------
# the spec choice (pure)
# ----------------------------------------------------------------------

def spec_for(kind: str, shape: Tuple[int, ...], s, *,
             heads: Optional[int] = None, experts: Optional[int] = None):
    """The spec the reference's ``constrain`` gives a tensor of global
    ``shape`` and ``kind`` in scope ``s`` (``repro/distributed/
    act_sharding.py:66-120``), or ``None`` where it leaves the tensor
    unconstrained (no model axis, an unknown kind, a fallback that
    applies nothing).  Reads ``REPRO_SEQ_SHARD`` and
    ``REPRO_ATTN_FALLBACK`` as the reference does."""
    from .sharding import P
    if s is None or s.model is None:
        return None
    b_ok = shape[0] % max(s.data_size, 1) == 0 and shape[0] > 1
    batch = s.batch if b_ok else None
    seq_shard = os.environ.get("REPRO_SEQ_SHARD") == "1"
    m = s.model_size
    if kind == "btd":
        if seq_shard and shape[1] % m == 0:
            return P(batch, s.model, None)
        return P(batch, None, None)
    if kind == "btf":
        if seq_shard and shape[1] % m == 0:
            return P(batch, s.model, None)
        return P(batch, None, s.model if shape[-1] % m == 0 else None)
    if kind == "logits":
        return P(batch, None, s.model if shape[-1] % m == 0 else None)
    if kind == "bhsd":
        h = heads if heads is not None else shape[1]
        if h % m == 0:
            return P(batch, s.model, None, None)
        strategy = os.environ.get("REPRO_ATTN_FALLBACK", "context")
        if strategy == "context" and shape[2] % m == 0:
            return P(batch, None, s.model, None)
        if strategy == "replicate":
            return P(batch, None, None, None)
        return None
    if kind in ("ecd", "ecf"):
        e = experts if experts is not None else shape[0]
        if e % m == 0:
            return P(s.model, None, None)
        if kind == "ecf" and shape[-1] % m == 0:
            return P(None, None, s.model)
        return None
    if kind in ("gecd", "gecf"):
        e = experts if experts is not None else shape[1]
        g_ax = s.batch if shape[0] % max(s.data_size, 1) == 0 else None
        if e % m == 0:
            return P(g_ax, s.model, None, None)
        if kind == "gecf" and shape[-1] % m == 0:
            return P(g_ax, None, None, s.model)
        return P(g_ax, None, None, None)
    return None


def _axis_dim(spec, axis) -> Optional[int]:
    """The dimension ``spec`` splits over ``axis`` (None: none)."""
    for d, e in enumerate(spec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return d
    return None


# ----------------------------------------------------------------------
# constrain
# ----------------------------------------------------------------------

def constrain(x: torch.Tensor, kind: str, *, heads: Optional[int] = None,
              experts: Optional[int] = None,
              have: Optional[int] = None) -> torch.Tensor:
    """``x`` in the layout :func:`spec_for` picks for ``kind``.  Outside
    a scope, or in a scope over a mesh shape (no ranks), or with a model
    axis of one rank, it is ``x``.  In an SPMD scope ``x`` is this rank's
    piece: batch rows of its data coordinate, and split over ``model``
    along dimension ``have`` (``None``: whole); the piece is sliced or
    all-gathered along ``model`` to the spec's layout, and the result is
    returned (its gradient gathered or sliced back).  A sequence-sharded
    stream's rows are passed with ``have=1``: where the spec puts the
    sequence over ``model`` they are left as they are."""
    s = _get()
    if s is None or not s.spmd or s.model_size == 1:
        return x
    shape = list(x.shape)
    shape[0] *= s.data_size
    if have is not None:
        shape[have] *= s.model_size
    spec = spec_for(kind, tuple(shape), s, heads=heads, experts=experts)
    if spec is None:
        return x
    want = _axis_dim(spec, s.model)
    if want == have:
        return x
    group = s.groups[s.model]
    if have is not None:
        x = C.gather_whole(x, group, have)
    return x if want is None else C.split(x, group, want)


# ----------------------------------------------------------------------
# what a rank computes under an SPMD scope
# ----------------------------------------------------------------------

def spmd() -> Optional[_Scope]:
    """The active scope when it runs on ranks (a ``DeviceMesh``)."""
    s = _get()
    return s if s is not None and s.spmd else None


def model_size() -> int:
    """Ranks of the model axis of the active SPMD scope (1 without)."""
    s = spmd()
    return s.model_size if s is not None else 1


def model_group():
    return spmd().groups["model"]


def model_rank() -> int:
    return spmd().coords["model"]


def data_groups():
    """The process groups of the batch axes (pod, data) of the scope."""
    s = spmd()
    return [s.groups[a] for a in s.batch]


def copy_to_model(x: torch.Tensor, seq: bool = False) -> torch.Tensor:
    """Megatron's f over ``model`` (identity; gradient summed).  With
    ``seq`` (:func:`seq_sharded`), ``x`` is the rank's rows along
    dimension 1 and comes back gathered whole (sequence parallelism's f:
    the backward reduce-scatters)."""
    if model_size() == 1:
        return x
    if seq:
        return C.gather(x, model_group(), 1)
    return C.copy_to(x, model_group())


def reduce_from_model(x: torch.Tensor, seq: bool = False) -> torch.Tensor:
    """Megatron's g over ``model`` (partial sums summed; gradient
    passed).  With ``seq``, the sum's rows of this rank along dimension
    1 (a reduce-scatter; the backward gathers)."""
    if model_size() == 1:
        return x
    if seq:
        return C.reduce_split(x, model_group(), 1)
    return C.reduce_from(x, model_group())


def seq_sharded(seq: int) -> bool:
    """Whether a forward over ``seq`` positions holds the residual
    stream sequence-sharded: an SPMD scope whose model axis of > 1 rank
    :func:`spec_for` puts on the sequence of ``btd`` (``REPRO_SEQ_SHARD=1``
    and ``seq`` divisible; the module docstring)."""
    s = spmd()
    if s is None or s.model_size == 1:
        return False
    spec = spec_for("btd", (s.data_size, seq, 1), s)
    return spec is not None and _axis_dim(spec, s.model) == 1


def whole_sequence(x: torch.Tensor) -> torch.Tensor:
    """The rank's rows along dimension 1 gathered whole over ``model``
    for a layer every rank of the group runs on the whole sequence (the
    backward takes the rank's rows of the gradient)."""
    return C.gather_whole(x, model_group(), 1)


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows along dimension 1 of ``x``, which every rank of
    the model group holds whole (the backward gathers)."""
    return C.split(x, model_group(), 1)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The ranks' partial ``x`` summed over ``model``, the gradient summed
    too: a sum every rank then reads whole for its own part of the work
    (mamba's ``x_proj`` product, a norm's sum of squares over channels
    the ranks split)."""
    return x if model_size() == 1 else C.reduce_both(x, model_group())


def model_slice(n: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's equal share of ``n`` along ``model``."""
    step = n // model_size()
    lo = (model_rank() if model_size() > 1 else 0) * step
    return lo, lo + step


def context_parallel(n_heads: int, seq: int) -> bool:
    """Whether a rank attends its slice of the queries of an attention
    layer of ``n_heads`` over ``seq`` positions: :func:`spec_for` puts
    ``bhsd`` on the sequence (heads that do not divide ``model``, the
    ``context`` fallback)."""
    s = spmd()
    spec = spec_for("bhsd", (s.data_size, n_heads, seq, 1), s,
                    heads=n_heads)
    return spec is not None and _axis_dim(spec, s.model) == 2


@contextmanager
def sequence_pieces(on: bool = True):
    """Mark the enclosed attention calls as taking this rank's sequence
    pieces of q, k and v (``models.attention.sdpa``'s context branch);
    ``on=False`` leaves the mark as it is."""
    s = spmd()
    if not on or s is None:
        yield
        return
    prev = s.seq_pieces
    s.seq_pieces = True
    try:
        yield
    finally:
        s.seq_pieces = prev


def seq_pieces() -> bool:
    s = spmd()
    return s is not None and s.seq_pieces


def _lookup(tree, path: str):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def _use(x: torch.Tensor, spec, s: _Scope, keep_model: bool,
         partial_model: bool) -> torch.Tensor:
    """:func:`_gathered`, from the scope's ``held`` leaves when the leaf
    has not changed since it was gathered."""
    if s.held is None:
        return _gathered(x, spec, s, keep_model, partial_model)
    key = (id(x), keep_model, partial_model)
    hit = s.held.get(key)
    if hit is None or hit[0] is not x or hit[1] != x._version:
        hit = (x, x._version, _gathered(x, spec, s, keep_model,
                                        partial_model))
        s.held[key] = hit
    return hit[2]


def _gathered(x: torch.Tensor, spec, s: _Scope, keep_model: bool,
              partial_model: bool) -> torch.Tensor:
    """One parameter leaf as the rank's computation uses it.  Over each
    batch axis: gathered where the spec splits a dimension (the backward
    sums the data ranks' gradients and keeps the shard), else passed with
    its gradient summed.  Over ``model``: kept split (``keep_model``),
    else gathered, the gradient summed over ``model`` when the rank's
    use of the whole leaf is its own part of the work
    (``partial_model``) and sliced when every rank does the same work."""
    for a in s.batch:
        d = _axis_dim(spec, a)
        g = s.groups[a]
        x = C.copy_to(x, g) if d is None else C.gather(x, g, d)
    if s.model is None or s.model_size == 1:
        return x
    d = _axis_dim(spec, s.model)
    g = s.groups[s.model]
    if d is None:
        return C.copy_to(x, g) if partial_model else x
    if keep_model:
        return x
    return C.gather(x, g, d) if partial_model else C.gather_whole(x, g, d)


def use_param(path: str, x: torch.Tensor) -> torch.Tensor:
    """The top-level leaf ``path`` (``embed``, ``lm_head``, ...) as the
    rank uses it; ``x`` itself outside an SPMD scope.  Gathered once a
    scope (the tied embedding's lookup and LM head share one gather, and
    so one reduction of its gradient)."""
    s = spmd()
    if s is None:
        return x
    if path not in s.used:
        s.used[path] = _use(x, _lookup(s.param_specs, path), s, True,
                            False)
    return s.used[path]


class LayerPlan(NamedTuple):
    """How a rank runs one layer (:func:`use_params`).  ``attn``:
    ``"one"`` (no SPMD scope, or a model axis of 1: the one-process
    layer), ``"heads"`` (its query heads, and its KV heads when they
    divide ``model``), ``"context"`` (decode against a cache whose slots
    are split over ``model``: K/V, or an MLA layer's latent), ``"rows"``
    (a sequence-sharded forward's rows of every head) or ``"whole"`` (all
    of it; in training the layer then asks :func:`context_parallel`
    whether it takes its slice of the queries).  ``mlp_split``: the
    dense MLP (an MoE block's dense residual, an rwkv block's channel
    mix) runs split over ``model`` (its hidden width divides).  ``mixer``: a mamba or rwkv layer's
    ``"channels"`` (the rank's channels or heads) or ``"whole"``.
    ``moe``: ``"experts"`` (the rank's experts), ``"hidden"`` (every
    expert's hidden columns of the rank) or ``"whole"``.
    ``shared_split``: the MoE's shared expert runs split.  ``model``: the
    ranks of the model axis.  ``cache_split``: the dimension ``model``
    splits of the K/V cache (MLA's ``c_kv``) a prefill fills (None:
    none)."""
    attn: str = "one"
    mlp_split: bool = False
    model: int = 1
    mixer: str = "one"
    moe: str = "one"
    shared_split: bool = False
    cache_split: Optional[int] = None


ONE = LayerPlan()

# the replicated per-channel (or per-head) leaves of a mamba or rwkv
# layer that a rank slices to its own, and the dimension it slices
_CHANNEL_LEAVES = {"mamba": {"conv_w": 1, "conv_b": 0, "dt_bias": 0,
                             "D": 0, "norm": 0},
                   "rwkv": {"decay_base": 0, "bonus": 0, "ln_out": 0}}


def use_params(cfg, spec, index: int, p: dict, seq: bool = False
               ) -> Tuple[dict, LayerPlan]:
    """Layer ``index`` (block ``spec``) of the parameter tree as the
    rank's computation of it uses it (the scheme of the module
    docstring), and the layer's :class:`LayerPlan`.  ``seq``: the forward
    holds the residual stream sequence-sharded (:func:`seq_sharded`).
    Outside an SPMD scope, ``(p, ONE)``."""
    s = spmd()
    if s is None:
        return p, ONE
    tp = s.model_size
    specs = _lookup(s.param_specs, f"layers/{index}")
    kv_local = cfg.n_kv_heads % tp == 0
    attn, cache_split = "whole", None
    if spec.mixer in ("attn", "sliding", "mla"):
        # the cache entry that shows the split, and its slots' dimension
        key, slots = ("c_kv", 1) if spec.mixer == "mla" else ("k", 2)
        if s.cache_specs is not None:
            # decode: the cache's split decides (heads, slots, or none)
            d = _axis_dim(_lookup(s.cache_specs, f"{index}/{key}"),
                          s.model)
            if d == slots:
                attn = "context"
            elif d == 1 and key == "k":
                attn = "heads"
        elif spec.mixer != "mla" and cfg.n_heads % tp == 0:
            attn = "heads"
        elif spec.mixer != "mla" and seq:
            attn = "rows"
        if s.fill_specs is not None and s.model is not None:
            cache_split = _axis_dim(_lookup(s.fill_specs, f"{index}/{key}"),
                                    s.model)

    def split(path: str) -> Optional[int]:
        """The dimension ``model`` splits of the leaf at ``path`` (None:
        none, or no such leaf)."""
        try:
            return _axis_dim(_lookup(specs, path), s.model)
        except KeyError:
            return None

    if tp == 1:
        plan = ONE
    else:
        mixer = "one"
        if spec.mixer == "mamba":
            mixer = "channels" if split("mamba/x_proj") == 0 else "whole"
        elif spec.mixer == "rwkv":
            divide = (cfg.d_model // cfg.rwkv_head_dim) % tp == 0
            mixer = ("channels" if divide and split("rwkv/w_r") == 1
                     else "whole")
        moe = "one"
        if spec.ffn == "moe":
            moe = {0: "experts", 2: "hidden"}.get(split("moe/w_up"),
                                                  "whole")
        mlp_split = (split("rwkv/cm_k") == 1 and mixer == "channels"
                     if spec.mixer == "rwkv" else split("mlp/w_up") == 1)
        plan = LayerPlan(attn, mlp_split, tp, mixer, moe,
                         split("moe/shared/w_up") == 1, cache_split)
    heads = attn == "heads"
    group = s.groups[s.model] if s.model else None
    # a dense FFN that runs on the rank's rows of a sequence-sharded
    # stream (its hidden does not split over model)
    mlp_rows = seq and spec.ffn == "dense" and not plan.mlp_split

    def leaf(block: str, name: str, x, sp):
        if block in ("mamba", "rwkv"):
            return mixer_leaf(block, name, x, sp)
        if block != "attn":
            # the norms, and such an FFN, are applied to the rank's rows:
            # their gradient is summed over model
            rows = seq and (block.startswith("norm")
                            or (block == "mlp" and mlp_rows))
            return _use(x, sp, s, True, rows)
        if attn == "rows":             # every head on the rank's rows
            return _use(x, sp, s, False, True)
        if not heads:                  # every rank the whole attention
            return _use(x, sp, s, False, False)
        if name in ("wq", "wo"):
            return _use(x, sp, s, True, False)
        if name in ("wk", "wv"):
            return _use(x, sp, s, kv_local, not kv_local)
        if name == "bq" or (name in ("bk", "bv") and kv_local):
            x = _use(x, sp, s, True, False)
            return C.split(x, group, 0)
        # bk/bv of whole K/V heads, q_norm/k_norm: whole leaves the
        # rank applies to its own heads
        return _use(x, sp, s, True, True)

    def mixer_leaf(block: str, name: str, x, sp):
        if plan.mixer != "channels":   # every rank the whole layer
            return _use(x, sp, s, False, False)
        dim = _CHANNEL_LEAVES[block].get(name)
        if dim is not None:            # the rank's channels or heads
            return C.split(_use(x, sp, s, True, False), group, dim)
        if name == "in_proj" or name == "decay_a":
            # used whole for the rank's own channels: gradient summed
            return _use(x, sp, s, False, True)
        if name == "decay_b":
            # whole, then the rank's columns (its channels' decays)
            return C.split(_use(x, sp, s, False, False), group, 1)
        if name == "cm_r":             # every rank the whole gate
            return _use(x, sp, s, False, False)
        if name.startswith("mu_"):
            # the time mix's token-shift mixes feed the rank's own
            # heads: gradient summed
            return _use(x, sp, s, True, True)
        return _use(x, sp, s, True, False)

    def walk(block: str, name: str, x, sp):
        if isinstance(x, dict):        # a block, or the MoE's shared MLP
            return {n: walk(block if block else n, n, v, sp[n])
                    for n, v in x.items()}
        return leaf(block, name, x, sp)

    return walk("", "", p, specs), plan


def count_merge() -> None:
    """Count one log-sum-exp merge of the ranks' attention partials."""
    spmd().merges += 1


def embed_split() -> bool:
    """Whether the rank holds a vocabulary slice of the embedding (a
    model axis of > 1 rank that the vocabulary divides)."""
    s = spmd()
    return s is not None and s.model_size > 1 and \
        _axis_dim(s.param_specs["embed"], s.model) == 0


def vocab_split(cfg) -> bool:
    """Whether the rank's logits are its vocabulary slice: the head's
    weight is split by vocabulary over a model axis of > 1 rank."""
    s = spmd()
    if s is None or s.model_size == 1:
        return False
    if not cfg.lm_head:
        name = "cls_head" if cfg.n_classes else None
        if name is None:
            return False
        return _axis_dim(s.param_specs[name], s.model) == 1
    if cfg.tie_embeddings:
        return _axis_dim(s.param_specs["embed"], s.model) == 0
    return _axis_dim(s.param_specs["lm_head"], s.model) == 1
