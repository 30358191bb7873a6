"""The decoder LM in PyTorch: configuration, parameters, prefill and
decode.

Counterpart of ``repro/models/lm.py`` for every block it builds: the
``attn``, ``sliding`` (window in prefill, a ring cache in decode),
``mla``, ``mamba`` and ``rwkv`` mixers (RWKV-6 keeps its channel mix
inside the block), each with a ``dense``, ``moe`` (optionally beside a
dense residual FFN) or no FFN; qkv bias, qk-norm, embeddings in, an
encoder head and a final logit softcap.  It holds the config
dataclasses (torch dtypes), :func:`init_params`,
:func:`params_from_numpy` (carries the reference's parameter pytree
across), :func:`cast_params`, :func:`forward` (prefill; attention
through the flash kernel, WKV6 and the Mamba scan through theirs;
returns the summed MoE aux loss), :func:`init_cache` and
:func:`decode_step` (one token per row against the cache; attention
through the decode kernel, WKV6 and the Mamba scan through theirs from
the cached state; MoE dropless), and :func:`lm_loss` (the training
loss; ``forward`` checkpoints each group of layers under
``remat="full"``).

The port keeps parameters as one per-layer list, the layout the serving
executor iterates (the reference stacks groups for ``lax.scan`` and
unstacks them in ``serving/executor.py::split_layer_params``)::

    {"embed": (V, D), "final_norm": (D,), ["lm_head": (D, V)],
     ["cls_head": (D, n_classes)],
     "layers": [{"norm1", "attn": {"wq", "wk", "wv", "wo",
                                   ["bq", "bk", "bv"],
                                   ["q_norm", "k_norm"]}
                          or "attn": {"wq_a", "wq_b", "wkv_a", "wkv_b",
                                      "q_norm", "kv_norm", "wo"} (mla)
                          or "mamba": {"in_proj", "conv_w", ...},
                 "norm2", "mlp": {"w_up", "w_down", ["w_gate"]}
                          or "moe": {"router", "w_up", "w_down",
                                     "w_gate", ["shared"]}
                                 [+ "mlp", the dense residual]}
                or {"norm1", "rwkv": {...}}, ...]}

The cache is a per-layer list as well: ``{"k": (B, Hkv, Smax, hd), "v"}``
for an attn layer (``min(Smax, window)`` slots, a ring, for a sliding
one), ``{"c_kv": (B, Smax, rank), "k_rope": (B, 1, Smax, rope)}`` for an
mla layer, ``{"conv": (B, d_conv - 1, Di), "ssm": (B, Di, N) fp32}`` for
a mamba layer, ``{"wkv": (B, H, hd, hd) fp32, "shift", "cm_shift": (B,
1, D)}`` for an rwkv layer.  :func:`decode_step` updates
it in place (the reference stacks it per group for ``lax.scan`` and
donates it, or returns new recurrent entries).

Under a mesh scope (``distributed/act_sharding.py``, the meshed step
builders of ``launch/train.py``) every layer's leaves pass through
``act_sharding.use_params`` as the layer runs, the embedding and the LM
head split the vocabulary over ``model`` (a masked lookup summed over
the ranks; vocabulary-sliced logits), :func:`lm_loss` reduces its max,
log-partition and label logit over the slices and returns the rank's
share of the global mean, and ``constrain`` is called where the
reference calls it.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from .. import resolve_device
from ..distributed import act_sharding as AS
from ..distributed import collectives as C
from . import layers as L

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]


@dataclass(frozen=True)
class BlockSpec:
    mixer: str = "attn"          # attn | sliding | mla | mamba | rwkv
    ffn: str = "dense"           # dense | moe | none


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)
    # attention
    causal: bool = True
    window: Optional[int] = None
    rope_theta: Optional[float] = 10000.0
    rope_theta_local: Optional[float] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    query_scale: Optional[float] = None
    # MoE
    n_experts: int = 0
    n_experts_padded: Optional[int] = None
    top_k: int = 2
    n_shared_experts: int = 0
    d_ff_shared: Optional[int] = None
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False
    d_ff_dense_residual: Optional[int] = None
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    mla_nope_dim: int = 0
    mla_rope_dim: int = 0
    mla_v_dim: int = 0
    # mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # rwkv
    rwkv_head_dim: int = 64
    # misc
    act: str = "silu"
    gated_mlp: bool = True
    norm: str = "rms"                     # rms | layer
    norm_offset: float = 0.0              # 1.0 for gemma (1+w)
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False             # gemma: x *= sqrt(d_model)
    final_softcap: Optional[float] = None
    input_mode: str = "tokens"
    lm_head: bool = True
    n_classes: Optional[int] = None
    param_dtype: Any = torch.bfloat16
    remat: str = "full"
    unroll_groups: bool = False
    attn_backend: str = "auto"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail(self) -> Tuple[BlockSpec, ...]:
        rem = self.n_layers % len(self.pattern)
        return self.pattern[:rem]

    def layer_specs(self) -> Tuple[BlockSpec, ...]:
        """Every layer's block spec in order (groups, then the tail)."""
        return tuple(self.pattern) * self.n_groups + tuple(self.tail)


MIXERS = ("attn", "sliding", "mla", "mamba", "rwkv")
FFNS = ("dense", "moe", "none")
# (mixer, ffn) pairs the port covers: every pair the reference's
# _block_init builds
SUPPORTED_BLOCKS = frozenset((m, f) for m in MIXERS for f in FFNS)


def _check_supported(cfg: LMConfig) -> None:
    """What the reference refuses too: a mixer or FFN it does not know,
    an input mode other than tokens or embeddings."""
    for spec in cfg.layer_specs():
        if (spec.mixer, spec.ffn) not in SUPPORTED_BLOCKS:
            raise ValueError(f"{cfg.name}: unknown block {spec} (mixers "
                             f"{MIXERS}, FFNs {FFNS})")
    if cfg.input_mode not in ("tokens", "embeddings"):
        raise ValueError(f"{cfg.name}: unknown input_mode "
                         f"{cfg.input_mode!r}")


def _norm_init(cfg: LMConfig, device) -> torch.Tensor:
    fill = 0.0 if cfg.norm_offset else 1.0
    return torch.full((cfg.d_model,), fill, dtype=torch.float32,
                      device=device)


def abstract_params(cfg: LMConfig) -> Params:
    """Shape-only parameters: :func:`init_params`'s tree on the ``meta``
    device, allocating nothing (the sharding tables read only shapes).
    Each call gives new tensors; the tree they copy is made once per
    config (meta draws run through Python: 9 s for arctic-480b's)."""
    return _map(_abstract_params(cfg), torch.empty_like)


@functools.lru_cache(maxsize=16)
def _abstract_params(cfg: LMConfig) -> Params:
    return init_params(cfg, device="meta")


def init_params(cfg: LMConfig, seed: int = 0, device=None,
                cut=None) -> Params:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default CUDA).  Same shapes, scales and dtypes as the reference's
    ``init_params``; the numbers differ, since torch and JAX draw
    differently from one seed.  Every leaf is made in its own dtype, so
    a bf16 model never passes through an fp32 copy of itself (the widest
    fp32 draw is one weight matrix, or one expert's).  ``cut(path,
    leaf)``, where given, takes each leaf as soon as it is drawn (its
    '/'-joined tree path, ``layers/3/moe/w_up``) and returns what the
    tree keeps (``launch.train.init_pieces``: the rank's piece)."""
    _check_supported(cfg)
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    gen = torch.Generator(device="cpu" if meta else dev).manual_seed(seed)
    dt = cfg.param_dtype
    cut = cut or L.whole

    def at(prefix: str) -> L.Keep:
        return lambda name, leaf: cut(prefix + name, leaf)

    def norm(path: str) -> torch.Tensor:
        return cut(path, _norm_init(cfg, dev))

    def zeros(path: str) -> torch.Tensor:
        return cut(path, torch.zeros(cfg.d_model, device=dev))

    params: Params = {
        "embed": cut("embed", L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                           dt, dev)),
        "final_norm": norm("final_norm"),
    }
    if cfg.norm == "layer":
        params["final_norm_b"] = zeros("final_norm_b")
    layers = []
    for i, spec in enumerate(cfg.layer_specs()):
        pre = f"layers/{i}/"
        p: Params = {"norm1": norm(pre + "norm1")}
        if cfg.norm == "layer":
            p["norm1_b"] = zeros(pre + "norm1_b")
        if spec.mixer == "rwkv":
            p["rwkv"] = L.rwkv6_init(gen, cfg.d_model,
                                     head_dim=cfg.rwkv_head_dim, dtype=dt,
                                     device=dev, keep=at(pre + "rwkv/"))
        elif spec.mixer == "mamba":
            p["mamba"] = L.mamba_init(gen, cfg.d_model,
                                      d_state=cfg.mamba_d_state,
                                      d_conv=cfg.mamba_d_conv,
                                      expand=cfg.mamba_expand, dtype=dt,
                                      device=dev, keep=at(pre + "mamba/"))
        elif spec.mixer == "mla":
            p["attn"] = L.mla_init(
                gen, cfg.d_model, cfg.n_heads, q_lora_rank=cfg.q_lora_rank,
                kv_lora_rank=cfg.kv_lora_rank, nope_dim=cfg.mla_nope_dim,
                rope_dim=cfg.mla_rope_dim, v_dim=cfg.mla_v_dim, dtype=dt,
                device=dev, keep=at(pre + "attn/"))
        else:
            p["attn"] = L.attn_init(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.hd, dt, dev,
                                    qkv_bias=cfg.qkv_bias,
                                    keep=at(pre + "attn/"))
            if cfg.qk_norm:
                for name in ("q_norm", "k_norm"):
                    p["attn"][name] = cut(pre + "attn/" + name, torch.ones(
                        cfg.hd, dtype=torch.float32, device=dev))
        if spec.ffn != "none":
            p["norm2"] = norm(pre + "norm2")
            if cfg.norm == "layer":
                p["norm2_b"] = zeros(pre + "norm2_b")
        if spec.ffn == "dense":
            p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, dev,
                                  gated=cfg.gated_mlp, keep=at(pre + "mlp/"))
        elif spec.ffn == "moe":
            p["moe"] = L.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                  dt, dev, gated=True,
                                  n_shared=cfg.n_shared_experts,
                                  d_ff_shared=cfg.d_ff_shared,
                                  n_padded=cfg.n_experts_padded,
                                  keep=at(pre + "moe/"))
            if cfg.moe_dense_residual:
                p["mlp"] = L.mlp_init(
                    gen, cfg.d_model, cfg.d_ff_dense_residual or cfg.d_ff,
                    dt, dev, gated=True, keep=at(pre + "mlp/"))
        layers.append(p)
    params["layers"] = layers
    if cfg.lm_head and not cfg.tie_embeddings:
        params["lm_head"] = cut("lm_head", L.dense_init(
            gen, cfg.d_model, cfg.vocab_size, dt, dev))
    if not cfg.lm_head and cfg.n_classes:
        params["cls_head"] = cut("cls_head", L.dense_init(
            gen, cfg.d_model, cfg.n_classes, dt, dev))
    return params


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                ).view(torch.bfloat16).to(device)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint8)
                                ).view(torch.float8_e4m3fn).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_to(params: Params, device) -> Params:
    """The same parameter tree with every tensor on ``device`` (tensors
    already there are not copied)."""
    return _map(params, lambda a: a.to(device))


# leaves that init_params (and the reference's) makes in fp32 whatever
# param_dtype is: norm weights and biases, qk-norm and MLA's q_norm and
# kv_norm (repro/models/lm.py:123-124, layers.py:195-196), rwkv's ln_out,
# decay_base and bonus (layers.py:555-561), mamba's dt_bias, A_log, D
# and norm (:438-446), the MoE router (:310)
FP32_LEAVES = frozenset({"norm1", "norm1_b", "norm2", "norm2_b",
                         "final_norm", "final_norm_b", "q_norm", "k_norm",
                         "kv_norm", "ln_out", "decay_base", "bonus",
                         "dt_bias", "A_log", "D", "norm", "router"})


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Every leaf that ``init_params`` makes in ``param_dtype`` cast to
    ``dtype`` (embeddings, projections, experts, mamba's conv, rwkv's 1-D
    token-shift mixes); the leaves of :data:`FP32_LEAVES` stay fp32.
    So ``cast_params(init_params(cfg32), dtype)`` has the dtypes of
    ``init_params`` at ``param_dtype=dtype``, leaf for leaf."""
    def cast(tree, name=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [cast(v, name) for v in tree]
        return tree if name in FP32_LEAVES else tree.to(dtype)
    return cast(params)


def params_from_numpy(cfg: LMConfig, tree: Params, device=None) -> Params:
    """Carry the reference's parameter pytree across.  ``tree`` is the
    reference's params as nested dicts/lists of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``).  The scan-stacked ``groups``
    (leading axis = group index) and the unrolled ``tail`` are unstacked
    into the per-layer list, in the order
    ``repro/serving/executor.py::split_layer_params`` uses."""
    _check_supported(cfg)
    dev = resolve_device(device)
    layers = []
    for gi in range(cfg.n_groups):
        for j in range(len(cfg.pattern)):
            layers.append(_map(tree["groups"][j],
                               lambda a, gi=gi: _to_tensor(
                                   np.asarray(a)[gi], dev)))
    for j in range(len(cfg.tail)):
        layers.append(_map(tree["tail"][j], lambda a: _to_tensor(a, dev)))
    out: Params = {k: _map(v, lambda a: _to_tensor(a, dev))
                   for k, v in tree.items() if k not in ("groups", "tail")}
    out["layers"] = layers
    return out


# ----------------------------------------------------------------------
# block application
# ----------------------------------------------------------------------

def _norm(cfg: LMConfig, x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    if cfg.norm == "layer":
        return L.layer_norm(x, w, b, cfg.norm_eps)
    return L.rms_norm(x, w, cfg.norm_eps, cfg.norm_offset)


def _apply_block(cfg: LMConfig, spec: BlockSpec, p: Params,
                 x: torch.Tensor, aux: torch.Tensor,
                 cache: Optional[Dict] = None,
                 cache_pos: Optional[int] = None,
                 plan: AS.LayerPlan = AS.ONE, seq: bool = False,
                 fill: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """One block: its mixer, then its FFN (dense, MoE with an optional
    dense residual beside it, or none); returns (x, aux + this block's
    MoE aux loss, new cache).  ``cache_pos``: the host int absolute
    position in decode (recurrent blocks need none: their state holds
    the past).  A sliding layer windows its prefill and, in decode,
    writes its ring at slot ``cache_pos % ring`` and attends the
    ``min(cache_pos + S, ring)`` live slots with no window (the ring is
    the window), its keys roped at their absolute positions, as the
    reference does (``repro/models/lm.py:240-256``); where a mesh splits
    the ring's slots over ``model`` (``plan.attn == "context"``), the
    slot and the live count are the whole ring's.  ``plan``: how a rank
    of a mesh runs the layer (``act_sharding.use_params``).  ``seq``:
    ``x`` is the rank's rows of a sequence-sharded residual stream, and so
    is the result (each layer's scheme in ``act_sharding``'s docstring).
    ``fill`` (a prefill, without ``cache``): the layer's cache, written as
    S decode steps from position 0 would leave it."""
    AS.note_rows(x)
    h = _norm(cfg, x, p["norm1"], p.get("norm1_b"))
    # a recurrent mixer fills its cache by running from it (zeros)
    state = cache if fill is None else fill
    # mixers that run on the whole sequence under sequence sharding: the
    # rank's rows gathered in, its rows of the output kept
    whole = seq and not (spec.mixer in ("attn", "sliding")
                         or (spec.mixer == "mamba"
                             and plan.mixer == "channels"))
    if whole:
        h = AS.whole_sequence(h)
    if spec.mixer == "rwkv":
        out, new_cache = L.rwkv6(p["rwkv"], h, head_dim=cfg.rwkv_head_dim,
                                 cache=state, backend=cfg.attn_backend,
                                 plan=plan.mixer, cm_split=plan.mlp_split)
    elif spec.mixer == "mamba":
        out, new_cache = L.mamba(p["mamba"], h, d_state=cfg.mamba_d_state,
                                 d_conv=cfg.mamba_d_conv,
                                 expand=cfg.mamba_expand, cache=state,
                                 backend=cfg.attn_backend, plan=plan.mixer,
                                 seq=seq and not whole)
    elif spec.mixer == "mla":
        out, new_cache = L.mla_attention(
            p["attn"], h, n_heads=cfg.n_heads, nope_dim=cfg.mla_nope_dim,
            rope_dim=cfg.mla_rope_dim, v_dim=cfg.mla_v_dim,
            kv_lora_rank=cfg.kv_lora_rank, causal=cfg.causal,
            rope_theta=cfg.rope_theta, cache=cache, cache_pos=cache_pos,
            backend=cfg.attn_backend, fill=fill, plan=plan.attn,
            fill_split=plan.cache_split)
    else:
        sliding = spec.mixer == "sliding"
        window = cfg.window if sliding else None
        theta = (cfg.rope_theta_local
                 if (sliding and cfg.rope_theta_local) else cfg.rope_theta)
        write_pos, cache_len = cache_pos, None
        if cache is not None and sliding:
            ring = cache["k"].shape[2] * (plan.model
                                          if plan.attn == "context" else 1)
            write_pos = cache_pos % ring
            cache_len = min(cache_pos + h.shape[1], ring)
            window = None                  # the ring is the window
        out, new_cache = L.attention(
            p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, causal=cfg.causal, window=window,
            rope_theta=theta, query_scale=cfg.query_scale,
            cache=cache, cache_pos=write_pos, cache_len=cache_len,
            abs_pos_arg=cache_pos, q_norm=cfg.qk_norm,
            backend=cfg.attn_backend, plan=plan.attn, seq=seq, fill=fill,
            fill_split=plan.cache_split)
    if whole:
        out = AS.own_rows(out)
    x = x + out
    if spec.ffn != "none":
        h2 = _norm(cfg, x, p["norm2"], p.get("norm2_b"))
        if spec.ffn == "dense":
            x = x + L.mlp(p["mlp"], h2, cfg.act, plan.mlp_split, seq)
        else:
            if seq:
                h2 = AS.whole_sequence(h2)
            # decode is dropless (capacity = every token of the step), as
            # in the reference (repro/models/lm.py:281-295)
            cf = (cfg.capacity_factor if cache is None
                  else float(cfg.n_experts) / cfg.top_k)
            moe_out, moe_aux = L.moe(
                p["moe"], h2, top_k=cfg.top_k, n_experts=cfg.n_experts,
                capacity_factor=cf, activation=cfg.act,
                n_padded=cfg.n_experts_padded, plan=plan.moe,
                shared_split=plan.shared_split)
            if cfg.moe_dense_residual:
                moe_out = moe_out + L.mlp(p["mlp"], h2, cfg.act,
                                          plan.mlp_split)
            if seq:
                moe_out = AS.own_rows(moe_out)
            x = x + moe_out
            aux = aux + moe_aux
    return x, aux, new_cache


def _embed(cfg: LMConfig, params: Params, tokens=None,
           embeds=None, seq: bool = False) -> torch.Tensor:
    """The scaled embeddings; with ``seq`` (a sequence-sharded stream)
    a vocabulary-parallel lookup's sum is reduce-scattered to the rank's
    rows."""
    if embeds is not None:
        return scale_embeddings(cfg, embeds.to(cfg.param_dtype))
    w = AS.use_param("embed", params["embed"])
    if AS.embed_split():
        # this rank's vocabulary rows; other tokens look up zeros, and the
        # ranks' rows are summed (one nonzero term a token: exact)
        v_loc = w.shape[0]
        t = tokens.long() - AS.model_rank() * v_loc
        inside = ((t >= 0) & (t < v_loc)).unsqueeze(-1).to(w.dtype)
        x = AS.reduce_from_model(w[t.clamp(0, v_loc - 1)] * inside, seq)
    else:
        x = w[tokens]
    return scale_embeddings(cfg, x)


def scale_embeddings(cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """``x`` times ``sqrt(d_model)`` when the config scales embeddings."""
    if cfg.embed_scale:
        # the scale is rounded to x's dtype first, as the reference does
        # (it matters for bf16 gemma); it stays a host number, since a
        # scalar tensor made on the card is a blocking copy
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def _head(cfg: LMConfig, params: Params, x: torch.Tensor,
          seq: bool = False) -> torch.Tensor:
    """The final norm, then the LM head (tied or not) and the optional
    softcap ``tanh(logits / c) * c`` in fp32; an encoder
    (``lm_head=False``) returns its ``cls_head`` logits, or the normed
    hidden states without one.  With ``seq`` the rank's rows are gathered
    whole along the sequence first (``logits`` keeps the sequence whole),
    so the final norm runs as without the switch."""
    if seq:
        x = AS.whole_sequence(x)
    x = _norm(cfg, x, AS.use_param("final_norm", params["final_norm"]),
              None if "final_norm_b" not in params else
              AS.use_param("final_norm_b", params["final_norm_b"]))
    split = AS.vocab_split(cfg)
    if split:
        x = AS.copy_to_model(x)
    if not cfg.lm_head:
        if not cfg.n_classes:
            return x
        return x @ AS.use_param("cls_head", params["cls_head"])
    logits = x @ (AS.use_param("embed", params["embed"]).T
                  if cfg.tie_embeddings
                  else AS.use_param("lm_head", params["lm_head"]))
    logits = AS.constrain(logits, "logits", have=2 if split else None)
    if cfg.final_softcap:
        c = cfg.final_softcap
        logits = torch.tanh(logits.float() / c) * c
    return logits


# ----------------------------------------------------------------------
# forward (prefill)
# ----------------------------------------------------------------------

def _apply_blocks(cfg: LMConfig, specs, layers, x: torch.Tensor,
                  aux: torch.Tensor, first: int, grouped: bool,
                  seq: bool = False, fills=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layers ``first``, ``first + 1``, ... (their specs and parameters);
    a group's output is constrained after each block, as in the
    reference's ``group_body``.  ``seq``: ``x`` is the rank's rows of a
    sequence-sharded stream; ``fills``: the layers' caches a prefill
    fills."""
    for i, (spec, p) in enumerate(zip(specs, layers)):
        p, plan = AS.use_params(cfg, spec, first + i, p, seq)
        x, aux, _ = _apply_block(cfg, spec, p, x, aux, plan=plan, seq=seq,
                                 fill=None if fills is None else fills[i])
        if grouped:
            x = AS.constrain(x, "btd", have=1 if seq else None)
    return x, aux


def forward(cfg: LMConfig, params: Params, tokens=None, embeds=None,
            cache: Optional[Cache] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), aux_loss).  ``tokens``: (B, S) integer
    tensor on the params' device, or precomputed ``embeds`` (B, S, D).
    ``aux_loss`` is the fp32 sum of the MoE layers' balance losses (zero
    without MoE layers).  With ``cache`` (:func:`init_cache`'s, or a
    rank's pieces of it in a mesh scope with ``fill_specs``) the prefill
    also writes every layer's entries as S :func:`decode_step` calls from
    position 0 would leave them (K/V at their positions, a sliding ring's
    last positions, the recurrent states after the S positions), so that
    decoding continues at position S; the logits are the same.

    In a mesh scope under ``REPRO_SEQ_SHARD=1`` whose model axis divides
    S (``act_sharding.seq_sharded``) a rank holds its S/m rows of the
    residual stream between blocks; the logits keep S whole.

    With ``cfg.remat == "full"`` and autograd recording, each group of
    ``len(cfg.pattern)`` layers runs under ``torch.utils.checkpoint``
    (the reference's ``jax.checkpoint(group_body)``): only the group's
    input is kept, and the backward pass runs the group's forward again,
    kernels included.  The tail layers after the last whole group are
    not checkpointed, as in the reference."""
    _check_supported(cfg)
    if cache is not None and len(cache) != cfg.n_layers:
        raise ValueError(f"forward: a cache of {len(cache)} layers for "
                         f"{cfg.name}'s {cfg.n_layers}")
    seq = AS.seq_sharded((tokens if embeds is None else embeds).shape[1])
    x = _embed(cfg, params, tokens, embeds, seq)
    x = AS.constrain(x, "btd", have=1 if seq and embeds is None
                     and AS.embed_split() else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    specs, layers = cfg.layer_specs(), params["layers"]
    g = len(cfg.pattern)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for i in range(0, cfg.n_groups * g, g):
        group = (cfg, specs[i:i + g], layers[i:i + g])
        fills = None if cache is None else cache[i:i + g]
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _apply_blocks, *group, x, aux, i, True, seq, fills,
                use_reentrant=False)
        else:
            x, aux = _apply_blocks(*group, x, aux, i, True, seq, fills)
    tail = cfg.n_groups * g
    x, aux = _apply_blocks(cfg, specs[tail:], layers[tail:], x, aux, tail,
                           False, seq,
                           None if cache is None else cache[tail:])
    return _head(cfg, params, x, seq), aux


# the profiler range around lm_loss's own ops (after the LM head)
LOSS_RANGE = "lm_loss::cross_entropy"


def lm_loss(cfg: LMConfig, params: Params, batch: Dict[str, torch.Tensor],
            z_loss: float = 1e-4) -> torch.Tensor:
    """Next-token cross-entropy of :func:`forward`'s logits in fp32, plus
    ``z_loss`` times the mean squared log-partition and the MoE aux loss
    (the reference's ``lm_loss``).  ``batch``: ``"tokens"`` (or
    ``"embeds"``), ``"labels"`` (B, S), optional ``"mask"`` (B, S)
    weighting the positions.  The label's logit is gathered where the
    reference sums a one-hot product: the sum adds exact zeros to the one
    nonzero term, so both give the same fp32 value, and the gather never
    makes the (B, S, V) mask.  In a mesh scope whose head splits the
    vocabulary over ``model`` the max, the log-partition's sum and the
    label's logit are reduced over the slices (Megatron's vocab-parallel
    cross entropy; the (B, S, V) logits are never gathered), and the
    result is the rank's share of the global mean: its sums over the
    global token count (or mask sum), plus its 1/data share of the MoE
    aux loss; the data ranks' shares add up to the loss.  The profiler
    range
    ``lm_loss::cross_entropy`` holds the loss's own ops."""
    logits, aux = forward(cfg, params, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"))
    labels = batch["labels"]
    split = AS.vocab_split(cfg)
    with torch.profiler.record_function(LOSS_RANGE):
        logits = logits.float()
        m = logits.detach().amax(dim=-1, keepdim=True)
        if split:
            C.all_reduce_max(m, AS.model_group())
        shifted = logits - m
        sumexp = torch.exp(shifted).sum(dim=-1)
        if split:
            # Megatron's vocab-parallel cross entropy: the slices' sums
            # and the label's logit (one slice holds it) summed over model
            v_loc = logits.shape[-1]
            t = labels.long() - AS.model_rank() * v_loc
            inside = (t >= 0) & (t < v_loc)
            picked = shifted.gather(-1, t.clamp(0, v_loc - 1).unsqueeze(
                -1))[..., 0] * inside.to(shifted.dtype)
            sumexp = AS.reduce_from_model(sumexp)
            picked = AS.reduce_from_model(picked)
        else:
            picked = shifted.gather(-1, labels.long().unsqueeze(-1))[..., 0]
        logz = torch.log(sumexp) + m[..., 0]
        nll = logz - (picked + m[..., 0])
        mask = batch.get("mask")
        s = AS.spmd()
        if s is None:
            if mask is None:
                loss = nll.mean()
                zl = torch.square(logz).mean()
            else:
                mask = mask.to(nll.dtype)
                denom = torch.clamp(mask.sum(), min=1)
                loss = (nll * mask).sum() / denom
                zl = (torch.square(logz) * mask).sum() / denom
            return loss + z_loss * zl + aux
        # the rank's share of the global mean: its sums over the global
        # count; the data ranks' shares add up to the loss (the MoE aux,
        # a global value, is shared equally)
        if mask is None:
            mask = torch.ones_like(nll)
            denom = float(nll.numel() * s.data_size)
        else:
            mask = mask.to(nll.dtype)
            denom = mask.sum()
            for group in AS.data_groups():
                C.all_reduce_sum(denom, group)
            denom = torch.clamp(denom, min=1)
        loss = (nll * mask).sum() / denom
        zl = (torch.square(logz) * mask).sum() / denom
        return loss + z_loss * zl + aux / s.data_size


# ----------------------------------------------------------------------
# KV cache and decode step
# ----------------------------------------------------------------------

def _block_cache_layout(cfg: LMConfig, spec: BlockSpec, batch: int,
                        max_seq: int, dtype: torch.dtype
                        ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    # the reference's rwkv shift rows and mamba conv rows start in the
    # cache dtype, but each step returns them in the activation dtype; the
    # port writes them in place, so they are held in that dtype from the
    # start (zeros are exact in either)
    if spec.mixer == "rwkv":
        hd = cfg.rwkv_head_dim
        row = ((batch, 1, cfg.d_model), cfg.param_dtype)
        return {"wkv": ((batch, cfg.d_model // hd, hd, hd), torch.float32),
                "shift": row, "cm_shift": row}
    if spec.mixer == "mamba":
        d_inner = cfg.mamba_expand * cfg.d_model
        return {"conv": ((batch, cfg.mamba_d_conv - 1, d_inner),
                         cfg.param_dtype),
                "ssm": ((batch, d_inner, cfg.mamba_d_state), torch.float32)}
    if spec.mixer == "mla":
        return {"c_kv": ((batch, max_seq, cfg.kv_lora_rank), dtype),
                "k_rope": ((batch, 1, max_seq, cfg.mla_rope_dim), dtype)}
    slots = max_seq
    if spec.mixer == "sliding":
        slots = min(max_seq, cfg.window or max_seq)
    kv = ((batch, cfg.n_kv_heads, slots, cfg.hd), dtype)
    return {"k": kv, "v": kv}


def cache_layout(cfg: LMConfig, batch: int, max_seq: int,
                 dtype: torch.dtype = torch.bfloat16
                 ) -> List[Dict[str, Tuple[Tuple[int, ...], torch.dtype]]]:
    """Per layer, each cache entry's (shape, dtype), as :func:`init_cache`
    makes it (the reference's ``_block_cache``, ``repro/models/lm.py:
    363-393``, with the recurrent rows in the activation dtype)."""
    _check_supported(cfg)
    return [_block_cache_layout(cfg, spec, batch, max_seq, dtype)
            for spec in cfg.layer_specs()]


def abstract_cache(cfg: LMConfig, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> Cache:
    """Shape-only cache: :func:`init_cache`'s tree on the ``meta``
    device, allocating nothing (the reference's ``abstract_cache``; the
    sharding tables read only shapes)."""
    return [{name: torch.empty(shape, dtype=dt, device="meta")
             for name, (shape, dt) in entry.items()}
            for entry in cache_layout(cfg, batch, max_seq, dtype)]


def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device=None,
               mesh=None) -> Cache:
    """An empty per-layer cache on ``device`` (default CUDA), zeros in
    the layout of :func:`cache_layout`.  With ``mesh``, the rank's pieces
    of it under ``sharding.cache_specs`` (what the meshed serve step
    takes)."""
    layout = cache_layout(cfg, batch, max_seq, dtype)
    if mesh is not None:
        from ..distributed import sharding as S
        specs = S.cache_specs(cfg, abstract_cache(cfg, batch, max_seq,
                                                  dtype), mesh)
        layout = [{n: (S.local_shape(shape, specs[i][n], mesh), dt)
                   for n, (shape, dt) in entry.items()}
                  for i, entry in enumerate(layout)]
    dev = resolve_device(device)
    return [{name: torch.zeros(shape, dtype=dt, device=dev)
             for name, (shape, dt) in entry.items()} for entry in layout]


def decode_step(cfg: LMConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Cache]:
    """One serving step: ``tokens`` (B, 1), ``pos`` the host int write
    position (== the number of tokens already in the cache).  Returns
    (logits (B, 1, V), cache); the cache tensors are updated in place and
    returned as they are.  An encoder (``lm_head=False``) has no decode
    step and raises (the reference's fails reading its ``lm_head``)."""
    _check_supported(cfg)
    if not cfg.lm_head:
        raise ValueError(f"{cfg.name}: an encoder (lm_head=False) has no "
                         f"decode step")
    x = _embed(cfg, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (spec, p, c) in enumerate(zip(cfg.layer_specs(),
                                         params["layers"], cache)):
        p, plan = AS.use_params(cfg, spec, i, p)
        x, aux, _ = _apply_block(cfg, spec, p, x, aux, cache=c,
                                 cache_pos=pos, plan=plan)
    return _head(cfg, params, x), cache
