"""LM configuration and parameters in PyTorch.

Counterpart of ``repro/models/lm.py`` for the serving slice: the config
dataclasses (torch dtypes), :func:`init_params` for ``attn``/``dense``
blocks, and :func:`params_from_numpy`, which carries the reference's
parameter pytree across.

The port keeps parameters as one per-layer list, the layout the serving
executor iterates (the reference stacks groups for ``lax.scan`` and
unstacks them in ``serving/executor.py::split_layer_params``)::

    {"embed": (V, D), "final_norm": (D,), ["lm_head": (D, V)],
     "layers": [{"norm1", "attn": {"wq", "wk", "wv", "wo"},
                 "norm2", "mlp": {"w_up", "w_down", ["w_gate"]}}, ...]}

``forward`` and ``decode_step`` come with the next slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from . import layers as L

Params = Dict[str, Any]


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


def _check_supported(cfg: LMConfig) -> None:
    for spec in cfg.layer_specs():
        if spec.mixer != "attn" or spec.ffn not in ("dense", "none"):
            raise NotImplementedError(
                f"{cfg.name}: block {spec} is not ported yet; the port "
                f"covers attn/dense blocks (other mixers and MoE are "
                f"ROADMAP.md queue A, item 11)")
    if cfg.qkv_bias or cfg.qk_norm or cfg.final_softcap or \
            cfg.input_mode != "tokens" or not cfg.lm_head:
        raise NotImplementedError(
            f"{cfg.name}: qkv bias, qk-norm, softcap, embeddings-in and "
            f"encoder heads are not ported yet (ROADMAP.md queue A, "
            f"item 11)")


def _norm_init(cfg: LMConfig, device) -> torch.Tensor:
    fill = 0.0 if cfg.norm_offset else 1.0
    return torch.full((cfg.d_model,), fill, dtype=torch.float32,
                      device=device)


def init_params(cfg: LMConfig, seed: int = 0, device=None) -> Params:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default CUDA).  Same shapes, scales and dtypes as the reference's
    ``init_params``; the numbers differ, since torch and JAX draw
    differently from one seed."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.param_dtype
    params: Params = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, dev),
        "final_norm": _norm_init(cfg, dev),
    }
    if cfg.norm == "layer":
        params["final_norm_b"] = torch.zeros(cfg.d_model, device=dev)
    layers = []
    for spec in cfg.layer_specs():
        p: Params = {"norm1": _norm_init(cfg, dev)}
        if cfg.norm == "layer":
            p["norm1_b"] = torch.zeros(cfg.d_model, device=dev)
        p["attn"] = L.attn_init(gen, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.hd, dt, dev)
        if spec.ffn == "dense":
            p["norm2"] = _norm_init(cfg, dev)
            if cfg.norm == "layer":
                p["norm2_b"] = torch.zeros(cfg.d_model, device=dev)
            p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, dev,
                                  gated=cfg.gated_mlp)
        layers.append(p)
    params["layers"] = layers
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dt, dev)
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


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Weight matrices (embeddings, projections) cast to ``dtype``; the
    1-D norm weights stay fp32, as ``init_params`` makes them."""
    return _map(params, lambda a: a.to(dtype) if a.ndim >= 2 else a)


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
