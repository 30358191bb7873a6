"""arctic-480b — Snowflake Arctic base  [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8, head_dim=128) vocab=32000.
Dense-MoE hybrid: every layer has a dense residual FFN (7168) IN PARALLEL
with a 128-expert top-2 MoE (d_ff_expert=4864)  → ≈480B total params.
56 heads don't divide TP=16 → attention runs context-parallel (see
distributed.sharding).  Experts shard 128/16 = 8 per chip (EP).
Training uses Adafactor + bf16 params so optimizer state fits the pod.
In torch dtypes; copied from ``repro/configs/arctic_480b.py``.
"""
import torch

from ..models.lm import BlockSpec, LMConfig
from .common import lm_shapes

CONFIG = LMConfig(
    name="arctic-480b",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000,
    pattern=(BlockSpec("attn", "moe"),),
    n_experts=128, top_k=2,
    moe_dense_residual=True, d_ff_dense_residual=7168,
    rope_theta=1e4, act="silu", tie_embeddings=False,
    param_dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="arctic-smoke",
    n_layers=2, d_model=64, n_heads=7, n_kv_heads=1, head_dim=16,
    d_ff=48, vocab_size=128,
    pattern=(BlockSpec("attn", "moe"),),
    n_experts=8, top_k=2, moe_dense_residual=True, d_ff_dense_residual=64,
    tie_embeddings=False, param_dtype=torch.float32, remat="none",
    attn_backend="ref",
)

SHAPES = lm_shapes(long_ok=False)
