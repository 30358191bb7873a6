"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B  [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) vocab=151936; MoE: 60 routed experts top-4
(d_ff_expert=1408) + shared expert (5632 = 4×1408, "4 shared").
EP note: 60 experts don't divide the 16-way model axis — expert slots are
PADDED to 64 (dead slots with zero routing probability; semantics
unchanged) so the expert axis shards 64/16 = 4-way (§Perf iteration 3).
In torch dtypes; copied from ``repro/configs/qwen2_moe_a2_7b.py``.
"""
import torch

from ..models.lm import BlockSpec, LMConfig
from .common import lm_shapes

CONFIG = LMConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    pattern=(BlockSpec("attn", "moe"),),
    n_experts=60, n_experts_padded=64, top_k=4,
    n_shared_experts=4, d_ff_shared=5632,
    qkv_bias=True, rope_theta=1e6, act="silu",
    tie_embeddings=False, param_dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="qwen2-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab_size=128,
    pattern=(BlockSpec("attn", "moe"),),
    n_experts=4, top_k=2, n_shared_experts=1, d_ff_shared=64,
    qkv_bias=True, tie_embeddings=False,
    param_dtype=torch.float32, remat="none", attn_backend="ref",
)

SHAPES = lm_shapes(long_ok=False)
