"""jamba-1.5-large-398b — AI21 Jamba 1.5 Large  [arXiv:2403.19887], in
torch dtypes.

72L d_model=8192; Mamba:attention 7:1 interleave (1 attention layer per
8-layer Jamba block, at position 4); MoE (16 experts, top-2,
d_ff=24576) every other layer, dense FFN (24576) otherwise.
Attention: 64H GQA kv=8, head_dim 128, no positional encoding.  Mamba:
d_state=16, d_conv=4, expand=2 (d_inner 16384), dt_rank d_model/16 = 512.
Vocab 65536, untied head.  Copied from
``repro/configs/jamba_1_5_large_398b.py``.
"""
import torch

from ..models.lm import BlockSpec, LMConfig
from .common import lm_shapes

_PATTERN = tuple(
    BlockSpec(mixer=("attn" if i == 4 else "mamba"),
              ffn=("moe" if i % 2 == 1 else "dense"))
    for i in range(8)
)

CONFIG = LMConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    pattern=_PATTERN,
    n_experts=16, top_k=2,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    rope_theta=None,   # Jamba uses no positional encoding in attention
    act="silu", tie_embeddings=False, param_dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="jamba-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=128,
    pattern=tuple(
        BlockSpec(mixer=("attn" if i == 4 else "mamba"),
                  ffn=("moe" if i % 2 == 1 else "dense"))
        for i in range(8)),
    n_experts=4, top_k=2, rope_theta=None,
    tie_embeddings=False, param_dtype=torch.float32, remat="none",
    attn_backend="ref",
)

SHAPES = lm_shapes(long_ok=True)
