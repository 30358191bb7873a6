"""llava-next-mistral-7b  [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B backbone: 32L d_model=4096, 32H GQA kv=8, SwiGLU d_ff=14336,
vocab=32000, rope theta 1e6.  The anyres vision tower is a STUB per spec:
``input_specs`` provides precomputed patch+text embeddings (B, S, 4096)
for train/prefill; decode runs on text tokens.
In torch dtypes; copied from ``repro/configs/llava_next_mistral_7b.py``.
"""
import torch

from ..models.lm import BlockSpec, LMConfig
from .common import lm_shapes

CONFIG = LMConfig(
    name="llava-next-mistral-7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    pattern=(BlockSpec("attn", "dense"),),
    rope_theta=1e6, act="silu", tie_embeddings=False,
    input_mode="embeddings", param_dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="llava-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=128,
    pattern=(BlockSpec("attn", "dense"),),
    tie_embeddings=False, input_mode="embeddings",
    param_dtype=torch.float32, remat="none", attn_backend="ref",
)

SHAPES = lm_shapes(long_ok=False)
