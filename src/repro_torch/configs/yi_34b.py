"""yi-34b  [arXiv:2403.04652] — llama-architecture GQA.

60L d_model=7168, 56H GQA kv=8 (head_dim=128), SwiGLU d_ff=20480,
vocab=64000.  56 heads don't divide TP=16 → context-parallel attention.
In torch dtypes; copied from ``repro/configs/yi_34b.py``.
"""
import torch

from ..models.lm import BlockSpec, LMConfig
from .common import lm_shapes

CONFIG = LMConfig(
    name="yi-34b",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    pattern=(BlockSpec("attn", "dense"),),
    rope_theta=5e6, act="silu", tie_embeddings=False,
    param_dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="yi-smoke",
    n_layers=2, d_model=64, n_heads=7, n_kv_heads=1, head_dim=16,
    d_ff=192, vocab_size=128,
    pattern=(BlockSpec("attn", "dense"),),
    tie_embeddings=False, param_dtype=torch.float32, remat="none",
    attn_backend="ref",
)

SHAPES = lm_shapes(long_ok=False)
