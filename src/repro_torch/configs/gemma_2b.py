"""gemma-2b  [arXiv:2403.08295], in torch dtypes.

18L d_model=2048, MQA (8 query heads, 1 KV head, head_dim=256),
GeGLU d_ff=16384, vocab=256000, tied embeddings scaled by sqrt(d_model),
RMSNorm with (1+w) convention.  Copied from ``repro/configs/gemma_2b.py``.
"""
import torch

from ..models.lm import BlockSpec, LMConfig
from .common import lm_shapes

CONFIG = LMConfig(
    name="gemma-2b",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000,
    pattern=(BlockSpec("attn", "dense"),),
    act="gelu", norm_offset=1.0, embed_scale=True, tie_embeddings=True,
    rope_theta=1e4, param_dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="gemma-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256,
    pattern=(BlockSpec("attn", "dense"),),
    act="gelu", norm_offset=1.0, embed_scale=True, tie_embeddings=True,
    param_dtype=torch.float32, remat="none", attn_backend="ref",
)

SHAPES = lm_shapes(long_ok=False)
