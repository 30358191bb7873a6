"""gemma3-1b  [hf:google/gemma-3-1b-pt].

26L d_model=1152, 4H GQA kv=1, head_dim=256, GeGLU d_ff=6912,
vocab=262144.  5:1 local:global attention (sliding window 512 on local
layers, rope theta 10k local / 1M global), QK-norm, (1+w) RMSNorm, tied
scaled embeddings.  26 = 4×(5+1) + 2-layer sliding tail.
long_500k: local layers keep a 512-slot ring buffer; only the 4 global
layers hold full 524288-token KV → runs (noted in DESIGN.md).
In torch dtypes; copied from ``repro/configs/gemma3_1b.py``.
"""
import torch

from ..models.lm import BlockSpec, LMConfig
from .common import lm_shapes

_PATTERN = tuple([BlockSpec("sliding", "dense")] * 5
                 + [BlockSpec("attn", "dense")])

CONFIG = LMConfig(
    name="gemma3-1b",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    pattern=_PATTERN, window=512,
    rope_theta=1e6, rope_theta_local=1e4, qk_norm=True,
    act="gelu", norm_offset=1.0, embed_scale=True, tie_embeddings=True,
    param_dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="gemma3-smoke",
    n_layers=8, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
    d_ff=128, vocab_size=256,
    pattern=tuple([BlockSpec("sliding", "dense")] * 5
                  + [BlockSpec("attn", "dense")]),
    window=8, rope_theta=1e6, rope_theta_local=1e4, qk_norm=True,
    act="gelu", norm_offset=1.0, embed_scale=True, tie_embeddings=True,
    param_dtype=torch.float32, remat="none", attn_backend="ref",
)

SHAPES = lm_shapes(
    long_ok=True,
    long_reason="5:1 sliding:global — rings bound local KV; global KV "
                "(4 layers) fits sharded")
