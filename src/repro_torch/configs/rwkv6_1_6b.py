"""rwkv6-1.6b — RWKV-6 "Finch" 1.6B  [arXiv:2404.05892], in torch dtypes.

24L d_model=2048, attention-free (WKV6 data-dependent-decay recurrence),
channel-mix FFN 3.5×d = 7168, vocab=65536, head_dim=64 (32 heads).
Constant-size state: each layer carries an (H, 64, 64) fp32 WKV state and
two token-shift rows, whatever the sequence length.  Copied from
``repro/configs/rwkv6_1_6b.py``.
"""
import torch

from ..models.lm import BlockSpec, LMConfig
from .common import lm_shapes

CONFIG = LMConfig(
    name="rwkv6-1.6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab_size=65536,
    pattern=(BlockSpec("rwkv", "none"),),   # channel-mix lives in the block
    rwkv_head_dim=64, rope_theta=None,
    tie_embeddings=False, param_dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="rwkv6-smoke",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=224, vocab_size=128,
    pattern=(BlockSpec("rwkv", "none"),),
    rwkv_head_dim=32, rope_theta=None, tie_embeddings=False,
    param_dtype=torch.float32, remat="none", attn_backend="ref",
)

SHAPES = lm_shapes(long_ok=True)
