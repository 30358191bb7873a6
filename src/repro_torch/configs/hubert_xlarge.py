"""hubert-xlarge  [arXiv:2106.07447] — encoder-only audio transformer.

48L d_model=1280, 16H bidirectional attention, plain-GELU d_ff=5120,
LayerNorm, 504-class frame prediction head (cluster targets).
The conv waveform frontend is a STUB per spec: ``input_specs`` provides
precomputed frame embeddings (B, S, 1280).  No decode shapes
(encoder-only) and no rope (frontend carries positions).
In torch dtypes; copied from ``repro/configs/hubert_xlarge.py``.
"""
import torch

from ..models.lm import BlockSpec, LMConfig
from .common import lm_shapes

CONFIG = LMConfig(
    name="hubert-xlarge",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,
    pattern=(BlockSpec("attn", "dense"),),
    causal=False, rope_theta=None,
    act="gelu", gated_mlp=False, norm="layer",
    lm_head=False, n_classes=504, tie_embeddings=False,
    input_mode="embeddings", param_dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="hubert-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=64,
    pattern=(BlockSpec("attn", "dense"),),
    causal=False, rope_theta=None, act="gelu", gated_mlp=False,
    norm="layer", lm_head=False, n_classes=64, tie_embeddings=False,
    input_mode="embeddings", param_dtype=torch.float32, remat="none",
    attn_backend="ref",
)

SHAPES = lm_shapes(
    long_ok=False, decode_ok=False,
    long_reason="encoder-only: no autoregressive decode",
)
