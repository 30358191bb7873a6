"""minicpm3-4b  [hf:openbmb/MiniCPM3-4B] — MLA (multi-head latent attn).

62L d_model=2560, 40 heads, MLA: q_lora_rank=768, kv_lora_rank=256,
qk_nope=64, qk_rope=32, v_dim=64; SwiGLU d_ff=6400, vocab=73448.
The decode cache stores only (c_kv 256 + k_rope 32) per token — the MLA
memory win.  MiniCPM's depth/emb scaling factors are folded away (noted
in DESIGN.md §Arch-applicability).
In torch dtypes; copied from ``repro/configs/minicpm3_4b.py``.
"""
import torch

from ..models.lm import BlockSpec, LMConfig
from .common import lm_shapes

CONFIG = LMConfig(
    name="minicpm3-4b",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    pattern=(BlockSpec("mla", "dense"),),
    q_lora_rank=768, kv_lora_rank=256,
    mla_nope_dim=64, mla_rope_dim=32, mla_v_dim=64,
    rope_theta=1e4, act="silu", tie_embeddings=True,
    param_dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="minicpm3-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=128,
    pattern=(BlockSpec("mla", "dense"),),
    q_lora_rank=32, kv_lora_rank=16, mla_nope_dim=16, mla_rope_dim=8,
    mla_v_dim=16, tie_embeddings=True, param_dtype=torch.float32,
    remat="none", attn_backend="ref",
)

SHAPES = lm_shapes(long_ok=False)
