"""Model configurations of the port: ``gemma_2b`` (attn/dense blocks),
``rwkv6_1_6b`` (rwkv blocks) and ``jamba_1_5_large_398b`` (mamba and
attn blocks with dense and MoE FFNs), each a ``CONFIG`` at the published
widths and a small ``SMOKE``.  The other seven architectures come with
ROADMAP.md queue A6."""
