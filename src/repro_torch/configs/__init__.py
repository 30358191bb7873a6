"""Model configurations of the port: ``gemma_2b`` (attn/dense blocks) and
``rwkv6_1_6b`` (rwkv blocks), each a ``CONFIG`` at the published widths
and a small ``SMOKE``.  The other eight architectures come with
ROADMAP.md queue A, item 11."""
