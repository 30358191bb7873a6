"""Model configurations of the port (gemma-2b only in this slice; the
other nine architectures come with ROADMAP.md queue A, item 11)."""
