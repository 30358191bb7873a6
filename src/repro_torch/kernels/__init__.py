"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Nothing is built or imported from Triton at import time."""

from ._build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
