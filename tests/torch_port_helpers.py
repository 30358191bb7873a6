"""Shared helpers of the port's tests (``tests/test_torch_*.py``).

Tests are the only place where ``repro`` (JAX) and ``repro_torch``
meet: inputs are made with numpy from a seed and handed to both, and
parameters cross as numpy arrays.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import LMConfig
from repro_torch.models import lm as TLM

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def tiny_cfg() -> LMConfig:
    """The reference serving tests' config (tests/test_serving.py)."""
    return LMConfig(name="serve-tiny", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_ff=128, vocab_size=97,
                    param_dtype=jnp.float32, remat="none",
                    attn_backend="ref")


def port_cfg(cfg: LMConfig) -> TLM.LMConfig:
    """The port's LMConfig with the same fields as a reference one."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["pattern"] = tuple(TLM.BlockSpec(b.mixer, b.ffn)
                              for b in cfg.pattern)
    fields["param_dtype"] = _DTYPES[cfg.param_dtype]
    return TLM.LMConfig(**fields)


def port_params(cfg: LMConfig, params):
    """Carry the reference's params across through numpy."""
    import jax
    return TLM.params_from_numpy(port_cfg(cfg),
                                 jax.tree.map(np.asarray, params),
                                 device="cpu")


def to_torch(a) -> torch.Tensor:
    """numpy (or jax) array -> CPU tensor, bf16/fp8 included."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@pytest.fixture
def cuda_device():
    """Skips the test unless a CUDA device is present; decided here, at
    run time, never while a module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# the marker of tests that need the card: they run only with a GPU
requires_cuda = pytest.mark.usefixtures("cuda_device")
