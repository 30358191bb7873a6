"""Shared helpers of the port's tests (``tests/test_torch_*.py``).

Tests are the only place where ``repro`` (JAX) and ``repro_torch``
meet: inputs are made with numpy from a seed and handed to both, and
parameters cross as numpy arrays.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as JLM
from repro.models.lm import LMConfig
from repro_torch.models import lm as TLM

PARITY_RTOL = 5e-3                      # tests/test_models_lm.py

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def tiny_cfg() -> LMConfig:
    """The reference serving tests' config (tests/test_serving.py)."""
    return LMConfig(name="serve-tiny", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_ff=128, vocab_size=97,
                    param_dtype=jnp.float32, remat="none",
                    attn_backend="ref")


@functools.lru_cache(maxsize=None)
def tiny_models(n_layers: int = 2, seed: int = 0):
    """The reference's tiny serving config cut to ``n_layers`` layers,
    its params from ``jax.random.key(seed)``, and the port's copies of
    both: (cfg, params, port cfg, port params)."""
    cfg = dataclasses.replace(tiny_cfg(), n_layers=n_layers)
    params = JLM.init_params(cfg, jax.random.key(seed))
    return cfg, params, port_cfg(cfg), port_params(cfg, params)


def port_cfg(cfg: LMConfig) -> TLM.LMConfig:
    """The port's LMConfig with the same fields as a reference one."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["pattern"] = tuple(TLM.BlockSpec(b.mixer, b.ffn)
                              for b in cfg.pattern)
    fields["param_dtype"] = _DTYPES[cfg.param_dtype]
    return TLM.LMConfig(**fields)


def port_params(cfg: LMConfig, params):
    """Carry the reference's params across through numpy."""
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


def greedy_rollouts(cfg, steps, prompt=4, batch=2, max_seq=32,
                    cache_dtype="float32"):
    """The reference's and the port's ``decode_step`` from the same
    reference params: ``prompt`` tokens fed one a step, then greedy, with
    caches of ``cache_dtype`` on both sides.  Returns (JAX logits per
    step, port logits per step, JAX greedy tokens, port greedy
    tokens)."""
    params = JLM.init_params(cfg, jax.random.key(7))
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    step = jax.jit(lambda p, c, t, pos: JLM.decode_step(cfg, p, c, t, pos))
    jc = JLM.init_cache(cfg, batch, max_seq, getattr(jnp, cache_dtype))
    tcfg, tp = port_cfg(cfg), port_params(cfg, params)
    tc = TLM.init_cache(tcfg, batch, max_seq, getattr(torch, cache_dtype),
                        device="cpu")
    j_tok, t_tok = toks[:, :1], torch.from_numpy(toks[:, :1]).long()
    j_logits, t_logits, j_out, t_out = [], [], [], []
    for pos in range(steps):
        jl, jc = step(params, jc, jnp.asarray(j_tok), jnp.int32(pos))
        tl, tc = TLM.decode_step(tcfg, tp, tc, t_tok, pos)
        j_logits.append(np.asarray(jl))
        t_logits.append(to_numpy(tl))
        if pos + 1 < prompt:
            j_tok = toks[:, pos + 1:pos + 2]
            t_tok = torch.from_numpy(j_tok).long()
        else:
            j_tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
            t_tok = tl[:, -1].argmax(-1, keepdim=True)
            j_out.append(j_tok[:, 0])
            t_out.append(t_tok[:, 0].numpy())
    return j_logits, t_logits, np.stack(j_out, 1), np.stack(t_out, 1)


def port_rollout_parity(tcfg, tp, tokens):
    """The port's own ``rollout_parity`` (tests/test_models_lm.py): the
    last prefill logits equal a ``decode_step`` rollout's within
    ``PARITY_RTOL``."""
    logits, _ = TLM.forward(tcfg, tp, tokens)
    cache = TLM.init_cache(tcfg, tokens.shape[0], 16, torch.float32,
                           device="cpu")
    for t in range(tokens.shape[1]):
        lg, cache = TLM.decode_step(tcfg, tp, cache, tokens[:, t:t + 1], t)
    np.testing.assert_allclose(to_numpy(lg[:, 0]), to_numpy(logits[:, -1]),
                               rtol=PARITY_RTOL, atol=PARITY_RTOL)


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


@pytest.fixture
def port_cpu():
    """Runs the test with the port's eager factories on the CPU (their
    default is CUDA), with a fresh dispatch cache."""
    import repro_torch
    repro_torch.reset_dispatch_cache()
    with repro_torch.default_device("cpu"):
        yield
    repro_torch.reset_dispatch_cache()


def jax_array(a, dtype: str):
    """A numpy array as a jax array of ``dtype`` (bf16 rounded from
    fp32 by JAX)."""
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def port_tensor(a, dtype: str) -> torch.Tensor:
    """A numpy array as a CPU torch tensor of ``dtype`` (bf16 rounded
    from fp32 by torch: the same round-to-nearest-even as JAX)."""
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def load_reference_state(port_module, ref_module) -> None:
    """Load a reference module's ``state_dict()`` (parameters and
    buffers, as numpy arrays) into the port's module of the same
    architecture; both keep NCHW / OIHW layouts."""
    port_module.load_state_dict(
        {k: np.asarray(v.data) for k, v in ref_module.state_dict().items()})


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds: half a unit of
    the 13 dropped bits added to the magnitude, then those bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor,
                terms: int = 3) -> torch.Tensor:
    """a @ b as the fp32 flash kernel takes it on the tensor cores: each
    operand split into big = tf32(x) and small = tf32(x - big), and the
    products a_small b_big + a_big b_small + a_big b_big summed in fp32
    (``terms=3``, 3xTF32), or the big term alone (``terms=1``, TF32)."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    if terms == 1:
        return a_big @ b_big
    a_small, b_small = tf32_round(a - a_big), tf32_round(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def flash_attention_tf32(q, k, v, *, causal: bool, scale: float,
                         window=None, terms: int = 3) -> torch.Tensor:
    """Attention with both products in ``matmul_tf32``'s arithmetic and
    an fp32 softmax: q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), the queries
    the last Sq positions, as ``flash_attention_plain`` computes it."""
    hq, sq = q.shape[1], q.shape[2]
    hkv, skv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    s = matmul_tf32(q, k.transpose(-1, -2), terms) * scale
    q_pos = torch.arange(sq)[:, None] + (skv - sq)
    k_pos = torch.arange(skv)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window is not None:
        ok = ok & (k_pos > q_pos - window)
    s = torch.where(ok, s, torch.finfo(torch.float32).min)
    return matmul_tf32(torch.softmax(s, dim=-1), v, terms)


def strided_operands(x):
    """Two views of ``x``'s values that the kernels cannot read as they
    are: the same values at an odd element offset (contiguous, not 16-byte
    aligned), and a transposed copy transposed back (not contiguous)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    odd = flat[1:].view(x.shape).copy_(x)
    swapped = x.transpose(0, -1).contiguous().transpose(0, -1)
    assert odd.data_ptr() % 16 and not swapped.is_contiguous()
    return odd, swapped
