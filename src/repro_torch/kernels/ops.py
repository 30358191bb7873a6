"""Public wrappers around the port's kernels.

Counterpart of ``repro/kernels/ops.py``:

  * :func:`flash_attention` flattens ``(B, Hq, S, D) -> (B*Hq, S, D)``
    as ``ops.py:50-90`` does and calls the CUDA flash kernel; it is a
    ``torch.autograd.Function`` whose backward recomputes through the
    plain version, as the reference's ``custom_vjp`` differentiates its
    jnp oracle (there is no backward kernel in either);
  * :func:`decode_attention` does the GQA grouping
    ``(B, Hq, 1, D) -> (B, Hkv, G, D)`` of ``ops.py:97-116`` and calls
    the CUDA decode kernel;
  * :func:`mixed_attention` does the GQA grouping
    ``(T, Hq, D) -> (T, Hkv, G, D)`` of ``ops.py:123-147`` and calls the
    CUDA mixed-attention kernel over per-slot contiguous caches, without
    ``_pad_last`` (no cache is copied to a padded width);
  * :func:`paged_attention` does the GQA grouping
    ``(T, Hq, D) -> (T, Hkv, G, D)`` of ``ops.py:160-193`` and calls the
    CUDA paged-attention kernel.  There is no ``_pad_last`` lane padding:
    the kernel is templated on head_dim, so no page pool is ever copied
    to a padded width, and no ``pages_per_tile`` (see the kernel's
    source note);
  * :func:`gumbel_perturb` is the Gumbel-max perturbation
    ``logits + -log(-log(u))`` in fp32, a Triton kernel on CUDA, and
    :func:`gumbel_perturb_keyed` the same with ``u`` the port's
    position-keyed uniforms, drawn inside its Triton kernel;
  * :func:`rwkv6_scan` calls the CUDA WKV6 kernel on the (B, H, S, D)
    views as they come, where ``ops.py:200-227`` flattens them to
    (B*H, S, D) and pads the lanes, with an optional initial state; it
    is a
    ``torch.autograd.Function`` whose backward recomputes through the
    plain version, as the reference's ``custom_vjp`` differentiates its
    oracle (``ops.py:230-240``);
  * :func:`mamba_scan` calls the CUDA selective-scan kernel with an
    optional initial state and returns the final state too (the
    reference's ``ops.py:244-266`` returns y alone); it is a
    ``torch.autograd.Function`` whose backward recomputes through the
    plain version, as the reference's ``_mamba_bwd`` differentiates
    ``ref.mamba_scan``;
  * :func:`fused_elementwise` / :func:`make_fused_elementwise` run a
    fusion-queue chain as one Triton kernel generated from the chain
    (``ops.py:277-357``; the kernel, its plain version and its source
    note are in ``kernels/fused_elementwise.py``).

Source note for the Gumbel kernels.  They replace
``repro/kernels/ops.py::gumbel_perturb``, which ran the perturbation as
one Pallas ``fused_elementwise`` kernel (``pallas_call`` at
``ops.py:323``) over a ``(rows, 128)`` lane-major view, with the
uniforms an input drawn by ``jax.random`` (threefry) beforehand.  On the
H100 the perturbation is bound by bytes: for gemma-2b's ``R = S*(K+1)``
rows of ``V = 256000`` it does two logs per element, far below the
card's compute.  The serving path takes the keyed kernel
(:func:`gumbel_perturb_keyed`): it draws the port's position-keyed
uniforms (``kernels/_noise.py``) in registers, so the (R, V) uniform
tensor, and the ~24 int64 passes that made it in torch ops, never
exist, and a call reads the logits once and writes the result once.
Its hash is exact ``uint32`` arithmetic (one ``mul.lo`` where the torch
version splits each product into 16-bit halves), so it reproduces the
torch version's uniforms bit for bit.  A program takes a 2-D tile of
rows x lanes (4 x 1024): each lane's hash is computed once for the
tile's rows, each row's once per program, and the elements are read
and written as 16-byte accesses where the row width allows.  The logs
are ``tl.log`` (libdevice ``logf``): near ``u = 1 - 2**-24``,
``-log(u)`` is ~6e-8 and an approximate log's absolute error would
move ``-log(-log(u))`` by O(1).  :func:`gumbel_perturb` keeps the
uniforms an input, as the TPU kernel did (tests hand both packages the
same numbers): one flat pass over three fp32 streams.  Neither needs
tiling, shared memory or tensor cores, which is why Triton serves as
well as CUDA C++; the TPU's ``(rows, 128)`` view, sublane-rounded
block rows and tail padding do not carry over: Triton masks the ragged
edges itself.

Each wrapper takes the plain version only for CPU tensors; on a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import LaunchCounter, launch_op
from ._noise import position_uniforms
from .decode_attention import (decode_attention_fwd, mixed_attention_fwd,
                               paged_attention_fwd)
from .flash_attention import flash_attention_fwd, flash_attention_plain
from .fused_elementwise import (FusedChain, fused_elementwise,  # noqa: F401
                                fused_elementwise_plain,
                                make_fused_elementwise)
from .mamba import mamba_scan_fwd, mamba_scan_plain
from .rwkv6 import rwkv6_scan_fwd, rwkv6_scan_plain

gumbel_counter = LaunchCounter("gumbel_perturb")


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU).  Backward:
    autograd through :func:`flash_attention_plain` on the saved inputs.
    ``setup_context`` is separate from ``forward`` so that the function
    also runs under ``torch.func.vjp`` (the eager runtime's
    ``F.scaled_dot_product_attention``)."""

    @staticmethod
    def forward(q, k, v, causal, scale, window):
        b, hq, sq, d = q.shape
        _, hkv, skv, _ = k.shape
        out = flash_attention_fwd(
            q.reshape(b * hq, sq, d).contiguous(),
            k.reshape(b * hkv, skv, d).contiguous(),
            v.reshape(b * hkv, skv, d).contiguous(),
            causal=causal, scale=scale, window=window)
        return out.reshape(b, hq, sq, d)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, scale, window = inputs
        ctx.save_for_backward(q, k, v)
        ctx.attn = (causal, scale, window)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        causal, scale, window = ctx.attn
        b, hq, sq, d = q.shape
        _, hkv, skv, _ = k.shape
        with torch.enable_grad():
            qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
            out = flash_attention_plain(
                qq.reshape(b * hq, sq, d), kk.reshape(b * hkv, skv, d),
                vv.reshape(b * hkv, skv, d), causal=causal, scale=scale,
                window=window).reshape(b, hq, sq, d)
            dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), grad)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D), GQA-aware; the queries
    are the last Sq positions.  Returns (B, Hq, Sq, D) in q's dtype;
    differentiable in q, k and v."""
    eff_scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, eff_scale, window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     scale: Optional[float] = None,
                     window: Optional[int] = None,
                     return_lse: bool = False):
    """q: (B, Hq, 1, D) against the cache (B, Hkv, Smax, D) filled to
    ``cache_len``: a host int, or a (B,) tensor, broadcast to (B,) int32
    (lengths >= 1).  Returns (B, Hq, 1, D), and with ``return_lse`` also
    the (B, Hq, 1) fp32 log-sum-exp of each row's visible scaled
    logits.  Inference only (no backward, as in the reference)."""
    b, hq, sq, d = q.shape
    hkv = k_cache.shape[1]
    if sq != 1:
        raise ValueError(f"decode_attention: one query per row, got Sq={sq}")
    eff_scale = scale if scale is not None else d ** -0.5
    if isinstance(cache_len, torch.Tensor):
        lens = cache_len.to(device=q.device, dtype=torch.int32
                            ).reshape(-1).expand(b).contiguous()
    else:
        lens = torch.full((b,), int(cache_len), dtype=torch.int32,
                          device=q.device)
    out = decode_attention_fwd(q.reshape(b, hkv, hq // hkv, d).contiguous(),
                               k_cache, v_cache, lens, scale=eff_scale,
                               window=window, return_lse=return_lse)
    if return_lse:
        out, lse = out
        return out.reshape(b, hq, 1, d), lse.reshape(b, hq, 1)
    return out.reshape(b, hq, 1, d)


def mixed_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, seg_ids, positions,
                    scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (T, Hq, D) flat token batch against per-slot contiguous caches
    (S, Hkv, L, D); seg_ids/positions (T,) (tensors or sequences, taken
    as int32 on q's device).  Token t attends slot seg_ids[t]'s keys at
    positions <= positions[t] (and > positions[t] - window).  Returns
    (T, Hq, D) in q's dtype.  Inference only (no backward, as in the
    reference)."""
    t, hq, d = q.shape
    hkv = k_cache.shape[1]
    eff_scale = scale if scale is not None else d ** -0.5
    seg = torch.as_tensor(seg_ids, dtype=torch.int32, device=q.device)
    pos = torch.as_tensor(positions, dtype=torch.int32, device=q.device)
    out = mixed_attention_fwd(q.reshape(t, hkv, hq // hkv, d).contiguous(),
                              k_cache, v_cache, seg.contiguous(),
                              pos.contiguous(), scale=eff_scale,
                              window=window)
    return out.reshape(t, hq, d)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, tables: torch.Tensor,
                    seg_ids: torch.Tensor, positions: torch.Tensor,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """Mixed prefill/decode attention directly over the physical KV page
    pool.  q: (T, Hq, D) flat token batch; k_pages/v_pages (N, ps, Hkv,
    D); tables (S, P), seg_ids/positions (T,) int32.  Token t attends
    slot seg_ids[t]'s pages at key positions <= positions[t] (seg_ids < 0
    is padding whose output the caller discards).  A quantized pool
    passes (N, ps, Hkv) fp32 ``k_scale``/``v_scale``.  Returns (T, Hq, D)
    in q's dtype; with ``return_lse`` also each row's (T, Hq) fp32
    log-sum-exp (``paged_attention_fwd``)."""
    t, hq, d = q.shape
    hkv = k_pages.shape[2]
    eff_scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(t, hkv, hq // hkv, d).contiguous()
    out = paged_attention_fwd(qg, k_pages, v_pages, tables, seg_ids,
                              positions, scale=eff_scale, window=window,
                              k_scale=k_scale, v_scale=v_scale,
                              return_lse=return_lse)
    if return_lse:
        return out[0].reshape(t, hq, d), out[1].reshape(t, hq)
    return out.reshape(t, hq, d)


def gumbel_perturb_plain(logits: torch.Tensor,
                         uniform: torch.Tensor) -> torch.Tensor:
    """``logits + -log(-log(u))`` in fp32, elementwise."""
    return logits.float() + -torch.log(-torch.log(uniform.float()))


def gumbel_perturb(logits: torch.Tensor,
                   uniform: torch.Tensor) -> torch.Tensor:
    """Gumbel-max perturbation for sampling: ``argmax`` of the result is
    a categorical draw from ``softmax(logits)``.  ``uniform`` in (0, 1),
    same shape as ``logits``.  Returns fp32."""
    if logits.shape != uniform.shape:
        raise ValueError(f"gumbel_perturb: shapes differ "
                         f"{tuple(logits.shape)} vs {tuple(uniform.shape)}")
    if logits.device.type == "cpu":
        return gumbel_perturb_plain(logits, uniform)
    if logits.device.type != "cuda" or uniform.device != logits.device:
        raise ValueError(f"gumbel_perturb: unsupported devices "
                         f"{logits.device}/{uniform.device}")
    return _gumbel_launch(logits.float().contiguous(),
                          uniform.float().contiguous())


@launch_op("gumbel_perturb")
def _gumbel_launch(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The launch of :func:`gumbel_perturb` as one operator (its shape
    function below)."""
    out = torch.empty_like(x)
    if x.numel():
        from . import _gumbel_triton
        with torch.cuda.device(x.device):
            _gumbel_triton.launch(x, u, out)
        gumbel_counter.bump()
    return out


@_gumbel_launch.register_fake
def _(x, u):
    return torch.empty_like(x)


def gumbel_perturb_keyed_plain(logits: torch.Tensor, seeds: torch.Tensor,
                               positions: torch.Tensor) -> torch.Tensor:
    """:func:`gumbel_perturb_plain` of ``logits`` with the position-keyed
    uniforms ``position_uniforms(seeds, positions, V)``."""
    return gumbel_perturb_plain(
        logits, position_uniforms(seeds, positions, logits.shape[-1]))


def gumbel_perturb_keyed(logits: torch.Tensor, seeds: torch.Tensor,
                         positions: torch.Tensor) -> torch.Tensor:
    """Gumbel-max perturbation of (R, V) ``logits`` with the noise of
    row r keyed by ``(seeds[r], positions[r])`` ((R,) integer tensors):
    :func:`gumbel_perturb_keyed_plain` in one launch, the uniforms drawn
    in registers.  Returns fp32."""
    if logits.dim() != 2 or seeds.shape != (logits.shape[0],) or \
            positions.shape != seeds.shape:
        raise ValueError(f"gumbel_perturb_keyed: logits (R, V) with (R,) "
                         f"seeds and positions, got {tuple(logits.shape)}, "
                         f"{tuple(seeds.shape)}, {tuple(positions.shape)}")
    if logits.device.type == "cpu":
        return gumbel_perturb_keyed_plain(logits, seeds, positions)
    if logits.device.type != "cuda" or seeds.device != logits.device or \
            positions.device != logits.device:
        raise ValueError(f"gumbel_perturb_keyed: unsupported devices "
                         f"{logits.device}/{seeds.device}/"
                         f"{positions.device}")
    return _gumbel_keyed_launch(logits.float().contiguous(),
                                seeds.long().contiguous(),
                                positions.long().contiguous())


@launch_op("gumbel_perturb_keyed")
def _gumbel_keyed_launch(x: torch.Tensor, seeds: torch.Tensor,
                         positions: torch.Tensor) -> torch.Tensor:
    """The launch of :func:`gumbel_perturb_keyed` as one operator (its
    shape function below)."""
    out = torch.empty_like(x)
    if x.numel():
        from . import _gumbel_triton
        with torch.cuda.device(x.device):
            _gumbel_triton.launch_keyed(x, seeds, positions, out)
        gumbel_counter.bump()
    return out


@_gumbel_keyed_launch.register_fake
def _(x, seeds, positions):
    return torch.empty_like(x)


class _RWKV6Scan(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU).  Backward:
    autograd through :func:`rwkv6_scan_plain` on the saved inputs, for r,
    k, v, w and u; ``state0`` is inference-only and gets no gradient (it
    is held constant in the recomputation)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        ctx.save_for_backward(r, k, v, w, u, state0)
        return rwkv6_scan_fwd(r, k, v, w, u, state0)

    @staticmethod
    def backward(ctx, g_out, g_state):
        *saved, state0 = ctx.saved_tensors
        with torch.enable_grad():
            ins = [x.detach().requires_grad_() for x in saved]
            out, state = rwkv6_scan_plain(*ins, state0)
            grads = torch.autograd.grad((out, state), ins, (g_out, g_state))
        return (*grads, None)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state0: Optional[torch.Tensor] = None):
    """r/k/v/w: (B, H, S, D), any strides, decays ``w`` in (0, 1]; u:
    (H, D) fp32 bonus; state0: (B, H, D, D) fp32 or None (zeros).
    Returns (out (B, H, S, D) in r's dtype, final state (B, H, D, D)
    fp32).  Differentiable in r, k, v, w and u."""
    return _RWKV6Scan.apply(r, k, v, w, u, state0)


class _MambaScan(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU).  Backward:
    autograd through :func:`mamba_scan_plain` on the saved inputs, for x,
    dt, B, C, A and D; ``h0`` is inference-only and gets no gradient (it
    is held constant in the recomputation)."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A, D, h0):
        ctx.save_for_backward(x, dt, B, C, A, D, h0)
        return mamba_scan_fwd(x, dt, B, C, A, D, h0)

    @staticmethod
    def backward(ctx, g_y, g_h):
        *saved, h0 = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in saved]
            y, h = mamba_scan_plain(*ins, h0)
            grads = torch.autograd.grad((y, h), ins, (g_y, g_h))
        return (*grads, None)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
               h0: Optional[torch.Tensor] = None):
    """x/dt: (B, S, Di), B/C: (B, S, N), any strides; A: (Di, N) fp32
    (negative); D: (Di,) fp32; h0: (B, Di, N) fp32 or None (zeros).
    Returns (y (B, S, Di) in x's dtype, final state (B, Di, N) fp32).
    Differentiable in x, dt, B, C, A and D."""
    return _MambaScan.apply(x, dt, B, C, A, D, h0)
