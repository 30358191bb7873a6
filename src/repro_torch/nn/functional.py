"""nn.functional — stateless ops over Tensors.

Counterpart of ``repro/nn/functional.py``: every op is one torch-level
function routed through the eager dispatcher as a single tape node (its
backward is ``torch.func.vjp`` of that function), with the same op
names and the same ``static=`` tuples, so the dispatch-cache keys and
the fusion queue's chains are the reference's.  Array-valued values an
op depends on (indices, targets, masks, running stats) are operands,
never closed over.

Layouts are the reference's (and PyTorch's): NCHW activations, OIHW
convolution weights, (out, in) linear weights.  Elementwise activations
follow the reference's formulas through PyTorch's own ops; where the two
define a default differently the reference's holds (``gelu`` defaults
to ``approximate="tanh"``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as TF

from ..core.tensor import Tensor, _apply_op, _coerce, _raw

# ----------------------------------------------------------------------
# activations
# ----------------------------------------------------------------------


def relu(x: Tensor) -> Tensor:
    return _apply_op("relu", torch.relu, _coerce(x), static=())


def relu6(x: Tensor) -> Tensor:
    return _apply_op("relu6", TF.relu6, _coerce(x), static=())


def gelu(x: Tensor, approximate: str = "tanh") -> Tensor:
    mode = "tanh" if approximate == "tanh" else "none"
    return _apply_op("gelu", lambda v: TF.gelu(v, approximate=mode),
                     _coerce(x), static=(approximate,))


def silu(x: Tensor) -> Tensor:
    return _apply_op("silu", TF.silu, _coerce(x), static=())


def sigmoid(x: Tensor) -> Tensor:
    return _apply_op("sigmoid", torch.sigmoid, _coerce(x), static=())


def tanh(x: Tensor) -> Tensor:
    return _apply_op("tanh", torch.tanh, _coerce(x), static=())


def softmax(x: Tensor, dim: int = -1) -> Tensor:
    return _apply_op("softmax", lambda v: torch.softmax(v, dim),
                     _coerce(x), static=(dim,))


def log_softmax(x: Tensor, dim: int = -1) -> Tensor:
    return _apply_op("log_softmax", lambda v: torch.log_softmax(v, dim),
                     _coerce(x), static=(dim,))


def leaky_relu(x: Tensor, negative_slope: float = 0.01) -> Tensor:
    return _apply_op("leaky_relu",
                     lambda v: TF.leaky_relu(v, negative_slope), _coerce(x),
                     static=(negative_slope,))


def elu(x: Tensor, alpha: float = 1.0) -> Tensor:
    return _apply_op("elu", lambda v: TF.elu(v, alpha), _coerce(x),
                     static=(alpha,))


def softplus(x: Tensor) -> Tensor:
    return _apply_op("softplus", TF.softplus, _coerce(x), static=())


def hardswish(x: Tensor) -> Tensor:
    return _apply_op("hardswish", TF.hardswish, _coerce(x), static=())


# ----------------------------------------------------------------------
# linear / embedding
# ----------------------------------------------------------------------

def linear(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """y = x @ W^T + b  (torch layout: weight is (out, in))."""
    x, weight = _coerce(x), _coerce(weight)
    if bias is None:
        return _apply_op("linear", lambda v, w: v @ w.T, x, weight,
                         static=())
    return _apply_op("linear",
                     lambda v, w, b: v @ w.T + b, x, weight, _coerce(bias),
                     static=())


def embedding(indices: Tensor, weight: Tensor) -> Tensor:
    # indices ride as an integer *operand* (non-diffable position), not a
    # closure capture: new index values replay the same cached entry
    weight = _coerce(weight)
    return _apply_op("embedding",
                     lambda w, i: w[i.long()],
                     weight, _coerce(indices, device=weight.device),
                     static=())


# ----------------------------------------------------------------------
# normalization
# ----------------------------------------------------------------------

def _var(v, axes, keepdim=False):
    return torch.var(v, dim=axes, correction=0, keepdim=keepdim)


def layer_norm(x: Tensor, normalized_shape: Sequence[int],
               weight: Optional[Tensor] = None,
               bias: Optional[Tensor] = None, eps: float = 1e-5) -> Tensor:
    axes = tuple(range(-len(tuple(normalized_shape)), 0))

    def _ln(v, *wb):
        mean = torch.mean(v, dim=axes, keepdim=True)
        var = _var(v, axes, keepdim=True)
        out = (v - mean) * torch.rsqrt(var + eps)
        if wb:
            out = out * wb[0]
            if len(wb) > 1:
                out = out + wb[1]
        return out

    args = [_coerce(x)]
    if weight is not None:
        args.append(_coerce(weight))
        if bias is not None:
            args.append(_coerce(bias))
    return _apply_op("layer_norm", _ln, *args, static=(axes, eps))


def rms_norm(x: Tensor, weight: Optional[Tensor] = None,
             eps: float = 1e-6, offset: float = 0.0) -> Tensor:
    """RMSNorm; ``offset=1.0`` gives the Gemma convention (1+w scaling)."""

    def _rms(v, *w):
        var = torch.mean(torch.square(v.float()), dim=-1, keepdim=True)
        out = v * torch.rsqrt(var + eps).to(v.dtype)
        if w:
            out = out * (offset + w[0])
        return out

    args = [_coerce(x)]
    if weight is not None:
        args.append(_coerce(weight))
    return _apply_op("rms_norm", _rms, *args, static=(eps, offset))


def batch_norm(x: Tensor, running_mean, running_var,
               weight: Optional[Tensor] = None,
               bias: Optional[Tensor] = None, training: bool = False,
               momentum: float = 0.1, eps: float = 1e-5) -> Tensor:
    """2d batch norm over NCHW.  In training mode, running stats are
    updated in place on the buffer tensors (imperative semantics): the
    biased batch variance, as the reference does."""
    x = _coerce(x)
    reduce_axes = (0,) + tuple(range(2, x.ndim))
    shape = (1, x.shape[1]) + (1,) * (x.ndim - 2)

    if training:
        if running_mean is not None:
            xd = x.data
            batch_mean = torch.mean(xd, dim=reduce_axes)
            batch_var = _var(xd, reduce_axes)
            running_mean._data = ((1 - momentum) * running_mean.data
                                  + momentum * batch_mean)
            running_var._data = ((1 - momentum) * running_var.data
                                 + momentum * batch_var)
            running_mean._version.bump()
            running_var._version.bump()

        def _bn(v, *wb):
            m = torch.mean(v, dim=reduce_axes).reshape(shape)
            var = _var(v, reduce_axes).reshape(shape)
            out = (v - m) * torch.rsqrt(var + eps)
            if wb:
                out = out * wb[0].reshape(shape)
                if len(wb) > 1:
                    out = out + wb[1].reshape(shape)
            return out

        args = [x]
    else:
        # eval mode: running stats are *operands* (they mutate across
        # train steps — closing over them would cache stale values)
        def _bn(v, m, var, *wb):
            m = m.reshape(shape)
            var = var.reshape(shape)
            out = (v - m) * torch.rsqrt(var + eps)
            if wb:
                out = out * wb[0].reshape(shape)
                if len(wb) > 1:
                    out = out + wb[1].reshape(shape)
            return out

        args = [x, _coerce(running_mean), _coerce(running_var)]

    if weight is not None:
        args.append(_coerce(weight))
        if bias is not None:
            args.append(_coerce(bias))
    return _apply_op("batch_norm", _bn, *args, static=(training, eps))


# ----------------------------------------------------------------------
# convolution / pooling (NCHW, torch layout)
# ----------------------------------------------------------------------

def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _same_pads(size: int, k: int, s: int, d: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding (low, high) of one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _conv_pads(pad, x_shape, w_shape, stride, dilation):
    """((lo, hi) per spatial dim) of a reference ``padding``: explicit
    pairs, ``"SAME"`` or ``"VALID"``."""
    if pad == "VALID":
        return tuple((0, 0) for _ in stride)
    if pad == "SAME":
        return tuple(_same_pads(n, k, s, d) for n, k, s, d in zip(
            x_shape[2:], w_shape[2:], stride, dilation))
    return pad


def _conv(v, w, b, stride, pads, dilation, groups, conv):
    if any(lo != hi for lo, hi in pads):
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        v = TF.pad(v, flat)
        pads = tuple((0, 0) for _ in pads)
    return conv(v, w, b, stride, tuple(lo for lo, _ in pads), dilation,
                groups)


def conv2d(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None,
           stride: Union[int, Tuple[int, int]] = 1,
           padding: Union[int, Tuple[int, int], str] = 0,
           dilation: Union[int, Tuple[int, int]] = 1,
           groups: int = 1) -> Tensor:
    stride = _pair(stride)
    dilation = _pair(dilation)
    if isinstance(padding, str):
        pad = padding.upper()
    else:
        p = _pair(padding)
        pad = ((p[0], p[0]), (p[1], p[1]))

    def _conv2d(v, w, *b):
        pads = _conv_pads(pad, v.shape, w.shape, stride, dilation)
        return _conv(v, w, b[0] if b else None, stride, pads, dilation,
                     groups, TF.conv2d)

    args = [_coerce(x), _coerce(weight)]
    if bias is not None:
        args.append(_coerce(bias))
    return _apply_op("conv2d", _conv2d, *args,
                     static=(stride, pad, dilation, groups))


def conv1d(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> Tensor:
    def _conv1d(v, w, *b):
        return TF.conv1d(v, w, b[0] if b else None, stride, padding,
                         dilation, groups)

    args = [_coerce(x), _coerce(weight)]
    if bias is not None:
        args.append(_coerce(bias))
    return _apply_op("conv1d", _conv1d, *args,
                     static=(stride, padding, dilation, groups))


def max_pool2d(x: Tensor, kernel_size, stride=None, padding=0) -> Tensor:
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    p = _pair(padding)

    def _pool(v):
        # the reference pads with -inf, as torch's max pooling does
        return TF.max_pool2d(v, k, s, p)

    return _apply_op("max_pool2d", _pool, _coerce(x), static=(k, s, p))


def avg_pool2d(x: Tensor, kernel_size, stride=None, padding=0) -> Tensor:
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    p = _pair(padding)

    def _pool(v):
        # zero padding counted in the window, as the reference's
        # reduce_window sum over k0 * k1 is
        return TF.avg_pool2d(v, k, s, p, count_include_pad=True)

    return _apply_op("avg_pool2d", _pool, _coerce(x), static=(k, s, p))


def adaptive_avg_pool2d(x: Tensor, output_size) -> Tensor:
    out = _pair(output_size)

    def _pool(v):
        n, c, h, w = v.shape
        if h >= out[0] and w >= out[1] and h % out[0] == 0 \
                and w % out[1] == 0:
            kh, kw = h // out[0], w // out[1]
            v = v.reshape(n, c, out[0], kh, out[1], kw)
            return v.mean(dim=(3, 5))
        # non-divisible / upscale: linear interpolation, as the
        # reference's jax.image.resize (antialiased when shrinking)
        return TF.interpolate(v, size=out, mode="bilinear",
                              align_corners=False,
                              antialias=h > out[0] or w > out[1])

    return _apply_op("adaptive_avg_pool2d", _pool, _coerce(x),
                     static=(out,))


# ----------------------------------------------------------------------
# dropout
# ----------------------------------------------------------------------

_dropout_seed = np.random.default_rng(1234)


def dropout(x: Tensor, p: float = 0.5, training: bool = True,
            rng: Optional[torch.Generator] = None) -> Tensor:
    """Inverted dropout.  The keep mask comes from the module's host
    numpy generator (seeded 1234, as the reference's), or from ``rng``,
    a ``torch.Generator`` on the tensor's device (the reference takes a
    JAX key there, which gives other bits)."""
    if not training or p == 0.0:
        return _coerce(x)
    x = _coerce(x)
    if rng is None:
        keep = _dropout_seed.random(x.shape) >= p
        mask = torch.as_tensor(keep, device=x.device).to(x.dtype)
    else:
        mask = (torch.rand(x.shape, generator=rng, device=x.device)
                < 1.0 - p).to(x.dtype)
    scale = 1.0 / (1.0 - p)
    return _apply_op("dropout", lambda v, m: v * m * scale, x, Tensor(mask),
                     static=(p,))


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------

def cross_entropy(logits: Tensor, target: Tensor,
                  ignore_index: int = -100,
                  label_smoothing: float = 0.0,
                  reduction: str = "mean") -> Tensor:
    """Softmax cross-entropy with integer targets (torch semantics)."""

    def _ce(lg, tgt):
        logp = torch.log_softmax(lg.float(), dim=-1)
        n_cls = lg.shape[-1]
        flat_logp = logp.reshape(-1, n_cls)
        flat_tgt = tgt.reshape(-1)
        valid = flat_tgt != ignore_index
        safe_tgt = torch.where(valid, flat_tgt, 0).long()
        picked = torch.take_along_dim(
            flat_logp, safe_tgt[:, None], dim=-1)[:, 0]
        if label_smoothing > 0.0:
            smooth = torch.mean(flat_logp, dim=-1)
            picked = (1 - label_smoothing) * picked + label_smoothing * smooth
        loss = -torch.where(valid, picked, 0.0)
        if reduction == "mean":
            return loss.sum() / torch.clamp(valid.sum(), min=1)
        if reduction == "sum":
            return loss.sum()
        return loss.reshape(tgt.shape)

    logits = _coerce(logits)
    return _apply_op("cross_entropy", _ce, logits,
                     _coerce(target, device=logits.device),
                     static=(ignore_index, label_smoothing, reduction))


def nll_loss(log_probs: Tensor, target: Tensor,
             reduction: str = "mean") -> Tensor:
    def _nll(lp, tgt):
        picked = torch.take_along_dim(
            lp.reshape(-1, lp.shape[-1]),
            tgt.reshape(-1)[:, None].long(), dim=-1)[:, 0]
        loss = -picked
        if reduction == "mean":
            return loss.mean()
        if reduction == "sum":
            return loss.sum()
        return loss.reshape(tgt.shape)

    log_probs = _coerce(log_probs)
    return _apply_op("nll_loss", _nll, log_probs,
                     _coerce(target, device=log_probs.device),
                     static=(reduction,))


def mse_loss(input: Tensor, target: Tensor, reduction: str = "mean") -> Tensor:
    def _mse(a, b):
        d = torch.square(a - b)
        if reduction == "mean":
            return d.mean()
        if reduction == "sum":
            return d.sum()
        return d

    return _apply_op("mse_loss", _mse, _coerce(input), _coerce(target),
                     static=(reduction,))


def binary_cross_entropy_with_logits(input: Tensor, target: Tensor,
                                     reduction: str = "mean") -> Tensor:
    def _bce(lg, t):
        loss = torch.clamp(lg, min=0) - lg * t + torch.log1p(
            torch.exp(-torch.abs(lg)))
        if reduction == "mean":
            return loss.mean()
        if reduction == "sum":
            return loss.sum()
        return loss

    return _apply_op("bce_logits", _bce, _coerce(input), _coerce(target),
                     static=(reduction,))


# ----------------------------------------------------------------------
# attention: the port's models.attention.sdpa (the flash kernel on the
# card, its plain version on the CPU)
# ----------------------------------------------------------------------

def scaled_dot_product_attention(q: Tensor, k: Tensor, v: Tensor,
                                 attn_mask: Optional[Tensor] = None,
                                 is_causal: bool = False,
                                 scale: Optional[float] = None,
                                 window: Optional[int] = None,
                                 backend: str = "auto") -> Tensor:
    """(B, H, S, D) attention with GQA broadcast, causal & sliding-window
    masking, through ``models.attention.sdpa``."""
    from ..models import attention as _attn

    static = (is_causal, scale, window, backend)
    if attn_mask is None:
        fn = lambda qd, kd, vd: _attn.sdpa(  # noqa: E731
            qd, kd, vd, is_causal=is_causal, scale=scale, window=window,
            mask=None, backend=backend)
        return _apply_op("sdpa", fn, _coerce(q), _coerce(k), _coerce(v),
                         static=static)
    # the mask is an operand, not a closure capture: attention masks
    # change per batch while shapes stay fixed
    fn = lambda qd, kd, vd, md: _attn.sdpa(  # noqa: E731
        qd, kd, vd, is_causal=is_causal, scale=scale, window=window,
        mask=md, backend=backend)
    return _apply_op("sdpa", fn, _coerce(q), _coerce(k), _coerce(v),
                     _coerce(attn_mask), static=static)


# handy aliases matching torch.nn.functional
def pad(x: Tensor, padding: Sequence[int], value: float = 0.0) -> Tensor:
    """torch-style pad: last-dim-first pairs."""
    x = _coerce(x)
    pads = tuple(padding)
    return _apply_op("pad",
                     lambda v: TF.pad(v, pads, value=value), x,
                     static=(pads, value))


def one_hot(x: Tensor, num_classes: int) -> Tensor:
    return Tensor(TF.one_hot(_raw(x).long(), num_classes).float())


def normalize(x: Tensor, p: float = 2.0, dim: int = -1,
              eps: float = 1e-12) -> Tensor:
    def _norm(v):
        n = torch.linalg.vector_norm(v, ord=p, dim=dim, keepdim=True)
        return v / torch.clamp(n, min=eps)

    return _apply_op("normalize", _norm, _coerce(x), static=(p, dim, eps))
