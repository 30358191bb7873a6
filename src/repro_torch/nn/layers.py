"""Built-in layers (paper Listing 1: constructors create parameters,
``forward`` processes activations).  Counterpart of
``repro/nn/layers.py``: the same initializers, drawn from the same host
generator (``repro_torch.manual_seed``), so a seed gives the reference's
weights."""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from ..core import tensor_mod as T
from ..core.tensor import Tensor
from . import functional as F
from .module import Module, Parameter


def _kaiming_uniform(shape, fan_in, dtype=torch.float32) -> Tensor:
    bound = math.sqrt(1.0 / fan_in) if fan_in > 0 else 0.0
    return T.uniform(-bound, bound, shape, dtype=dtype)


class Linear(Module):
    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = Parameter(
            _kaiming_uniform((out_features, in_features), in_features, dtype))
        if bias:
            self.bias = Parameter(
                _kaiming_uniform((out_features,), in_features, dtype))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x, self.weight, self._parameters.get("bias"))

    def __repr__(self):
        return (f"Linear(in={self.in_features}, out={self.out_features}, "
                f"bias={self._parameters.get('bias') is not None})")


class Embedding(Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dtype=torch.float32):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = Parameter(
            T.normal(0.0, 1.0, (num_embeddings, embedding_dim), dtype=dtype))

    def forward(self, idx: Tensor) -> Tensor:
        return F.embedding(idx, self.weight)

    def __repr__(self):
        return f"Embedding({self.num_embeddings}, {self.embedding_dim})"


class LayerNorm(Module):
    def __init__(self, normalized_shape: Union[int, Tuple[int, ...]],
                 eps: float = 1e-5, elementwise_affine: bool = True,
                 bias: bool = True, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        if elementwise_affine:
            self.weight = Parameter(T.ones(*self.normalized_shape,
                                           dtype=dtype))
            if bias:
                self.bias = Parameter(T.zeros(*self.normalized_shape,
                                              dtype=dtype))
            else:
                self.register_parameter("bias", None)
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: Tensor) -> Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            self._parameters.get("weight"),
                            self._parameters.get("bias"), self.eps)


class RMSNorm(Module):
    """offset=1.0 gives the Gemma (1+w) convention."""

    def __init__(self, dim: int, eps: float = 1e-6, offset: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.offset = offset
        init = T.zeros(dim, dtype=dtype) if offset else T.ones(dim,
                                                               dtype=dtype)
        self.weight = Parameter(init)

    def forward(self, x: Tensor) -> Tensor:
        return F.rms_norm(x, self.weight, self.eps, self.offset)


class BatchNorm2d(Module):
    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        if affine:
            self.weight = Parameter(T.ones(num_features))
            self.bias = Parameter(T.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", T.zeros(num_features))
        self.register_buffer("running_var", T.ones(num_features))

    def forward(self, x: Tensor) -> Tensor:
        return F.batch_norm(
            x, self._buffers["running_mean"], self._buffers["running_var"],
            self._parameters.get("weight"), self._parameters.get("bias"),
            training=self.training, momentum=self.momentum, eps=self.eps)


class Conv2d(Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]],
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int], str] = 0,
                 dilation: int = 1, groups: int = 1, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        k = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        # canonicalize at construction: every forward then passes
        # identical static descriptors (one dispatch-cache key per layer
        # config, whether the user wrote `stride=1` or `stride=(1, 1)`)
        self.stride = F._pair(stride)
        self.padding = padding if isinstance(padding, str) \
            else F._pair(padding)
        self.dilation, self.groups = F._pair(dilation), groups
        fan_in = in_channels // groups * k[0] * k[1]
        self.weight = Parameter(_kaiming_uniform(
            (out_channels, in_channels // groups, k[0], k[1]), fan_in, dtype))
        if bias:
            self.bias = Parameter(_kaiming_uniform(
                (out_channels,), fan_in, dtype))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: Tensor) -> Tensor:
        return F.conv2d(x, self.weight, self._parameters.get("bias"),
                        self.stride, self.padding, self.dilation, self.groups)


class Conv1d(Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        fan_in = in_channels // groups * kernel_size
        self.weight = Parameter(_kaiming_uniform(
            (out_channels, in_channels // groups, kernel_size), fan_in,
            dtype))
        if bias:
            self.bias = Parameter(_kaiming_uniform((out_channels,), fan_in,
                                                   dtype))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: Tensor) -> Tensor:
        return F.conv1d(x, self.weight, self._parameters.get("bias"),
                        self.stride, self.padding, self.dilation, self.groups)


class MaxPool2d(Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding

    def forward(self, x: Tensor) -> Tensor:
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)


class AvgPool2d(Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding

    def forward(self, x: Tensor) -> Tensor:
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding)


class AdaptiveAvgPool2d(Module):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x: Tensor) -> Tensor:
        return F.adaptive_avg_pool2d(x, self.output_size)


class Dropout(Module):
    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x: Tensor, rng=None) -> Tensor:
        return F.dropout(x, self.p, training=self.training, rng=rng)


class Flatten(Module):
    def __init__(self, start_dim: int = 1, end_dim: int = -1):
        super().__init__()
        self.start_dim, self.end_dim = start_dim, end_dim

    def forward(self, x: Tensor) -> Tensor:
        return x.flatten(self.start_dim, self.end_dim)


class Identity(Module):
    def forward(self, x: Tensor) -> Tensor:
        return x


class ReLU(Module):
    def forward(self, x):
        return F.relu(x)


class ReLU6(Module):
    def forward(self, x):
        return F.relu6(x)


class GELU(Module):
    def __init__(self, approximate: str = "tanh"):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class SiLU(Module):
    def forward(self, x):
        return F.silu(x)


class Sigmoid(Module):
    def forward(self, x):
        return F.sigmoid(x)


class Tanh(Module):
    def forward(self, x):
        return F.tanh(x)


class Softmax(Module):
    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return F.softmax(x, self.dim)


class Hardswish(Module):
    def forward(self, x):
        return F.hardswish(x)
