"""Shared model layers, port of revisiting_at_tpu/models/layers.py.

Activations are NHWC tensors ([B, H, W, C], contiguous), as in the JAX
package; a convolution runs on the NCHW view of that memory, which is
PyTorch's channels_last layout, so no copy is made around it. Parameters
are float32 and are cast to the compute dtype at use.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def trunc_normal_(t: torch.Tensor, std: float = 0.02) -> torch.Tensor:
    """Truncated normal at +-2 std, the timm/JAX init of ConvNeXt weights."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """LayerNorm over the last (channel) axis, eps 1e-6, f32 statistics.

    Computes like flax's nn.LayerNorm, which the JAX package uses:
    var = E[x^2] - E[x]^2 clipped at 0, then (x - mean) * (rsqrt(var + eps)
    * weight) + bias in f32, and the result cast to `dtype`."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


class ImageNormalizer(nn.Module):
    """(x - mean) / std as the first layer, so attacks stay in [0, 1] pixels."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        super().__init__()
        self.register_buffer("mean", torch.tensor(mean).reshape(1, 1, 1, -1), persistent=False)
        self.register_buffer("std", torch.tensor(std).reshape(1, 1, 1, -1), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)


class NormalizedModel(nn.Module):
    """Sequential(normalize, model). The normalizer holds no state_dict
    entries, so checkpoints carry the inner model's keys (ckpt/convert.py
    loads into `.model`)."""

    def __init__(self, model: nn.Module, mean: Sequence[float], std: Sequence[float]):
        super().__init__()
        self.normalize = ImageNormalizer(mean, std)
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(self.normalize(x))


def blur_pool_2d(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 binomial blur, stride 1, SAME padding, on NHWC x."""
    c = x.shape[-1]
    filt = torch.tensor([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]],
                        dtype=x.dtype, device=x.device) / 16.0
    w = filt.expand(c, 1, 3, 3)
    return to_nhwc(F.conv2d(to_nchw(x), w, padding=1, groups=c))


class Conv(nn.Module):
    """k x k convolution on NHWC x, compute dtype configurable, with an
    optional BlurPool before a strided conv of >= 16 input channels.
    weight is [out, in, k, k], PyTorch's layout."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, dtype: torch.dtype = torch.float32,
                 use_blurpool: bool = False, init: str = "trunc_normal"):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dtype = dtype
        self.use_blurpool = use_blurpool
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        if init == "trunc_normal":
            trunc_normal_(self.weight)
        else:  # variance_scaling(1/3, fan_in, uniform): the ConvStem convs
            fan_in = cin * kernel_size * kernel_size
            bound = (1.0 / fan_in) ** 0.5
            nn.init.uniform_(self.weight, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_blurpool and self.stride > 1 and x.shape[-1] >= 16:
            x = blur_pool_2d(x)
        dt = self.dtype
        b = self.bias.to(dt) if self.bias is not None else None
        y = F.conv2d(to_nchw(x.to(dt)), self.weight.to(dt), b, self.stride, self.padding)
        return to_nhwc(y)
