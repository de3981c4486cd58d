"""Shared model layers, port of revisiting_at_tpu/models/layers.py.

Activations are NHWC tensors ([B, H, W, C], contiguous), as in the JAX
package; a convolution runs on the NCHW view of that memory, which is
PyTorch's channels_last layout, so no copy is made around it. Parameters
are float32 and are cast to the compute dtype at use.

BatchNorm computes as flax's nn.BatchNorm, which the JAX package's ResNet,
DenseNet and Inception use, under torchvision's buffer names.
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


def lecun_normal_(t: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init, variance_scaling(1, fan_in, truncated_normal):
    a normal truncated at +-2 std, scaled to variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std)


class Conv(nn.Module):
    """k x k (or kh x kw) convolution on NHWC x, compute dtype configurable,
    with an optional BlurPool before a strided conv of >= 16 input channels.
    weight is [out, in, kh, kw], PyTorch's layout; padding an int or (ph, pw)."""

    def __init__(self, cin: int, cout: int, kernel_size: int | tuple[int, int],
                 stride: int = 1, padding: int | tuple[int, int] = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32, use_blurpool: bool = False,
                 init: str = "trunc_normal"):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dtype = dtype
        self.use_blurpool = use_blurpool
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        fan_in = cin * kh * kw
        if init == "trunc_normal":
            trunc_normal_(self.weight)
        elif init == "lecun_normal":  # flax nn.Conv's default: the BN family's convs
            lecun_normal_(self.weight, fan_in)
        else:  # variance_scaling(1/3, fan_in, uniform): the ConvStem convs
            bound = (1.0 / fan_in) ** 0.5
            nn.init.uniform_(self.weight, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_blurpool and self.stride > 1 and x.shape[-1] >= 16:
            x = blur_pool_2d(x)
        dt = self.dtype
        b = self.bias.to(dt) if self.bias is not None else None
        y = F.conv2d(to_nchw(x.to(dt)), self.weight.to(dt), b, self.stride, self.padding)
        return to_nhwc(y)


class BatchNorm(nn.Module):
    """BatchNorm over the channel (last) axis of NHWC x, as flax's
    nn.BatchNorm(momentum=0.9) computes it, under torchvision's names
    (weight, bias, running_mean, running_var, num_batches_tracked).

    In train mode the batch statistics are reduced in f32 over (B, H, W),
    the variance as E[x^2] - E[x]^2 clipped at 0, and x is normalised with
    that biased variance; the running statistics then move once,
    ra = 0.9 ra + 0.1 stat, with the same biased variance (torch's
    BatchNorm2d normalises with it too, but keeps the unbiased variance in
    running_var). In eval mode the running statistics are read and left
    alone. Either way y = (x - mean) * (rsqrt(var + eps) * weight) + bias
    in f32, cast to `dtype`. eps is 1e-5 (ResNet, DenseNet) or 1e-3
    (Inception)."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.9,
                 dtype: torch.dtype = torch.float32, zero_scale: bool = False):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.weight = nn.Parameter(torch.zeros(dim) if zero_scale else torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean((0, 1, 2))
            var = ((xf * xf).mean((0, 1, 2)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a reference checkpoint without the counter (older torch, or made
        # from a JAX tree) strict-loads with it at 0, as torch's BatchNorm does
        state_dict.setdefault(prefix + "num_batches_tracked", torch.tensor(0, dtype=torch.long))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def bn_stat_names(model: nn.Module) -> list[str]:
    """The running_mean and running_var buffer names of the model's
    BatchNorms: the statistics that the EMA follows and checkpoints carry."""
    return [f"{name}.{stat}" if name else stat for name, m in model.named_modules()
            if isinstance(m, BatchNorm) for stat in ("running_mean", "running_var")]
