"""ResNet family (ResNet-50/101, WideResNet-50-2), port of
revisiting_at_tpu/models/resnet.py.

torchvision's bottleneck network under torchvision's names (conv1, bn1,
layer<L>.<b>.conv1-3 / bn1-3 / downsample.0-1, fc), so the state_dict is
the reference checkpoint format: a 7x7 s2 stem and a 3x3 s2 max pool, four
stages of bottlenecks (1x1 -> 3x3 (stride) -> 1x1 to 4 x 64 x 2^s), each
BatchNorm then the activation, bn3 starting at zero scale, the global mean
in f32 and the head in f32. NHWC activations, f32 parameters cast to the
compute dtype at use; the BatchNorms compute as flax's (models/layers.py).

`resnet50_gelu` takes JAX's `nn.gelu`, whose default is the tanh
approximation, so `act` is F.gelu(approximate="tanh"); the reference's
torch GELU is erf (ROADMAP C20). No drop path, remat or kernel: the JAX
factory builds these models without them.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, lecun_normal_, to_nchw, to_nhwc


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default (approximate=True)."""
    return F.gelu(x, approximate="tanh")


def max_pool_3x3_s2(x: torch.Tensor, padding: int) -> torch.Tensor:
    """3x3 stride-2 max pool of NHWC x; the padding is -inf, as flax's."""
    return to_nhwc(F.max_pool2d(to_nchw(x), 3, 2, padding))


def dense_head(cin: int, cout: int) -> nn.Linear:
    """flax nn.Dense's init: lecun normal kernel, zero bias."""
    fc = nn.Linear(cin, cout)
    lecun_normal_(fc.weight, cin)
    nn.init.zeros_(fc.bias)
    return fc


def conv(cin, cout, k, dtype, stride=1, padding=0) -> Conv:
    """flax nn.Conv(use_bias=False) with its default init."""
    return Conv(cin, cout, k, stride=stride, padding=padding, bias=False, dtype=dtype,
                init="lecun_normal")


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, out: int, stride: int, act: Callable,
                 dtype: torch.dtype):
        super().__init__()
        self.act = act
        self.conv1, self.bn1 = conv(cin, width, 1, dtype), BatchNorm(width, dtype=dtype)
        self.conv2 = conv(width, width, 3, dtype, stride=stride, padding=1)
        self.bn2 = BatchNorm(width, dtype=dtype)
        self.conv3 = conv(width, out, 1, dtype)
        self.bn3 = BatchNorm(out, dtype=dtype, zero_scale=True)
        self.downsample = None
        if stride != 1 or cin != out:  # JAX's shortcut.shape != y.shape
            self.downsample = nn.Sequential(conv(cin, out, 1, dtype, stride=stride),
                                            BatchNorm(out, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.bn1(self.conv1(x)))
        y = self.act(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        shortcut = x if self.downsample is None else self.downsample(x)
        return self.act(shortcut + y)


class ResNet(nn.Module):
    """stage_sizes blocks per stage; width_factor 2 for wide_resnet50_2."""

    layout = "resnet"  # its JAX param paths (ckpt/convert.py)

    def __init__(self, stage_sizes=(3, 4, 6, 3), width_factor: int = 1,
                 num_classes: int = 1000, act: Callable = F.relu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.act = dtype, act
        self.conv1 = conv(3, 64, 7, dtype, stride=2, padding=3)
        self.bn1 = BatchNorm(64, dtype=dtype)
        cin = 64
        for si, n_blocks in enumerate(stage_sizes):
            width, out = 64 * 2 ** si * width_factor, 64 * 2 ** si * 4
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(cin, width, out, 2 if si > 0 and bi == 0 else 1, act,
                                         dtype))
                cin = out
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.fc = dense_head(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] in [0, 1] (after any normalizer) -> f32 logits."""
        x = max_pool_3x3_s2(self.act(self.bn1(self.conv1(x))), padding=1)
        for si in range(self.n_stages):
            x = getattr(self, f"layer{si + 1}")(x)
        return F.linear(x.float().mean(dim=(1, 2)), self.fc.weight, self.fc.bias)


RESNET_CFGS = {
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), width_factor=1),
    "resnet101": dict(stage_sizes=(3, 4, 23, 3), width_factor=1),
    "wrn_50_2": dict(stage_sizes=(3, 4, 6, 3), width_factor=2),
}
