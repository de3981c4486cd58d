"""Inception-v3, port of revisiting_at_tpu/models/inception.py (the
reference's 'inception'): torchvision's inception_v3 without the aux
head, under torchvision's names (Conv2d_1a_3x3.conv / .bn, ...,
Mixed_5b.branch1x1.conv / .bn, ..., fc), so the state_dict is the
reference checkpoint format.

Each BasicConv2d is a bias-free conv, a BatchNorm with eps 1e-3 computing
as flax's (models/layers.py) and a ReLU. The 1x7 and 7x1 convs pad (0, 3)
and (3, 0), the 1x3 and 3x1 (0, 1) and (1, 0); the 3x3 s2 max pools are
VALID; the pool branches average 3x3 windows at stride 1 over a padding
of 1, counting the padding (flax's count_include_pad). NHWC activations;
the branches concatenate along C in the reference's order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, to_nchw, to_nhwc
from .resnet import conv, dense_head, max_pool_3x3_s2


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, k, dtype: torch.dtype, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = conv(cin, cout, k, dtype, stride=stride, padding=padding)
        self.bn = BatchNorm(cout, eps=1e-3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    # pooled on a contiguous NCHW copy: on the card, the backward of this
    # padded pool over a channels_last tensor returns wrong input gradients
    # (torch 2.11 on an H100: more than 100% of max |grad| off the CPU's,
    # which matches JAX; chip_smoke.py phase 19 (c))
    return to_nhwc(F.avg_pool2d(to_nchw(x).contiguous(), 3, 1, 1, count_include_pad=True))


def _cat(*xs: torch.Tensor) -> torch.Tensor:
    return torch.cat(xs, dim=-1)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, dtype):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1, dtype)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1, dtype)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, dtype, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, dtype)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, dtype, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, dtype, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1, dtype)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return _cat(self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_3x3(x)))


class InceptionB(nn.Module):
    def __init__(self, cin: int, dtype):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, dtype, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, dtype)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, dtype, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, dtype, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return _cat(self.branch3x3(x), bd, max_pool_3x3_s2(x, padding=0))


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, dtype):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1, dtype)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1, dtype)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), dtype, padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), dtype, padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1, dtype)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), dtype, padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), dtype, padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), dtype, padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), dtype, padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1, dtype)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return _cat(self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_3x3(x)))


class InceptionD(nn.Module):
    def __init__(self, cin: int, dtype):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1, dtype)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, dtype, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1, dtype)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), dtype, padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), dtype, padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, dtype, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return _cat(b3, b7, max_pool_3x3_s2(x, padding=0))


class InceptionE(nn.Module):
    def __init__(self, cin: int, dtype):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1, dtype)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1, dtype)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), dtype, padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), dtype, padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1, dtype)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, dtype, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), dtype, padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), dtype, padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1, dtype)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = _cat(self.branch3x3_2a(b3), self.branch3x3_2b(b3))
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = _cat(self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd))
        return _cat(self.branch1x1(x), b3, bd, self.branch_pool(_avg_pool_3x3(x)))


class InceptionV3(nn.Module):
    layout = "inception"  # its JAX param paths (ckpt/convert.py)

    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, dtype, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, dtype)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, dtype, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, dtype)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, dtype)
        self.Mixed_5b = InceptionA(192, 32, dtype)
        self.Mixed_5c = InceptionA(256, 64, dtype)
        self.Mixed_5d = InceptionA(288, 64, dtype)
        self.Mixed_6a = InceptionB(288, dtype)
        self.Mixed_6b = InceptionC(768, 128, dtype)
        self.Mixed_6c = InceptionC(768, 160, dtype)
        self.Mixed_6d = InceptionC(768, 160, dtype)
        self.Mixed_6e = InceptionC(768, 192, dtype)
        self.Mixed_7a = InceptionD(768, dtype)
        self.Mixed_7b = InceptionE(1280, dtype)
        self.Mixed_7c = InceptionE(2048, dtype)
        self.fc = dense_head(2048, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] in [0, 1] (after any normalizer), at least
        75 px -> f32 logits."""
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool_3x3_s2(x, padding=0)
        x = max_pool_3x3_s2(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), padding=0)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return F.linear(x.float().mean(dim=(1, 2)), self.fc.weight, self.fc.bias)
