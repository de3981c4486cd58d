"""DenseNet-201, port of revisiting_at_tpu/models/densenet.py (the
reference's 'densnet201').

torchvision's densenet under its names (features.conv0 / norm0,
features.denseblock<B>.denselayer<L>.norm1 / conv1 / norm2 / conv2,
features.transition<T>.norm / conv, features.norm5, classifier): a 7x7 s2
stem and a 3x3 s2 max pool; dense layers BN-ReLU-1x1 (4 x growth) then
BN-ReLU-3x3 (growth), each concatenated after its input, [x, y]; between
blocks a transition BN-ReLU-1x1 to half the channels and a 2x2 average
pool; BN-ReLU, the global mean in f32, the classifier in f32. NHWC, the
BatchNorms computing as flax's (eps 1e-5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, to_nchw, to_nhwc
from .resnet import conv, dense_head, max_pool_3x3_s2


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth: int, dtype: torch.dtype):
        super().__init__()
        self.norm1, self.conv1 = BatchNorm(cin, dtype=dtype), conv(cin, 4 * growth, 1, dtype)
        self.norm2 = BatchNorm(4 * growth, dtype=dtype)
        self.conv2 = conv(4 * growth, growth, 3, dtype, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=-1)


class DenseNet(nn.Module):
    layout = "densenet"  # its JAX param paths (ckpt/convert.py)

    def __init__(self, block_config=(6, 12, 48, 32), growth: int = 32,
                 num_init_features: int = 64, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.features = nn.Module()
        f = self.features
        f.conv0 = conv(3, num_init_features, 7, dtype, stride=2, padding=3)
        f.norm0 = BatchNorm(num_init_features, dtype=dtype)
        c = num_init_features
        self.n_blocks = len(block_config)
        for bi, n_layers in enumerate(block_config):
            block = nn.Module()
            for li in range(n_layers):
                setattr(block, f"denselayer{li + 1}", DenseLayer(c, growth, dtype))
                c += growth
            setattr(f, f"denseblock{bi + 1}", block)
            if bi != len(block_config) - 1:
                trans = nn.Module()
                trans.norm, trans.conv = BatchNorm(c, dtype=dtype), conv(c, c // 2, 1, dtype)
                setattr(f, f"transition{bi + 1}", trans)
                c //= 2
        f.norm5 = BatchNorm(c, dtype=dtype)
        self.classifier = dense_head(c, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] in [0, 1] (after any normalizer) -> f32 logits."""
        f = self.features
        x = max_pool_3x3_s2(F.relu(f.norm0(f.conv0(x))), padding=1)
        for bi in range(self.n_blocks):
            for layer in getattr(f, f"denseblock{bi + 1}").children():
                x = layer(x)
            if bi != self.n_blocks - 1:
                trans = getattr(f, f"transition{bi + 1}")
                x = trans.conv(F.relu(trans.norm(x)))
                x = to_nhwc(F.avg_pool2d(to_nchw(x), 2, 2))
        x = F.relu(f.norm5(x))
        return F.linear(x.float().mean(dim=(1, 2)), self.classifier.weight, self.classifier.bias)
