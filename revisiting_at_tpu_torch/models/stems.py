"""ConvNeXt stems, port of the ConvNeXt half of revisiting_at_tpu/models/stems.py.

  PatchifyStem  conv k4 s4 + LN (timm's default ConvNeXt stem): keys stem.0/1.
  ConvStem1     /4: conv3x3 s2 (siz) + conv3x3 s2 (2 siz), each LN + GELU;
                ConvNeXt-T/S with not_original (the paper's ConvStem).
  ConvStem3     /4: conv3x3 s2 (siz) + s2 (1.5 siz) + s1 (2 siz), each
                LN + GELU; ConvNeXt-B (siz 64) and -L (siz 96).

ConvStem1/3 hold a Sequential `stem` with a conv at 3k, its LN at 3k+1 and a
GELU at 3k+2, the reference's layout, so their keys are stem.stem.<i>.
The ViT stems (ConvStem, ConvStem2, PatchEmbed) wait for the ViT slice.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv, LayerNorm


class PatchifyStem(nn.Sequential):
    def __init__(self, features: int, patch_size: int = 4, dtype=torch.float32,
                 use_blurpool: bool = False, cin: int = 3):
        super().__init__(
            Conv(cin, features, patch_size, stride=patch_size, dtype=dtype,
                 use_blurpool=use_blurpool),
            LayerNorm(features, dtype=dtype),
        )


def _conv_ln_gelu(cin, cout, stride, dtype, use_blurpool):
    return [Conv(cin, cout, 3, stride=stride, padding=1, dtype=dtype,
                 use_blurpool=use_blurpool, init="variance_scaling"),
            LayerNorm(cout, dtype=dtype), nn.GELU()]  # erf, as flax's approximate=False


class ConvStem1(nn.Module):
    def __init__(self, siz: int = 48, dtype=torch.float32, use_blurpool: bool = False,
                 cin: int = 3):
        super().__init__()
        self.out_dim = 2 * siz
        self.stem = nn.Sequential(
            *_conv_ln_gelu(cin, siz, 2, dtype, use_blurpool),
            *_conv_ln_gelu(siz, 2 * siz, 2, dtype, use_blurpool),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stem(x)


class ConvStem3(nn.Module):
    def __init__(self, siz: int = 64, dtype=torch.float32, use_blurpool: bool = False,
                 cin: int = 3):
        super().__init__()
        self.out_dim = 2 * siz
        mid = int(siz * 1.5)
        self.stem = nn.Sequential(
            *_conv_ln_gelu(cin, siz, 2, dtype, use_blurpool),
            *_conv_ln_gelu(siz, mid, 2, dtype, use_blurpool),
            *_conv_ln_gelu(mid, 2 * siz, 1, dtype, use_blurpool),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stem(x)
