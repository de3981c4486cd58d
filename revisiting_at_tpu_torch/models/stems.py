"""Model stems, port of revisiting_at_tpu/models/stems.py.

  PatchifyStem  conv k4 s4 + LN (timm's default ConvNeXt stem): keys stem.0/1.
  ConvStem1     /4: conv3x3 s2 (siz) + conv3x3 s2 (2 siz), each LN + GELU;
                ConvNeXt-T/S with not_original (the paper's ConvStem).
  ConvStem3     /4: conv3x3 s2 (siz) + s2 (1.5 siz) + s1 (2 siz), each
                LN + GELU; ConvNeXt-B (siz 64) and -L (siz 96).
  PatchEmbed    conv k16 s16 (timm's ViT PatchEmbed.proj).
  ConvStem      /16: four conv3x3 s2 (siz, 2, 4, 8 siz), each LN + GELU, then
                a 1x1 conv to fin = 432 if fin_dim == 432 else siz * end_siz;
                vit_s/deit_s ConvStem(48, 8), vit_b ConvStem(48, 16, None).
  ConvStem2     the same trunk with a fixed 1x1 to 512 (vit_m).

The ConvStems hold a Sequential `stem` with a conv at 3k, its LN at 3k+1 and
a GELU at 3k+2, the reference's layout, and the ViT stems their 1x1 proj
at 12: keys stem.stem.<i> in a ConvNeXt, patch_embed.proj.stem.<i> in a ViT.
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


class PatchEmbed(nn.Module):
    """ViT patch embedding: conv k16 s16 (keys patch_embed.proj.*)."""

    def __init__(self, features: int, patch_size: int = 16, dtype=torch.float32,
                 use_blurpool: bool = False, cin: int = 3):
        super().__init__()
        self.proj = Conv(cin, features, patch_size, stride=patch_size, dtype=dtype,
                         use_blurpool=use_blurpool)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


def _vit_stem(siz, fin, dtype, use_blurpool, cin):
    chans = [cin, siz, 2 * siz, 4 * siz, 8 * siz]
    layers = []
    for i in range(4):
        layers += _conv_ln_gelu(chans[i], chans[i + 1], 2, dtype, use_blurpool)
    layers.append(Conv(8 * siz, fin, 1, dtype=dtype))  # the 1x1 proj, no blurpool
    return nn.Sequential(*layers)


class ConvStem(nn.Module):
    def __init__(self, siz: int = 48, end_siz: int = 8, fin_dim: int | None = 384,
                 dtype=torch.float32, use_blurpool: bool = False, cin: int = 3):
        super().__init__()
        self.out_dim = 432 if fin_dim == 432 else siz * end_siz
        self.stem = _vit_stem(siz, self.out_dim, dtype, use_blurpool, cin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stem(x)


class ConvStem2(nn.Module):
    def __init__(self, siz: int = 48, dtype=torch.float32, use_blurpool: bool = False,
                 cin: int = 3):
        super().__init__()
        self.out_dim = 512
        self.stem = _vit_stem(siz, 512, dtype, use_blurpool, cin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stem(x)
