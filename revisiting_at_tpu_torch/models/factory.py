"""Model factory, port of revisiting_at_tpu/models/factory.py: the whole
zoo, ConvNeXt (T/S/B/L, iso, micro), the ViTs and the BN family (ResNet-50,
ResNet-50 with GELU, ResNet-101, WRN-50-2, DenseNet-201, Inception-v3).

Same names and semantics: `not_original` swaps in the paper's ConvStem
(ConvStem1(48) for convnext tiny/small, ConvStem3(64/96) for base/large,
ConvStem1(8) for convnext_micro, ConvStem(48, 8, fin 432 if `updated` else
384) for convnext_iso, whose width `updated` also sets (432 or 384);
ConvStem(48, 8) for vit_s/deit_s/vit_s_21k,
ConvStem2(48) for vit_m, ConvStem(48, 16, fin_dim=None) for vit_b,
ConvStem(4, 8) for vit_micro), `add_normalization` prepends the ImageNet
normalizer, and `wide_tail=None` means on for convnext_large only. A ViT
is built for one `img_size` (its pos_embed's grid); `attn_impl` picks the
fused attention's layout ('qkv' or 'bhnd'); `remat` recomputes each block
in the backward. Unlike JAX's factory, which drops `remat` for vit_micro
(revisiting_at_tpu/models/factory.py:154-163), every model here takes it
(ROADMAP C8): it changes memory, not numbers. The BN family takes only
num_classes and dtype, as in JAX: no ConvStem, drop path, blurpool, remat
or kernel.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch
from torch import nn

import torch.nn.functional as F

from .convnext import CONVNEXT_CFGS, ConvNeXt, ConvNeXtIsotropic
from .densenet import DenseNet
from .inception import InceptionV3
from .layers import NormalizedModel
from .resnet import RESNET_CFGS, ResNet, gelu_tanh
from .stems import ConvStem, ConvStem1, ConvStem2, ConvStem3
from .vit import VIT_CFGS, VisionTransformer

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# the BN family: 'densnet201' keeps the reference's spelling
BN_FAMILY = ("resnet50", "resnet50_gelu", "resnet101", "wrn_50_2", "densnet201", "inception")


def model_family(name: str) -> str:
    """The family of a zoo name, 'convnext', 'vit' or 'resnet' (the BN
    family, as JAX's factory names it): it sets the weight-decay rule and
    the checkpoint layout."""
    if name.startswith("convnext"):
        return "convnext"
    if name.startswith(("vit", "deit")):
        return "vit"
    if name in BN_FAMILY:
        return "resnet"
    raise ValueError(f"unknown model {name!r}")


@dataclasses.dataclass(frozen=True)
class ModelMeta:
    name: str
    family: str  # 'convnext' | 'vit' | 'resnet': drives the weight-decay rule
    has_batch_stats: bool = False  # BatchNorm running statistics (the BN family)
    patch_size: int = 16  # for pos-embed interpolation on ViTs


def get_model(name: str, *, not_original: bool = False, updated: bool = False,
              num_classes: int = 1000,
              dtype: torch.dtype = torch.bfloat16, drop_path_rate: float = 0.0,
              use_blurpool: bool = False, add_normalization: bool = False,
              use_pallas: bool = False, wide_tail: bool | None = None,
              attn_impl: str = "qkv", img_size: int = 224,
              remat: bool = False) -> tuple[nn.Module, ModelMeta]:
    """Build a model by reference name. Returns (module, meta); the module
    maps NHWC [0, 1] images to f32 logits."""
    if wide_tail is None:
        wide_tail = name == "convnext_large"
    common = dict(num_classes=num_classes, dtype=dtype, use_blurpool=use_blurpool,
                  drop_path_rate=drop_path_rate, use_pallas=use_pallas, wide_tail=wide_tail,
                  remat=remat)
    vit = dict(common, attn_impl=attn_impl, img_size=img_size)
    if name in ("convnext_tiny", "convnext_small", "convnext_base", "convnext_large",
                "convnext_tiny_21k"):
        size = name.replace("convnext_", "").replace("_21k", "")
        stem = None
        if not_original and name != "convnext_tiny_21k":
            stem = {"tiny": partial(ConvStem1, siz=48), "small": partial(ConvStem1, siz=48),
                    "base": partial(ConvStem3, siz=64), "large": partial(ConvStem3, siz=96)}[size]
        model = ConvNeXt(**CONVNEXT_CFGS[size], stem_factory=stem, **common)
    elif name == "convnext_iso":
        dim = 432 if updated else 384
        stem = partial(ConvStem, siz=48, end_siz=8, fin_dim=dim) if not_original else None
        model = ConvNeXtIsotropic(dim=dim, depth=18, stem_factory=stem, **common)
    elif name == "convnext_micro":
        # the JAX package's smoke-test model: convnext_tiny's topology at 1/6 width
        stem = partial(ConvStem1, siz=8) if not_original else None
        model = ConvNeXt(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), stem_factory=stem,
                         **common)
    elif name in ("vit_s", "deit_s", "vit_s_21k", "vit_m", "vit_b"):
        cfg = VIT_CFGS[{"vit_m": "m", "vit_b": "b"}.get(name, "s")]
        embed = None
        if not_original:
            embed = {"vit_m": partial(ConvStem2, siz=48),
                     "vit_b": partial(ConvStem, siz=48, end_siz=16, fin_dim=None)
                     }.get(name, partial(ConvStem, siz=48, end_siz=8))
        model = VisionTransformer(embed_factory=embed, **cfg, **vit)
    elif name == "vit_micro":
        # the JAX package's smoke-test ViT: embed 32, depth 2, 2 heads
        embed = partial(ConvStem, siz=4, end_siz=8) if not_original else None
        model = VisionTransformer(embed_dim=32, depth=2, num_heads=2, embed_factory=embed,
                                  **dict(vit, wide_tail=False))
    elif name in ("resnet50", "resnet50_gelu", "resnet101", "wrn_50_2"):
        act = gelu_tanh if name.endswith("gelu") else F.relu
        model = ResNet(**RESNET_CFGS["resnet50" if name.startswith("resnet50") else name],
                       act=act, num_classes=num_classes, dtype=dtype)
    elif name == "densnet201":
        model = DenseNet(num_classes=num_classes, dtype=dtype)
    elif name == "inception":
        model = InceptionV3(num_classes=num_classes, dtype=dtype)
    else:
        raise ValueError(f"unknown model {name!r}")
    if add_normalization and name != "convnext_tiny_21k":
        model = NormalizedModel(model, IMAGENET_MEAN, IMAGENET_STD)
    return model, ModelMeta(name, model_family(name), has_batch_stats=name in BN_FAMILY)
