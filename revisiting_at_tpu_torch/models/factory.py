"""Model factory, port of the ConvNeXt half of revisiting_at_tpu/models/factory.py.

Same names and semantics: `not_original` swaps in the paper's ConvStem
(ConvStem1(48) for tiny/small, ConvStem3(64/96) for base/large, ConvStem1(8)
for convnext_micro), `add_normalization` prepends the ImageNet normalizer,
and `wide_tail=None` means on for convnext_large only.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch
from torch import nn

from .convnext import CONVNEXT_CFGS, ConvNeXt
from .layers import NormalizedModel
from .stems import ConvStem1, ConvStem3

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# Names of the JAX package's zoo that the port does not build yet, with the
# ROADMAP item that brings them.
_NOT_YET = {
    "convnext_iso": "A3 (ConvNeXtIsotropic)",
    "vit_s": "A9", "deit_s": "A9", "vit_s_21k": "A9", "vit_m": "A9", "vit_b": "A9",
    "vit_micro": "A9",
    "resnet50": "A12", "resnet50_gelu": "A12", "resnet101": "A12", "wrn_50_2": "A12",
    "densnet201": "A12", "inception": "A12",
}


@dataclasses.dataclass(frozen=True)
class ModelMeta:
    name: str
    family: str


def get_model(name: str, *, not_original: bool = False, num_classes: int = 1000,
              dtype: torch.dtype = torch.bfloat16, drop_path_rate: float = 0.0,
              use_blurpool: bool = False, add_normalization: bool = False,
              use_pallas: bool = False,
              wide_tail: bool | None = None) -> tuple[nn.Module, ModelMeta]:
    """Build a model by reference name. Returns (module, meta); the module
    maps NHWC [0, 1] images to f32 logits."""
    if wide_tail is None:
        wide_tail = name == "convnext_large"
    common = dict(num_classes=num_classes, dtype=dtype, use_blurpool=use_blurpool,
                  drop_path_rate=drop_path_rate, use_pallas=use_pallas, wide_tail=wide_tail)
    if name in ("convnext_tiny", "convnext_small", "convnext_base", "convnext_large",
                "convnext_tiny_21k"):
        size = name.replace("convnext_", "").replace("_21k", "")
        stem = None
        if not_original and name != "convnext_tiny_21k":
            stem = {"tiny": partial(ConvStem1, siz=48), "small": partial(ConvStem1, siz=48),
                    "base": partial(ConvStem3, siz=64), "large": partial(ConvStem3, siz=96)}[size]
        model = ConvNeXt(**CONVNEXT_CFGS[size], stem_factory=stem, **common)
    elif name == "convnext_micro":
        # the JAX package's smoke-test model: convnext_tiny's topology at 1/6 width
        stem = partial(ConvStem1, siz=8) if not_original else None
        model = ConvNeXt(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), stem_factory=stem,
                         **common)
    elif name in _NOT_YET:
        raise NotImplementedError(f"{name}: not ported yet, ROADMAP {_NOT_YET[name]}")
    else:
        raise ValueError(f"unknown model {name!r}")
    if add_normalization and name != "convnext_tiny_21k":
        model = NormalizedModel(model, IMAGENET_MEAN, IMAGENET_STD)
    return model, ModelMeta(name, "convnext")
