from .convnext import CONVNEXT_CFGS, ConvNeXt, ConvNeXtBlock
from .factory import IMAGENET_MEAN, IMAGENET_STD, ModelMeta, get_model
from .layers import Conv, ImageNormalizer, LayerNorm, NormalizedModel, blur_pool_2d
from .stems import ConvStem1, ConvStem3, PatchifyStem

__all__ = [
    "CONVNEXT_CFGS",
    "ConvNeXt",
    "ConvNeXtBlock",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "ModelMeta",
    "get_model",
    "Conv",
    "ImageNormalizer",
    "LayerNorm",
    "NormalizedModel",
    "blur_pool_2d",
    "ConvStem1",
    "ConvStem3",
    "PatchifyStem",
]
