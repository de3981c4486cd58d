from .convnext import CONVNEXT_CFGS, ConvNeXt, ConvNeXtBlock
from .factory import IMAGENET_MEAN, IMAGENET_STD, ModelMeta, get_model
from .layers import Conv, ImageNormalizer, LayerNorm, NormalizedModel, blur_pool_2d
from .pos_embed import interpolate_pos_encoding, resize_vit_pos_embed
from .stems import ConvStem, ConvStem1, ConvStem2, ConvStem3, PatchEmbed, PatchifyStem
from .vit import VIT_CFGS, ViTBlock, VisionTransformer

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
    "interpolate_pos_encoding",
    "resize_vit_pos_embed",
    "ConvStem",
    "ConvStem1",
    "ConvStem2",
    "ConvStem3",
    "PatchEmbed",
    "PatchifyStem",
    "VIT_CFGS",
    "ViTBlock",
    "VisionTransformer",
]
