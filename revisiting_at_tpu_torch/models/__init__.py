from .convnext import CONVNEXT_CFGS, ConvNeXt, ConvNeXtBlock, ConvNeXtIsotropic
from .densenet import DenseNet
from .factory import BN_FAMILY, IMAGENET_MEAN, IMAGENET_STD, ModelMeta, get_model
from .inception import InceptionV3
from .layers import (BatchNorm, Conv, ImageNormalizer, LayerNorm, NormalizedModel,
                     blur_pool_2d)
from .pos_embed import interpolate_pos_encoding, resize_vit_pos_embed
from .resnet import RESNET_CFGS, ResNet
from .stems import ConvStem, ConvStem1, ConvStem2, ConvStem3, PatchEmbed, PatchifyStem
from .vit import VIT_CFGS, ViTBlock, VisionTransformer

__all__ = [
    "BN_FAMILY",
    "BatchNorm",
    "CONVNEXT_CFGS",
    "ConvNeXt",
    "ConvNeXtBlock",
    "ConvNeXtIsotropic",
    "DenseNet",
    "InceptionV3",
    "RESNET_CFGS",
    "ResNet",
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
