from .augment import (AugmentDraws, RandAugmentConfig, augment_batch, draw_augment,
                      rand_augment_single)
from .folder import FolderConfig, list_image_folder, make_folder_dataset
from .mixup import MixupConfig, MixupDraws, draw_mixup, mixup_cutmix, one_hot_smooth
from .synthetic import SyntheticData

__all__ = ["AugmentDraws", "FolderConfig", "MixupConfig", "MixupDraws", "RandAugmentConfig",
           "SyntheticData", "augment_batch", "draw_augment", "draw_mixup", "list_image_folder",
           "make_folder_dataset", "mixup_cutmix", "one_hot_smooth", "rand_augment_single"]
