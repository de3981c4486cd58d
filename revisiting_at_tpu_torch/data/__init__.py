from .mixup import MixupConfig, MixupDraws, draw_mixup, mixup_cutmix, one_hot_smooth
from .synthetic import SyntheticData

__all__ = ["MixupConfig", "MixupDraws", "SyntheticData", "draw_mixup", "mixup_cutmix",
           "one_hot_smooth"]
