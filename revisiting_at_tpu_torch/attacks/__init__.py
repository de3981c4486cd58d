from .apgd import ApgdResult, apgd_attack, start_noise
from .fgsm import fgsm_train

__all__ = ["ApgdResult", "apgd_attack", "fgsm_train", "start_noise"]
