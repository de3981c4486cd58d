from .apgd import ApgdResult, apgd_attack, start_noise
from .fgsm import fgsm_train
from .pgd import pgd_attack, start_offset
from .wrapped import AdversarialModel

__all__ = ["AdversarialModel", "ApgdResult", "apgd_attack", "fgsm_train", "pgd_attack",
           "start_noise", "start_offset"]
