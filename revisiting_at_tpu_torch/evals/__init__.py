from .autoattack import (
    EPS_DICT,
    SHORT_ATTACKS,
    STANDARD_ATTACKS,
    AutoAttack,
    AutoAttackConfig,
    torch_noise,
)

__all__ = [
    "EPS_DICT",
    "SHORT_ATTACKS",
    "STANDARD_ATTACKS",
    "AutoAttack",
    "AutoAttackConfig",
    "torch_noise",
]
