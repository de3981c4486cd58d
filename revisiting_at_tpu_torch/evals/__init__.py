from .autoattack import (
    EPS_DICT,
    SHORT_ATTACKS,
    STANDARD_ATTACKS,
    AutoAttack,
    AutoAttackConfig,
    global_robust_accuracy,
    shard_for_process,
    torch_noise,
    torch_square_draws,
)
from .fab import fab_attack_single_target, fab_attack_targeted
from .square import (
    SquareDraws,
    TorchSquareDraws,
    square_attack,
    square_attack_l1,
    square_attack_l2,
)

__all__ = [
    "EPS_DICT",
    "SHORT_ATTACKS",
    "STANDARD_ATTACKS",
    "AutoAttack",
    "AutoAttackConfig",
    "SquareDraws",
    "TorchSquareDraws",
    "fab_attack_single_target",
    "fab_attack_targeted",
    "global_robust_accuracy",
    "shard_for_process",
    "square_attack",
    "square_attack_l1",
    "square_attack_l2",
    "torch_noise",
    "torch_square_draws",
]
