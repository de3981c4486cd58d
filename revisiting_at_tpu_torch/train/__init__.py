from .ema import ema_init, ema_update
from .optimizer import ScheduledOptimizer, freeze_labels, make_optimizer, wd_mask
from .schedule import LRConfig, epoch_lr, get_resolution, make_lr_schedule
from .state import TrainState
from .train_step import (
    AdvConfig,
    attack_grad_mode,
    input_grad_view,
    make_eval_step,
    make_train_step,
    to_unit_pixels,
)

__all__ = [
    "AdvConfig",
    "LRConfig",
    "ScheduledOptimizer",
    "TrainState",
    "attack_grad_mode",
    "ema_init",
    "ema_update",
    "epoch_lr",
    "freeze_labels",
    "get_resolution",
    "input_grad_view",
    "make_eval_step",
    "make_lr_schedule",
    "make_optimizer",
    "make_train_step",
    "to_unit_pixels",
    "wd_mask",
]
