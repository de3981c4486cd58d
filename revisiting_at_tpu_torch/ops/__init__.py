from .dwconv import dwconv7x7, dwconv7x7_v2
from .losses import (
    ce_indiv,
    dlr_loss,
    dlr_loss_targeted,
    is_correct,
    make_criterion,
    predicted_class,
    smoothed_ce,
    soft_ce_mean,
    soft_target_ce,
)
from .norms import (
    check_imgs,
    l0_norm,
    l1_norm,
    l1_projection,
    l2_norm,
    l2_project,
    linf_project,
)

__all__ = [
    "dwconv7x7",
    "dwconv7x7_v2",
    "ce_indiv",
    "dlr_loss",
    "dlr_loss_targeted",
    "is_correct",
    "make_criterion",
    "predicted_class",
    "smoothed_ce",
    "soft_ce_mean",
    "soft_target_ce",
    "check_imgs",
    "l0_norm",
    "l1_norm",
    "l1_projection",
    "l2_norm",
    "l2_project",
    "linf_project",
]
