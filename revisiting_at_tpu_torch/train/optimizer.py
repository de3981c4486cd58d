"""Optimizers with the reference's weight-decay grouping, port of
revisiting_at_tpu/train/optimizer.py.

  * AdamW(betas=(0.9, 0.95), eps=1e-8) with decoupled weight decay, or SGD
    with momentum and coupled (L2) decay, as torch's own optimizers do;
  * the weight-decay exclusion depends on the model family, here over timm
    parameter names: for ConvNeXt only names that end in 'bias' are
    excluded (LayerNorm scales and LayerScale gamma do decay); every other
    family excludes parameters with ndim <= 1;
  * the LR comes from a schedule of the optimizer's step count, read before
    the update and incremented after it, as optax reads `count`.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def wd_mask(model: nn.Module, family: str) -> dict[str, bool]:
    """{parameter name: True where weight decay applies}."""
    if family == "resnet":
        raise NotImplementedError("resnet family: ROADMAP A12")
    out = {}
    for name, p in model.named_parameters():
        out[name] = (not name.endswith("bias")) if family == "convnext" else p.ndim > 1
    return out


def freeze_labels(model: nn.Module, early: bool) -> dict[str, str]:
    """'train' / 'freeze' per parameter: early=True trains only the stem,
    early=False everything but the stem."""
    out = {}
    for name, _ in model.named_parameters():
        in_stem = any("stem" in part.lower() for part in name.split("."))
        out[name] = "train" if (in_stem if early else not in_stem) else "freeze"
    return out


class ScheduledOptimizer:
    """A torch optimizer whose LR is set from `schedule(count)` before each
    update; `count` is the number of updates made so far."""

    def __init__(self, opt: torch.optim.Optimizer, schedule: Callable[[int], float]):
        self.opt, self.schedule, self.count = opt, schedule, 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> float:
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1
        return lr


def make_optimizer(model: nn.Module, *, optimizer: str = "adamw", weight_decay: float = 0.05,
                   momentum: float = 0.9, family: str = "convnext",
                   learning_rate: Callable[[int], float] | float,
                   freeze_some: bool = False, early: bool = True,
                   grad_accum: int = 1) -> ScheduledOptimizer:
    """Two parameter groups, with and without decay. Frozen parameters
    (freeze_some) are in neither: they keep their gradients but get no
    update, as optax's set_to_zero gives them."""
    if grad_accum > 1:
        raise NotImplementedError("training.grad_accum > 1: ROADMAP A7")
    schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
    mask = wd_mask(model, family)
    labels = freeze_labels(model, early) if freeze_some else {}
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if labels.get(name, "train") == "train":
            (decay if mask[name] else no_decay).append(p)
    groups = [{"params": decay, "weight_decay": weight_decay},
              {"params": no_decay, "weight_decay": 0.0}]
    lr0 = schedule(0)
    if optimizer == "adamw":
        opt = torch.optim.AdamW(groups, lr=lr0, betas=(0.9, 0.95), eps=1e-8)
    elif optimizer == "sgd":
        opt = torch.optim.SGD(groups, lr=lr0, momentum=momentum)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return ScheduledOptimizer(opt, schedule)
