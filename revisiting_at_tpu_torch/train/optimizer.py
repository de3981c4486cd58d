"""Optimizers with the reference's weight-decay grouping, port of
revisiting_at_tpu/train/optimizer.py.

  * AdamW(betas=(0.9, 0.95), eps=1e-8) with decoupled weight decay, or SGD
    with momentum and coupled (L2) decay, as torch's own optimizers do;
  * the weight-decay exclusion depends on the model family: for ConvNeXt
    only names that end in 'bias' are excluded (LayerNorm scales and
    LayerScale gamma do decay); for the BN family ('resnet') JAX's rule
    runs on each parameter's JAX path (ckpt/convert.py jax_param_path):
    excluded where a path component contains 'bn' (or ends in '_bn') and
    every bias. So ResNet's and Inception's BatchNorms are excluded, the
    downsample's too (JAX's downsample_bn, where a substring rule on
    torch's 'downsample.1.weight' would decay it; ROADMAP C21), and
    DenseNet's norm* scales decay; every other family excludes parameters
    with ndim <= 1;
  * the LR comes from a schedule of the optimizer's step count, read before
    the update and incremented after it, as optax reads `count`;
  * grad_accum = k > 1 is optax.MultiSteps(every_k_schedule=k): the
    gradients of k micro-steps are averaged (its Welford running mean,
    acc += (g - acc) / (i + 1)), and the update, with the LR of the
    optimizer's step count, is applied once every k micro-steps.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..ckpt.convert import jax_param_path
from ..models.layers import BatchNorm, NormalizedModel


def _resnet_rule(path: str) -> bool:
    """JAX's resnet_rule on a flax path (revisiting_at_tpu/train/optimizer.py:34-37)."""
    names = path.split("/")
    in_bn = any("bn" in n or n.endswith("_bn") or n == "BatchNorm" for n in names)
    return not (in_bn or names[-1].endswith("bias"))


def wd_mask(model: nn.Module, family: str) -> dict[str, bool]:
    """{parameter name: True where weight decay applies}."""
    if family == "resnet":
        core, prefix = (model.model, "model.") if isinstance(model, NormalizedModel) else (model,
                                                                                          "")
        out = {}
        for mod_name, mod in core.named_modules():
            for leaf, _ in mod.named_parameters(recurse=False):
                name = f"{mod_name}.{leaf}" if mod_name else leaf
                path = jax_param_path(name, core.layout, isinstance(mod, BatchNorm))
                out[prefix + name] = _resnet_rule(path)
        return out
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
    update; `count` is the number of updates made so far. With every_k > 1,
    `update` folds each micro-step's gradients into their running mean and
    applies it once every k micro-steps (`mini_step` counts those made
    towards the next update)."""

    def __init__(self, opt: torch.optim.Optimizer, schedule: Callable[[int], float],
                 every_k: int = 1, names: list[str] | None = None):
        self.opt, self.schedule, self.count = opt, schedule, 0
        self.every_k, self.mini_step = every_k, 0
        self.params = [p for group in opt.param_groups for p in group["params"]]
        self.names = names  # the parameters' names, in the order of `params`
        self.acc: list[torch.Tensor] | None = None  # the running mean, between updates

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> float:
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1
        return lr

    def update(self) -> bool:
        """After a micro-step's backward: step at once (every_k = 1), else
        fold the .grad of the optimizer's parameters into the running mean
        and step on it at the k-th micro-step. Returns whether it stepped."""
        if self.every_k == 1:
            self.step()
            return True
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.acc is None:
            self.acc = [g.clone() for g in grads]  # acc + (g - acc) / 1 with acc = 0
        else:
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return False
        for p, a in zip(self.params, self.acc):
            p.grad = a
        self.step()
        self.mini_step, self.acc = 0, None
        return True

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, sd: dict) -> None:
        self.opt.load_state_dict(sd["opt"])
        self.count, self.mini_step, self.acc = sd["count"], sd["mini_step"], sd["acc"]


def make_optimizer(model: nn.Module, *, optimizer: str = "adamw", weight_decay: float = 0.05,
                   momentum: float = 0.9, family: str = "convnext",
                   learning_rate: Callable[[int], float] | float,
                   freeze_some: bool = False, early: bool = True,
                   grad_accum: int = 1, params=None) -> ScheduledOptimizer:
    """Two parameter groups, with and without decay. Frozen parameters
    (freeze_some) are in neither: they keep their gradients but get no
    update, as optax's set_to_zero gives them. grad_accum: the micro-steps
    per update (optax.MultiSteps). params: the named tensors to update in
    place of the model's parameters (under FSDP, a sharded parameter's
    slice: parallel/zero.py ParallelModel.named_master); the rules read
    the model's names."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum {grad_accum} < 1")
    schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
    mask = wd_mask(model, family)
    labels = freeze_labels(model, early) if freeze_some else {}
    decay, no_decay = [], []
    for name, p in (model.named_parameters() if params is None else params):
        if labels.get(name, "train") == "train":
            (decay if mask[name] else no_decay).append((name, p))
    groups = [{"params": [p for _, p in decay], "weight_decay": weight_decay},
              {"params": [p for _, p in no_decay], "weight_decay": 0.0}]
    lr0 = schedule(0)
    if optimizer == "adamw":
        opt = torch.optim.AdamW(groups, lr=lr0, betas=(0.9, 0.95), eps=1e-8)
    elif optimizer == "sgd":
        opt = torch.optim.SGD(groups, lr=lr0, momentum=momentum)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return ScheduledOptimizer(opt, schedule, grad_accum, [n for n, _ in decay + no_decay])
