"""The adversarial train step, port of revisiting_at_tpu/train/train_step.py
(its mesh=None path).

One call of the step:
  mixup/cutmix -> APGD in eval mode with the block tail's input-only
  backward -> training forward in train mode -> loss -> weight backward
  (the tail's full backward) -> AdamW with the LR schedule -> EMA update.

The JAX step is one pure jitted function; here the model, the optimizer and
the EMA tensors are updated in place, and the step returns its metrics.
Randomness per step: the mixup draws come from a CPU torch.Generator seeded
from (seed, step), or from an injected `mixup_draws(step, h, w)`; DropPath
draws from the model's `drop_generator`, seeded the same way per step.

Semantics kept from the reference:
  * the model is deterministic (eval mode) while the attack runs and
    stochastic (DropPath) for the training forward;
  * training consumes the attack's best-loss point x_best, detached;
  * the loss is soft-target CE under mixup, else mean CE;
  * adv_acc is APGD's accuracy against the mixup targets' argmax, and
    train_acc the training logits' accuracy against the hard labels.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch import nn

from ..attacks import apgd_attack
from ..data.mixup import MixupConfig, MixupDraws, draw_mixup, mixup_cutmix
from ..ops.losses import ce_indiv, soft_target_ce
from .ema import ema_update
from .state import TrainState


def _grad_mode_owner(m: nn.Module) -> nn.Module | None:
    """The module that holds `grad_mode`: the model, or the model inside a
    NormalizedModel; None for models without the knob."""
    for target in (m, getattr(m, "model", None)):
        if target is not None and hasattr(target, "grad_mode"):
            return target
    return None


def input_grad_view(m: nn.Module) -> nn.Module:
    """Set the fused block tail's backward to input-only (grad_mode='input')
    on the model, or on the model inside a NormalizedModel, and return it.

    Attacks differentiate w.r.t. the input only, so the tail's backward
    computes ds and no weight cotangents. Unlike the JAX version, which
    clones a module, this sets the mode in place. No-op for models without
    the knob. Never use it on a model whose weights are being trained: the
    train step uses the scoped `attack_grad_mode` instead."""
    owner = _grad_mode_owner(m)
    if owner is not None:
        owner.grad_mode = "input"
    return m


@contextlib.contextmanager
def attack_grad_mode(m: nn.Module):
    """Within the block: eval mode, the tail's input-only backward, and every
    parameter's requires_grad off, so that the attack neither accumulates
    into .grad nor keeps tensors for weight cotangents. All three are
    restored on exit, also on an exception."""
    owner = _grad_mode_owner(m)
    old_mode = owner.grad_mode if owner is not None else None
    was_training = m.training
    params = list(m.parameters())
    flags = [p.requires_grad for p in params]
    try:
        if owner is not None:
            owner.grad_mode = "input"
        m.eval()
        for p in params:
            p.requires_grad_(False)
        yield m
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)
        m.train(was_training)
        if owner is not None:
            owner.grad_mode = old_mode


def to_unit_pixels(images: torch.Tensor) -> torch.Tensor:
    """Canonical [0, 1] f32 pixels: uint8 is scaled by 1/255, floats are
    taken as already in [0, 1]."""
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images.float()


@dataclasses.dataclass(frozen=True)
class AdvConfig:
    """The reference 'adv' config section, less the FGSM knobs (alpha,
    noise_level, skip_projection) that come with FGSM training (A4)."""

    attack: str = "none"  # 'none' | 'apgd' ('fgsm' raises)
    norm: str = "Linf"
    eps: float = 4.0 / 255.0
    n_iter: int = 2
    loss: str = "ce"


def step_seed(seed: int, step: int, stream: int) -> int:
    """Seed of one random stream (1: mixup, 2: DropPath) at one step."""
    return (seed * 1_000_003 + step * 8 + stream) % (2 ** 63 - 1)


def make_train_step(
    model: nn.Module,
    *,
    adv: AdvConfig,
    mixup: MixupConfig | None,
    ema_decay: float = 0.0,
    seed: int = 0,
    mixup_draws: Callable[[int, int, int], MixupDraws] | None = None,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], dict[str, torch.Tensor]]:
    """Build the step: (state, images NHWC [0, 1] or uint8, int labels) ->
    metrics {loss, train_acc, adv_acc, grad_norm} as 0-d tensors. The state
    is updated in place and its step advanced by one.

    mixup_draws(step, h, w), when given, replaces the generator's draws."""
    if adv.attack == "fgsm":
        raise NotImplementedError("adv.attack='fgsm': FGSM training is ROADMAP A4")
    if adv.attack not in ("apgd", "none"):
        raise ValueError(f"unknown attack {adv.attack!r}")
    core = _grad_mode_owner(model) or model

    def step_fn(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        m = state.model
        images = to_unit_pixels(images)
        labels = labels.long()
        targets = labels
        if mixup is not None:
            _, h, w, _ = images.shape
            if mixup_draws is not None:
                draws = mixup_draws(state.step, h, w)
            else:
                gen = torch.Generator().manual_seed(step_seed(seed, state.step, 1))
                draws = draw_mixup(gen, h, w, mixup)
            images, targets = mixup_cutmix(images, labels, mixup, draws)

        adv_acc = torch.ones((), device=images.device)
        x_use = images
        if adv.attack == "apgd":
            with attack_grad_mode(m):
                res = apgd_attack(m, images, targets, norm=adv.norm, eps=adv.eps,
                                  n_iter=adv.n_iter, loss=adv.loss, is_train=True)
            x_use = res.x_best.detach()
            adv_acc = res.acc.float().mean()

        m.train()
        if hasattr(core, "drop_generator"):
            core.drop_generator = torch.Generator(device=images.device).manual_seed(
                step_seed(seed, state.step, 2))
        logits = m(x_use)
        if mixup is not None:
            loss = soft_target_ce(logits, targets)
        else:
            loss = ce_indiv(logits, targets).mean()
        state.optimizer.zero_grad()
        loss.backward()
        grads = [p.grad for p in m.parameters() if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads))) if grads else torch.zeros(())
        state.optimizer.step()
        if ema_decay > 0.0 and state.ema is not None:
            ema_update(state.ema, m, ema_decay)
        train_acc = (logits.detach().argmax(-1) == labels).float().mean()
        state.step += 1
        return {"loss": loss.detach(), "train_acc": train_acc, "adv_acc": adv_acc,
                "grad_norm": grad_norm}

    return step_fn


def make_eval_step(model: nn.Module, *, lr_tta: bool = False):
    """Clean-accuracy eval step: (images, labels) -> (top1 count, top5 count)
    as 0-d tensors; lr_tta adds the logits of the horizontally flipped batch."""

    @torch.no_grad()
    def eval_fn(images: torch.Tensor, labels: torch.Tensor):
        was_training = model.training
        model.eval()
        x = to_unit_pixels(images)
        logits = model(x)
        if lr_tta:
            logits = logits + model(x.flip(2))
        model.train(was_training)
        labels = labels.long()
        top1 = (logits.argmax(-1) == labels).sum()
        k = min(5, logits.shape[-1])
        top5 = (logits.topk(k, -1).indices == labels[:, None]).any(-1).sum()
        return top1, top5

    return eval_fn
