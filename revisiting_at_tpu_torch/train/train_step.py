"""The adversarial train step, port of revisiting_at_tpu/train/train_step.py
(its mesh=None step on one process, its shard_map step on a mesh).

One call of the step:
  uint8 -> [0, 1] -> RandAugment, erasing and flip (with data.augmentations)
  -> mixup/cutmix -> APGD or FGSM in eval mode with the block tail's
  input-only backward -> training forward in train mode -> loss -> weight
  backward (the tail's full backward) -> AdamW with the LR schedule (with
  training.grad_accum = k, on the mean gradient of k micro-steps, once
  every k steps) -> EMA update.

The JAX step is one pure jitted function; here the model, the optimizer and
the EMA tensors are updated in place, and the step returns its metrics.
Randomness per step: the augmentation draws and the mixup draws come from
CPU torch.Generators seeded from (seed, step), or from an injected
`augment_draws(step, b, h, w)` and `mixup_draws(step, h, w)`; the erasing
noise from a generator on the batch's device seeded the same way; FGSM's
random start from a generator on the batch's device seeded the same way,
or from an injected `attack_draws(step, shape)`; DropPath draws from the
model's `drop_generator`, seeded the same way per step.

On a mesh of more than one rank (`state.parallel`, parallel/zero.py) the
step is JAX's shard_map step (train_step.py:110-141, 231-321), with
use_pallas 0 and 1 alike: each rank augments, attacks and trains on its
batch shard; the mixup draws are shared by every rank (one lambda and box,
the partner within the shard), while the augmentation, erasing, DropPath
and FGSM streams are those of shard_seed(seed, batch shard) (JAX's fold_in
of axis_index), and an injected draw function is this rank's; the BatchNorm
statistics are averaged over the shards after the training forward, the
gradient after the backward (grad_norm is the averaged gradient's), and
loss, train_acc and adv_acc before they are returned. Under JAX's trainer
a use_pallas=0 mesh takes the auto-partitioned global-batch step instead
(BatchNorm statistics and the mixup partner over the whole batch); the
port keeps the shard-local one (ROADMAP C25).

Semantics kept from the reference:
  * the model is deterministic (eval mode) while the attack runs and
    stochastic (DropPath) for the training forward; a BN model's running
    statistics stay frozen through the attack and move once, in the
    training forward, and the EMA follows them (train/ema.py), as JAX's
    has_batch_stats step (train_step.py:208-217, 257-261);
  * training consumes the attack's best-loss point x_best, detached;
  * the loss is soft-target CE under mixup, else mean CE;
  * adv_acc is APGD's accuracy against the mixup targets' argmax, but
    FGSM's is one more eval forward at the FGSM point scored against the
    hard labels (ROADMAP C3: the two arms differ in JAX, and here);
    train_acc is the training logits' accuracy against the hard labels.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch import nn

from ..attacks import apgd_attack, fgsm_train
from ..data.augment import AugmentDraws, RandAugmentConfig, augment_batch, draw_augment
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
    """Canonical [0, 1] f32 pixels: uint8 is scaled by the f32 1/255 (the
    product XLA makes of JAX's /255, on either device), floats are taken as
    already in [0, 1]."""
    if images.dtype == torch.uint8:
        return images.float() * (1.0 / 255.0)
    return images.float()


@dataclasses.dataclass(frozen=True)
class AdvConfig:
    """The reference 'adv' config section."""

    attack: str = "none"  # 'none' | 'fgsm' | 'apgd'
    norm: str = "Linf"
    eps: float = 4.0 / 255.0
    n_iter: int = 2
    alpha: float = 1.25  # fgsm step multiplier
    noise_level: float = 1.0
    skip_projection: bool = False
    loss: str = "ce"


def step_seed(seed: int, step: int, stream: int) -> int:
    """Seed of one random stream (1: mixup, 2: DropPath, 3: FGSM's start,
    4: the augmentation draws, 5: the erasing noise) at one step."""
    return (seed * 1_000_003 + step * 8 + stream) % (2 ** 63 - 1)


def shard_seed(seed: int, rank: int) -> int:
    """The seed of batch shard `rank`'s own streams (DropPath, FGSM's start,
    the augmentation draws, the erasing noise), JAX's fold_in of axis_index:
    a single process seeded with it draws what rank `rank` draws. Rank 0
    keeps `seed`."""
    return (seed + rank * 0x9E3779B97F4A7C15) % (2 ** 63 - 1)


def make_train_step(
    model: nn.Module,
    *,
    adv: AdvConfig,
    mixup: MixupConfig | None,
    randaug: RandAugmentConfig | None = None,
    ema_decay: float = 0.0,
    seed: int = 0,
    augment_draws: Callable[[int, int, int, int], AugmentDraws] | None = None,
    mixup_draws: Callable[[int, int, int], MixupDraws] | None = None,
    attack_draws: Callable[[int, tuple[int, ...]], torch.Tensor] | None = None,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], dict[str, torch.Tensor]]:
    """Build the step: (state, images NHWC [0, 1] or uint8, int labels) ->
    metrics {loss, train_acc, adv_acc, grad_norm} as 0-d tensors. The state
    is updated in place and its step advanced by one.

    randaug: RandAugment with erasing and flip on the batch's device, before
    mixup, in JAX's order (train_step.py:146-151). augment_draws(step, b, h,
    w), when given, replaces the generator's augmentation draws (its noise,
    if set, the erasing fill); mixup_draws(step, h, w), the mixup draws;
    attack_draws(step, shape), FGSM's raw U(0, 1) start draw.

    Each call is one micro-step: `state.step` counts them and keys the
    draws; the optimizer applies its update every k-th (optimizer.py), and
    the EMA follows the parameters after every call, as JAX's MultiSteps
    step does (train_step.py:256-267). grad_norm is the micro-step's."""
    if adv.attack not in ("apgd", "fgsm", "none"):
        raise ValueError(f"unknown attack {adv.attack!r}")
    core = _grad_mode_owner(model) or model

    def step_fn(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        m, par = state.model, state.parallel
        own = shard_seed(seed, par.mesh.batch_rank) if par is not None else seed
        images = to_unit_pixels(images)
        labels = labels.long()
        targets = labels
        if randaug is not None:
            b, h, w, _ = images.shape
            if augment_draws is not None:
                draws = augment_draws(state.step, b, h, w)
            else:
                gen = torch.Generator().manual_seed(step_seed(own, state.step, 4))
                draws = draw_augment(gen, b, h, w, randaug)
            noise_gen = torch.Generator(device=images.device).manual_seed(
                step_seed(own, state.step, 5))
            with torch.profiler.record_function("augment"):  # a profiler span, free when off
                images = augment_batch(images, draws, randaug, generator=noise_gen)
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
        elif adv.attack == "fgsm":
            noise = attack_draws(state.step, tuple(images.shape)) if attack_draws else None
            gen = None
            if noise is None:
                gen = torch.Generator(device=images.device).manual_seed(
                    step_seed(own, state.step, 3))
            with attack_grad_mode(m):
                x_use = fgsm_train(m, images, targets, eps=adv.eps, noise=noise, generator=gen,
                                   loss=adv.loss, alpha=adv.alpha, use_rs=True,
                                   noise_level=adv.noise_level,
                                   skip_projection=adv.skip_projection)
                with torch.no_grad():  # one more eval forward, on the hard labels (C3)
                    adv_acc = (m(x_use).argmax(-1) == labels).float().mean()

        m.train()
        if hasattr(core, "drop_generator"):
            core.drop_generator = torch.Generator(device=images.device).manual_seed(
                step_seed(own, state.step, 2))
        logits = m(x_use)
        if par is not None:
            par.average_stats()  # before the EMA takes them
        if mixup is not None:
            loss = soft_target_ce(logits, targets)
        else:
            loss = ce_indiv(logits, targets).mean()
        state.optimizer.zero_grad()
        loss.backward()
        if par is not None:
            grad_norm = par.sync_grads()
        else:
            grads = [p.grad for p in m.parameters() if p.grad is not None]
            grad_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads))) if grads else torch.zeros(())
        if state.optimizer.update() and par is not None:
            par.after_update()
        if ema_decay > 0.0 and state.ema is not None:
            ema_update(state.ema, m, ema_decay,
                       params=par.named_master() if par is not None else None)
        train_acc = (logits.detach().argmax(-1) == labels).float().mean()
        loss = loss.detach()
        if par is not None:
            loss, train_acc, adv_acc = par.mean([loss, train_acc, adv_acc])
        state.step += 1
        return {"loss": loss, "train_acc": train_acc, "adv_acc": adv_acc,
                "grad_norm": grad_norm}

    return step_fn


def make_adv_eval_step(model: nn.Module, *, adv: AdvConfig):
    """In-training adversarial validation, port of make_adv_eval_step
    (revisiting_at_tpu/train/train_step.py:344-368): (images, labels) -> the
    count of points still classified right after APGD-CE against the
    training threat model, as a 0-d tensor. The attack starts at x (JAX's
    default random_start=False), so the count has no randomness; it runs in
    eval mode with the tail's input-only backward and frozen weights
    (attack_grad_mode), and the robust logits are one more eval forward at
    the last point that flipped the prediction."""

    def fn(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        x = to_unit_pixels(images)
        labels = labels.long()
        with attack_grad_mode(model):
            res = apgd_attack(model, x, labels, norm=adv.norm, eps=adv.eps, n_iter=adv.n_iter,
                              loss="ce", is_train=False)
            with torch.no_grad():
                return (model(res.x_best_adv).argmax(-1) == labels).sum()

    return fn


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
