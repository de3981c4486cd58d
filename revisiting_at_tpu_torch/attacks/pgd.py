"""Plain PGD (no momentum, no adaptive step), port of
revisiting_at_tpu/attacks/pgd.py: a baseline attack and a test oracle.

n_iter steps of step_size (default 2 eps / n_iter): a sign step for Linf,
a step along the L2-normalised gradient for L2, each projected back onto
the eps ball around x and the [0, 1] box. The random start is x plus a
uniform offset in [-eps, eps] (Linf) or eps times a normalised Gaussian
(L2), clipped to [0, 1].

Given an nn.Module, the attack runs it in attack mode
(train.train_step.attack_grad_mode: eval mode, the block tail's
input-only backward, weights frozen), restored afterwards; any other
callable is differentiated as it is.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch import nn

from ..ops.losses import make_criterion
from ..ops.norms import l2_norm, l2_project, linf_project


def start_offset(shape, norm: str, eps: float, *, generator: torch.Generator | None = None,
                 device=None) -> torch.Tensor:
    """The random start's draw as JAX makes it: for Linf the offset itself,
    U(-eps, eps) as u * 2 eps - eps; for L2 the N(0, 1) draw that is
    scaled onto the sphere of radius eps."""
    if norm == "Linf":
        return torch.rand(shape, generator=generator, device=device) * (2.0 * eps) - eps
    return torch.randn(shape, generator=generator, device=device)


def pgd_attack(logits_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
               y: torch.Tensor, *, norm: str = "Linf", eps: float = 4.0 / 255.0,
               n_iter: int = 10, step_size: float | None = None, loss: str = "ce",
               random_start: bool = True, noise: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """The PGD point for x (f32 NHWC) against int labels or soft targets y.
    noise: the random start's draw (start_offset's form, e.g. injected by a
    test); without it the draw comes from `generator`."""
    if norm not in ("Linf", "L2"):
        raise ValueError(f"pgd_attack: norm {norm!r} is not Linf or L2")
    x = x.float()
    criterion = make_criterion(loss)
    step = 2.0 * eps / n_iter if step_size is None else step_size
    x_adv = x
    if random_start:
        t = noise if noise is not None else start_offset(x.shape, norm, eps,
                                                         generator=generator, device=x.device)
        t = t.to(x.device, torch.float32)
        x_adv = x + (t if norm == "Linf" else eps * t / (l2_norm(t, keepdims=True) + 1e-12))
    x_adv = x_adv.clamp(0.0, 1.0)

    scope = contextlib.nullcontext()
    if isinstance(logits_fn, nn.Module):
        from ..train.train_step import attack_grad_mode  # it imports this package

        scope = attack_grad_mode(logits_fn)
    with scope, torch.enable_grad():
        for _ in range(n_iter):
            xa = x_adv.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(criterion(logits_fn(xa), y).sum(), xa)
            if norm == "Linf":
                x_adv = linf_project(x_adv + step * torch.sign(g), x, eps)
            else:
                x_adv = l2_project(x_adv + step * g / (l2_norm(g, keepdims=True) + 1e-12), x,
                                   eps)
    return x_adv.detach()
