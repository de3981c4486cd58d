"""Single-step FGSM adversarial-training attack (RS-FGSM), port of
revisiting_at_tpu/attacks/fgsm.py.

Optional random start in +-eps * noise_level, one forward and one input
gradient, a step of alpha * eps * sign(g), then (unless skip_projection)
the projection onto the eps ball around x and the [0, 1] box. The train
step calls it with use_rs=True and the config's alpha.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.losses import make_criterion


def fgsm_train(logits_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
               y: torch.Tensor, *, eps: float, noise: torch.Tensor | None = None,
               generator: torch.Generator | None = None, loss: str = "ce",
               alpha: float = 1.25, use_rs: bool = False, noise_level: float = 1.0,
               skip_projection: bool = False) -> torch.Tensor:
    """The FGSM point for x (f32 NHWC) against int labels or soft targets y.

    With use_rs the start is x + (2t - 1) * eps * noise_level, clipped to
    [0, 1] unless skip_projection, where t is the raw U(0, 1) draw `noise`
    (e.g. injected by a test) or drawn from `generator`."""
    x = x.float()
    if use_rs:
        if noise is None:
            noise = torch.rand(x.shape, generator=generator, device=x.device)
        x_adv = x + (2.0 * noise.to(x.device, torch.float32) - 1.0) * eps * noise_level
        if not skip_projection:
            x_adv = x_adv.clamp(0.0, 1.0)
    else:
        x_adv = x

    criterion = make_criterion(loss)
    xa = x_adv.detach().requires_grad_(True)
    with torch.enable_grad():
        (grad,) = torch.autograd.grad(criterion(logits_fn(xa), y).sum(), xa)

    x_adv = x_adv + alpha * eps * torch.sign(grad)
    if not skip_projection:
        x_adv = (x + (x_adv - x).clamp(-eps, eps)).clamp(0.0, 1.0)
    return x_adv.detach()
