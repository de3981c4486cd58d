"""Model EMA, port of revisiting_at_tpu/train/ema.py (timm ModelEmaV2
semantics): f32 copies of the parameters, ema = ema * decay + p * (1 - decay)
after every update."""

from __future__ import annotations

import torch
from torch import nn


def ema_init(model: nn.Module) -> dict[str, torch.Tensor]:
    """f32 copies of the model's parameters, by name."""
    return {name: p.detach().float().clone() for name, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], model: nn.Module, decay: float = 0.9999) -> None:
    """Update `ema` in place (the JAX version returns a new tree)."""
    names = [name for name, _ in model.named_parameters()]
    tensors = [ema[name] for name in names]
    params = [p.detach().float() for _, p in model.named_parameters()]
    torch._foreach_mul_(tensors, decay)
    torch._foreach_add_(tensors, torch._foreach_mul(params, 1.0 - decay))
