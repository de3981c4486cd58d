"""Model EMA, port of revisiting_at_tpu/train/ema.py (timm ModelEmaV2
semantics): f32 copies of the parameters, ema = ema * decay + p * (1 - decay)
after every update. A model with BatchNorms keeps the EMA of its running
statistics beside them, under their buffer names, with the same decay
(JAX's ema_batch_stats, train_step.py:257-261)."""

from __future__ import annotations

import torch
from torch import nn

from ..models.layers import bn_stat_names


def _tracked(model: nn.Module) -> list[tuple[str, torch.Tensor]]:
    """The parameters, then the BatchNorms' running statistics, by name."""
    stats = dict(model.named_buffers())
    return list(model.named_parameters()) + [(n, stats[n]) for n in bn_stat_names(model)]


def ema_init(model: nn.Module) -> dict[str, torch.Tensor]:
    """f32 copies of the model's parameters (and running statistics), by name."""
    return {name: t.detach().float().clone() for name, t in _tracked(model)}


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], model: nn.Module, decay: float = 0.9999) -> None:
    """Update `ema` in place (the JAX version returns a new tree)."""
    named = _tracked(model)
    tensors = [ema[name] for name, _ in named]
    new = [t.detach().float() for _, t in named]
    torch._foreach_mul_(tensors, decay)
    torch._foreach_add_(tensors, torch._foreach_mul(new, 1.0 - decay))
