"""Model EMA, port of revisiting_at_tpu/train/ema.py (timm ModelEmaV2
semantics): f32 copies of the parameters, ema = ema * decay + p * (1 - decay)
after every update. A model with BatchNorms keeps the EMA of its running
statistics beside them, under their buffer names, with the same decay
(JAX's ema_batch_stats, train_step.py:257-261). Under FSDP the EMA of a
sharded parameter is a slice, as its optimizer state (`params`: the named
tensors the optimizer updates, parallel/zero.py ParallelModel.named_master)."""

from __future__ import annotations

import torch
from torch import nn

from ..models.layers import bn_stat_names


def _tracked(model: nn.Module, params=None) -> list[tuple[str, torch.Tensor]]:
    """The parameters (or `params`), then the BatchNorms' running statistics, by name."""
    stats = dict(model.named_buffers())
    params = list(model.named_parameters()) if params is None else list(params)
    return params + [(n, stats[n]) for n in bn_stat_names(model)]


def ema_init(model: nn.Module, params=None) -> dict[str, torch.Tensor]:
    """f32 copies of the model's parameters (and running statistics), by name."""
    return {name: t.detach().float().clone() for name, t in _tracked(model, params)}


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], model: nn.Module, decay: float = 0.9999,
               params=None) -> None:
    """Update `ema` in place (the JAX version returns a new tree)."""
    named = _tracked(model, params)
    tensors = [ema[name] for name, _ in named]
    new = [t.detach().float() for _, t in named]
    torch._foreach_mul_(tensors, decay)
    torch._foreach_add_(tensors, torch._foreach_mul(new, 1.0 - decay))
