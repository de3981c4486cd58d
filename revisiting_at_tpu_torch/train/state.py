"""TrainState, port of revisiting_at_tpu/train/state.py: the training state
as one plain dataclass. The model and the optimizer are updated in place."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .optimizer import ScheduledOptimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: ScheduledOptimizer
    ema: dict[str, torch.Tensor] | None = None  # f32 EMA of the parameters, by name
    step: int = 0
