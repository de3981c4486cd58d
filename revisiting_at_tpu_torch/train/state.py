"""TrainState, port of revisiting_at_tpu/train/state.py: the training state
as one plain dataclass. The model and the optimizer are updated in place.
On a mesh of more than one rank, `parallel` holds the rank's gradient sync,
FSDP slices and full-checkpoint layout (parallel/zero.py); the optimizer
and the EMA then hold the tensors of its master layout."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..parallel.zero import ParallelModel
from .optimizer import ScheduledOptimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: ScheduledOptimizer
    # f32 EMA of the parameters by name, and of a BN model's running
    # statistics by buffer name (JAX's ema_params and ema_batch_stats); the
    # raw statistics are the model's buffers
    ema: dict[str, torch.Tensor] | None = None
    step: int = 0
    parallel: ParallelModel | None = None
