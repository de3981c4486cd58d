"""Replicas of one model on this host's GPUs, each batch split over them
(`cli.eval --shard_eval 1`, JAX's batch-sharded eval over the local devices
with the params replicated, revisiting_at_tpu/cli/eval.py:229-236)."""

from __future__ import annotations

import copy

import torch
from torch import nn


class SplitBatch:
    """logits_fn(x): x split into len(devices) chunks, chunk i through the
    replica on devices[i], the logits gathered on devices[0]. Autograd
    crosses the copies, so an attack's input gradient is the whole
    batch's; every point meets the same weights and draws as on one
    device. The model (on devices[0]) is copied as it stands."""

    def __init__(self, model: nn.Module, devices: list[torch.device]):
        self.devices = devices
        self.replicas = [model] + [copy.deepcopy(model).to(d) for d in devices[1:]]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for chunk, replica, dev in zip(x.chunk(len(self.devices)), self.replicas, self.devices):
            with torch.cuda.device(dev):
                outs.append(replica(chunk.to(dev, non_blocking=True)))
        return torch.cat([o.to(self.devices[0]) for o in outs])
