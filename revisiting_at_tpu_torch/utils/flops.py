"""FLOP accounting, port of revisiting_at_tpu/utils/flops.py.

The JAX package reads XLA's cost analysis of the compiled forward, which
counts every operation, elementwise ones included. Here
torch.utils.flop_counter.FlopCounterMode counts the matrix products and
convolutions only, two FLOPs per multiply-add (the fvcore convention of the
reference's table, main.py:846-854): GELU, LayerNorm, softmax and the
residual adds count nothing. So the two packages' numbers differ for the
same model, the port's being the lower.

FlopCounterMode sees aten operations: a hand kernel's autograd.Function is
opaque to it. Count on the model's plain path (use_pallas=0), which is what
the trainer does, on a twin built on the meta device.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

CONVENTION = "matmuls and convolutions, 2 per multiply-add (torch.utils.flop_counter)"


def forward_flops(model: nn.Module, input_shape=(1, 224, 224, 3)) -> float:
    """FLOPs of one eval-mode forward of `model` on zeros of `input_shape`
    (NHWC), made on the model's device (the meta device computes nothing)."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(torch.zeros(input_shape, device=device))
    finally:
        model.train(was_training)
    return float(counter.get_total_flops())


def sizeof_fmt(num: float, suffix: str = "Flops") -> str:
    for unit in ["", "Ki", "Mi", "G", "T"]:
        if abs(num) < 1000.0:
            return f"{num:3.3f}{unit}{suffix}"
        num /= 1000.0
    return f"{num:.1f}P{suffix}"


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
