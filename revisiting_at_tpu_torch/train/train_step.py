"""Port of revisiting_at_tpu/train/train_step.py. Only the attack-closure
view is here yet; the fused train step comes with ROADMAP A5.
"""

from __future__ import annotations

from torch import nn


def input_grad_view(m: nn.Module) -> nn.Module:
    """Set the fused block tail's backward to input-only (grad_mode='input')
    on the model, or on the model inside a NormalizedModel, and return it.

    Attacks differentiate w.r.t. the input only, so the tail's backward
    computes ds and no weight cotangents. Unlike the JAX version, which
    clones a module, this sets the mode in place. No-op for models without
    the knob. Never use it on a model whose weights are being trained."""
    for target in (m, getattr(m, "model", None)):
        if target is not None and hasattr(target, "grad_mode"):
            target.grad_mode = "input"
            break
    return m
