"""Port parity of the APGD training step on the dwconv route: 3 steps of
convnext_micro + ConvStem1(8) with use_pallas=1 and use_pallas_dwconv=1
(mixup, 2-step APGD, AdamW, EMA) of revisiting_at_tpu_torch against the
JAX step on the same JAX model, its Pallas kernels in interpret mode, on
the CPU, with JAX's mixup draws injected. About 45 s of CPU time on one
core, most of it the JAX step's compile.

Tolerance, as tests/test_torch_port_train.py: loss and grad_norm to 1e-4
relative, accuracies equal, every parameter and EMA element within 1e-4.
"""

import torch

from _torch_port_util import (dwconv_step_batch, jax_dwconv_trajectory, port_dwconv_step,
                              step_mismatches)
from revisiting_at_tpu.train.train_step import AdvConfig as JaxAdv
from revisiting_at_tpu_torch.ops import dwconv as tdw
from revisiting_at_tpu_torch.train import AdvConfig

torch.set_num_threads(1)


def test_apgd_train_step_on_dwconv_route_matches_jax(monkeypatch):
    """3 APGD steps: metrics, parameters and EMA. The attack's backwards run
    dx alone; the weight pass runs once per gated block per step, in the
    training backward."""
    params, trajectory = jax_dwconv_trajectory(JaxAdv(attack="apgd", n_iter=2), 3)
    calls = []
    real = tdw.dwconv_wgrad
    monkeypatch.setattr(tdw, "dwconv_wgrad", lambda *a: calls.append(1) or real(*a))
    state, step = port_dwconv_step(params, AdvConfig(attack="apgd", n_iter=2))
    assert step_mismatches(state, step, trajectory, *dwconv_step_batch()) == []
    assert state.step == 3 and len(calls) == 3 * 4  # 4 gated blocks
