"""LR schedules with per-iteration interpolation, port of
revisiting_at_tpu/train/schedule.py as plain Python floats.

step / cyclic (triangular) / cosine with linear warm-up, evaluated at
integer epochs and linearly interpolated per iteration between epoch
endpoints, as the reference recipe does. Arithmetic is float32, as in the
JAX version, so both give the same LR bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

_f = np.float32


@dataclasses.dataclass(frozen=True)
class LRConfig:
    lr: float = 1e-3
    schedule_type: str = "cosine"  # 'step' | 'cyclic' | 'cosine'
    lr_peak_epoch: int = 10
    step_ratio: float = 0.1
    step_length: int = 30
    epochs: int = 100


def epoch_lr(cfg: LRConfig, epoch) -> float:
    """LR at an integer epoch."""
    e = _f(epoch)
    if cfg.schedule_type == "step":
        if e >= cfg.epochs:
            return 0.0
        return float(_f(cfg.step_ratio) ** np.floor(e / _f(cfg.step_length)) * _f(cfg.lr))
    warm = (_f(1e-4 * cfg.lr) + _f(cfg.lr - 1e-4 * cfg.lr) * e
            / _f(max(cfg.lr_peak_epoch, 1)))
    if cfg.schedule_type == "cyclic":
        if e <= cfg.lr_peak_epoch:
            return float(warm)
        down = _f(cfg.lr) * (_f(cfg.epochs) - e) / _f(max(cfg.epochs - cfg.lr_peak_epoch, 1))
        return float(max(down, _f(0.0)))
    if cfg.schedule_type == "cosine":
        if e <= cfg.lr_peak_epoch:
            return float(warm)
        lr_min = 5e-6
        phase = _f(math.pi) * (e - _f(cfg.lr_peak_epoch)) / _f(
            max(cfg.epochs - cfg.lr_peak_epoch, 1))
        return float(_f(lr_min) + _f(0.5 * (cfg.lr - lr_min)) * (_f(1.0) + np.cos(phase)))
    raise ValueError(f"unknown schedule {cfg.schedule_type!r}")


def make_lr_schedule(cfg: LRConfig, iters_per_epoch: int) -> Callable[[int], float]:
    """Global step -> LR, linearly interpolated between epoch endpoints."""

    def schedule(step: int) -> float:
        s, n = _f(step), _f(iters_per_epoch)
        epoch = np.floor(s / n)
        frac = (s - epoch * n) / n
        lr0, lr1 = _f(epoch_lr(cfg, epoch)), _f(epoch_lr(cfg, epoch + _f(1)))
        return float(lr0 + (lr1 - lr0) * frac)

    return schedule


def get_resolution(epoch: int, min_res: int, max_res: int, start_ramp: int,
                   end_ramp: int) -> int:
    """Resolution ramp of the reference; constant in the paper recipe."""
    assert min_res <= max_res
    if epoch <= start_ramp:
        return min_res
    if epoch >= end_ramp:
        return max_res
    interp = np.interp([epoch], [start_ramp, end_ramp], [min_res, max_res])
    return int(np.round(interp[0] / 32)) * 32
