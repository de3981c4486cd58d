"""Batch-mode MixUp/CutMix with timm `Mixup` semantics, port of
revisiting_at_tpu/data/mixup.py.

timm Mixup(mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0, switch_prob=0.5,
mode='batch', label_smoothing=0.1): one draw per batch, the partner of each
image is the flipped batch, a CutMix box is pasted from it and lam is
corrected to the box's true area.

The draws (apply, switch, lam_mix, lam_cut, box centre) are made on the host
from a torch.Generator by `draw_mixup`, or handed in as a `MixupDraws`, so
that a test can feed the JAX package's draws. Scalar arithmetic follows the
JAX version's float32 steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MixupConfig:
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    prob: float = 1.0
    switch_prob: float = 0.5
    label_smoothing: float = 0.1
    num_classes: int = 1000


@dataclasses.dataclass(frozen=True)
class MixupDraws:
    """One batch's random draws: two U(0, 1), two Beta draws and the CutMix
    box centre (row cy in [0, h), column cx in [0, w))."""
    apply: float
    switch: float
    lam_mix: float
    lam_cut: float
    cy: int
    cx: int


def _beta(alpha: float, generator: torch.Generator) -> float:
    """Beta(alpha, alpha) by Johnk's rejection method, from U(0, 1) draws."""
    if alpha <= 0.0:
        return 1.0
    while True:
        u, v = torch.rand(2, generator=generator, dtype=torch.float64).tolist()
        x, y = u ** (1.0 / alpha), v ** (1.0 / alpha)
        if 0.0 < x + y <= 1.0:
            return x / (x + y)


def draw_mixup(generator: torch.Generator, h: int, w: int, cfg: MixupConfig) -> MixupDraws:
    """The draws of one batch from a (CPU) torch.Generator."""
    apply, switch = torch.rand(2, generator=generator).tolist()
    lam_mix = _beta(cfg.mixup_alpha, generator)
    lam_cut = _beta(cfg.cutmix_alpha, generator)
    cy = int(torch.randint(0, h, (), generator=generator))
    cx = int(torch.randint(0, w, (), generator=generator))
    return MixupDraws(apply, switch, lam_mix, lam_cut, cy, cx)


def one_hot_smooth(y: torch.Tensor, num_classes: int, smoothing: float) -> torch.Tensor:
    on = 1.0 - smoothing + smoothing / num_classes
    off = smoothing / num_classes
    return torch.nn.functional.one_hot(y.long(), num_classes).float() * (on - off) + off


def _rand_bbox(h: int, w: int, lam: float, cy: int, cx: int):
    """timm rand_bbox: a box of relative area (1 - lam) centred on (cy, cx), clipped."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h, cut_w = int(np.float32(h) * ratio), int(np.float32(w) * ratio)
    yl, yh = np.clip(cy - cut_h // 2, 0, h), np.clip(cy + cut_h // 2, 0, h)
    xl, xh = np.clip(cx - cut_w // 2, 0, w), np.clip(cx + cut_w // 2, 0, w)
    return int(yl), int(yh), int(xl), int(xh)


def mixup_cutmix(images: torch.Tensor, labels: torch.Tensor, cfg: MixupConfig,
                 draws: MixupDraws) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply batch-mode MixUp or CutMix. images NHWC, labels int [B].
    Returns (mixed images, soft targets [B, num_classes] f32)."""
    _, h, w, _ = images.shape
    use_cutmix = draws.switch < cfg.switch_prob and cfg.cutmix_alpha > 0.0
    if cfg.mixup_alpha <= 0.0:
        use_cutmix = True
    flipped = images.flip(0)
    if draws.apply >= cfg.prob:
        lam, mixed = 1.0, images
    elif use_cutmix:
        yl, yh, xl, xh = _rand_bbox(h, w, draws.lam_cut, draws.cy, draws.cx)
        mixed = images.clone()
        mixed[:, yl:yh, xl:xh, :] = flipped[:, yl:yh, xl:xh, :]
        lam = float(np.float32(1.0) - np.float32((yh - yl) * (xh - xl)) / np.float32(h * w))
    else:
        lam = float(np.float32(draws.lam_mix))
        mixed = images * lam + flipped * (1.0 - lam)
    y1 = one_hot_smooth(labels, cfg.num_classes, cfg.label_smoothing).to(images.device)
    targets = y1 * lam + y1.flip(0) * (1.0 - lam)
    return mixed.to(images.dtype), targets
