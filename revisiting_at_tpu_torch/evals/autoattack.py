"""Batched AutoAttack evaluator, port of revisiting_at_tpu/evals/autoattack.py.

Standard AutoAttack runs APGD-CE -> APGD-T (9 targets, DLR-targeted) ->
FAB-T -> Square, each attack ONLY on the points still robust (worklist
semantics), and re-scores robust accuracy on the returned examples. The
worklist lives on the host as a boolean mask: between attacks the still-
robust indices are gathered, padded to the batch size, attacked on the
device, and the flipped points scattered back into a sparse store. Every
returned point is checked against the epsilon ball.

The short mode (APGD-CE, APGD-T) is ported; FAB-T and Square wait for
ROADMAP A8. Random starts come from `noise_fn(key, shape)`, where key is
(attack index, batch start) for APGD-CE and (attack index, batch start,
target index) for APGD-T: the JAX package's fold_in chain, so a test can
inject JAX's draws. By default a torch.Generator seeded from (seed, *key)
draws them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from ..attacks.apgd import apgd_attack, start_noise
from ..ops.norms import check_imgs

EPS_DICT = {"imagenet": {"Linf": 4.0 / 255.0, "L2": 2.0, "L1": 75.0}}

STANDARD_ATTACKS = ("apgd-ce", "apgd-t", "fab-t", "square")
SHORT_ATTACKS = ("apgd-ce", "apgd-t")

NoiseFn = Callable[[tuple, tuple], torch.Tensor]


def _unit(xb: np.ndarray) -> np.ndarray:
    """A new f32 [0, 1] array from a uint8 or unit-float batch (never a view)."""
    if xb.dtype == np.uint8:
        return xb.astype(np.float32) / 255.0
    return np.array(xb, np.float32)


@dataclasses.dataclass
class AutoAttackConfig:
    norm: str = "Linf"
    eps: float = 4.0 / 255.0
    attacks_to_run: Sequence[str] = STANDARD_ATTACKS
    n_iter: int = 100
    n_target_classes: int = 9
    seed: int = 0
    batch_size: int = 200
    verbose: bool = True


def torch_noise(seed: int, norm: str, device) -> NoiseFn:
    """Default start noise: a torch.Generator on `device` seeded from (seed, *key)."""
    def draw(key: tuple, shape: tuple) -> torch.Tensor:
        h = seed
        for k in key:
            h = (h * 1_000_003 + int(k) + 1) % (2 ** 63 - 1)
        gen = torch.Generator(device=device)
        gen.manual_seed(h)
        return start_noise(shape, norm, generator=gen, device=device)
    return draw


class AutoAttack:
    """`AutoAttack(logits_fn, cfg, device=...).run_standard_evaluation(x, y)`.

    logits_fn maps an NHWC [0, 1] f32 batch on `device` to logits [B, classes].
    The device is the card unless the caller asks for the CPU."""

    def __init__(self, logits_fn: Callable[[torch.Tensor], torch.Tensor],
                 cfg: AutoAttackConfig, logger=None, noise_fn: NoiseFn | None = None,
                 device: str | torch.device = "cuda"):
        for attack in cfg.attacks_to_run:
            if attack in ("fab-t", "square"):
                raise NotImplementedError(f"{attack}: ROADMAP A8")
            if attack not in SHORT_ATTACKS:
                raise ValueError(f"unknown attack {attack!r}")
        self.cfg = cfg
        self.logits_fn = logits_fn
        self.device = torch.device(device)
        self.noise_fn = noise_fn or torch_noise(cfg.seed, cfg.norm, self.device)
        if logger is not None:
            self.log = logger.log
        elif cfg.verbose:
            self.log = print
        else:
            self.log = lambda *a, **k: None

    # ----------------------------------------------------------- utilities
    def _dev_x(self, xb: np.ndarray) -> torch.Tensor:
        """Pixel batch -> device as [0, 1] f32; uint8 crosses at 1 B/px."""
        t = torch.from_numpy(np.ascontiguousarray(xb)).to(self.device)
        return t.float() / 255.0 if t.dtype == torch.uint8 else t.float()

    def _logits(self, xb: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return self.logits_fn(self._dev_x(xb)).float().cpu().numpy()

    def _pad(self, xb, yb):
        """Pad to the fixed batch size by repeating the last point."""
        n = len(xb)
        bs = self.cfg.batch_size
        if n < bs:
            xb = np.concatenate([xb, np.repeat(xb[-1:], bs - n, axis=0)])
            yb = np.concatenate([yb, np.repeat(yb[-1:], bs - n, axis=0)])
        return xb, yb, n

    def clean_accuracy(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Per-point correctness, batched."""
        bs = self.cfg.batch_size
        out = np.zeros(len(x), bool)
        for i in range(0, len(x), bs):
            xb, yb, n = self._pad(x[i:i + bs], y[i:i + bs])
            out[i:i + n] = self._logits(xb).argmax(-1)[:n] == yb[:n]
        return out

    def _top_target_classes(self, x: np.ndarray) -> np.ndarray:
        """[N, n_target_classes]: the 2nd ... (k+1)-th most likely classes."""
        bs, k = self.cfg.batch_size, self.cfg.n_target_classes
        out = np.zeros((len(x), k), np.int64)
        for i in range(0, len(x), bs):
            xb = x[i:i + bs]
            n = len(xb)
            xb, _, _ = self._pad(xb, np.zeros(n, np.int64))
            order = np.argsort(self._logits(xb)[:n], axis=-1)
            out[i:i + n] = order[:, -2:-2 - k:-1]
        return out

    # --------------------------------------------------------- evaluation
    def run_standard_evaluation(self, x: np.ndarray, y: np.ndarray):
        """Returns (x_adv f32, robust mask). x is NHWC uint8 or f32 in [0, 1].
        Only flipped points are held in f32 during the attacks; x_adv is
        assembled batchwise at the end."""
        cfg = self.cfg
        x = np.asarray(x)
        y = np.asarray(y, np.int64)
        store: dict[int, np.ndarray] = {}

        robust = self.clean_accuracy(x, y)
        self.log(f"initial (clean) accuracy: {robust.mean():.2%}")

        for attack_idx, attack in enumerate(cfg.attacks_to_run):
            idx = np.where(robust)[0]
            if len(idx) == 0:
                break
            flipped_x, flipped_mask = self._run_attack(attack, attack_idx, x[idx], y[idx])
            newly_broken = idx[flipped_mask]
            for j, pt in zip(newly_broken, flipped_x):
                store[int(j)] = pt
            robust[newly_broken] = False
            self.log(f"robust accuracy after {attack.upper()}: {robust.mean():.2%} "
                     f"(broke {flipped_mask.sum()}/{len(idx)})")

        def batch_adv(i, j):
            xb = _unit(x[i:j])
            for k in range(i, min(j, len(x))):
                if k in store:
                    xb[k - i] = store[k]
            return xb

        bs = cfg.batch_size
        max_norm, lo, hi = 0.0, np.inf, -np.inf
        for i in range(0, len(x), bs):
            mn, l, h = check_imgs(torch.from_numpy(batch_adv(i, i + bs)),
                                  torch.from_numpy(_unit(x[i:i + bs])), cfg.norm)
            max_norm, lo, hi = max(max_norm, mn), min(lo, l), max(hi, h)
        self.log(f"max {cfg.norm} perturbation: {max_norm:.5f}, "
                 f"image range [{lo:.5f}, {hi:.5f}]")
        if not max_norm <= cfg.eps * 1.001 + 1e-6:
            raise AssertionError(f"eps-ball violated: {max_norm} > {cfg.eps}")

        rescored = np.zeros(len(x), bool)
        for i in range(0, len(x), bs):
            xb, yb, n = self._pad(batch_adv(i, i + bs), y[i:i + bs])
            rescored[i:i + n] = self._logits(xb).argmax(-1)[:n] == yb[:n]
        self.log(f"robust accuracy (re-scored on x_adv): {rescored.mean():.2%}")

        x_adv = np.empty((len(x),) + tuple(x.shape[1:]), np.float32)
        for i in range(0, len(x), bs):
            x_adv[i:i + bs] = batch_adv(i, i + bs)
        return x_adv, robust

    # ------------------------------------------------------------- attacks
    def _apgd(self, xb, yb, key, loss, y_target=None):
        cfg = self.cfg
        res = apgd_attack(self.logits_fn, xb, yb, norm=cfg.norm, eps=cfg.eps,
                          n_iter=cfg.n_iter, loss=loss, y_target=y_target, is_train=False,
                          random_start=True,
                          noise=self.noise_fn(key, tuple(xb.shape)).to(xb.device))
        return res.x_best_adv.cpu().numpy(), res.acc.cpu().numpy()

    def _run_attack(self, attack: str, attack_idx: int, x: np.ndarray, y: np.ndarray):
        """One attack over the worklist subset. Returns (flipped f32 points in
        np.where(flipped) order, flipped mask aligned with x)."""
        bs, n = self.cfg.batch_size, len(x)
        store: dict[int, np.ndarray] = {}
        flipped = np.zeros(n, bool)

        def keep(i, got, adv):
            for j in np.where(got)[0]:
                store[i + int(j)] = adv[j]

        for i in range(0, n, bs):
            xb, yb, nb = self._pad(x[i:i + bs], y[i:i + bs])
            xb_t = self._dev_x(xb)
            yb_t = torch.from_numpy(yb).to(self.device)
            if attack == "apgd-ce":
                adv, acc = self._apgd(xb_t, yb_t, (attack_idx, i), "ce")
                got = ~acc[:nb]
                keep(i, got, adv[:nb])
                flipped[i:i + nb] |= got
            else:  # apgd-t
                targets = self._top_target_classes(xb)
                still = np.ones(nb, bool)
                for t in range(self.cfg.n_target_classes):
                    if not still.any():
                        break
                    yt = torch.from_numpy(targets[:, t].copy()).to(self.device)
                    adv, acc = self._apgd(xb_t, yb_t, (attack_idx, i, t), "dlr-targeted", yt)
                    got = (~acc[:nb]) & still
                    keep(i, got, adv[:nb])
                    flipped[i:i + nb] |= got
                    still &= acc[:nb]

        flipped_idx = np.where(flipped)[0]
        if len(flipped_idx):
            return np.stack([store[int(j)] for j in flipped_idx]), flipped
        return np.zeros((0,) + tuple(x.shape[1:]), np.float32), flipped
