"""AdversarialModel, port of revisiting_at_tpu/attacks/wrapped.py: the
reference's WrappedModel object API (forward(x, y) attacks first, then
runs the training forward on the adversarial points; set_perturb toggles
it). Training itself uses the fused step (train/train_step.py); this is
for code written against the reference's object.

    wrapped = AdversarialModel(model, attack="apgd", eps=4 / 255)
    wrapped.set_perturb(True)
    logits = wrapped(x, y)   # the attack in eval mode, then the train-mode forward
    wrapped.set_perturb(False)
    logits = wrapped(x)      # a clean eval-mode forward

The attack runs in attack mode (train.train_step.attack_grad_mode: eval
mode with frozen running statistics, the block tail's input-only
backward, weights frozen): APGD's training flavour, whose best-loss
point x_best is returned, or RS-FGSM with alpha, noise_level and
skip_projection. FGSM's random start is drawn per call from a generator
seeded from (seed, calls), as JAX draws from fold_in(PRNGKey(seed),
calls), or taken from an injected `attack_draws(calls, shape)` (the raw
U(0, 1) draw). The wrapper holds the module, whose weights are its
variables.
"""

from __future__ import annotations

import torch
from torch import nn

from .apgd import apgd_attack
from .fgsm import fgsm_train


class AdversarialModel:
    def __init__(self, model: nn.Module, *, attack: str = "apgd", norm: str = "Linf",
                 eps: float = 4.0 / 255.0, n_iter: int = 2, alpha: float = 1.25,
                 noise_level: float = 1.0, skip_projection: bool = False, seed: int = 0,
                 attack_draws=None):
        self.model = model
        self.attack, self.norm, self.eps, self.n_iter = attack, norm, eps, n_iter
        self.alpha, self.noise_level, self.skip_projection = alpha, noise_level, skip_projection
        self.seed, self.attack_draws = seed, attack_draws
        self.perturb_input = False
        self._calls = 0

    def set_perturb(self, mode: bool) -> None:
        self.perturb_input = bool(mode)

    def perturb(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Adversarial examples for (x, y), made in attack mode (the
        reference's base_model.eval() during the attack); detached."""
        from ..train.train_step import attack_grad_mode, step_seed  # it imports this package

        if self.attack not in ("apgd", "fgsm"):
            raise ValueError(f"unknown attack {self.attack!r}")
        with attack_grad_mode(self.model):
            if self.attack == "apgd":
                return apgd_attack(self.model, x, y, norm=self.norm, eps=self.eps,
                                   n_iter=self.n_iter, is_train=True).x_best.detach()
            self._calls += 1
            noise = self.attack_draws(self._calls, tuple(x.shape)) if self.attack_draws else None
            gen = None
            if noise is None:
                gen = torch.Generator(device=x.device).manual_seed(
                    step_seed(self.seed, self._calls, 3))
            return fgsm_train(self.model, x, y, eps=self.eps, noise=noise, generator=gen,
                              alpha=self.alpha, use_rs=True, noise_level=self.noise_level,
                              skip_projection=self.skip_projection)

    def __call__(self, x: torch.Tensor, y: torch.Tensor | None = None, *,
                 train: bool = True) -> torch.Tensor:
        """With perturbation on: the attack, then the forward in train mode
        (`train`) on its points; else a clean eval-mode forward. The model
        keeps the mode of that forward afterwards."""
        if self.perturb_input:
            if y is None:
                raise ValueError("perturb mode needs labels (the reference's forward(x, y))")
            z = self.perturb(x, y)
            self.model.train(train)
            return self.model(z)
        self.model.eval()
        return self.model(x)
