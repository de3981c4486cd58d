"""APGD (Auto-PGD), port of revisiting_at_tpu/attacks/apgd.py.

k forward/backward steps w.r.t. the input with momentum (0.75 after step
0), a per-sample step size halved at oscillation / no-improvement
checkpoints, best-loss tracking with snap-back to the best point, and
Linf/L2/L1 ball projection (L1: sparse top-k direction and the exact
projection). `check_oscillation`'s window over the loss history keeps the
reference's negative-index wraparound on the first checkpoint. The last
iteration is forward-only: (n_iter + 1) forwards and n_iter input-gradients.

The JAX package runs this as one `lax.scan`; here it is a Python loop over
eager tensors with the same masked updates, so the two agree step by step.
Carries are float32 whatever the model's compute dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..ops.losses import is_correct, make_criterion
from ..ops.norms import l0_norm, l1_projection, l2_norm

LogitsFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class ApgdResult:
    x_best: torch.Tensor      # best-loss point (what training consumes)
    acc: torch.Tensor         # [B] bool: still correct after the attack
    loss_best: torch.Tensor   # [B] best per-sample loss
    x_best_adv: torch.Tensor  # last point that flipped the prediction


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (ndim - 1))


def start_noise(shape, norm: str, *, generator: torch.Generator | None = None,
                device=None) -> torch.Tensor:
    """The random start's raw draw: U(-1, 1) for Linf, N(0, 1) for L2/L1."""
    if norm == "Linf":
        return torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0
    return torch.randn(shape, generator=generator, device=device)


def apgd_attack(logits_fn: LogitsFn, x: torch.Tensor, y: torch.Tensor, *,
                norm: str = "Linf", eps: float = 4.0 / 255.0, n_iter: int = 10,
                loss: str = "ce", y_target: torch.Tensor | None = None,
                is_train: bool = True, random_start: bool = False,
                noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> ApgdResult:
    """Run APGD against `logits_fn` (a deterministic model closure).

    The training flavour (random_start=False) starts at x. The eval flavour
    starts at a random point of the ball made from `noise` (the raw draw of
    `start_noise`, e.g. injected by a test), or drawn from `generator`."""
    if norm not in ("Linf", "L2", "L1"):
        raise ValueError(f"unsupported norm {norm!r}")
    bs, ndim = x.shape[0], x.ndim
    n_fts = math.prod(x.shape[1:])
    x = x.float()

    criterion = make_criterion(loss)
    if loss == "dlr-targeted":
        if y_target is None:
            raise ValueError("dlr-targeted needs y_target")
        crit = lambda logits, yy: criterion(logits, yy, y_target)  # noqa: E731
    else:
        crit = criterion

    def loss_grad(x_adv):
        xa = x_adv.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = logits_fn(xa)
            li = crit(logits, y)
            (grad,) = torch.autograd.grad(li.sum(), xa)
        return li.detach(), logits.detach(), grad.detach()

    if random_start:
        t = (noise if noise is not None else
             start_noise(x.shape, norm, generator=generator, device=x.device)).float()
        if norm == "Linf":
            x_adv = x + eps * t / _bcast(t.reshape(bs, -1).abs().amax(1), ndim)
        elif norm == "L2":
            x_adv = x + eps * t / (l2_norm(t, keepdims=True) + 1e-12)
        else:
            x_adv = x + t + l1_projection(x, t, eps)
    else:
        x_adv = x
    x_adv = x_adv.clamp(0.0, 1.0)

    if norm in ("Linf", "L2"):
        n_iter_2 = max(int(0.22 * n_iter), 1)
        n_iter_min = max(int(0.06 * n_iter), 1)
        size_decr = max(int(0.03 * n_iter), 1)
        k0 = k_max = n_iter_2
        thr_decr = 0.75
        alpha = 2.0
    else:
        k0 = k_max = max(int(0.04 * n_iter), 1)
        init_topk = 0.05 if is_train else 0.2
        adasp_redstep, adasp_minstep = 1.5, 10.0
        alpha = 1.0

    li0, logits0, grad0 = loss_grad(x_adv)
    c = dict(
        x_adv=x_adv, x_adv_old=x_adv, grad=grad0, grad_best=grad0,
        x_best=x_adv, x_best_adv=x_adv, loss_best=li0, loss_best_last_check=li0,
        reduced_last_check=torch.ones(bs, device=x.device),
        loss_steps=torch.zeros(n_iter, bs, device=x.device),
        step_size=alpha * eps * torch.ones((bs,) + (1,) * (ndim - 1), device=x.device),
        acc=is_correct(logits0, y), counter3=0, k=k0,
    )
    if norm == "L1":
        c["topk"] = init_topk * torch.ones(bs, device=x.device)
        c["sp_old"] = float(n_fts) * torch.ones(bs, device=x.device)

    def ball(z):
        return torch.clamp(torch.clamp(z, x - eps, x + eps), 0.0, 1.0)

    def l2_ball(x1):
        d = x1 - x
        n = l2_norm(d, keepdims=True)
        return (x + d / (n + 1e-12) * torch.clamp(n, max=eps)).clamp(0.0, 1.0)

    def momentum_step(c, i):
        x_adv_c, grad, step_size = c["x_adv"], c["grad"], c["step_size"]
        grad2 = x_adv_c - c["x_adv_old"]
        a = 0.75 if i > 0 else 1.0
        if norm == "Linf":
            x1 = ball(x_adv_c + step_size * torch.sign(grad))
            x1 = ball(x_adv_c + (x1 - x_adv_c) * a + grad2 * (1.0 - a))
        elif norm == "L2":
            x1 = l2_ball(x_adv_c + step_size * grad / (l2_norm(grad, keepdims=True) + 1e-12))
            x1 = l2_ball(x_adv_c + (x1 - x_adv_c) * a + grad2 * (1.0 - a))
        else:
            gsort = torch.sort(grad.abs().reshape(bs, -1), dim=-1).values
            topk_curr = ((1.0 - c["topk"]) * n_fts).clamp(0, n_fts - 1).long()
            thresh = _bcast(gsort.gather(1, topk_curr[:, None])[:, 0], ndim)
            sg_sign = torch.sign(grad * (grad.abs() >= thresh).to(grad.dtype))
            denom = sg_sign.abs().reshape(bs, -1).sum(-1)
            x1 = x_adv_c + step_size * sg_sign / (_bcast(denom, ndim) + 1e-10)
            delta_u = x1 - x
            x1 = x + delta_u + l1_projection(x, delta_u, eps)
        return x1

    def bookkeeping(c, i, x1, li, logits, g_new):
        pred = is_correct(logits, y)
        acc = c["acc"] & pred
        mis = _bcast((~pred).float(), ndim)
        x_best_adv = x1 * mis + c["x_best_adv"] * (1.0 - mis)
        improved = li > c["loss_best"]
        imp = _bcast(improved.float(), ndim)
        x_best = x1 * imp + c["x_best"] * (1.0 - imp)
        grad_best = g_new * imp + c["grad_best"] * (1.0 - imp)
        loss_best = torch.where(improved, li, c["loss_best"])
        loss_steps = c["loss_steps"].clone()
        loss_steps[i] = li
        counter3 = c["counter3"] + 1
        k = c["k"]
        is_ckpt = counter3 == k
        grad, x_adv, step_size = g_new, x1, c["step_size"]
        new = dict(c)
        if norm in ("Linf", "L2"):
            cs = torch.arange(k_max, device=x.device)
            idx_hi = torch.remainder(i - cs, n_iter)
            idx_lo = torch.remainder(i - cs - 1, n_iter)
            inc = (loss_steps[idx_hi] > loss_steps[idx_lo]).float()
            cmask = (cs < k).float()[:, None]
            t = (inc * cmask).sum(0)
            fl_osc = (t <= k * thr_decr).float()
            fl_no_impr = (1.0 - c["reduced_last_check"]) * (
                c["loss_best_last_check"] >= loss_best).float()
            fl_osc = torch.maximum(fl_osc, fl_no_impr)
            if is_ckpt:
                new["reduced_last_check"] = fl_osc
                new["loss_best_last_check"] = loss_best
                halve = _bcast(fl_osc, ndim)
                step_size = step_size * (1.0 - halve) + step_size * 0.5 * halve
                x_adv = x_adv * (1.0 - halve) + x_best * halve
                grad = grad * (1.0 - halve) + grad_best * halve
                new["k"] = max(k - size_decr, n_iter_min)
        elif is_ckpt:
            sp_curr = l0_norm(x_best - x)
            fl_redtopk = ((sp_curr / c["sp_old"]) < 0.95).float()
            new["topk"] = sp_curr / n_fts / 1.5
            red = _bcast(fl_redtopk, ndim)
            ss_new = red * (alpha * eps) + (1.0 - red) * (step_size / adasp_redstep)
            step_size = ss_new.clamp(alpha * eps / adasp_minstep, alpha * eps)
            new["sp_old"] = sp_curr
            x_adv = x_adv * (1.0 - red) + x_best * red
            grad = grad * (1.0 - red) + grad_best * red
        new.update(x_adv=x_adv, x_adv_old=c["x_adv"], grad=grad, grad_best=grad_best,
                   x_best=x_best, x_best_adv=x_best_adv, loss_best=loss_best,
                   loss_steps=loss_steps, step_size=step_size, acc=acc,
                   counter3=0 if is_ckpt else counter3)
        return new

    for i in range(n_iter - 1):
        x1 = momentum_step(c, i)
        li, logits, g_new = loss_grad(x1)
        c = bookkeeping(c, i, x1, li, logits, g_new)

    # last iteration: forward only, no input-gradient
    x1 = momentum_step(c, n_iter - 1)
    with torch.no_grad():
        logits = logits_fn(x1)
        li = crit(logits, y)
    pred = is_correct(logits, y)
    acc = c["acc"] & pred
    mis = _bcast((~pred).float(), ndim)
    x_best_adv = x1 * mis + c["x_best_adv"] * (1.0 - mis)
    improved = li > c["loss_best"]
    imp = _bcast(improved.float(), ndim)
    x_best = x1 * imp + c["x_best"] * (1.0 - imp)
    loss_best = torch.where(improved, li, c["loss_best"])
    return ApgdResult(x_best=x_best, acc=acc, loss_best=loss_best, x_best_adv=x_best_adv)

