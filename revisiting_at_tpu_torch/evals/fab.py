"""FAB-T (Fast Adaptive Boundary, targeted), port of revisiting_at_tpu/evals/fab.py.

The third attack of standard AutoAttack (9 target classes, n_iter=100,
alpha_max=0.1, eta=1.05, beta=0.9; Croce & Hein, ICML 2020). Per
iteration, targeted at class c:
  1. linearize the decision boundary f_c(z) - f_y(z) = 0 at the iterate x1:
     the hyperplane w.z = b with w = grad(f_c - f_y), b = w.x1 - (f_c - f_y);
  2. project x1 and the original point x onto {z in [0, 1]^d : w.z = b}
     under the attack norm, from either side of it;
  3. take the eta-extrapolated convex combination with adaptive alpha
     (at most alpha_max);
  4. if the new point is misclassified, keep it as the best point when its
     distance to x is the smallest yet, then step back toward x by beta.
Success means a best distance within eps.

The box-and-hyperplane projections are the JAX package's: a fixed-count
bisection on the radius (Linf) or on the Lagrange multiplier (L2), and a
sort, a cumulative sum and a partial move (L1). Functions take tensors on
any device; the model's gradient is w.r.t. its input only (the caller
passes a model in `train_step.input_grad_view`). FAB draws no random
numbers, so a carry (x1, x_best, res_best) resumes exactly across calls.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.norms import l1_norm, l2_norm

LogitsFn = Callable[[torch.Tensor], torch.Tensor]


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _rows(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-row [B] vector shaped to broadcast over a [B, ...] tensor."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def _proj_hyperplane_box_linf(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                              n_bisect: int = 30) -> torch.Tensor:
    """delta minimizing ||delta||_inf s.t. t + delta in [0, 1]^d, w.(t + delta) <= b.

    g(r) = min over the box and |z - t|_inf <= r of w.z is non-increasing in
    r; bisect on r for g(r) = b. 0 where t is feasible; the saturating delta
    where the hyperplane cannot be reached inside the box."""
    violation = (w * t).sum(1) - b
    sgn = torch.sign(w)

    def z_at(r):
        return torch.clamp(t - r[:, None] * sgn, 0.0, 1.0)

    lo = torch.zeros_like(b)
    hi = torch.ones_like(b)  # the box's diameter bounds any useful radius
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        too_high = (w * z_at(mid)).sum(1) > b  # needs a larger radius
        lo = torch.where(too_high, mid, lo)
        hi = torch.where(too_high, hi, mid)
    delta = z_at(hi) - t
    return torch.where(violation[:, None] > 0, delta, torch.zeros_like(delta))


def _proj_hyperplane_box_l2(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            n_bisect: int = 40) -> torch.Tensor:
    """delta minimizing ||delta||_2 s.t. t + delta in [0, 1]^d, w.(t + delta) <= b.

    KKT: z(lam) = clip(t - lam w, 0, 1), w.z(lam) non-increasing in lam:
    8 growths of lam_hi by 4, then a bisection."""
    violation = (w * t).sum(1) - b

    def z_at(lam):
        return torch.clamp(t - lam[:, None] * w, 0.0, 1.0)

    def g(lam):
        return (w * z_at(lam)).sum(1)

    lam_hi = 2.0 / (w.abs().amax(1) + 1e-12)
    for _ in range(8):
        lam_hi = torch.where(g(lam_hi) > b, lam_hi * 4.0, lam_hi)
    lo, hi = torch.zeros_like(b), lam_hi
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        too_high = g(mid) > b
        lo = torch.where(too_high, mid, lo)
        hi = torch.where(too_high, hi, mid)
    delta = z_at(hi) - t
    return torch.where(violation[:, None] > 0, delta, torch.zeros_like(delta))


def _proj_hyperplane_box_l1(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """delta minimizing ||delta||_1 s.t. t + delta in [0, 1]^d, w.(t + delta) <= b.

    The LP's optimum saturates coordinates in decreasing |w_i| order, each
    up to its box room, until the violation is paid, with a partial move on
    the crossing coordinate: one sort, a cumulative sum and a threshold.
    The sort is stable, as jnp.argsort's: ties in |w| are common (a zero
    gradient off the model's support), and their order decides which
    coordinate moves."""
    violation = (w * t).sum(1) - b
    aw = w.abs()
    room = torch.where(w > 0, t, 1.0 - t)  # room to the box moving against w
    cap = aw * room  # each coordinate's reduction capacity of w.z

    order = torch.argsort(-aw, dim=1, stable=True)
    cap_sorted = cap.gather(1, order)
    cum = torch.cumsum(cap_sorted, dim=1)
    cum_prev = cum - cap_sorted

    v = violation[:, None]
    full = cum <= v  # saturated coordinates, in sorted order
    residual = torch.minimum(torch.clamp(v - cum_prev, min=0.0), cap_sorted)
    aw_sorted = aw.gather(1, order)
    room_sorted = room.gather(1, order)
    mag_sorted = torch.where(full, room_sorted, residual / torch.clamp(aw_sorted, min=1e-12))

    inv = torch.argsort(order, dim=1)
    delta = -torch.sign(w) * mag_sorted.gather(1, inv)
    return torch.where(v > 0, delta, torch.zeros_like(delta))


def _project(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor, norm: str) -> torch.Tensor:
    """Min-norm delta taking t onto the box-restricted hyperplane w.z = b from
    either side. As the official projection (autoattack
    fab_projections.py:13-17), (w, b) flip per row so that t lies on the
    w.z >= b side: an adversarial iterate is projected back onto the
    linearized boundary, which FAB's minimum-norm refinement needs."""
    s = torch.where((w * t).sum(1) - b >= 0.0, 1.0, -1.0)
    w = w * s[:, None]
    b = b * s
    if norm == "Linf":
        return _proj_hyperplane_box_linf(t, w, b)
    if norm == "L2":
        return _proj_hyperplane_box_l2(t, w, b)
    if norm == "L1":
        return _proj_hyperplane_box_l1(t, w, b)
    raise ValueError(f"unknown norm {norm!r}")


def _dist(a: torch.Tensor, b: torch.Tensor, norm: str) -> torch.Tensor:
    d = a - b
    if norm == "Linf":
        return _flat(d).abs().amax(1)
    if norm == "L2":
        return l2_norm(d)
    return l1_norm(d)


def fab_single_init(x: torch.Tensor):
    """The carry of one targeted run before its first iteration: (x1, x_best, res_best)."""
    x = x.float()
    return x, x, torch.full((x.shape[0],), 1e10, dtype=torch.float32, device=x.device)


def _diff_and_grad(logits_fn: LogitsFn, x1, y, y_target):
    """(f_t - f_y, its gradient w.r.t. x1), row by row."""
    with torch.enable_grad():
        z = x1.detach().requires_grad_(True)
        logits = logits_fn(z)
        df = (logits.gather(1, y_target[:, None])[:, 0]
              - logits.gather(1, y[:, None])[:, 0]).float()
        (dg,) = torch.autograd.grad(df.sum(), z)
    return df.detach(), dg


def fab_single_chunk(logits_fn: LogitsFn, x: torch.Tensor, y: torch.Tensor,
                     y_target: torch.Tensor, carry, n_chunk: int, *, norm: str = "Linf",
                     alpha_max: float = 0.1, eta: float = 1.05, beta: float = 0.9):
    """Advance one targeted run's carry by n_chunk iterations."""
    x = x.float()
    xf = _flat(x)
    x1, x_best, res_best = carry
    for _ in range(n_chunk):
        df, dg = _diff_and_grad(logits_fn, x1, y, y_target)
        w = _flat(dg)
        x1f = _flat(x1)
        # boundary hyperplane w.z = b (adversarial side w.z >= b), solved on
        # the minimizing side as -w.z <= -b
        b_hp = (w * x1f).sum(1) - df
        d1 = _project(x1f, -w, -b_hp, norm)  # from the iterate
        d2 = _project(xf, -w, -b_hp, norm)  # from the original point
        if norm == "Linf":
            a1, a2 = d1.abs().amax(1), d2.abs().amax(1)
        elif norm == "L1":
            a1, a2 = d1.abs().sum(1), d2.abs().sum(1)
        else:
            a1, a2 = (d1 * d1).sum(1).sqrt(), (d2 * d2).sum(1).sqrt()
        a1 = torch.clamp(a1, min=1e-8)
        a2 = torch.clamp(a2, min=1e-8)
        alpha = torch.clamp(a1 / (a1 + a2), 0.0, alpha_max)[:, None]

        x1f_new = (x1f + eta * d1) * (1.0 - alpha) + (xf + eta * d2) * alpha
        x1_new = torch.clamp(x1f_new.reshape(x.shape), 0.0, 1.0)

        with torch.no_grad():
            is_adv = logits_fn(x1_new).argmax(-1) != y
        t_dist = _dist(x1_new, x, norm)
        improved = is_adv & (t_dist < res_best)
        imp = _rows(improved.float(), x.ndim)
        x_best = x1_new * imp + x_best * (1.0 - imp)
        res_best = torch.where(improved, t_dist, res_best)

        # the backward step toward x for adversarial points
        back = _rows(is_adv.float(), x.ndim)
        x1_back = x + (x1_new - x) * beta
        x1 = x1_back * back + x1_new * (1.0 - back)
    return x1, x_best, res_best


def fab_attack_single_target(logits_fn: LogitsFn, x, y, y_target, *, norm: str = "Linf",
                             eps: float = 4.0 / 255.0, n_iter: int = 100,
                             alpha_max: float = 0.1, eta: float = 1.05, beta: float = 0.9):
    """One targeted run. Returns (x_best, best distance); eps is unused, as in JAX."""
    _, x_best, res_best = fab_single_chunk(
        logits_fn, x, y, y_target, fab_single_init(x), n_iter, norm=norm,
        alpha_max=alpha_max, eta=eta, beta=beta)
    return x_best, res_best


def fab_attack_targeted(logits_fn: LogitsFn, x, y, y_targets, *, norm: str = "Linf",
                        eps: float = 4.0 / 255.0, n_iter: int = 100, alpha_max: float = 0.1,
                        eta: float = 1.05, beta: float = 0.9):
    """FAB-T over the target classes y_targets [B, n_targets]: the best
    minimum-norm point over the targets. Returns (x_adv, success), success
    meaning a misclassified point within eps; x_adv is x where none was found."""
    x = x.float()
    best_x = x
    best_res = torch.full((x.shape[0],), 1e10, dtype=torch.float32, device=x.device)
    for ti in range(y_targets.shape[1]):
        xb, res = fab_attack_single_target(
            logits_fn, x, y, y_targets[:, ti], norm=norm, eps=eps, n_iter=n_iter,
            alpha_max=alpha_max, eta=eta, beta=beta)
        better = res < best_res
        keep = _rows(better.float(), x.ndim)
        best_x = xb * keep + best_x * (1.0 - keep)
        best_res = torch.where(better, res, best_res)
    success = best_res <= eps
    succ = _rows(success.float(), x.ndim)
    return best_x * succ + x * (1.0 - succ), success
