"""Per-sample norms and threat-model ball projections.

Port of revisiting_at_tpu/ops/norms.py. All functions take NHWC (or any
[B, ...]) tensors and reduce over the non-batch axes, accumulating in
float32 whatever the input dtype.
"""

from __future__ import annotations

import torch


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _keep(z: torch.Tensor, ref_ndim: int, keepdims: bool) -> torch.Tensor:
    if keepdims:
        return z.reshape((-1,) + (1,) * (ref_ndim - 1))
    return z


def l1_norm(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    z = _flat(x).abs().float().sum(-1)
    return _keep(z, x.ndim, keepdims)


def l2_norm(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    xf = _flat(x).float()
    z = (xf * xf).sum(-1).sqrt()
    return _keep(z, x.ndim, keepdims)


def l0_norm(x: torch.Tensor) -> torch.Tensor:
    return (_flat(x) != 0.0).float().sum(-1)


def linf_project(x_adv: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Project onto the Linf ball of radius eps around x, intersected with [0, 1]."""
    return torch.clamp(torch.clamp(x_adv, x - eps, x + eps), 0.0, 1.0)


def l2_project(x_adv: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Rescale delta onto the L2 ball, then clip to the box (the reference's order)."""
    delta = (x_adv - x).float()
    n = l2_norm(delta, keepdims=True)
    factor = torch.clamp(n, max=eps) / (n + 1e-12)
    return torch.clamp(x + delta * factor, 0.0, 1.0).to(x_adv.dtype)


def l1_projection(x2: torch.Tensor, y2: torch.Tensor, eps1: float) -> torch.Tensor:
    """Exact projection onto {z : ||z||_1 <= eps1, 0 <= x2 + z <= 1}, as a delta.

    Returns ``delta`` such that ``x2 + y2 + delta`` lies in the L1 ball of
    radius eps1 around x2 intersected with the box. The JAX package's
    branch-free form: a count over the sorted breakpoints of the monotone
    piecewise-linear objective takes the place of a per-row bisection.
    """
    bs = x2.shape[0]
    x = _flat(x2).float()
    y = _flat(y2).float()

    sigma = torch.sign(y)
    u = torch.minimum(1.0 - x - y, x + y).clamp(max=0.0)
    l = -y.abs()
    d = u

    neg = -torch.cat([u, l], dim=1)
    bps, order = torch.sort(neg, dim=1, stable=True)  # ascending
    inu = torch.where(order < u.shape[1], 1.0, -1.0)
    bps2 = torch.cat([bps[:, 1:], bps.new_zeros(bs, 1)], dim=1)
    size1 = torch.cumsum(inu, dim=1)

    s1 = -u.sum(1)
    c = eps1 - y.abs().sum(1)
    needs_proj = (s1 + c) < 0.0

    s = s1[:, None] + torch.cumsum((bps2 - bps) * size1, dim=1)
    mask = (s + c[:, None]) < 0.0
    lb = (mask.sum(1) - 1).clamp(min=0)
    lb_next = (lb + 1).clamp(max=s.shape[1] - 1)

    def at(t, idx):
        return t.gather(1, idx[:, None])[:, 0]

    alpha = (-at(s, lb) - c) / at(size1, lb_next) + at(bps2, lb)
    d_proj = -torch.minimum(torch.maximum(-u, alpha[:, None]), -l)
    d = torch.where(needs_proj[:, None], d_proj, d)
    return (sigma * d).reshape(x2.shape).to(x2.dtype)


def check_imgs(adv: torch.Tensor, x: torch.Tensor, norm: str) -> tuple[float, float, float]:
    """Epsilon-ball checker: (max perturbation norm, min pixel, max pixel)."""
    delta = (adv - x).float()
    if norm == "Linf":
        res = delta.abs().max()
    elif norm == "L2":
        res = l2_norm(delta).max()
    elif norm == "L1":
        res = l1_norm(delta).max()
    else:
        raise ValueError(f"unknown norm {norm}")
    return float(res), float(adv.min()), float(adv.max())
