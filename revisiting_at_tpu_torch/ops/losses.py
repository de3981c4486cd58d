"""Attack and training losses, port of revisiting_at_tpu/ops/losses.py.

Every loss is computed in float32 from (possibly bf16) logits.
"""

from __future__ import annotations

import torch


def _log_softmax32(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def ce_indiv(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-entropy; `y` is int labels [B] or soft targets [B, C]."""
    logp = _log_softmax32(logits)
    if y.ndim == 1:
        return -logp.gather(-1, y[:, None].long())[:, 0]
    return -(y.float() * logp).sum(-1)


def soft_ce_mean(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft-target CE, batch mean."""
    return (-(target.float() * _log_softmax32(logits)).sum(-1)).mean()


soft_target_ce = soft_ce_mean


def smoothed_ce(logits: torch.Tensor, y: torch.Tensor, smoothing: float,
                num_classes: int) -> torch.Tensor:
    """Label-smoothed CE over hard int labels, batch mean."""
    logp = _log_softmax32(logits)
    nll = -logp.gather(-1, y[:, None].long())[:, 0]
    smooth = -logp.mean(-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def dlr_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Difference-of-logits-ratio loss, per sample."""
    x = logits.float()
    x_sorted, ind_sorted = torch.sort(x, dim=1)
    ind = (ind_sorted[:, -1] == y).float()
    zy = x.gather(1, y[:, None].long())[:, 0]
    return -(zy - x_sorted[:, -2] * ind - x_sorted[:, -1] * (1.0 - ind)) / (
        x_sorted[:, -1] - x_sorted[:, -3] + 1e-12
    )


def dlr_loss_targeted(logits: torch.Tensor, y: torch.Tensor,
                      y_target: torch.Tensor) -> torch.Tensor:
    """Targeted DLR loss, per sample."""
    x = logits.float()
    x_sorted = torch.sort(x, dim=1).values
    zy = x.gather(1, y[:, None].long())[:, 0]
    zt = x.gather(1, y_target[:, None].long())[:, 0]
    return -(zy - zt) / (x_sorted[:, -1] - 0.5 * (x_sorted[:, -3] + x_sorted[:, -4]) + 1e-12)


def make_criterion(name: str):
    """Per-sample criterion by name; 'ce' handles soft targets too."""
    table = {
        "ce": ce_indiv,
        "softloss": soft_ce_mean,
        "dlr": dlr_loss,
        "dlr-targeted": dlr_loss_targeted,
    }
    if name not in table:
        raise ValueError(f"unknown criterion {name!r}; choose from {sorted(table)}")
    return table[name]


def predicted_class(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(-1)


def is_correct(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Accuracy indicator; soft targets compare against their argmax."""
    target = y if y.ndim == 1 else y.argmax(-1)
    return predicted_class(logits) == target
