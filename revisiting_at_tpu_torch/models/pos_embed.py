"""ViT positional-embedding interpolation for evaluation at another image
size, port of revisiting_at_tpu/models/pos_embed.py.

The JAX package resizes the patch grid with `jax.image.resize(...,
"bicubic")`, which is not `F.interpolate(mode="bicubic")`: its weights are
the Keys cubic with a = -0.5 (PyTorch's uses -0.75), at half-pixel centres,
with the kernel widened by the scale when shrinking (antialiasing), each
output's weights divided by their sum, and taps whose sample point lies
outside [-0.5, n - 0.5] zeroed. `resize_weights` builds that [n_out, n_in]
matrix; the grid is resized by it separably, rows then columns, in f32.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_out, n_in] f32 bicubic resize matrix, as jax.image.resize builds it."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    w = _keys_cubic(dist / kernel_scale)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).t().contiguous()


def interpolate_pos_encoding(pos_embed: torch.Tensor, new_img_size: int,
                             patch_size: int = 16, num_prefix_tokens: int = 1) -> torch.Tensor:
    """Resize a [1, prefix + N, D] (or [1, N, D] with no prefix token)
    positional embedding to the grid of `new_img_size`; the prefix tokens
    are kept. Unchanged if the grid already matches."""
    n = pos_embed.shape[1] - num_prefix_tokens
    gs_new = new_img_size // patch_size
    if gs_new * gs_new == n:
        return pos_embed
    gs_old = math.isqrt(n)
    if gs_old * gs_old != n:
        raise ValueError(f"non-square patch grid: {n} tokens")
    dim = pos_embed.shape[-1]
    grid = pos_embed[:, num_prefix_tokens:].reshape(gs_old, gs_old, dim).float()
    w = resize_weights(gs_old, gs_new).to(grid.device)
    grid = torch.einsum("ph,hwd->pwd", w, grid)
    grid = torch.einsum("qw,pwd->pqd", w, grid)
    patch = grid.reshape(1, gs_new * gs_new, dim).to(pos_embed.dtype)
    return torch.cat([pos_embed[:, :num_prefix_tokens], patch], dim=1)


def resize_vit_pos_embed(state_dict: Mapping[str, torch.Tensor], new_img_size: int,
                         patch_size: int = 16) -> dict[str, torch.Tensor]:
    """A copy of a ViT state_dict with `pos_embed` resized for
    `new_img_size`. A perfect-square token count is the no_embed_class
    layout (no class-token position), any other has one prefix token."""
    out = dict(state_dict)
    for key, v in state_dict.items():
        if key.split(".")[-1] == "pos_embed":
            ntok = v.shape[1]
            prefix = 0 if math.isqrt(ntok) ** 2 == ntok else 1
            out[key] = interpolate_pos_encoding(v, new_img_size, patch_size, prefix)
    return out
