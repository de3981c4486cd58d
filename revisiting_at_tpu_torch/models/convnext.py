"""ConvNeXt (T/S/B/L), port of revisiting_at_tpu/models/convnext.py.

NHWC activations, f32 parameters cast to the compute dtype at use, and
timm-0.8 module names (stem, stages.<s>.downsample / .blocks.<b>, head), so
a state_dict is the reference checkpoint format.

  block: dwconv7x7 -> LN -> Dense(4C) -> GELU -> Dense(C) -> gamma * .
         -> DropPath -> + residual
  head:  global average pool (f32) -> LN -> Dense(num_classes) in f32

The block tail has two paths with one set of parameters: plain PyTorch ops
with erf GELU, or the fused tail of ops/block_mlp.py (tanh GELU, bf16
matmul operands) when `use_pallas` and `tail_fusable(C, grad_mode, wide)`.
The flag keeps the JAX package's name. The 7x7 depthwise conv is
PyTorch's, as the JAX package leaves it to XLA.

DropPath is active in train mode (`model.train()`) for blocks with a
non-zero rate: each block draws a per-sample keep of mask / keep_p, the
mask Bernoulli(keep_p), from the model's `drop_generator` (None: PyTorch's
default generator), which a caller may replace to control the draws.
The isotropic ConvNeXt waits for ROADMAP A3.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.block_mlp import convnext_block_tail, tail_fusable
from .layers import Conv, LayerNorm, to_nchw, to_nhwc, trunc_normal_
from .stems import PatchifyStem


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        for fc in (self.fc1, self.fc2):
            trunc_normal_(fc.weight)
            nn.init.zeros_(fc.bias)


def _layer_norm_f32(s, g, b, eps=1e-6):
    sf = s.float()
    mu = sf.mean(-1, keepdim=True)
    var = ((sf - mu) ** 2).mean(-1, keepdim=True)
    return (sf - mu) * torch.rsqrt(var + eps) * g + b


def plain_tail(s, x, ln_g, ln_b, w1, b1, w2, b2, gamma, dtype, keep=None):
    """The block tail of the plain model path: f32 LayerNorm, then Dense(4C),
    erf GELU and Dense(C) in `dtype`, LayerScale, the per-sample DropPath
    scale `keep` ([B] or None) and the residual. w1 and w2 are nn.Linear
    weights ([4C, C] and [C, 4C])."""
    u = _layer_norm_f32(s, ln_g, ln_b).to(dtype)
    h = F.linear(u, w1.to(dtype), b1.to(dtype))
    o = F.linear(F.gelu(h), w2.to(dtype), b2.to(dtype))
    o = o * gamma.to(o.dtype)
    if keep is not None:
        o = o * keep.to(o.dtype).reshape(-1, 1, 1, 1)
    return x + o


def drop_path_keep(batch: int, drop_path: float, generator: torch.Generator | None,
                   device) -> torch.Tensor:
    """Per-sample DropPath scale [batch] f32: mask / keep_p, mask ~ Bernoulli(keep_p)."""
    keep_p = 1.0 - drop_path
    u = torch.rand(batch, generator=generator, device=generator.device if generator else device)
    return (u < keep_p).float().to(device) / keep_p


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, drop_path: float = 0.0, layer_scale_init: float = 1e-6,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 wide_tail: bool = False):
        super().__init__()
        self.dim, self.drop_path, self.dtype = dim, drop_path, dtype
        self.use_pallas, self.wide_tail = use_pallas, wide_tail
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        trunc_normal_(self.conv_dw.weight)
        nn.init.zeros_(self.conv_dw.bias)
        self.norm = LayerNorm(dim)  # parameters only: applied inside the tail
        self.mlp = Mlp(dim, 4 * dim)
        if layer_scale_init > 0:
            self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))
        else:
            self.register_buffer("gamma", torch.ones(dim), persistent=False)

    def forward(self, x: torch.Tensor, grad_mode: str = "full",
                generator: torch.Generator | None = None) -> torch.Tensor:
        C, dt = self.dim, self.dtype
        keep = None
        if self.drop_path > 0.0 and self.training:
            keep = drop_path_keep(x.shape[0], self.drop_path, generator, x.device)
        s = to_nhwc(F.conv2d(to_nchw(x.to(dt)), self.conv_dw.weight.to(dt),
                             self.conv_dw.bias.to(dt), padding=3, groups=C))
        ln_g, ln_b = self.norm.weight, self.norm.bias
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        if self.use_pallas and tail_fusable(C, grad_mode, wide=self.wide_tail):
            return convnext_block_tail(
                s, x, keep, ln_g, ln_b, fc1.weight.t(), fc1.bias, fc2.weight.t(), fc2.bias,
                self.gamma, grad_mode=grad_mode)
        return plain_tail(s, x, ln_g, ln_b, fc1.weight, fc1.bias, fc2.weight, fc2.bias,
                          self.gamma, dt, keep)


class ConvNeXt(nn.Module):
    """ConvNeXt with a pluggable stem: `stem_factory(dtype=, use_blurpool=)`
    returns a module mapping NHWC images to the stage-0 map (/4, dims[0]
    channels); default the patchify stem.

    `grad_mode` ('full' or 'input') is handed to every block; the attacks
    set 'input' through train.train_step.input_grad_view (eval) or
    attack_grad_mode (training, scoped). `drop_generator` feeds DropPath."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), num_classes: int = 1000,
                 drop_path_rate: float = 0.0, layer_scale_init: float = 1e-6,
                 dtype: torch.dtype = torch.float32,
                 stem_factory: Callable[..., nn.Module] | None = None,
                 use_blurpool: bool = False, use_pallas: bool = False,
                 wide_tail: bool = False):
        super().__init__()
        self.dtype = dtype
        self.grad_mode = "full"
        self.drop_generator: torch.Generator | None = None
        if stem_factory is not None:
            self.stem = stem_factory(dtype=dtype, use_blurpool=use_blurpool)
        else:
            self.stem = PatchifyStem(dims[0], dtype=dtype, use_blurpool=use_blurpool)
        total = sum(depths)
        dp_rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        stages, cur = [], 0
        for si, (depth, dim) in enumerate(zip(depths, dims)):
            stage = nn.Module()
            if si > 0:
                stage.downsample = nn.Sequential(
                    LayerNorm(dims[si - 1], dtype=dtype),
                    Conv(dims[si - 1], dim, 2, stride=2, dtype=dtype, use_blurpool=use_blurpool),
                )
            else:
                stage.downsample = nn.Identity()
            stage.blocks = nn.ModuleList(
                ConvNeXtBlock(dim, dp_rates[cur + bi], layer_scale_init, dtype, use_pallas,
                              wide_tail)
                for bi in range(depth)
            )
            cur += depth
            stages.append(stage)
        self.stages = nn.ModuleList(stages)
        self.head = nn.Module()
        self.head.norm = LayerNorm(dims[-1], dtype=dtype)
        self.head.fc = nn.Linear(dims[-1], num_classes)
        trunc_normal_(self.head.fc.weight)
        nn.init.zeros_(self.head.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] in [0, 1] (after any normalizer) -> f32 logits."""
        x = self.stem(x)
        for stage in self.stages:
            x = stage.downsample(x)
            for block in stage.blocks:
                x = block(x, self.grad_mode, self.drop_generator)
        x = x.float().mean(dim=(1, 2))
        x = self.head.norm(x.to(self.dtype))
        return F.linear(x.float(), self.head.fc.weight, self.head.fc.bias)


CONVNEXT_CFGS = {
    "tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
}
