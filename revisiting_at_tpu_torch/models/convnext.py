"""ConvNeXt (T/S/B/L) and the isotropic ConvNeXt, port of
revisiting_at_tpu/models/convnext.py.

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
PyTorch's (cuDNN on the card) on weights and bias cast to the compute
dtype, as the JAX package leaves it to XLA; with `use_pallas_dwconv` a
block of width C <= 384 takes ops/dwconv.py's kernel instead, on the f32
weight and bias, as the JAX package's gate of the same name does. Neither
factory nor config sets that flag, in either package: a caller builds
ConvNeXt(use_pallas_dwconv=True) directly. The isotropic model has no such
flag in JAX.

DropPath is active in train mode (`model.train()`) for blocks with a
non-zero rate: each block draws a per-sample keep of mask / keep_p, the
mask Bernoulli(keep_p), from the model's `drop_generator` (None: PyTorch's
default generator), which a caller may replace to control the draws.

With `remat` (training.remat, JAX's nn.remat per block) each block keeps
only its input for the backward and runs its forward again there, through
torch.utils.checkpoint, whenever gradients are recorded (the attacks'
input gradients too, as in JAX). The keep vector is drawn before the
checkpointed call and handed to it: checkpoint restores the default RNGs
but not an explicit generator, so a draw inside would differ on the
recompute.

ConvNeXtIsotropic (JAX `ConvNeXtIsotropic`, the reference's
models/convnext_iso.py): a /16 patchify conv or a ConvStem, `depth` blocks
of one width, mean pool, LayerNorm and head, under the reference's Meta
names (stem, blocks.<i>.dwconv/norm/pwconv1/pwconv2, norm, head), so that
the JAX package's export of a convnext_iso strict-loads. Its default
layer_scale_init = 0 makes gamma a constant of ones, not a parameter; the
fused tail takes it all the same. Its 7x7 conv is always the library's.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.block_mlp import convnext_block_tail, tail_fusable
from ..ops.dwconv import dwconv7x7
from ..parallel.collectives import copy_to_model, reduce_from_model
from .layers import Conv, LayerNorm, to_nchw, to_nhwc, trunc_normal_
from .stems import PatchifyStem


def _linear(cin: int, cout: int) -> nn.Linear:
    fc = nn.Linear(cin, cout)
    trunc_normal_(fc.weight)
    nn.init.zeros_(fc.bias)
    return fc


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


def plain_tail(s, x, ln_g, ln_b, w1, b1, w2, b2, gamma, dtype, keep=None, tp_group=None):
    """The block tail of the plain model path: f32 LayerNorm, then Dense(4C),
    erf GELU and Dense(C) in `dtype`, LayerScale, the per-sample DropPath
    scale `keep` ([B] or None) and the residual. w1 and w2 are nn.Linear
    weights ([4C, C] and [C, 4C]). With `tp_group` they are this rank's
    column and row shards (parallel/tp.py): the partial Dense(C) outputs
    are summed over the group before the bias."""
    u = _layer_norm_f32(s, ln_g, ln_b).to(dtype)
    if tp_group is not None:
        u = copy_to_model(u, tp_group)
    h = F.linear(u, w1.to(dtype), b1.to(dtype))
    if tp_group is None:
        o = F.linear(F.gelu(h), w2.to(dtype), b2.to(dtype))
    else:
        o = reduce_from_model(F.linear(F.gelu(h), w2.to(dtype)), tp_group) + b2.to(dtype)
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


def run_block(body, remat: bool, *args):
    """body(*args), or under torch.utils.checkpoint with remat while
    gradients are recorded. body draws nothing: its randomness comes in args."""
    if remat and torch.is_grad_enabled():
        return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False)
    return body(*args)


class ConvNeXtBlock(nn.Module):
    """The block under timm's names (conv_dw, norm, mlp.fc1, mlp.fc2,
    gamma), or with `meta_names` under Meta's (dwconv, norm, pwconv1,
    pwconv2), which the isotropic model's checkpoints use."""

    def __init__(self, dim: int, drop_path: float = 0.0, layer_scale_init: float = 1e-6,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 wide_tail: bool = False, use_pallas_dwconv: bool = False,
                 meta_names: bool = False):
        super().__init__()
        self.dim, self.drop_path, self.dtype = dim, drop_path, dtype
        self.use_pallas, self.wide_tail = use_pallas, wide_tail
        self.use_pallas_dwconv = use_pallas_dwconv
        conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        trunc_normal_(conv_dw.weight)
        nn.init.zeros_(conv_dw.bias)
        if meta_names:
            self.dwconv = conv_dw
            self.norm = LayerNorm(dim)  # parameters only: applied inside the tail
            mlp = Mlp(dim, 4 * dim)
            self.pwconv1, self.pwconv2 = fc1, fc2 = mlp.fc1, mlp.fc2
        else:
            self.conv_dw = conv_dw
            self.norm = LayerNorm(dim)
            self.mlp = Mlp(dim, 4 * dim)
            fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        self._layers = (conv_dw, fc1, fc2)  # a tuple: not registered a second time
        self.tp_group = None  # the "model" group when its MLP is split (parallel/tp.py)
        if layer_scale_init > 0:
            self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))
        else:
            self.register_buffer("gamma", torch.ones(dim), persistent=False)

    def forward(self, x: torch.Tensor, grad_mode: str = "full",
                generator: torch.Generator | None = None, remat: bool = False) -> torch.Tensor:
        keep = None
        if self.drop_path > 0.0 and self.training:
            keep = drop_path_keep(x.shape[0], self.drop_path, generator, x.device)
        return run_block(self.body, remat, x, keep, grad_mode)

    def body(self, x: torch.Tensor, keep: torch.Tensor | None, grad_mode: str) -> torch.Tensor:
        C, dt = self.dim, self.dtype
        conv_dw, fc1, fc2 = self._layers
        if self.use_pallas_dwconv and C <= 384:
            # the kernel route reads the f32 weight ([C, 1, 7, 7] -> [7, 7, 1, C]) and bias
            s = dwconv7x7(x.to(dt), conv_dw.weight.permute(2, 3, 1, 0), conv_dw.bias)
        else:
            s = to_nhwc(F.conv2d(to_nchw(x.to(dt)), conv_dw.weight.to(dt),
                                 conv_dw.bias.to(dt), padding=3, groups=C))
        ln_g, ln_b = self.norm.weight, self.norm.bias
        if self.use_pallas and tail_fusable(C, grad_mode, wide=self.wide_tail):
            return convnext_block_tail(
                s, x, keep, ln_g, ln_b, fc1.weight.t(), fc1.bias, fc2.weight.t(), fc2.bias,
                self.gamma, grad_mode=grad_mode)
        return plain_tail(s, x, ln_g, ln_b, fc1.weight, fc1.bias, fc2.weight, fc2.bias,
                          self.gamma, dt, keep, self.tp_group)


class ConvNeXt(nn.Module):
    """ConvNeXt with a pluggable stem: `stem_factory(dtype=, use_blurpool=)`
    returns a module mapping NHWC images to the stage-0 map (/4, dims[0]
    channels); default the patchify stem.

    `use_pallas_dwconv` gives the blocks of width C <= 384 the dwconv
    kernel. `grad_mode` ('full' or 'input') is handed to every block; the
    attacks set 'input' through train.train_step.input_grad_view (eval) or
    attack_grad_mode (training, scoped). `drop_generator` feeds DropPath;
    `remat` recomputes each block in the backward."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), num_classes: int = 1000,
                 drop_path_rate: float = 0.0, layer_scale_init: float = 1e-6,
                 dtype: torch.dtype = torch.float32,
                 stem_factory: Callable[..., nn.Module] | None = None,
                 use_blurpool: bool = False, use_pallas: bool = False,
                 wide_tail: bool = False, use_pallas_dwconv: bool = False,
                 remat: bool = False):
        super().__init__()
        self.dtype, self.remat = dtype, remat
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
                              wide_tail, use_pallas_dwconv)
                for bi in range(depth)
            )
            cur += depth
            stages.append(stage)
        self.stages = nn.ModuleList(stages)
        self.head = nn.Module()
        self.head.norm = LayerNorm(dims[-1], dtype=dtype)
        self.head.fc = _linear(dims[-1], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] in [0, 1] (after any normalizer) -> f32 logits."""
        x = self.stem(x)
        for stage in self.stages:
            x = stage.downsample(x)
            for block in stage.blocks:
                x = block(x, self.grad_mode, self.drop_generator, self.remat)
        x = x.float().mean(dim=(1, 2))
        x = self.head.norm(x.to(self.dtype))
        return F.linear(x.float(), self.head.fc.weight, self.head.fc.bias)


class ConvNeXtIsotropic(nn.Module):
    """Isotropic ConvNeXt: constant width and resolution, a /16 patchify
    conv (or `stem_factory(dtype=, use_blurpool=)`, a ConvStem to `dim`
    channels), `depth` blocks, mean pool, LayerNorm and head. DropPath rate
    i / (depth - 1) of drop_path_rate in block i; `grad_mode`,
    `drop_generator` and `remat` as in ConvNeXt. `wide_tail` changes
    nothing at the iso widths (<= 432), as in JAX."""

    def __init__(self, dim: int = 384, depth: int = 18, num_classes: int = 1000,
                 drop_path_rate: float = 0.0, layer_scale_init: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 stem_factory: Callable[..., nn.Module] | None = None,
                 use_blurpool: bool = False, use_pallas: bool = False,
                 wide_tail: bool = False, remat: bool = False):
        super().__init__()
        self.dtype, self.remat = dtype, remat
        self.grad_mode = "full"
        self.drop_generator: torch.Generator | None = None
        if stem_factory is not None:
            self.stem = stem_factory(dtype=dtype, use_blurpool=use_blurpool)
        else:  # JAX's plain stem takes no blurpool
            self.stem = Conv(3, dim, 16, stride=16, dtype=dtype)
        dp_rates = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = nn.ModuleList(
            ConvNeXtBlock(dim, dp_rates[i], layer_scale_init, dtype, use_pallas, wide_tail,
                          meta_names=True) for i in range(depth))
        self.norm = LayerNorm(dim, dtype=dtype)
        self.head = _linear(dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] in [0, 1] (after any normalizer) -> f32 logits."""
        x = self.stem(x)
        for block in self.blocks:
            x = block(x, self.grad_mode, self.drop_generator, self.remat)
        x = x.float().mean(dim=(1, 2))
        x = self.norm(x.to(self.dtype))
        return F.linear(x.float(), self.head.weight, self.head.bias)


CONVNEXT_CFGS = {
    "tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
}
