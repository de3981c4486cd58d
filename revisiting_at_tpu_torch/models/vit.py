"""Vision Transformer (ViT-S / DeiT-S / DeiT3-Medium / ViT-B), port of
revisiting_at_tpu/models/vit.py.

[B, N, D] tokens, f32 parameters cast to the compute dtype at use, and
timm-0.8 names (cls_token, pos_embed, patch_embed.proj, blocks.<i>.norm1 /
attn.qkv / attn.proj / ls1.gamma / norm2 / mlp.fc1 / mlp.fc2 / ls2.gamma,
norm, head), so a state_dict is the reference checkpoint format.

  block: x + ls1 * attn(norm1(x)), then x + ls2 * mlp(norm2(x)), each
         branch through DropPath; LayerScale (ls1, ls2) only with
         `init_values` (DeiT3 / vit_m)
  head:  norm, then Dense(num_classes) in f32 on the class token

With `use_pallas` the attention is the fused kernel of ops/attention.py
(`attn_impl='qkv'` on the qkv Dense output; 'bhnd' through the
[B, N, H, hd] wrapper), and the MLP tail the fused block tail of
ops/block_mlp.py where `tail_fusable(D, grad_mode, wide)` admits it (tanh
GELU, bf16 matmul operands; without `init_values` its gamma is a constant
ones buffer). The plain path writes the attention out with f32 scores,
an f32 softmax, the probabilities cast to the activation dtype and PV in
that dtype, and the MLP with erf GELU.

The image size fixes the token count, and so pos_embed's shape, at
construction. DropPath is active in train mode for blocks with a non-zero
rate: both branches of a block draw a per-sample keep from the model's
`drop_generator`, as in models/convnext.py. `remat` recomputes each block
in the backward as models/convnext.py does, the keeps drawn before the
checkpointed call.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_attention, fused_attention_qkv
from ..ops.block_mlp import tail_fusable, vit_mlp_tail
from ..parallel.collectives import (copy_to_model, gather_from_model, reduce_from_model,
                                    slice_to_model)
from .convnext import Mlp, drop_path_keep, run_block
from .layers import LayerNorm, trunc_normal_
from .stems import PatchEmbed


def _linear(dim_in: int, dim_out: int) -> nn.Linear:
    fc = nn.Linear(dim_in, dim_out)
    trunc_normal_(fc.weight)
    nn.init.zeros_(fc.bias)
    return fc


def _dense(x, fc: nn.Linear, dtype):
    return F.linear(x.to(dtype), fc.weight.to(dtype), fc.bias.to(dtype))


def plain_attention(qkv: torch.Tensor, num_heads: int, dtype: torch.dtype) -> torch.Tensor:
    """The model path's attention (use_pallas=0) on qkv [B, N, 3D]: f32
    scores scaled after the product, f32 softmax, the probabilities cast to
    `dtype`, PV in `dtype`. Returns [B, N, D]."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    q, k, v = qkv.reshape(B, N, 3, num_heads, D // num_heads).unbind(2)  # [B, N, H, hd]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (D // num_heads) ** -0.5
    p = torch.softmax(s, dim=-1).to(dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p, v.to(dtype)).reshape(B, N, D)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 use_pallas: bool = False, attn_impl: str = "qkv"):
        super().__init__()
        if attn_impl not in ("qkv", "bhnd"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.num_heads, self.dtype = num_heads, dtype
        self.use_pallas, self.attn_impl = use_pallas, attn_impl
        self.qkv = _linear(dim, 3 * dim)
        self.proj = _linear(dim, dim)
        # the "model" group when the heads are split over it (parallel/tp.py):
        # each rank attends over H / tp heads of the replicated qkv
        self.tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        H, dt = self.num_heads, self.dtype
        qkv = _dense(x, self.qkv, dt)
        if self.use_pallas and self.attn_impl == "qkv":
            return _dense(fused_attention_qkv(qkv, H), self.proj, dt)
        if self.use_pallas:
            q, k, v = qkv.reshape(B, N, 3, H, D // H).unbind(2)  # [B, N, H, hd]
            out = fused_attention(q, k, v).reshape(B, N, D)
        elif self.tp_group is not None:
            heads = slice_to_model(qkv.reshape(B, N, 3, H, D // H), 3, self.tp_group)
            h = heads.shape[3]
            out = plain_attention(heads.reshape(B, N, 3 * h * (D // H)), h, x.dtype)
            out = gather_from_model(out.reshape(B, N, h, D // H), 2, self.tp_group)
            out = out.reshape(B, N, D)
        else:
            out = plain_attention(qkv, H, x.dtype)
        return _dense(out, self.proj, dt)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_values))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, init_values: float | None = None,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 attn_impl: str = "qkv", wide_tail: bool = False):
        super().__init__()
        self.dim, self.drop_path, self.dtype = dim, drop_path, dtype
        self.use_pallas, self.wide_tail = use_pallas, wide_tail
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = Attention(dim, num_heads, dtype, use_pallas, attn_impl)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if init_values is not None:
            self.ls1 = LayerScale(dim, init_values)
            self.ls2 = LayerScale(dim, init_values)
        else:
            self.ls1 = self.ls2 = None
            # the fused tail's gamma when there is no LayerScale
            self.register_buffer("ones", torch.ones(dim), persistent=False)
        self.tp_group = None  # the "model" group when its MLP is split (parallel/tp.py)

    def forward(self, x: torch.Tensor, grad_mode: str = "full",
                generator: torch.Generator | None = None, remat: bool = False) -> torch.Tensor:
        keep1 = keep2 = None
        if self.drop_path > 0.0 and self.training:
            keep1 = drop_path_keep(x.shape[0], self.drop_path, generator, x.device)
            keep2 = drop_path_keep(x.shape[0], self.drop_path, generator, x.device)
        return run_block(self.body, remat, x, keep1, keep2, grad_mode)

    def body(self, x: torch.Tensor, keep1: torch.Tensor | None, keep2: torch.Tensor | None,
             grad_mode: str) -> torch.Tensor:
        dt = self.dtype
        y = self.attn(self.norm1(x))
        if self.ls1 is not None:
            y = self.ls1(y)
        if keep1 is not None:
            y = y * keep1.to(y.dtype).reshape(-1, 1, 1)
        x = x + y
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        if self.use_pallas and tail_fusable(self.dim, grad_mode, wide=self.wide_tail):
            gamma = self.ls2.gamma if self.ls2 is not None else self.ones
            return vit_mlp_tail(x, keep2, self.norm2.weight, self.norm2.bias, fc1.weight.t(),
                                fc1.bias, fc2.weight.t(), fc2.bias, gamma,
                                grad_mode=grad_mode).to(dt)
        if self.tp_group is None:
            y = _dense(F.gelu(_dense(self.norm2(x), fc1, dt)), fc2, dt)  # erf GELU
        else:  # this rank's column and row shards, summed over the group before the bias
            h = F.gelu(_dense(copy_to_model(self.norm2(x), self.tp_group), fc1, dt))
            y = reduce_from_model(F.linear(h.to(dt), fc2.weight.to(dt)), self.tp_group)
            y = y + fc2.bias.to(dt)
        if self.ls2 is not None:
            y = self.ls2(y)
        if keep2 is not None:
            y = y * keep2.to(y.dtype).reshape(-1, 1, 1)
        return x + y


class VisionTransformer(nn.Module):
    """ViT with a pluggable patch embedding: `embed_factory(dtype=,
    use_blurpool=)` returns the module (a ConvStem) that maps NHWC images to
    the [B, H/P, W/P, D] patch map, mounted at `patch_embed.proj` as the
    reference mounts it; default a k16 s16 conv.

    `grad_mode` ('full' or 'input') is handed to every block, as in
    ConvNeXt; `drop_generator` feeds DropPath; `remat` recomputes each
    block in the backward."""

    def __init__(self, embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, num_classes: int = 1000, patch_size: int = 16,
                 img_size: int = 224, drop_path_rate: float = 0.0,
                 init_values: float | None = None, no_embed_class: bool = False,
                 dtype: torch.dtype = torch.float32,
                 embed_factory: Callable[..., nn.Module] | None = None,
                 use_blurpool: bool = False, use_pallas: bool = False,
                 attn_impl: str = "qkv", wide_tail: bool = False, remat: bool = False):
        super().__init__()
        self.dtype, self.remat = dtype, remat
        self.no_embed_class = no_embed_class
        self.grad_mode = "full"
        self.drop_generator: torch.Generator | None = None
        if embed_factory is not None:
            self.patch_embed = nn.Module()
            self.patch_embed.proj = embed_factory(dtype=dtype, use_blurpool=use_blurpool)
        else:
            self.patch_embed = PatchEmbed(embed_dim, patch_size, dtype=dtype,
                                          use_blurpool=use_blurpool)
        n_patches = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.empty(1, n_patches + (0 if no_embed_class else 1), embed_dim))
        trunc_normal_(self.pos_embed)
        dp = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, dp[i], init_values, dtype, use_pallas,
                     attn_impl, wide_tail) for i in range(depth))
        self.norm = LayerNorm(embed_dim, dtype=dtype)
        self.head = _linear(embed_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] in [0, 1] (after any normalizer) -> f32 logits."""
        feat = self.patch_embed.proj(x)
        B, Hp, Wp, D = feat.shape
        tokens = feat.reshape(B, Hp * Wp, D)
        cls = self.cls_token.to(tokens.dtype).expand(B, 1, D)
        pos = self.pos_embed.to(tokens.dtype)
        if self.no_embed_class:
            tokens = torch.cat([cls, tokens + pos], dim=1)
        else:
            tokens = torch.cat([cls, tokens], dim=1) + pos
        for block in self.blocks:
            tokens = block(tokens, self.grad_mode, self.drop_generator, self.remat)
        cls_out = self.norm(tokens[:, 0])  # LayerNorm is per token: the class token's
        return F.linear(cls_out.float(), self.head.weight, self.head.bias)


VIT_CFGS = {
    # timm vit_small_patch16_224
    "s": dict(embed_dim=384, depth=12, num_heads=6),
    # timm deit_small_patch16_224
    "deit_s": dict(embed_dim=384, depth=12, num_heads=6),
    # timm deit3_medium_patch16_224
    "m": dict(embed_dim=512, depth=12, num_heads=8, init_values=1e-6, no_embed_class=True),
    # timm vit_base_patch16_224
    "b": dict(embed_dim=768, depth=12, num_heads=12),
}
