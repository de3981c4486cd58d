"""Tensor parallelism over the "model" axis, port of
revisiting_at_tpu/parallel/tp.py.

JAX's rule table maps param PATHS to PartitionSpecs and lets XLA split the
block MLPs Megatron's way. The port matches the same table against each
parameter's JAX path (ckpt/convert.py jax_param_path), keeps only this
rank's shard of a matched parameter, and runs the split explicitly:

  * pwconv1 / mlp.fc1 (weight and bias) keep a 4C/tp slice of their OUTPUT
    features ("column"); the block's LayerNorm output enters them through
    `copy_to_model` (identity forward, gradient summed over the group);
  * pwconv2 / mlp.fc2 weights keep the matching slice of their INPUT
    features ("row"); the partial products meet in `reduce_from_model`,
    ONE all-reduce of the C-wide block output, before the (replicated) bias.

A rule that matches a leaf whose sharded dimension tp does not divide
falls back to replicating it (JAX's `_tp_spec`); a block then runs
unsplit. A ViT whose head count tp divides also splits its attention by
heads (JAX's `tp_attn`, models/vit.py:78-90): each rank attends over its
heads of the replicated qkv projection, and the heads are gathered before
the projection. Every other parameter stays whole (and may take the FSDP
rule, parallel/zero.py).

The fused kernels take whole blocks: like JAX (trainer.py:63-68), the
trainer and `cli.eval` refuse tensor parallelism with use_pallas=1.
"""

from __future__ import annotations

import re

from torch import nn

from ..ckpt.convert import core_module, jax_param_path
from .mesh import Mesh, jax_layout

# (JAX path regex, JAX PartitionSpec as a tuple) - first match wins; the
# spec's length must equal the leaf's ndim and every "model"-sharded
# dimension must divide, else the leaf is replicated
TP_RULES: tuple[tuple[str, tuple], ...] = (
    # ConvNeXt and isotropic ConvNeXt block MLP
    (r"pwconv1_kernel$", (None, "model")),
    (r"pwconv1_bias$", ("model",)),
    (r"pwconv2_kernel$", ("model", None)),
    # ViT block MLP
    (r"mlp/fc1/kernel$", (None, "model")),
    (r"mlp/fc1/bias$", ("model",)),
    (r"mlp/fc2/kernel$", ("model", None)),
)

TP_REQUIRES_PLAIN = ("dist.tp > 1 requires training.use_pallas=0: the Pallas custom calls "
                     "are opaque to the SPMD partitioner, and the tensor-parallel path is "
                     "XLA auto-partitioned (parallel/tp.py)")


def _tp_spec(spec: tuple, shape: tuple[int, ...], tp: int) -> tuple | None:
    """JAX's check of a rule against a leaf: ndim must match and every
    "model"-sharded dimension must divide by tp; None -> replicate."""
    if len(spec) != len(shape):
        return None
    for dim, ax in zip(shape, spec):
        if ax is not None and (dim % tp != 0 or dim < tp):
            return None
    return spec


def tp_dims(model: nn.Module, layout: str, tp: int) -> dict[str, int]:
    """{parameter name: the dimension of the port's tensor that the rules
    shard over "model"} for the leaves a rule matches and tp divides."""
    if tp <= 1:
        return {}
    core = core_module(model)
    prefix = "model." if core is not model else ""
    out = {}
    for name, p in core.named_parameters():
        path = jax_param_path(name, layout)
        if path is None:
            continue
        for pattern, spec in TP_RULES:
            if re.search(pattern, path):
                perm = jax_layout(tuple(p.shape))
                ok = _tp_spec(spec, tuple(p.shape[i] for i in perm), tp)
                if ok is not None:
                    out[prefix + name] = perm[ok.index("model")]
                break  # matched but not divisible: replicated
    return out


def _mlp_layers(block: nn.Module):
    """The (fc1, fc2) Linears of a block MLP (timm's mlp.fc1/fc2, or Meta's
    pwconv1/pwconv2), or None."""
    if hasattr(block, "pwconv1"):
        return block.pwconv1, block.pwconv2
    mlp = getattr(block, "mlp", None)
    if mlp is not None and hasattr(mlp, "fc1"):
        return mlp.fc1, mlp.fc2
    return None


def apply_tensor_parallel(model: nn.Module, mesh: Mesh, layout: str) -> dict[str, int]:
    """Shard `model` in place for this rank of the "model" axis: each
    matched parameter keeps its slice, each block whose MLP is split gets
    `tp_group`, and a ViT Attention whose head count tp divides gets
    `tp_group` too. Returns tp_dims (empty when the axis has one rank)."""
    tp, rank, group = mesh.shape["model"], mesh.coords["model"], mesh.groups["model"]
    dims = tp_dims(model, layout, tp)
    params = dict(model.named_parameters())
    for name, dim in dims.items():
        p = params[name]
        p.data = p.data.chunk(tp, dim)[rank].contiguous()
    if tp <= 1:
        return dims
    sharded = {id(p) for name, p in params.items() if name in dims}
    for module in model.modules():
        layers = _mlp_layers(module)
        if layers is not None:
            fc1, fc2 = layers
            split = [id(t) in sharded for t in (fc1.weight, fc1.bias, fc2.weight)]
            if any(split) and not all(split):
                raise ValueError(f"{type(module).__name__}: the TP rules shard part of a block "
                                 f"MLP only ({split})")
            module.tp_group = group if all(split) else None
        if hasattr(module, "num_heads") and hasattr(module, "qkv"):
            module.tp_group = group if module.num_heads % tp == 0 else None
    return dims
