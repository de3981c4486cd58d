"""Checkpoints: the JAX param tree to the port's state_dict, and .pt files.

The port's module names are timm-0.8's, so its native state_dict is the
reference checkpoint format, and the output of the JAX package's
`python -m revisiting_at_tpu.cli.export` strict-loads into the port.

`jax_params_to_state_dict` takes the JAX package's param tree as nested
dicts of numpy arrays (no JAX needed) of a ConvNeXt, an isotropic ConvNeXt,
a ViT or a model of the BN family (with its batch_stats tree), maps each
leaf to its reference name by the family's patterns (a ConvStem's convs
and LNs go to stem.stem.<i> in a ConvNeXt or an isotropic ConvNeXt, to
patch_embed.proj.stem.<i> in a ViT; the ViT and iso stems' 1x1 proj follows
at index 12; the isotropic model takes Meta's names, head_norm -> norm) and
does the layout inversions:

  kernel [in, out]        -> Linear    [out, in]
  kernel [kh, kw, I, O]   -> Conv2d    [O, I, kh, kw]
  kernel [kh, kw, 1, C]   -> depthwise [C, 1, kh, kw]

The BN family (torchvision names) is the inverse of the JAX package's
BN_MAPPERS (revisiting_at_tpu/ckpt/torch_import.py:389-395): each
BatchNorm's scale and bias -> weight and bias, its batch_stats mean and
var -> running_mean and running_var, and num_batches_tracked 0.
`jax_param_path` maps a parameter name of the port's BN models back to its
JAX path, for the weight-decay rule (train/optimizer.py).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from ..models.factory import model_family
from ..models.layers import NormalizedModel


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, Mapping):
        out: dict[str, np.ndarray] = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def _conv(w):  # [kh, kw, I, O] -> [O, I, kh, kw]
    return np.transpose(w, (3, 2, 0, 1))


def _lin(w):  # [in, out] -> [out, in]
    return np.transpose(w, (1, 0))


_LN = {"scale": "weight", "bias": "bias"}
_BLOCK = {
    "dwconv_kernel": ("conv_dw.weight", _conv),
    "dwconv_bias": ("conv_dw.bias", None),
    "norm_scale": ("norm.weight", None),
    "norm_bias": ("norm.bias", None),
    "pwconv1_kernel": ("mlp.fc1.weight", _lin),
    "pwconv1_bias": ("mlp.fc1.bias", None),
    "pwconv2_kernel": ("mlp.fc2.weight", _lin),
    "pwconv2_bias": ("mlp.fc2.bias", None),
    "gamma": ("gamma", None),
}


def _kernel_or_bias(m, prefix: str, tf=_conv):
    return (f"{prefix}.{'weight' if m == 'kernel' else 'bias'}", tf if m == "kernel" else None)


def _stem_patterns(prefix: str):
    """A ConvStem's leaves: conv{i} at Sequential index 3i, its LayerNorm at
    3i + 1, the ViT stems' 1x1 proj after the four stages, at 12."""
    return [
        (r"ConvStem\d*_\d+/conv(\d+)/Conv_0/(kernel|bias)$",
         lambda m: _kernel_or_bias(m[2], f"{prefix}.{3 * int(m[1])}")),
        (r"ConvStem\d*_\d+/norm(\d+)/LayerNorm_0/(scale|bias)$",
         lambda m: (f"{prefix}.{3 * int(m[1]) + 1}.{_LN[m[2]]}", None)),
        (r"ConvStem\d*_\d+/proj/Conv_0/(kernel|bias)$",
         lambda m: _kernel_or_bias(m[1], f"{prefix}.12")),
    ]


_CONVNEXT_PATTERNS = _stem_patterns("stem.stem")[:2] + [
    (r"stem/proj/Conv_0/(kernel|bias)$", lambda m: _kernel_or_bias(m[1], "stem.0")),
    (r"stem/norm/LayerNorm_0/(scale|bias)$", lambda m: (f"stem.1.{_LN[m[1]]}", None)),
    (r"downsample_norm(\d+)/LayerNorm_0/(scale|bias)$",
     lambda m: (f"stages.{m[1]}.downsample.0.{_LN[m[2]]}", None)),
    (r"downsample_conv(\d+)/Conv_0/(kernel|bias)$",
     lambda m: _kernel_or_bias(m[2], f"stages.{m[1]}.downsample.1")),
    (r"stage(\d+)_block(\d+)/(\w+)$",
     lambda m: (f"stages.{m[1]}.blocks.{m[2]}.{_BLOCK[m[3]][0]}", _BLOCK[m[3]][1])),
    (r"head_norm/LayerNorm_0/(scale|bias)$", lambda m: (f"head.norm.{_LN[m[1]]}", None)),
    (r"head/(kernel|bias)$", lambda m: _kernel_or_bias(m[1], "head.fc", _lin)),
]
_VIT_PATTERNS = _stem_patterns("patch_embed.proj.stem") + [
    (r"(cls_token|pos_embed)$", lambda m: (m[1], None)),
    (r"patch_embed/proj/Conv_0/(kernel|bias)$",
     lambda m: _kernel_or_bias(m[1], "patch_embed.proj")),
    (r"block(\d+)/(norm[12])/LayerNorm_0/(scale|bias)$",
     lambda m: (f"blocks.{m[1]}.{m[2]}.{_LN[m[3]]}", None)),
    (r"block(\d+)/(attn|mlp)/(qkv|proj|fc1|fc2)/(kernel|bias)$",
     lambda m: _kernel_or_bias(m[4], f"blocks.{m[1]}.{m[2]}.{m[3]}", _lin)),
    (r"block(\d+)/(ls[12])$", lambda m: (f"blocks.{m[1]}.{m[2]}.gamma", None)),
    (r"norm/LayerNorm_0/(scale|bias)$", lambda m: (f"norm.{_LN[m[1]]}", None)),
    (r"head/(kernel|bias)$", lambda m: _kernel_or_bias(m[1], "head", _lin)),
]

_ISO_BLOCK = {"dwconv_kernel": ("dwconv.weight", _conv), "dwconv_bias": ("dwconv.bias", None),
              "norm_scale": ("norm.weight", None), "norm_bias": ("norm.bias", None),
              "pwconv1_kernel": ("pwconv1.weight", _lin), "pwconv1_bias": ("pwconv1.bias", None),
              "pwconv2_kernel": ("pwconv2.weight", _lin), "pwconv2_bias": ("pwconv2.bias", None),
              "gamma": ("gamma", None)}
_ISO_PATTERNS = _stem_patterns("stem.stem") + [
    (r"stem/Conv_0/(kernel|bias)$", lambda m: _kernel_or_bias(m[1], "stem")),
    (r"block(\d+)/(\w+)$",
     lambda m: (f"blocks.{m[1]}.{_ISO_BLOCK[m[2]][0]}", _ISO_BLOCK[m[2]][1])),
    (r"head_norm/LayerNorm_0/(scale|bias)$", lambda m: (f"norm.{_LN[m[1]]}", None)),
    (r"head/(kernel|bias)$", lambda m: _kernel_or_bias(m[1], "head", _lin)),
]

# The BN family's module names, JAX path <-> torchvision name, one rule a
# row: (JAX pattern, its torch name, torch pattern, its JAX path). The
# Inception tables are torchvision's branch names -> the JAX package's
# (revisiting_at_tpu/ckpt/torch_import.py:321-358).
_INC_STEM = {"Conv2d_1a_3x3": "Conv2d_1a", "Conv2d_2a_3x3": "Conv2d_2a",
             "Conv2d_2b_3x3": "Conv2d_2b", "Conv2d_3b_1x1": "Conv2d_3b",
             "Conv2d_4a_3x3": "Conv2d_4a"}
_INC_A = {"branch1x1": "b1x1", "branch5x5_1": "b5_1", "branch5x5_2": "b5_2",
          "branch3x3dbl_1": "b3_1", "branch3x3dbl_2": "b3_2", "branch3x3dbl_3": "b3_3",
          "branch_pool": "bpool"}
_INC_B = {"branch3x3": "b3", "branch3x3dbl_1": "bd_1", "branch3x3dbl_2": "bd_2",
          "branch3x3dbl_3": "bd_3"}
_INC_C = {"branch1x1": "b1x1", "branch7x7_1": "b7_1", "branch7x7_2": "b7_2",
          "branch7x7_3": "b7_3", "branch7x7dbl_1": "bd_1", "branch7x7dbl_2": "bd_2",
          "branch7x7dbl_3": "bd_3", "branch7x7dbl_4": "bd_4", "branch7x7dbl_5": "bd_5",
          "branch_pool": "bpool"}
_INC_D = {"branch3x3_1": "b3_1", "branch3x3_2": "b3_2", "branch7x7x3_1": "b7_1",
          "branch7x7x3_2": "b7_2", "branch7x7x3_3": "b7_3", "branch7x7x3_4": "b7_4"}
_INC_E = {"branch1x1": "b1x1", "branch3x3_1": "b3_1", "branch3x3_2a": "b3_2a",
          "branch3x3_2b": "b3_2b", "branch3x3dbl_1": "bd_1", "branch3x3dbl_2": "bd_2",
          "branch3x3dbl_3a": "bd_3a", "branch3x3dbl_3b": "bd_3b", "branch_pool": "bpool"}
_INC_BLOCKS = {"Mixed_5b": _INC_A, "Mixed_5c": _INC_A, "Mixed_5d": _INC_A, "Mixed_6a": _INC_B,
               "Mixed_6b": _INC_C, "Mixed_6c": _INC_C, "Mixed_6d": _INC_C, "Mixed_6e": _INC_C,
               "Mixed_7a": _INC_D, "Mixed_7b": _INC_E, "Mixed_7c": _INC_E}


def _inv(d: dict) -> dict:
    return {v: k for k, v in d.items()}


_BN_MODULES = {
    "resnet": [
        (r"(conv1|bn1|fc)$", lambda m: m[1], r"(conv1|bn1|fc)$", lambda m: m[1]),
        (r"stage(\d+)_block(\d+)/(conv\d|bn\d)$", lambda m: f"layer{int(m[1]) + 1}.{m[2]}.{m[3]}",
         r"layer(\d+)\.(\d+)\.(conv\d|bn\d)$", lambda m: f"stage{int(m[1]) - 1}_block{m[2]}/{m[3]}"),
        (r"stage(\d+)_block(\d+)/downsample_(conv|bn)$",
         lambda m: f"layer{int(m[1]) + 1}.{m[2]}.downsample.{int(m[3] == 'bn')}",
         r"layer(\d+)\.(\d+)\.downsample\.([01])$",
         lambda m: f"stage{int(m[1]) - 1}_block{m[2]}/downsample_{('conv', 'bn')[int(m[3])]}"),
    ],
    "densenet": [
        (r"(conv0|norm0)$", lambda m: f"features.{m[1]}",
         r"features\.(conv0|norm0)$", lambda m: m[1]),
        (r"block(\d+)_layer(\d+)/(norm1|conv1|norm2|conv2)$",
         lambda m: f"features.denseblock{int(m[1]) + 1}.denselayer{int(m[2]) + 1}.{m[3]}",
         r"features\.denseblock(\d+)\.denselayer(\d+)\.(norm1|conv1|norm2|conv2)$",
         lambda m: f"block{int(m[1]) - 1}_layer{int(m[2]) - 1}/{m[3]}"),
        (r"transition(\d+)_(norm|conv)$", lambda m: f"features.transition{int(m[1]) + 1}.{m[2]}",
         r"features\.transition(\d+)\.(norm|conv)$",
         lambda m: f"transition{int(m[1]) - 1}_{m[2]}"),
        (r"norm_final$", lambda m: "features.norm5", r"features\.norm5$", lambda m: "norm_final"),
        (r"classifier$", lambda m: "classifier", r"classifier$", lambda m: "classifier"),
    ],
    "inception": [
        (r"(Conv2d_\w+)/(conv|bn)$", lambda m: f"{_inv(_INC_STEM)[m[1]]}.{m[2]}",
         r"(Conv2d_\w+)\.(conv|bn)$", lambda m: f"{_INC_STEM[m[1]]}/{m[2]}"),
        (r"(Mixed_\w+)/(\w+)/(conv|bn)$",
         lambda m: f"{m[1]}.{_inv(_INC_BLOCKS[m[1]])[m[2]]}.{m[3]}",
         r"(Mixed_\w+)\.(\w+)\.(conv|bn)$", lambda m: f"{m[1]}/{_INC_BLOCKS[m[1]][m[2]]}/{m[3]}"),
        (r"fc$", lambda m: "fc", r"fc$", lambda m: "fc"),
    ],
}
# JAX leaf -> torch leaf of the BN family (kernel: a conv or the head)
_BN_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def bn_layout(arch: str) -> str:
    """The JAX param layout of a BN-family arch: 'resnet', 'densenet' or 'inception'."""
    return {"densnet201": "densenet", "inception": "inception"}.get(arch, "resnet")


def _bn_module(path: str, layout: str, to_torch: bool) -> str:
    for jax_re, torch_name, torch_re, jax_path in _BN_MODULES[layout]:
        m = re.match(jax_re if to_torch else torch_re, path)
        if m is not None:
            try:
                return (torch_name if to_torch else jax_path)(m)
            except KeyError:
                break
    raise ValueError(f"unmapped {'JAX' if to_torch else 'torch'} module {path!r} of a "
                     f"{layout} model")


_VIT_BLOCK_LEAF = {"weight": "kernel", "bias": "bias"}
# a block parameter of the port -> its JAX path, by layout ('convnext', 'iso', 'vit')
_BLOCK_PATHS = {
    "convnext": [(r"stages\.(\d+)\.blocks\.(\d+)\.(.+)$",
                  lambda m: f"stage{m[1]}_block{m[2]}/{_inv({k: v[0] for k, v in _BLOCK.items()})[m[3]]}")],
    "iso": [(r"blocks\.(\d+)\.(.+)$",
             lambda m: f"block{m[1]}/{_inv({k: v[0] for k, v in _ISO_BLOCK.items()})[m[2]]}")],
    "vit": [(r"blocks\.(\d+)\.(attn|mlp)\.(qkv|proj|fc1|fc2)\.(weight|bias)$",
             lambda m: f"block{m[1]}/{m[2]}/{m[3]}/{_VIT_BLOCK_LEAF[m[4]]}"),
            (r"blocks\.(\d+)\.(norm[12])\.(weight|bias)$",
             lambda m: f"block{m[1]}/{m[2]}/LayerNorm_0/{_inv(_LN)[m[3]]}"),
            (r"blocks\.(\d+)\.(ls[12])\.gamma$", lambda m: f"block{m[1]}/{m[2]}")],
}


def param_layout(arch: str) -> str:
    """The layout jax_param_path reads for an arch: 'convnext', 'iso',
    'vit', or a BN family's ('resnet', 'densenet', 'inception')."""
    if arch == "convnext_iso":
        return "iso"
    family = model_family(arch)
    return bn_layout(arch) if family == "resnet" else family


def jax_param_path(name: str, layout: str, is_bn: bool = False) -> str | None:
    """The JAX param path of a parameter of the port, by layout
    (`param_layout`). A BN-family parameter ('layer1.0.downsample.1.weight')
    -> 'stage0_block0/downsample_bn/scale'; is_bn: it belongs to a
    BatchNorm (weight -> scale, else -> kernel). A ConvNeXt, isotropic
    ConvNeXt or ViT block parameter ('stages.2.blocks.0.mlp.fc1.weight') ->
    'stage2_block0/pwconv1_kernel'; None for their parameters outside the
    blocks, which no rule of the port reads by path (the tensor-parallel
    rules, parallel/tp.py, match block leaves only)."""
    if layout in _BLOCK_PATHS:
        for pattern, path in _BLOCK_PATHS[layout]:
            m = re.match(pattern, name)
            if m is not None:
                return path(m)
        return None
    module, leaf = name.rsplit(".", 1)
    jleaf = {"bias": "bias", "weight": "scale" if is_bn else "kernel"}[leaf]
    return f"{_bn_module(module, layout, to_torch=False)}/{jleaf}"


def _bn_state_dict(params, batch_stats, arch: str) -> dict[str, torch.Tensor]:
    layout = bn_layout(arch)
    out: dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for key, value in _flatten(tree).items():
            module, leaf = key.rsplit("/", 1)
            if leaf not in _BN_LEAF:
                raise ValueError(f"unmapped JAX leaf {key!r} for {arch}")
            tf = (_conv if value.ndim == 4 else _lin) if leaf == "kernel" else None
            name = f"{_bn_module(module, layout, to_torch=True)}.{_BN_LEAF[leaf]}"
            out[name] = torch.from_numpy(np.array(tf(value) if tf else value, np.float32))
            if leaf == "mean":
                out[name.replace("running_mean", "num_batches_tracked")] = torch.tensor(
                    0, dtype=torch.long)
    return out


def jax_params_to_state_dict(params: Mapping[str, Any], arch: str,
                             batch_stats: Mapping[str, Any] | None = None
                             ) -> dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of numpy arrays, the tree under
    variables['params']) -> the port's state_dict, f32 (num_batches_tracked
    int64 0). A BN-family arch needs its `batch_stats` tree
    (variables['batch_stats']). A NormalizedModel's 'model' level is
    stripped. Every leaf must map: a leaf left over means the tree is not
    the arch's, and raises."""
    if set(params.keys()) == {"model"}:
        params = params["model"]
    if model_family(arch) == "resnet":
        if batch_stats is None:
            raise ValueError(f"{arch}: a BN-family tree needs its batch_stats")
        if set(batch_stats.keys()) == {"model"}:
            batch_stats = batch_stats["model"]
        return _bn_state_dict(params, batch_stats, arch)
    patterns = _ISO_PATTERNS if arch == "convnext_iso" else {
        "convnext": _CONVNEXT_PATTERNS, "vit": _VIT_PATTERNS}[model_family(arch)]
    out: dict[str, torch.Tensor] = {}
    for key, value in _flatten(params).items():
        name, tf = _map_leaf(key, arch, patterns)
        arr = tf(value) if tf else value
        out[name] = torch.from_numpy(np.array(arr, np.float32))
    return out


def _map_leaf(key: str, arch: str, patterns):
    for pattern, target in patterns:
        m = re.match(pattern, key)
        if m is not None:
            try:
                return target(m)
            except KeyError:
                break
    raise ValueError(f"unmapped JAX param leaf {key!r} for {arch}")


def core_module(model: nn.Module) -> nn.Module:
    """The module that owns the checkpoint's keys (inside any normalizer)."""
    return model.model if isinstance(model, NormalizedModel) else model


def strip_prefixes(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The reference's prefix cascade: drop 'module.' (DDP) and 'base_model.'
    (its WrappedModel), a leading 'model.' (its normalizer wrapper), and the
    normalizer's 'normalize.mean/std' buffers."""
    out = {}
    for k, v in sd.items():
        k = k.replace("module.", "").replace("base_model.", "")
        if k.startswith("model."):
            k = k[len("model."):]
        if k.startswith("normalize."):
            continue
        out[k] = v
    return out


def load_state_dict(model: nn.Module, sd: Mapping[str, torch.Tensor]) -> nn.Module:
    """Strict-load a reference-format state_dict into the model."""
    core_module(model).load_state_dict(strip_prefixes(sd), strict=True)
    return model


def read_torch_checkpoint(path: str | Path) -> dict[str, torch.Tensor]:
    """The state_dict of a .pt checkpoint (a plain state_dict, or a dict
    holding one under 'model_state_dict'), with the reference's prefixes
    stripped."""
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return strip_prefixes(sd)


def load_torch_checkpoint(path: str | Path, model: nn.Module) -> nn.Module:
    """Strict-load a .pt checkpoint into the model."""
    return load_state_dict(model, read_torch_checkpoint(path))


def save_torch_checkpoint(model: nn.Module, path: str | Path,
                          ema: Mapping[str, torch.Tensor] | None = None,
                          sd: Mapping[str, torch.Tensor] | None = None) -> None:
    """torch.save the model's reference-format state_dict (f32, raw keys).
    With `ema` ({model parameter name: tensor}, train/ema.py), the
    parameters are taken from it: the EMA weights of the same model. sd:
    the model's state_dict to write in place of its own (a distributed
    run's, gathered to whole tensors: ckpt/checkpoint.py)."""
    prefix = "model." if isinstance(model, NormalizedModel) else ""
    if sd is None:
        sd = model.state_dict()
    ema = ema or {}
    out = {k[len(prefix):]: ema.get(k, v).detach().float().cpu().contiguous()
           for k, v in sd.items() if k.startswith(prefix) and not k.startswith("normalize.")}
    torch.save(out, str(path))
