"""Checkpoints: the JAX param tree to the port's state_dict, and .pt files.

The port's module names are timm-0.8's, so its native state_dict is the
reference checkpoint format, and the output of the JAX package's
`python -m revisiting_at_tpu.cli.export` strict-loads into the port.

`jax_params_to_state_dict` takes the JAX package's param tree as nested
dicts of numpy arrays (no JAX needed) and does the layout inversions:

  kernel [in, out]        -> Linear    [out, in]
  kernel [kh, kw, I, O]   -> Conv2d    [O, I, kh, kw]
  kernel [kh, kw, 1, C]   -> depthwise [C, 1, kh, kw]
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

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
_PATTERNS = [
    # ConvStem: conv{i} at Sequential index 3i, its LayerNorm at 3i + 1
    (r"ConvStem\d*_\d+/conv(\d+)/Conv_0/(kernel|bias)$",
     lambda m: (f"stem.stem.{3 * int(m[1])}.{'weight' if m[2] == 'kernel' else 'bias'}",
                _conv if m[2] == "kernel" else None)),
    (r"ConvStem\d*_\d+/norm(\d+)/LayerNorm_0/(scale|bias)$",
     lambda m: (f"stem.stem.{3 * int(m[1]) + 1}.{_LN[m[2]]}", None)),
    (r"stem/proj/Conv_0/(kernel|bias)$",
     lambda m: (f"stem.0.{'weight' if m[1] == 'kernel' else 'bias'}",
                _conv if m[1] == "kernel" else None)),
    (r"stem/norm/LayerNorm_0/(scale|bias)$", lambda m: (f"stem.1.{_LN[m[1]]}", None)),
    (r"downsample_norm(\d+)/LayerNorm_0/(scale|bias)$",
     lambda m: (f"stages.{m[1]}.downsample.0.{_LN[m[2]]}", None)),
    (r"downsample_conv(\d+)/Conv_0/(kernel|bias)$",
     lambda m: (f"stages.{m[1]}.downsample.1.{'weight' if m[2] == 'kernel' else 'bias'}",
                _conv if m[2] == "kernel" else None)),
    (r"stage(\d+)_block(\d+)/(\w+)$",
     lambda m: (f"stages.{m[1]}.blocks.{m[2]}.{_BLOCK[m[3]][0]}", _BLOCK[m[3]][1])),
    (r"head_norm/LayerNorm_0/(scale|bias)$", lambda m: (f"head.norm.{_LN[m[1]]}", None)),
    (r"head/(kernel|bias)$",
     lambda m: (f"head.fc.{'weight' if m[1] == 'kernel' else 'bias'}",
                _lin if m[1] == "kernel" else None)),
]


def jax_params_to_state_dict(params: Mapping[str, Any], arch: str) -> dict[str, torch.Tensor]:
    """JAX ConvNeXt param tree (nested dicts of numpy arrays, the tree under
    variables['params']) -> the port's state_dict, f32. A NormalizedModel's
    'model' level is stripped. Every leaf must map: a leaf left over means
    the tree is not the arch's, and raises."""
    if not arch.startswith("convnext") or arch == "convnext_iso":
        raise NotImplementedError(f"{arch}: the port builds ConvNeXt T/S/B/L/micro only")
    if set(params.keys()) == {"model"}:
        params = params["model"]
    out: dict[str, torch.Tensor] = {}
    for key, value in _flatten(params).items():
        name, tf = _map_leaf(key, arch)
        arr = tf(value) if tf else value
        out[name] = torch.from_numpy(np.array(arr, np.float32))
    return out


def _map_leaf(key: str, arch: str):
    for pattern, target in _PATTERNS:
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


def load_torch_checkpoint(path: str | Path, model: nn.Module) -> nn.Module:
    """Strict-load a .pt checkpoint (a plain state_dict, or a dict holding one
    under 'model_state_dict') into the model."""
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return load_state_dict(model, sd)


def save_torch_checkpoint(model: nn.Module, path: str | Path,
                          ema: Mapping[str, torch.Tensor] | None = None) -> None:
    """torch.save the model's reference-format state_dict (f32, raw keys).
    With `ema` ({model parameter name: tensor}, train/ema.py), the
    parameters are taken from it: the EMA weights of the same model."""
    prefix = "model." if isinstance(model, NormalizedModel) else ""
    ema = ema or {}
    sd = {k: ema.get(prefix + k, v).detach().float().cpu().contiguous()
          for k, v in core_module(model).state_dict().items()}
    torch.save(sd, str(path))
