"""Initialise a model from a local timm / torchvision pretrained checkpoint,
port of `merge_param_tree` and `load_timm_pretrained`
(revisiting_at_tpu/ckpt/torch_import.py:419-526).

The reference builds its models with timm's ImageNet weights
(`get_new_model(pretrained=True)`); with `not_original` the pretrained
patchify stem then gives way to a fresh ConvStem. Nothing is downloaded
here: the weights are a local file, a state_dict (or one under 'model',
'state_dict' or 'model_state_dict'), whose 'module.', 'base_model.' and
'model.' prefixes and normalizer buffers are dropped (convert.strip_prefixes).

The port's names are the reference's, so the merge is by name: every
target tensor whose name the file holds with exactly its shape is loaded,
the rest keep their random init (a ConvStem has no counterpart in a timm
file; a shape mismatch, e.g. another head width, warns). The targets are
the parameters and, for the BN family, the running statistics, which are
reported apart (`stats_kept_random`). A ConvNeXt file with timm's older
head names (norm.*, head.weight/bias) is read as head.norm / head.fc, as
JAX's mapper reads it. The isotropic ConvNeXt has no timm layout and is
refused; so is a file that matches nothing, and a BN-family file without
its stem's conv.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import torch
from torch import nn

from ..models.factory import model_family
from ..models.layers import bn_stat_names
from .convert import core_module, strip_prefixes

# the first key JAX's BN mappers read (torch_import.py:245, 290, 379)
_BN_STEM = {"densnet201": "features.conv0.weight", "inception": "Conv2d_1a_3x3.conv.weight"}


def _timm_convnext_heads(sd: dict) -> dict:
    """timm's older ConvNeXt head names -> head.norm / head.fc."""
    rename = {"norm.weight": "head.norm.weight", "norm.bias": "head.norm.bias",
              "head.weight": "head.fc.weight", "head.bias": "head.fc.bias"}
    return {rename.get(k, k): v for k, v in sd.items()}


def merge_state_dict(source: dict, model: nn.Module, names: list[str]) -> dict:
    """Copy the tensors of `names` (the core module's) that `source` holds
    at exactly their shape into the model, in place; the report of JAX's
    merge_param_tree: loaded, kept_random, shape_mismatch (name, source
    shape, target shape) and dropped_source (source names not in `names`)."""
    target = core_module(model).state_dict(keep_vars=True)
    loaded, kept, mismatch = [], [], []
    with torch.no_grad():
        for name in names:
            t, v = target[name], source.get(name)
            if v is not None and tuple(v.shape) == tuple(t.shape):
                t.copy_(v.to(t.dtype))
                loaded.append(name)
            else:
                if v is not None:
                    mismatch.append((name, tuple(v.shape), tuple(t.shape)))
                kept.append(name)
    if mismatch:
        warnings.warn(f"merge_state_dict: {len(mismatch)} source tensors had mismatched "
                      f"shapes and were kept random, e.g. {mismatch[:3]}")
    return {"loaded": loaded, "kept_random": kept, "shape_mismatch": mismatch,
            "dropped_source": sorted(set(source) - set(names))}


def load_timm_pretrained(path: str | Path, model: nn.Module, arch: str) -> dict:
    """Initialise `model` (built by get_model(arch)) from the local file
    `path` in place; returns the merge report (BN family: with
    'stats_kept_random'). Raises ValueError for convnext_iso, for a file
    that matches no parameter, and for a BN-family file without its stem."""
    if arch == "convnext_iso":
        raise ValueError("convnext_iso has no timm pretrained mapping (Meta layout) — "
                         "use model.ckpt_path / --torch_ckpt for reference-format files")
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    for wrapper in ("model", "state_dict", "model_state_dict"):
        if isinstance(sd, dict) and wrapper in sd and isinstance(sd[wrapper], dict):
            sd = sd[wrapper]
    sd = strip_prefixes(sd)
    family = model_family(arch)
    core = core_module(model)
    params = [name for name, _ in core.named_parameters()]
    if family == "resnet":
        stem = _BN_STEM.get(arch, "conv1.weight")
        if stem not in sd:
            raise ValueError(f"pretrained checkpoint {path} is missing key '{stem}' expected "
                             f"for {arch} — wrong file or architecture")
        sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
        stats = bn_stat_names(core)
        report = merge_state_dict(sd, model, params + stats)
        report["stats_kept_random"] = [n for n in report["kept_random"] if n in set(stats)]
        for key in ("loaded", "kept_random"):
            report[key] = [n for n in report[key] if n not in set(stats)]
    else:
        if family == "convnext":
            sd = _timm_convnext_heads(sd)
        report = merge_state_dict(sd, model, params)
    if not report["loaded"]:
        raise ValueError(f"pretrained checkpoint {path} matched no parameters of {arch} — "
                         f"wrong file or architecture")
    return report
