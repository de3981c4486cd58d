"""Typed config of the reference's 9 sections and the params.json contract.

Port of revisiting_at_tpu/config/config.py: the same sections, fields and
defaults, so the port reads a params.json written by the JAX trainer (and
writes one the JAX evaluator reads). Flat 'section.param' keys; unknown
keys in a params.json are ignored for forward compatibility.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, get_type_hints


@dataclasses.dataclass
class ModelSection:
    arch: str = "convnext_tiny"
    pretrained: int = 0
    pretrained_path: str = ""
    ckpt_path: str = ""
    add_normalization: int = 1
    not_original: int = 0
    updated: int = 0
    model_ema: float = 0.0
    model_ema_decay: float = 0.9999
    freeze_some: int = 0
    early: int = 1
    drop_path_rate: float = 0.0


@dataclasses.dataclass
class ResolutionSection:
    min_res: int = 224
    max_res: int = 224
    end_ramp: int = 0
    start_ramp: int = 0


@dataclasses.dataclass
class DataSection:
    train_dataset: str = ""
    val_dataset: str = ""
    num_workers: int = 1
    in_memory: int = 1
    seed: int = 0
    augmentations: int = 0
    dataset: str = "folder"
    num_classes: int = 1000
    subset_size: int = 0


@dataclasses.dataclass
class LRSection:
    step_ratio: float = 0.1
    step_length: int = 30
    lr_schedule_type: str = "cosine"
    lr: float = 1e-3
    lr_peak_epoch: int = 10


@dataclasses.dataclass
class LoggingSection:
    folder: str = "./runs"
    log_level: int = 1
    save_freq: int = 1
    addendum: str = ""
    log_every_steps: int = 0


@dataclasses.dataclass
class ValidationSection:
    batch_size: int = 64
    resolution: int = 224
    lr_tta: int = 0
    precision: str = "bf16"
    max_batches: int = 200
    adv_val_freq: int = 0
    adv_val_iter: int = 5
    adv_val_batches: int = 4


@dataclasses.dataclass
class TrainingSection:
    eval_only: int = 0
    batch_size: int = 512
    optimizer: str = "adamw"
    momentum: float = 0.9
    weight_decay: float = 0.05
    epochs: int = 100
    label_smoothing: float = 0.1
    distributed: int = 0
    grad_accum: int = 1
    use_blurpool: int = 0
    precision: str = "bf16"
    seed: int = 0
    use_pallas: int = 0
    remat: int = 0
    stem_s2d: int = 0
    wide_tail: int = -1
    split_bwd: int = 0


@dataclasses.dataclass
class DistSection:
    world_size: int = 1
    fsdp: int = 1
    tp: int = 1
    address: str = "localhost"
    port: str = "12355"
    multihost: int = 0


@dataclasses.dataclass
class AdvSection:
    attack: str = "none"
    norm: str = "Linf"
    eps: float = 4.0 / 255.0
    n_iter: int = 2
    verbose: int = 0
    noise_level: float = 1.0
    skip_projection: int = 0
    alpha: float = 1.0


@dataclasses.dataclass
class MiscSection:
    notes: str = ""
    use_channel_last: int = 1
    profile_steps: int = 0
    debug_nans: int = 0
    log_flops: int = 0


@dataclasses.dataclass
class Config:
    model: ModelSection = dataclasses.field(default_factory=ModelSection)
    resolution: ResolutionSection = dataclasses.field(default_factory=ResolutionSection)
    data: DataSection = dataclasses.field(default_factory=DataSection)
    lr: LRSection = dataclasses.field(default_factory=LRSection)
    logging: LoggingSection = dataclasses.field(default_factory=LoggingSection)
    validation: ValidationSection = dataclasses.field(default_factory=ValidationSection)
    training: TrainingSection = dataclasses.field(default_factory=TrainingSection)
    dist: DistSection = dataclasses.field(default_factory=DistSection)
    adv: AdvSection = dataclasses.field(default_factory=AdvSection)
    misc: MiscSection = dataclasses.field(default_factory=MiscSection)

    def to_flat_dict(self) -> dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            section = getattr(self, f.name)
            for sf in dataclasses.fields(section):
                out[f"{f.name}.{sf.name}"] = getattr(section, sf.name)
        return out

    def dump_params_json(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_flat_dict(), indent=2))

    def set_flat(self, key: str, value: str) -> None:
        sec_name, param = key.split(".", 1)
        section = getattr(self, sec_name)
        if not hasattr(section, param):
            raise KeyError(f"unknown config key {key!r}")
        typ = get_type_hints(type(section))[param]
        setattr(section, param, typ(value))


def load_params_json(path: str | Path) -> Config:
    """Reconstruct a Config from a run's params.json."""
    cfg = Config()
    for key, value in json.loads(Path(path).read_text()).items():
        try:
            cfg.set_flat(key, str(value))
        except (KeyError, ValueError, AttributeError):
            pass  # forward-compat: ignore unknown keys
    return cfg
