"""Trainer: epochs, validation, checkpoints and metric logging, port of
revisiting_at_tpu/train/trainer.py for one device.

  * synthetic data (the folder pipeline is ROADMAP A10);
  * an initial clean validation, then per epoch the train loop with
    `log_every_steps` records, the NaN-loss exit and an epoch record;
  * per-epoch checkpoints of the weights and the EMA weights as .pt files in
    the reference format (ckpt/weights_<epoch>.pt, ckpt/weights_ema_<epoch>.pt),
    which `cli/eval.py --torch_ckpt` reads; a final clean validation;
  * JSONL records with relative timestamps, and params.json.

Options of the JAX trainer that the port does not have yet raise
NotImplementedError naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from ..ckpt.convert import save_torch_checkpoint
from ..config import Config
from ..data.synthetic import SyntheticData
from ..models import get_model
from ..utils.logging import RunLogger, make_run_name
from .ema import ema_init
from .optimizer import make_optimizer
from .schedule import LRConfig, make_lr_schedule
from .state import TrainState
from .train_step import AdvConfig, make_eval_step, make_train_step


def refuse_unported(cfg: Config) -> None:
    """Raise NotImplementedError for every option the port does not run yet
    (grad_accum and FGSM raise where the optimizer and the step are built).
    A resolution ramp is ignored, as the JAX trainer ignores it for
    synthetic data."""
    d, dist, t, m = cfg.data, cfg.dist, cfg.training, cfg.model
    unported = [
        (d.augmentations, "data.augmentations=1 (RandAugment with mixup): ROADMAP A10"),
        (d.dataset == "folder", "data.dataset=folder: the data pipeline is ROADMAP A10 "
                                "(pass --data.dataset synthetic)"),
        (dist.fsdp > 1 or dist.tp > 1 or dist.multihost or dist.world_size > 1,
         "dist.fsdp/tp/multihost/world_size: multi-GPU training is ROADMAP A11"),
        (cfg.validation.adv_val_freq > 0, "validation.adv_val_freq > 0: ROADMAP A7"),
        (bool(m.ckpt_path), "model.ckpt_path (resume): ROADMAP A7"),
        (bool(m.pretrained) or m.arch.endswith("_21k"),
         "model.pretrained / *_21k archs (timm checkpoint init): ROADMAP A12"),
        (bool(t.remat), "training.remat (activation checkpointing): ROADMAP A7"),
        (cfg.misc.profile_steps > 0, "misc.profile_steps: ROADMAP A7"),
        (bool(cfg.misc.log_flops), "misc.log_flops (utils/flops.py): ROADMAP A7"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(what)


class Trainer:
    """Builds the model, data, optimizer, EMA and step from a Config and runs
    the epochs on `device`. synthetic_batches: batches per synthetic epoch."""

    def __init__(self, cfg: Config, device: str | torch.device = "cuda",
                 synthetic_batches: int = 64):
        refuse_unported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        t = cfg.training
        torch.autograd.set_detect_anomaly(bool(cfg.misc.debug_nans))
        dtype = torch.bfloat16 if t.precision == "bf16" else torch.float32
        torch.manual_seed(t.seed)
        build = dict(not_original=bool(cfg.model.not_original),
                     num_classes=cfg.data.num_classes,
                     drop_path_rate=cfg.model.drop_path_rate,
                     use_blurpool=bool(t.use_blurpool),
                     add_normalization=bool(cfg.model.add_normalization))
        # training.split_bwd is ignored: the JAX split backward has the full
        # backward's cotangents, and the port's full backward already runs in passes
        self.model, self.meta = get_model(
            cfg.model.arch, dtype=dtype, use_pallas=bool(t.use_pallas),
            wide_tail=None if t.wide_tail < 0 else bool(t.wide_tail), **build)
        self.model.to(self.device)
        # the f32 validation twin (validation.precision=fp32) shares the weights
        self.val_model = self.model
        if cfg.validation.precision == "fp32" and t.precision != "fp32":
            self.val_model, _ = get_model(cfg.model.arch, dtype=torch.float32, **build)
            self.val_model.to(self.device)

        self.train_data = SyntheticData(t.batch_size, cfg.resolution.max_res, cfg.data.num_classes,
                                        seed=cfg.data.seed, n_batches=synthetic_batches)
        self.val_data = SyntheticData(cfg.validation.batch_size, cfg.validation.resolution,
                                      cfg.data.num_classes, seed=cfg.data.seed + 1, n_batches=8)
        self.iters_per_epoch = len(self.train_data)

        lr_cfg = LRConfig(lr=cfg.lr.lr, schedule_type=cfg.lr.lr_schedule_type,
                          lr_peak_epoch=cfg.lr.lr_peak_epoch, step_ratio=cfg.lr.step_ratio,
                          step_length=cfg.lr.step_length, epochs=t.epochs)
        self.lr_schedule = make_lr_schedule(lr_cfg, max(self.iters_per_epoch, 1))
        optimizer = make_optimizer(
            self.model, optimizer=t.optimizer, weight_decay=t.weight_decay,
            momentum=t.momentum, family=self.meta.family, learning_rate=self.lr_schedule,
            freeze_some=bool(cfg.model.freeze_some), early=bool(cfg.model.early),
            grad_accum=t.grad_accum)
        use_ema = cfg.model.model_ema > 0
        self.state = TrainState(self.model, optimizer, ema_init(self.model) if use_ema else None)

        adv = AdvConfig(attack=cfg.adv.attack, norm=cfg.adv.norm, eps=cfg.adv.eps,
                        n_iter=cfg.adv.n_iter)
        # mixup comes with data.augmentations, which is refused above (A10)
        self.train_step = make_train_step(
            self.model, adv=adv, mixup=None,
            ema_decay=cfg.model.model_ema_decay if use_ema else 0.0, seed=t.seed)
        self.eval_step = make_eval_step(self.val_model, lr_tta=bool(cfg.validation.lr_tta))

        run_name = make_run_name(cfg.model.arch, cfg.adv.attack, cfg.model.not_original,
                                 cfg.model.updated, cfg.logging.addendum)
        self.logger = RunLogger(cfg.logging.folder, run_name)
        cfg.dump_params_json(self.logger.dir / "params.json")
        self.ckpt_dir = self.logger.dir / "ckpt"
        self.ckpt_dir.mkdir(exist_ok=True)
        self.logger.log({
            "event": "init", "arch": cfg.model.arch,
            "params": sum(p.numel() for p in self.model.parameters()),
            "devices": 1, "device": str(self.device),
            "device_name": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
            "iters_per_epoch": self.iters_per_epoch,
        })

    def _to_device(self, images: np.ndarray, labels: np.ndarray):
        return (torch.from_numpy(images).to(self.device, non_blocking=True),
                torch.from_numpy(labels).to(self.device, non_blocking=True))

    def single_val(self) -> tuple[float, int]:
        """Clean top-1 accuracy over at most validation.max_batches batches."""
        if self.val_model is not self.model:
            self.val_model.load_state_dict(self.model.state_dict())
        correct = correct5 = total = 0
        for i, (images, labels) in enumerate(self.val_data):
            top1, top5 = self.eval_step(*self._to_device(images, labels))
            correct += int(top1)
            correct5 += int(top5)
            total += labels.shape[0]
            if i + 1 >= self.cfg.validation.max_batches:
                break
        self._last_top5 = correct5 / max(total, 1)
        return correct / max(total, 1), total

    def train_loop(self, epoch: int) -> float:
        losses = []
        log_every = int(self.cfg.logging.log_every_steps)
        window_t0 = time.time()
        for ix, (images, labels) in enumerate(self.train_data):
            metrics = self.train_step(self.state, *self._to_device(images, labels))
            losses.append(metrics["loss"])
            if log_every and (ix + 1) % log_every == 0:
                now = time.time()
                self.logger.log({
                    "event": "step", "epoch": epoch, "step": self.state.step,
                    "loss": float(metrics["loss"]),
                    "lr": self.lr_schedule(self.state.step),
                    "imgs_per_s": log_every * labels.shape[0] / max(now - window_t0, 1e-9),
                })
                window_t0 = time.time()
        return float(torch.stack(losses).mean())

    def save_checkpoint(self, epoch: int) -> None:
        save_torch_checkpoint(self.model, self.ckpt_dir / f"weights_{epoch}.pt")
        if self.state.ema is not None:
            save_torch_checkpoint(self.model, self.ckpt_dir / f"weights_ema_{epoch}.pt",
                                  ema=self.state.ema)

    def train(self) -> None:
        cfg = self.cfg
        acc, n = self.single_val()
        self.logger.log({"Validation acc": acc, "top5": self._last_top5, "points": n})
        for epoch in range(cfg.training.epochs):
            t0 = time.time()
            train_loss = self.train_loop(epoch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            epoch_time = time.time() - t0
            if math.isnan(train_loss):
                self.logger.log({"event": "nan_loss", "epoch": epoch})
                sys.exit(1)
            self.logger.log({
                "epoch": epoch, "train_loss": train_loss,
                "current_lr": self.lr_schedule(self.state.step), "epoch_time": epoch_time,
                "steps_per_sec": self.iters_per_epoch / max(epoch_time, 1e-9),
            })
            if epoch % cfg.logging.save_freq == 0 or epoch == cfg.training.epochs - 1:
                self.save_checkpoint(epoch)
        acc, n = self.single_val()
        self.logger.log({"event": "final_val", "Validation acc": acc, "top5": self._last_top5,
                         "points": n})
