"""Trainer: epochs, validation, checkpoints and metric logging, port of
revisiting_at_tpu/train/trainer.py for one device.

  * the data the caller hands in (the train CLI's image-folder loaders) or
    synthetic data; with data.augmentations, RandAugment, erasing and flip
    on the device inside the step, then mixup with label smoothing;
  * the resolution ramp: at each epoch `get_resolution`, and on a change
    the train data from `train_data_factory(res)`, logged as
    `resolution_change` (a ViT, whose pos_embed fixes its image size,
    refuses a resolution other than resolution.max_res);
  * an initial clean validation, then per epoch the train loop with
    `log_every_steps` records, the NaN-loss exit and an epoch record; both
    records carry the seconds the host waited on the loader (`data_wait`;
    the epoch's `data_wait_first`, its first batch, includes starting the
    loader's workers);
  * training.grad_accum = k: the optimizer updates every k micro-batches
    and the LR schedule counts its updates (iters_per_epoch // k per
    epoch), as JAX's trainer builds it (trainer.py:168-172, 449, 481);
  * training.remat: each block recomputed in the backward (models/);
  * checkpoints at epochs e with e % save_freq == 0 and at the last
    (ckpt/checkpoint.py): the weights and the EMA weights as .pt files in
    the reference format (ckpt/weights_<e>.pt, ckpt/weights_ema_<e>.pt),
    which `cli/eval.py` reads, and the full state (ckpt/state_<e>.pt);
  * true resume: model.ckpt_path names a run dir, the run continues in it
    from its latest full state (`try_resume`, trainer.py:296-350). The
    step's draws are keyed on (seed, step) and the folder loader shuffles
    from (seed, epoch), so a resumed run repeats the uninterrupted one;
  * adversarial validation every validation.adv_val_freq epochs and at the
    last: APGD-CE with validation.adv_val_iter steps on
    validation.adv_val_batches val batches (`adv_val` record); an
    improvement is saved to the best slot (ckpt_best/, `best_adv` record);
    the best accuracy so far is kept in the full state, so that a resumed
    run keeps its best slot (JAX's starts again from -1, ROADMAP C18);
  * misc.profile_steps: torch.profiler over steps [1, 1 + profile_steps)
    of the first epoch this process runs, a chrome trace in <run>/trace/
    (`trace_written` record);
  * misc.log_flops: the init record's `forward_flops` of one eval forward
    at (1, res, res, 3), counted on a plain twin on the meta device
    (utils/flops.py: matmuls and convolutions only, not XLA's count);
  * model.pretrained (or a *_21k arch): the weights of the local timm file
    model.pretrained_path merged in before the optimizer and the EMA are
    made (ckpt/torch_import.py), as JAX's trainer does (trainer.py:118-143);
    without a path, JAX's ValueError;
  * the BN family: the attack runs with the running statistics frozen, the
    training forward moves them once, the EMA follows them (train_step.py);
  * a final clean validation; JSONL records with relative timestamps, and
    params.json.

Options of the JAX trainer that the port does not have yet raise
NotImplementedError naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..config import Config
from ..data.augment import RandAugmentConfig
from ..data.mixup import MixupConfig
from ..data.synthetic import SyntheticData
from ..models import get_model
from ..utils.flops import CONVENTION, forward_flops
from ..utils.logging import RunLogger, make_run_name
from .ema import ema_init
from .optimizer import make_optimizer
from .schedule import LRConfig, get_resolution, make_lr_schedule
from .state import TrainState
from .train_step import AdvConfig, make_adv_eval_step, make_eval_step, make_train_step


def refuse_unported(cfg: Config) -> None:
    """Raise NotImplementedError for every option the port does not run yet."""
    dist = cfg.dist
    if dist.fsdp > 1 or dist.tp > 1 or dist.multihost or dist.world_size > 1:
        raise NotImplementedError(
            "dist.fsdp/tp/multihost/world_size: multi-GPU training is ROADMAP A11")


def pretrained_init(cfg: Config, model) -> None:
    """model.pretrained=1 or a *_21k arch (21k-pretrained, fine-tuned timm
    weights, meaningless from a random init): merge the local file
    model.pretrained_path into the model, in place."""
    m = cfg.model
    if not (bool(m.pretrained) or m.arch.endswith("_21k")):
        return
    if not m.pretrained_path:
        raise ValueError(
            f"model.pretrained=1 (or a *_21k arch, {m.arch!r}) needs "
            "model.pretrained_path pointing at a local timm checkpoint: this "
            "environment cannot download weights (reference: timm fetches "
            "them, utils_architecture.py:242-295)")
    from ..ckpt.torch_import import load_timm_pretrained

    report = load_timm_pretrained(m.pretrained_path, model, m.arch)
    print(f"pretrained init from {m.pretrained_path}: {len(report['loaded'])} tensors loaded, "
          f"{len(report['kept_random'])} kept at random init "
          f"(e.g. {report['kept_random'][:3]})")


class Trainer:
    """Builds the model, data, optimizer, EMA and step from a Config and runs
    the epochs on `device`. train_data / val_data: iterables of (images NHWC
    uint8 or [0, 1] f32, int labels) with a len, synthetic data when None
    (synthetic_batches batches per epoch); train_data_factory(res) gives
    the train data at a resolution of the ramp (revisiting_at_tpu/train/
    trainer.py:46-55, 460-469)."""

    def __init__(self, cfg: Config, device: str | torch.device = "cuda",
                 synthetic_batches: int = 64, train_data=None, val_data=None,
                 train_data_factory=None):
        refuse_unported(cfg)
        self.cfg = cfg
        self.train_data_factory = train_data_factory
        self.device = torch.device(device)
        t = cfg.training
        torch.autograd.set_detect_anomaly(bool(cfg.misc.debug_nans))
        dtype = torch.bfloat16 if t.precision == "bf16" else torch.float32
        torch.manual_seed(t.seed)
        # a ViT is built for one image size (its pos_embed), the training
        # resolution; the validation model shares its weights, so it must match
        build = dict(not_original=bool(cfg.model.not_original),
                     updated=bool(cfg.model.updated), num_classes=cfg.data.num_classes,
                     drop_path_rate=cfg.model.drop_path_rate,
                     use_blurpool=bool(t.use_blurpool),
                     add_normalization=bool(cfg.model.add_normalization),
                     img_size=cfg.resolution.max_res)
        # training.split_bwd is ignored: the JAX split backward has the full
        # backward's cotangents, and the port's full backward already runs in passes
        self.model, self.meta = get_model(
            cfg.model.arch, dtype=dtype, use_pallas=bool(t.use_pallas),
            wide_tail=None if t.wide_tail < 0 else bool(t.wide_tail), remat=bool(t.remat),
            **build)
        pretrained_init(cfg, self.model)
        if self.meta.family == "vit" and cfg.validation.resolution != cfg.resolution.max_res:
            raise ValueError(f"{cfg.model.arch}: validation.resolution "
                             f"{cfg.validation.resolution} != resolution.max_res "
                             f"{cfg.resolution.max_res}: a ViT's pos_embed fixes its image size")
        self.model.to(self.device)
        # the f32 validation twin (validation.precision=fp32) shares the weights
        self.val_model = self.model
        if cfg.validation.precision == "fp32" and t.precision != "fp32":
            self.val_model, _ = get_model(cfg.model.arch, dtype=torch.float32, **build)
            self.val_model.to(self.device)

        self.res = cfg.resolution.max_res
        self.train_data = train_data if train_data is not None else SyntheticData(
            t.batch_size, self.res, cfg.data.num_classes, seed=cfg.data.seed,
            n_batches=synthetic_batches)
        self.val_data = val_data if val_data is not None else SyntheticData(
            cfg.validation.batch_size, cfg.validation.resolution, cfg.data.num_classes,
            seed=cfg.data.seed + 1, n_batches=8)
        self.iters_per_epoch = len(self.train_data)

        lr_cfg = LRConfig(lr=cfg.lr.lr, schedule_type=cfg.lr.lr_schedule_type,
                          lr_peak_epoch=cfg.lr.lr_peak_epoch, step_ratio=cfg.lr.step_ratio,
                          step_length=cfg.lr.step_length, epochs=t.epochs)
        # the schedule counts optimizer updates, one per grad_accum micro-batches
        self.accum = t.grad_accum
        self.lr_schedule = make_lr_schedule(lr_cfg, max(self.iters_per_epoch // self.accum, 1))
        optimizer = make_optimizer(
            self.model, optimizer=t.optimizer, weight_decay=t.weight_decay,
            momentum=t.momentum, family=self.meta.family, learning_rate=self.lr_schedule,
            freeze_some=bool(cfg.model.freeze_some), early=bool(cfg.model.early),
            grad_accum=self.accum)
        use_ema = cfg.model.model_ema > 0
        self.state = TrainState(self.model, optimizer, ema_init(self.model) if use_ema else None)

        # alpha is the config's for FGSM only, as in the JAX trainer
        adv = AdvConfig(attack=cfg.adv.attack, norm=cfg.adv.norm, eps=cfg.adv.eps,
                        n_iter=cfg.adv.n_iter,
                        alpha=cfg.adv.alpha if cfg.adv.attack == "fgsm" else 1.25,
                        noise_level=cfg.adv.noise_level,
                        skip_projection=bool(cfg.adv.skip_projection))
        aug = bool(cfg.data.augmentations)
        mixup = MixupConfig(label_smoothing=t.label_smoothing,
                            num_classes=cfg.data.num_classes) if aug else None
        self.train_step = make_train_step(
            self.model, adv=adv, mixup=mixup, randaug=RandAugmentConfig() if aug else None,
            ema_decay=cfg.model.model_ema_decay if use_ema else 0.0, seed=t.seed)
        self.eval_step = make_eval_step(self.val_model, lr_tta=bool(cfg.validation.lr_tta))
        self.adv_eval_step = None
        self.best_adv_acc = -1.0
        if cfg.validation.adv_val_freq > 0:
            self.adv_eval_step = make_adv_eval_step(self.model, adv=AdvConfig(
                attack="apgd", norm=cfg.adv.norm, eps=cfg.adv.eps,
                n_iter=cfg.validation.adv_val_iter))

        # model.ckpt_path naming a run dir resumes that run in place
        if cfg.model.ckpt_path:
            run_path = Path(cfg.model.ckpt_path)
            self.logger = RunLogger(str(run_path.parent), run_path.name)
        else:
            run_name = make_run_name(cfg.model.arch, cfg.adv.attack, cfg.model.not_original,
                                     cfg.model.updated, cfg.logging.addendum)
            self.logger = RunLogger(cfg.logging.folder, run_name)
        cfg.dump_params_json(self.logger.dir / "params.json")
        self.ckpt = CheckpointManager(self.logger.dir, save_freq=cfg.logging.save_freq)
        self.start_epoch = 0
        init_record = {
            "event": "init", "arch": cfg.model.arch,
            "params": sum(p.numel() for p in self.model.parameters()),
            "devices": 1, "device": str(self.device),
            "device_name": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
            "iters_per_epoch": self.iters_per_epoch,
        }
        if cfg.misc.log_flops:
            # the plain path on the meta device: FlopCounterMode cannot see
            # inside the kernels' autograd.Functions, and meta computes nothing
            with torch.device("meta"):
                twin, _ = get_model(cfg.model.arch, dtype=dtype, **build)
            init_record["forward_flops"] = forward_flops(twin, (1, self.res, self.res, 3))
            init_record["flops_convention"] = CONVENTION
        self.logger.log(init_record)

    def try_resume(self) -> bool:
        """Restore the run dir's latest full state; the epochs go on after it."""
        restored = self.ckpt.restore_latest(self.state)
        if restored is None:
            return False
        self.start_epoch = restored["epoch"] + 1
        self.best_adv_acc = restored["best_adv_acc"]
        self.logger.log({"event": "resume", "epoch": restored["epoch"],
                         "step": self.state.step})
        return True

    def _to_device(self, images, labels):
        """A batch (numpy arrays, or the loader's pinned tensors) on the device."""
        return (torch.as_tensor(images).to(self.device, non_blocking=True),
                torch.as_tensor(labels).to(self.device, non_blocking=True))

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

    def adv_val(self) -> tuple[float, int]:
        """APGD-CE robust accuracy over validation.adv_val_batches val batches."""
        correct = total = 0
        for i, (images, labels) in enumerate(self.val_data):
            correct += int(self.adv_eval_step(*self._to_device(images, labels)))
            total += labels.shape[0]
            if i + 1 >= self.cfg.validation.adv_val_batches:
                break
        return correct / max(total, 1), total

    def _start_trace(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_trace(self, prof) -> None:
        """Stop the profiler after the device has run the traced steps and
        write its chrome trace to <run>/trace/."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        trace_dir = self.logger.dir / "trace"
        trace_dir.mkdir(exist_ok=True)
        path = trace_dir / f"trace_step{self.state.step}.json"
        prof.export_chrome_trace(str(path))
        self.logger.log({"event": "trace_written", "dir": str(trace_dir), "path": str(path)})

    def train_loop(self, epoch: int) -> tuple[float, list[float]]:
        """One epoch: (mean loss, seconds the host waited on the loader for
        each batch; the first wait includes starting the loader's workers).
        In the first epoch this process runs, steps [1, 1 + profile_steps)
        are traced (step 0 builds and warms up, as JAX's compiles)."""
        losses = []
        log_every = int(self.cfg.logging.log_every_steps)
        profile_steps = self.cfg.misc.profile_steps if epoch == self.start_epoch else 0
        prof = None
        window_t0 = time.time()
        waits, ix = [], -1
        batches = iter(self.train_data)
        while True:
            t0 = time.time()
            batch = next(batches, None)
            if batch is None:
                break
            waits.append(time.time() - t0)
            ix += 1
            if profile_steps and ix == 1:
                prof = self._start_trace()
            if prof is not None and ix == 1 + profile_steps:
                self._stop_trace(prof)
                prof = None
            images, labels = batch
            metrics = self.train_step(self.state, *self._to_device(images, labels))
            losses.append(metrics["loss"])
            if log_every and (ix + 1) % log_every == 0:
                now = time.time()
                self.logger.log({
                    "event": "step", "epoch": epoch, "step": self.state.step,
                    "loss": float(metrics["loss"]),
                    "lr": self.lr_schedule(self.state.step // self.accum),
                    "imgs_per_s": log_every * labels.shape[0] / max(now - window_t0, 1e-9),
                    "data_wait": sum(waits[-log_every:]),
                })
                window_t0 = time.time()
        if prof is not None:  # an epoch shorter than the traced steps
            self._stop_trace(prof)
        return float(torch.stack(losses).mean()), waits

    def train(self) -> None:
        cfg = self.cfg
        acc, n = self.single_val()
        self.logger.log({"Validation acc": acc, "top5": self._last_top5, "points": n})
        for epoch in range(self.start_epoch, cfg.training.epochs):
            r = cfg.resolution
            res = get_resolution(epoch, r.min_res, r.max_res, r.start_ramp, r.end_ramp)
            if res != self.res and self.train_data_factory is not None:
                if self.meta.family == "vit":
                    raise ValueError(f"{cfg.model.arch}: the ramp asks for {res} px, but a "
                                     f"ViT's pos_embed fixes its image size at "
                                     f"resolution.max_res {r.max_res}")
                self.logger.log({"event": "resolution_change", "res": res})
                self.train_data = self.train_data_factory(res)
                self.res = res
            t0 = time.time()
            train_loss, waits = self.train_loop(epoch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            epoch_time = time.time() - t0
            if math.isnan(train_loss):
                self.logger.log({"event": "nan_loss", "epoch": epoch})
                sys.exit(1)
            self.logger.log({
                "epoch": epoch, "train_loss": train_loss,
                "current_lr": self.lr_schedule(self.state.step // self.accum),
                "epoch_time": epoch_time,
                "steps_per_sec": self.iters_per_epoch / max(epoch_time, 1e-9),
                "data_wait": sum(waits), "data_wait_first": waits[0] if waits else 0.0,
                "res": self.res,
            })
            last = epoch == cfg.training.epochs - 1
            # the adversarial validation comes before the save (JAX's after
            # it) so that the entry holds this epoch's best accuracy; it
            # changes no state, and the records keep JAX's order
            freq = cfg.validation.adv_val_freq
            improved = False
            if self.adv_eval_step is not None and ((epoch + 1) % freq == 0 or last):
                adv_acc, n_adv = self.adv_val()
                self.logger.log({"event": "adv_val", "epoch": epoch, "adv_acc": adv_acc,
                                 "points": n_adv})
                improved = adv_acc > self.best_adv_acc
                self.best_adv_acc = max(self.best_adv_acc, adv_acc)
            self.ckpt.maybe_save(epoch, self.state, last=last, best_adv_acc=self.best_adv_acc)
            if improved:
                self.ckpt.save_best(epoch, self.state, best_adv_acc=self.best_adv_acc)
                self.logger.log({"event": "best_adv", "epoch": epoch,
                                 "adv_acc": self.best_adv_acc})
        acc, n = self.single_val()
        self.logger.log({"event": "final_val", "Validation acc": acc, "top5": self._last_top5,
                         "points": n})
