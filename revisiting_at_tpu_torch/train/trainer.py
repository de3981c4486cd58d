"""Trainer: epochs, validation, checkpoints and metric logging, port of
revisiting_at_tpu/train/trainer.py, on one device or one rank of a mesh.

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
    params.json;
  * distribution (parallel/): under torchrun (WORLD_SIZE > 1) or with
    dist.multihost, one process per device. The trainer starts the process
    group unless its caller did (parallel/mesh.py init_distributed), lays
    the ranks out as JAX's ("data", "fsdp", "model") mesh from dist.fsdp
    and dist.tp, splits the block MLPs over "model" (parallel/tp.py; with
    use_pallas=1 refused as JAX refuses it), and runs JAX's shard_map step
    (train_step.py; gradients, metrics and BatchNorm statistics averaged
    over the batch shards, FSDP slices of the optimizer state and EMA:
    parallel/zero.py). Each process feeds its own batch shard (synthetic
    data drawn per shard; the CLI's folder loader reads its shard of the
    files); validation counts are summed over the shards. Rank 0 alone
    writes params.json, the log and the checkpoints, in the single-process
    format; the other ranks print their records. `release` destroys the
    mesh's groups, and the process group where the trainer started it; a
    failed construction releases them itself.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..ckpt.checkpoint import CheckpointManager
from ..ckpt.convert import param_layout
from ..config import Config
from ..data.augment import RandAugmentConfig
from ..data.mixup import MixupConfig
from ..data.synthetic import SyntheticData
from ..models import get_model
from ..parallel.mesh import MeshConfig, init_distributed, make_mesh
from ..parallel.tp import TP_REQUIRES_PLAIN, apply_tensor_parallel
from ..parallel.zero import ParallelModel
from ..utils.flops import CONVENTION, forward_flops
from ..utils.logging import RunLogger, make_run_name
from .ema import ema_init
from .optimizer import make_optimizer
from .schedule import LRConfig, get_resolution, make_lr_schedule
from .state import TrainState
from .train_step import AdvConfig, make_adv_eval_step, make_eval_step, make_train_step


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
        self.cfg = cfg
        self.train_data_factory = train_data_factory
        tp = max(int(cfg.dist.tp), 1)
        if tp > 1 and cfg.training.use_pallas:
            raise ValueError(TP_REQUIRES_PLAIN)
        self.mesh = None
        self.dist_info = init_distributed(cfg.dist, device)
        try:
            self.mesh = make_mesh(MeshConfig(fsdp=cfg.dist.fsdp, model=tp))
            self._init_rest(cfg, tp, synthetic_batches, train_data, val_data)
        except BaseException:
            # a half-built Trainer is unreachable: nobody could release it
            self.release()
            raise

    def release(self) -> None:
        """Destroy the mesh's process groups, and the process group where the
        trainer started it (idempotent). The train CLI calls it at the end;
        in-process users (tests, notebooks) call it before building another
        distributed trainer."""
        if self.mesh is not None:
            self.mesh.release()
        if self.dist_info.started and dist.is_initialized():
            dist.destroy_process_group()
        self.dist_info = dataclasses.replace(self.dist_info, started=False)

    def _init_rest(self, cfg: Config, tp: int, synthetic_batches: int, train_data, val_data):
        self.device = self.dist_info.device
        mesh = self.mesh
        self.is_main = mesh.rank == 0
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
        layout = param_layout(cfg.model.arch)
        self.model.to(self.device)
        if mesh.size > 1:  # every rank starts from rank 0's weights and statistics
            with torch.no_grad():
                for tensor in list(self.model.parameters()) + list(self.model.buffers()):
                    dist.broadcast(tensor.data, src=0)
        tp_leaves = apply_tensor_parallel(self.model, mesh, layout)
        if tp > 1 and not tp_leaves:  # a rule or path drift must not degrade TP to replication
            raise AssertionError(f"dist.tp={tp} but no param matched the TP rules for arch "
                                 f"{cfg.model.arch!r} (parallel/tp.py TP_RULES)")
        # the f32 validation twin (validation.precision=fp32) shares the weights
        self.val_model = self.model
        if cfg.validation.precision == "fp32" and t.precision != "fp32":
            self.val_model, _ = get_model(cfg.model.arch, dtype=torch.float32, **build)
            apply_tensor_parallel(self.val_model, mesh, layout)
            self.val_model.to(self.device)
        self.parallel = ParallelModel(self.model, mesh, tp_leaves) if mesh.size > 1 else None

        # each batch shard draws its own synthetic data (shard 0 the
        # single process's); under TP the ranks of a "model" group share it
        self.res = cfg.resolution.max_res
        shard_seed = 7919 * mesh.batch_rank
        self.train_data = train_data if train_data is not None else SyntheticData(
            t.batch_size, self.res, cfg.data.num_classes, seed=cfg.data.seed + shard_seed,
            n_batches=synthetic_batches)
        self.val_data = val_data if val_data is not None else SyntheticData(
            cfg.validation.batch_size, cfg.validation.resolution, cfg.data.num_classes,
            seed=cfg.data.seed + 1 + shard_seed, n_batches=8)
        self.iters_per_epoch = len(self.train_data)

        lr_cfg = LRConfig(lr=cfg.lr.lr, schedule_type=cfg.lr.lr_schedule_type,
                          lr_peak_epoch=cfg.lr.lr_peak_epoch, step_ratio=cfg.lr.step_ratio,
                          step_length=cfg.lr.step_length, epochs=t.epochs)
        # the schedule counts optimizer updates, one per grad_accum micro-batches
        self.accum = t.grad_accum
        self.lr_schedule = make_lr_schedule(lr_cfg, max(self.iters_per_epoch // self.accum, 1))
        master = self.parallel.named_master() if self.parallel is not None else None
        optimizer = make_optimizer(
            self.model, optimizer=t.optimizer, weight_decay=t.weight_decay,
            momentum=t.momentum, family=self.meta.family, learning_rate=self.lr_schedule,
            freeze_some=bool(cfg.model.freeze_some), early=bool(cfg.model.early),
            grad_accum=self.accum, params=master)
        use_ema = cfg.model.model_ema > 0
        self.state = TrainState(self.model, optimizer,
                                ema_init(self.model, master) if use_ema else None,
                                parallel=self.parallel)

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

        # model.ckpt_path naming a run dir resumes that run in place; rank 0
        # names a new run and alone writes in it
        if cfg.model.ckpt_path:
            run_path = Path(cfg.model.ckpt_path)
            folder, run_name = str(run_path.parent), run_path.name
        else:
            folder = cfg.logging.folder
            run_name = [make_run_name(cfg.model.arch, cfg.adv.attack, cfg.model.not_original,
                                      cfg.model.updated, cfg.logging.addendum)]
            if mesh.size > 1:
                dist.broadcast_object_list(run_name, src=0)
            run_name = run_name[0]
        self.logger = RunLogger(folder, run_name, write=self.is_main)
        if self.is_main:
            cfg.dump_params_json(self.logger.dir / "params.json")
        self.ckpt = CheckpointManager(self.logger.dir, save_freq=cfg.logging.save_freq,
                                      write=self.is_main)
        self.start_epoch = 0
        par = self.parallel
        init_record = {
            "event": "init", "arch": cfg.model.arch,
            "params": sum(p.numel() * (tp if n in tp_leaves else 1)
                          for n, p in self.model.named_parameters()),
            "devices": mesh.size, "mesh": dict(mesh.shape), "rank": mesh.rank,
            "tp_sharded_leaves": len(tp_leaves),
            "fsdp_sharded_leaves": len(par.fsdp_dims) if par is not None else 0,
            "device": str(self.device),
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

    def _put_batch(self, images, labels):
        """This process's batch (numpy arrays, or the loader's pinned tensors)
        on its device: each rank feeds its own shard (JAX's _put_batch)."""
        return (torch.as_tensor(images).to(self.device, non_blocking=True),
                torch.as_tensor(labels).to(self.device, non_blocking=True))

    def _global(self, counts: list[int]) -> list[int]:
        """Counts summed over the batch shards (JAX sums over the global batch)."""
        return self.parallel.sum(counts) if self.parallel is not None else counts

    def single_val(self) -> tuple[float, int]:
        """Clean top-1 accuracy over at most validation.max_batches batches
        (of every shard: `correct` and `total` are global)."""
        if self.val_model is not self.model:
            self.val_model.load_state_dict(self.model.state_dict())
        correct = correct5 = total = 0
        for i, (images, labels) in enumerate(self.val_data):
            top1, top5 = self.eval_step(*self._put_batch(images, labels))
            correct += int(top1)
            correct5 += int(top5)
            total += labels.shape[0]
            if i + 1 >= self.cfg.validation.max_batches:
                break
        correct, correct5, total = self._global([correct, correct5, total])
        self._last_top5 = correct5 / max(total, 1)
        return correct / max(total, 1), total

    def adv_val(self) -> tuple[float, int]:
        """APGD-CE robust accuracy over validation.adv_val_batches val batches
        (of every shard)."""
        correct = total = 0
        for i, (images, labels) in enumerate(self.val_data):
            correct += int(self.adv_eval_step(*self._put_batch(images, labels)))
            total += labels.shape[0]
            if i + 1 >= self.cfg.validation.adv_val_batches:
                break
        correct, total = self._global([correct, total])
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
        # rank 0 traces
        profile_steps = (self.cfg.misc.profile_steps
                         if epoch == self.start_epoch and self.is_main else 0)
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
            metrics = self.train_step(self.state, *self._put_batch(images, labels))
            losses.append(metrics["loss"])
            if log_every and (ix + 1) % log_every == 0:
                now = time.time()
                self.logger.log({
                    "event": "step", "epoch": epoch, "step": self.state.step,
                    "loss": float(metrics["loss"]),
                    "lr": self.lr_schedule(self.state.step // self.accum),
                    "imgs_per_s": (log_every * labels.shape[0] * self.mesh.batch_count
                                   / max(now - window_t0, 1e-9)),
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
            if hasattr(self.train_data, "set_epoch"):  # the folder loader's shuffle
                self.train_data.set_epoch(epoch)
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
