"""Training entry point, port of revisiting_at_tpu/cli/train.py.

  python -m revisiting_at_tpu_torch.cli.train \
      --model.arch convnext_tiny --model.not_original 1 --model.add_normalization 0 \
      --adv.attack apgd --adv.n_iter 2 --model.model_ema 1 --training.use_pallas 1 \
      --data.augmentations 1 --data.dataset folder --data.train_dataset <root>/train \
      --data.val_dataset <root>/val --data.num_workers 8 --training.batch_size 80 \
      [--device cuda]

`--data.dataset folder` reads ImageFolder trees through the port's PIL +
DataLoader pipeline (data/folder.py): the train loader from
`data.train_dataset` (set to each resolution of the ramp, starting at
`resolution.min_res`), the val loader from `data.val_dataset` (synthetic
data without it, as in JAX), `data.num_workers` worker processes, the
decoded cache with `data.in_memory`. `--data.dataset synthetic` trains on
random images. `data.augmentations` adds RandAugment, erasing and flip on the
device inside the step, then mixup.

`--model.ckpt_path <run dir>` resumes that run in place from its latest full
state (ckpt/state_<e>.pt) with the run's own flags: the weights, optimizer,
EMA and step are restored and the epochs go on after the saved one.

Distributed training, one process per GPU:

  torchrun --nproc_per_node N -m revisiting_at_tpu_torch.cli.train \
      [--dist.fsdp F] [--dist.tp T --training.use_pallas 0] ...

(or torchrun on each host with --nnodes, or --dist.multihost 1 with RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set by hand). Each
process reads torchrun's environment (parallel/mesh.py init_distributed),
takes the GPU of its LOCAL_RANK and feeds its own batch shard:
`training.batch_size` is per process, as JAX's per-process batch under
multi-host (trainer.py:354-365), and the folder loader reads the shard
files[shard::shards] of the train and val roots. Rank 0 writes the run.

The flags are the JAX CLI's flat `--section.param value` (or `=value`), so a
run's params.json keeps the JAX contract. Two more flags are the port's and
are parsed first: `--device` (default cuda; without CUDA the CLI exits with
an error, and `--device cpu` runs on the CPU; distributed, NCCL on the card
and gloo on the CPU) and `--synthetic_batches` (batches per synthetic
epoch, default 64 as in the JAX package).
"""

from __future__ import annotations

import argparse
import sys


def folder_loaders(cfg, pin_memory: bool, shard: int = 0, shards: int = 1):
    """(train_data_factory(res), val loader or None) from the data section,
    as revisiting_at_tpu/cli/train.py:55-114 builds them, over this
    process's shard of each root. The factory gives one train loader, its
    workers kept, at each resolution of the ramp."""
    from ..data.folder import FolderConfig, FolderLoader

    d = cfg.data
    train = []

    def train_data_factory(res: int):
        if not train:
            train.append(FolderLoader(FolderConfig(
                root=d.train_dataset, resolution=res, batch_size=cfg.training.batch_size,
                is_train=True, seed=d.seed, num_parallel=d.num_workers,
                subset_size=d.subset_size, cache_decoded=bool(d.in_memory),
                pin_memory=pin_memory), shard, shards))
        return train[0].set_resolution(res)

    val_data = None
    if d.val_dataset:
        val_data = FolderLoader(FolderConfig(
            root=d.val_dataset, resolution=cfg.validation.resolution,
            batch_size=cfg.validation.batch_size, is_train=False, drop_remainder=True,
            num_parallel=d.num_workers, cache_decoded=bool(d.in_memory),
            pin_memory=pin_memory), shard, shards)
    return train_data_factory, val_data


def main(argv=None):
    """Train; returns the Trainer (its logger.dir is the run directory)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--synthetic_batches", type=int, default=64)
    args, rest = ap.parse_known_args(argv)

    import torch
    import torch.distributed as dist

    from ..config import config_from_args
    from ..parallel.mesh import batch_shard, init_distributed
    from ..train.trainer import Trainer

    cfg = config_from_args(rest)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available (pass --device cpu "
                         "to train on the CPU)")
    if cfg.data.dataset == "folder" and not cfg.data.train_dataset:
        raise SystemExit("data.dataset=folder needs data.train_dataset (an ImageFolder "
                         "root); pass --data.dataset synthetic to train on random images")
    info = init_distributed(cfg.dist, device)
    trainer = None
    try:
        train_data = val_data = train_data_factory = None
        if cfg.data.dataset == "folder":
            shard, shards = batch_shard(info.rank, info.world, cfg.dist.tp)
            train_data_factory, val_data = folder_loaders(
                cfg, pin_memory=device.type == "cuda", shard=shard, shards=shards)
            r = cfg.resolution
            train_data = train_data_factory(r.min_res if r.min_res < r.max_res else r.max_res)
        trainer = Trainer(cfg, device=info.device, synthetic_batches=args.synthetic_batches,
                          train_data=train_data, val_data=val_data,
                          train_data_factory=train_data_factory)
        if cfg.model.ckpt_path:
            trainer.try_resume()
        if cfg.training.eval_only:
            acc, n = trainer.single_val()
            trainer.logger.log({"eval_only_acc": acc, "points": n})
        else:
            trainer.train()
    finally:
        if trainer is not None:
            trainer.release()
        if info.started and dist.is_initialized():
            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
