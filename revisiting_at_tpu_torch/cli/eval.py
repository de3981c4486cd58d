"""Robustness evaluation entry point, port of revisiting_at_tpu/cli/eval.py.

Rebuilds the model from a run's params.json, loads the run's weights, and
runs batched AutoAttack per norm with the reference epsilon table
{Linf: 4/255, L2: 2, L1: 75}. The model
computes in bf16, as the JAX evaluator's does. A ViT is built for
--img_size, and the checkpoint's pos_embed is resized to that grid before
the strict load (bicubic, models/pos_embed.py; unchanged if it matches).

Usage:
  python -m revisiting_at_tpu_torch.cli.eval --run_dir runs/<run> \
      [--epoch N] [--best] [--use_ema 1] [--torch_ckpt weights.pt] \
      [--l_norms Linf,L2] [--l_epss 4,2] [--full_aa 1] \
      [--n_ex 5000] [--batch_size 200] [--n_iter 100] [--square_queries 5000] \
      [--save_imgs] [--use_pallas 1] [--data_dir <imagenet>/val | --synthetic] \
      [--device cuda]

--full_aa 1 runs standard AutoAttack (APGD-CE, APGD-T, FAB-T, Square),
0 its short mode (APGD-CE, APGD-T). --l_epss gives one eps per norm of
--l_norms (a Linf eps above 1 is in 1/255) and overrides --eps.
--save_imgs writes each norm's x_adv to
<run_dir>/aa_adv_{n_ex}_{norm}_{eps:.5f}.npy through a memmap.
--stem_s2d is accepted and does nothing: the JAX package's space-to-depth
stem convolution computes what the plain convolution does. So are
--fab_iter_chunk and --square_query_chunk: the JAX package splits FAB and
Square into compiled programs of that many iterations or queries, which
changes no result; here the attacks run eagerly, one launch at a time.

--data_dir reads the first --n_ex images by basename of an ImageFolder tree
(the robustbench subset) through the eval transform of data/folder.py:
the short side to img_size / 0.875 and the centre crop (a warp resize at 384
px and above), decoded by a pool of threads. The images stay uint8 on the
host; AutoAttack converts each batch it sends to the device. --synthetic evaluates random images.

The weights: --torch_ckpt names a .pt file in the reference format.
Without it the run's own checkpoint is read, as the JAX CLI reads it
(ckpt/checkpoint.py restore_run_weights): --epoch (-1, the default: the
latest), --best (the best-robust slot, <run_dir>/ckpt_best) and --use_ema 1
(the EMA weights; a run that kept none is refused, never evaluated on its
raw weights). A port run gives ckpt[_best]/weights[_ema]_<e>.pt; a JAX
run's orbax snapshot ckpt[_best]/<e>/ is read through tensorstore
(ckpt/orbax_reader.py). Where tensorstore is not installed, export the JAX
run first with `python -m revisiting_at_tpu.cli.export --run_dir <run> --out
weights.pt` and pass --torch_ckpt.

A BN-family model (resnet50, ..., densnet201, inception) loads its running
statistics with its weights: --torch_ckpt's, or the run's, and with
--use_ema the EMA statistics that weights_ema_<e>.pt carries (a JAX run's
ema_batch_stats).

Distribution (revisiting_at_tpu/cli/eval.py:207-241, 258-303):
  * --multihost 1 (or torchrun, WORLD_SIZE > 1): one process per GPU or
    host, started from torchrun's environment (parallel/mesh.py
    init_distributed; NCCL on the card, gloo on the CPU, or the group the
    caller started). Each process attacks its round-robin shard x[r::n] of the
    eval set (evals.shard_for_process) exactly as a single process would
    attack that shard, and the robust counts are summed over the processes
    (evals.global_robust_accuracy): every rank logs the same global
    accuracy, rank 0 alone into the log file. --save_imgs writes each
    rank's shard to aa_adv_..._r<rank>.npy.
  * --shard_eval 1: each dispatched batch is split over this host's GPUs,
    the weights replicated (parallel/replicas.py); every point meets the
    draws of the one-device run. With one GPU it runs on it and says so.
  * --tp N (under torchrun, N processes a group): the block MLPs (and a
    ViT's heads, where N divides them) split over the group
    (parallel/tp.py); the groups shard the eval set as --multihost does.
    It requires --use_pallas 0, as in JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--epoch", type=int, default=-1, help="-1: latest checkpoint")
    p.add_argument("--best", action="store_true",
                   help="read the best-adv-val checkpoint (<run_dir>/ckpt_best)")
    p.add_argument("--use_ema", type=int, default=0,
                   help="the run's EMA weights (refused for a run that kept none)")
    p.add_argument("--torch_ckpt", type=str, default="",
                   help="reference-format .pt checkpoint to evaluate instead of the run's own")
    p.add_argument("--batch_size", type=int, default=200)
    p.add_argument("--n_ex", type=int, default=5000)
    p.add_argument("--l_norms", type=str, default="Linf", help="comma-separated")
    p.add_argument("--eps", type=float, default=None)
    p.add_argument("--l_epss", type=str, default="",
                   help="comma-separated eps per norm, aligned with --l_norms; overrides --eps")
    p.add_argument("--full_aa", type=int, default=0)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--data_dir", type=str, default="",
                   help="ImageFolder root of the eval images (e.g. ImageNet val)")
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate on random images (smoke tests only: numbers are meaningless)")
    p.add_argument("--only_clean", action="store_true")
    p.add_argument("--save_imgs", action="store_true",
                   help="write x_adv of each norm to <run_dir>/aa_adv_{n_ex}_{norm}_{eps}.npy")
    p.add_argument("--n_iter", type=int, default=100)
    p.add_argument("--square_queries", type=int, default=5000,
                   help="Square attack query budget (autoattack n_queries)")
    p.add_argument("--fab_iter_chunk", type=int, default=50,
                   help="accepted for the JAX CLI's sake; no effect (the attacks run eagerly)")
    p.add_argument("--square_query_chunk", type=int, default=500,
                   help="accepted for the JAX CLI's sake; no effect (the attacks run eagerly)")
    p.add_argument("--use_pallas", type=int, default=0,
                   help="the fused kernels: the block tail (ConvNeXt and ViT blocks) and "
                        "the ViT attention")
    p.add_argument("--wide_tail", type=int, default=-1,
                   help="the fused tail past C = 512 in training mode; -1: on for convnext_large")
    p.add_argument("--stem_s2d", type=int, default=0,
                   help="accepted for the JAX CLI's sake; no effect (the plain stem conv)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--shard_eval", type=int, default=0,
                   help="split each eval batch over this host's GPUs, weights replicated")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel group size (under torchrun): the block MLPs split "
                        "over it (parallel/tp.py); requires --use_pallas 0")
    p.add_argument("--multihost", type=int, default=0,
                   help="one process per host or GPU: each attacks its round-robin shard of "
                        "the eval set, robust counts summed over the processes")
    return p.parse_args(argv)


def load_eval_set(args, num_classes: int):
    """The eval set: the first n_ex images of --data_dir by basename, resized
    and centre-cropped at img_size, as uint8 (revisiting_at_tpu/cli/
    eval.py:85-113); or, with --synthetic, the JAX evaluator's random draw
    (RandomState(0))."""
    if args.data_dir:
        from ..data.folder import FolderConfig, FolderLoader

        # read once: decoded by min(8, CPUs) threads of this process, as
        # tf.data's 8 parallel calls, with no worker processes to start
        loader = FolderLoader(FolderConfig(
            root=args.data_dir, resolution=args.img_size, batch_size=args.batch_size,
            is_train=False, drop_remainder=False, sort_by_basename=True,
            subset_size=args.n_ex, num_parallel=min(8, os.cpu_count() or 1),
            cache_decoded=True))
        xs, ys = zip(*((img.numpy(), lab.numpy()) for img, lab in loader))
        return np.concatenate(xs), np.concatenate(ys).astype(np.int64)
    if not args.synthetic:
        raise SystemExit("no --data_dir given: pass --data_dir /path/to/val for a real "
                         "evaluation, or --synthetic to run on random images (smoke test only)")
    print("WARNING: --synthetic evaluation: accuracies below are meaningless")
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, size=(args.n_ex, args.img_size, args.img_size, 3)).astype(np.float32)
    y = rng.randint(0, num_classes, size=args.n_ex).astype(np.int64)
    return x, y


def main(argv=None) -> dict:
    """Run the evaluation; returns {norm: {"eps", "robust" (or "clean"), "n",
    "points"}}: the accuracy and count over every process's shard, and
    this process's per-point mask."""
    args = get_args(argv)
    if args.tp > 1 and args.use_pallas:
        raise SystemExit("--tp requires --use_pallas 0 (parallel/tp.py)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available (pass --device cpu "
                         "to evaluate on the CPU)")
    norms = args.l_norms.split(",")
    epss = [float(e) for e in args.l_epss.split(",")] if args.l_epss else None
    if epss is not None and len(epss) != len(norms):
        raise SystemExit(f"--l_epss has {len(epss)} values for the {len(norms)} norms of "
                         f"--l_norms: give one eps per norm")

    import torch.distributed as dist

    from ..config import DistSection
    from ..parallel.mesh import MeshConfig, init_distributed, make_mesh

    info = init_distributed(DistSection(multihost=args.multihost), device)
    mesh = None
    try:
        if info.world % max(args.tp, 1):
            raise SystemExit(f"--tp {args.tp} needs a multiple of {args.tp} processes (torchrun "
                             f"--nproc_per_node {args.tp}); this run has {info.world}")
        mesh = make_mesh(MeshConfig(model=max(args.tp, 1)))
        return _evaluate(args, norms, epss, info.device, mesh)
    finally:
        if mesh is not None:
            mesh.release()
        if info.started and dist.is_initialized():
            dist.destroy_process_group()


def _evaluate(args, norms, epss, device, mesh) -> dict:
    import torch.distributed as dist

    from ..ckpt.checkpoint import restore_run_weights
    from ..ckpt.convert import load_state_dict, param_layout, read_torch_checkpoint
    from ..config import load_params_json
    from ..evals import (EPS_DICT, SHORT_ATTACKS, STANDARD_ATTACKS, AutoAttack, AutoAttackConfig,
                         global_robust_accuracy, shard_for_process)
    from ..models import get_model, resize_vit_pos_embed
    from ..parallel.tp import apply_tensor_parallel
    from ..train.train_step import input_grad_view
    from ..utils.logging import EvalLogger

    run_dir = Path(args.run_dir)
    cfg = load_params_json(run_dir / "params.json")
    model, meta = get_model(
        cfg.model.arch, not_original=bool(cfg.model.not_original),
        updated=bool(cfg.model.updated), num_classes=cfg.data.num_classes, dtype=torch.bfloat16,
        use_blurpool=bool(cfg.training.use_blurpool),
        add_normalization=bool(cfg.model.add_normalization),
        use_pallas=bool(args.use_pallas), img_size=args.img_size,
        wide_tail=None if args.wide_tail < 0 else bool(args.wide_tail),
    )
    if args.torch_ckpt:
        sd = read_torch_checkpoint(args.torch_ckpt)
    else:
        try:
            sd, epoch = restore_run_weights(run_dir, cfg.model.arch, best=args.best,
                                            epoch=args.epoch, use_ema=bool(args.use_ema))
        except FileNotFoundError as e:
            raise SystemExit(f"{e}: pass --torch_ckpt <weights.pt>, or an --epoch the run "
                             f"saved") from e
        print(f"weights: {'ckpt_best' if args.best else 'ckpt'} epoch {epoch}"
              f"{' (EMA)' if args.use_ema else ''} of {run_dir}", flush=True)
    if meta.family == "vit":
        sd = resize_vit_pos_embed(sd, args.img_size, meta.patch_size)
    load_state_dict(model, sd)
    if args.tp > 1:
        if not apply_tensor_parallel(model, mesh, param_layout(cfg.model.arch)):
            raise AssertionError(f"--tp {args.tp}: no param matched the TP rules for this arch")
    model = model.to(device).eval().requires_grad_(False)
    # every eval attack differentiates w.r.t. the input only
    attack_view = input_grad_view(model)
    logits_fn = attack_view
    if args.shard_eval:
        from ..parallel.replicas import SplitBatch

        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        if n_dev == 1:
            print(f"--shard_eval 1: this host has one {device.type} device; the batches run "
                  f"on it whole", flush=True)
        else:
            logits_fn = SplitBatch(attack_view, [torch.device("cuda", i) for i in range(n_dev)])
            print(f"--shard_eval 1: each batch split over {n_dev} GPUs", flush=True)

    x, y = load_eval_set(args, cfg.data.num_classes)
    shards = mesh.batch_count
    x, y = shard_for_process(x, y, mesh.batch_rank, shards)
    # one log writer: rank 0; under TP one writer of the images a group
    main_rank = mesh.rank == 0
    logger = EvalLogger(str(run_dir / f"evaluated_logs_{args.l_norms}_{args.full_aa}.txt")
                        if main_rank else None)
    count_device = device if dist.is_initialized() and dist.get_backend() == "nccl" else "cpu"

    def global_acc(mask):
        if shards == 1:
            return float(mask.mean()), len(mask)
        return global_robust_accuracy(mask, mesh.groups["batch"], count_device)

    results = {}
    for norm_idx, norm in enumerate(norms):
        if epss is not None:
            eps = epss[norm_idx]
        else:
            eps = args.eps if args.eps is not None else EPS_DICT["imagenet"][norm]
        if eps > 1 and norm == "Linf":
            eps /= 255.0
        attacks = STANDARD_ATTACKS if args.full_aa else SHORT_ATTACKS
        aa = AutoAttack(logits_fn, AutoAttackConfig(
            norm=norm, eps=eps, attacks_to_run=attacks, n_iter=args.n_iter,
            square_n_queries=args.square_queries, batch_size=args.batch_size),
            logger=logger, device=device)
        logger.log(f"norm={norm} eps={eps:.5f} attacks={attacks}")
        if args.only_clean:
            points = aa.clean_accuracy(x, y)
            acc, n = global_acc(points)
            logger.log(f"clean accuracy: {acc:.2%} ({n} pts)")
            results[norm] = dict(eps=eps, clean=acc, n=n, points=points.tolist())
            continue
        out_path = None
        if args.save_imgs and mesh.coords["model"] == 0:
            rank = f"_r{mesh.batch_rank}" if shards > 1 else ""
            out_path = run_dir / f"aa_adv_{args.n_ex}_{norm}_{eps:.5f}{rank}.npy"
        _, robust = aa.run_standard_evaluation(x, y, out_path=out_path)
        acc, n = global_acc(robust)
        logger.log(f"robust accuracy ({norm}): {acc:.2%} ({n} pts)")
        results[norm] = dict(eps=eps, robust=acc, n=n, points=robust.tolist())
        if out_path is not None:
            results[norm]["adv_path"] = str(out_path)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
