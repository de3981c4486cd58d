#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (revisiting_at_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--kernels-only]

Phases, each fatal on failure:
  1. environment: CUDA present; card name and power limit, torch and CUDA versions;
  2. build the kernels (csrc/block_mlp.cu, csrc/block_mlp_bwd.cu,
     csrc/attention.cu and csrc/dwconv.cu, sm_90a), one nvcc per source,
     all started together; ptxas spills are printed;
  3. each kernel against its plain PyTorch version, in bf16: the block
     tail's forward and input backward at the four ConvNeXt-T stage shapes
     at batch 32 (stage 3, C = 768, also at batch 80, ragged, in f32 and
     with a per-sample keep); its full backward (row pass, weight pass,
     reductions, and the host recovery of dW2, db2, dgamma) on all nine
     cotangents at stages 0-2 at batch 80 (and C = 768 at batch 80 and
     ragged with a keep); both also at a ragged M, in f32 once, with a
     per-sample keep once, at the other widths built (ConvNeXt-B/L), at
     convnext_iso's C = 432 and ConvNeXt-B's stage-2 C = 512 (196 rows an
     image: batch 32, the full backward at batch 80, ragged with a keep, f32),
     at ConvNeXt-B's stage-3 C = 1024 (49 rows an image: batch 32 and 80,
     ragged with a keep, f32) and at the micro models' C = 16, 32, 64 (padded
     to 64); the first launch of each cluster kernel (C = 432, 512, 768 in
     clusters of two, 1024 in clusters of four; its plan and the clusters the
     card holds at a time logged) under a watchdog; the weight pass with
     its reduction alone, both products, at WGRAD_CASES (the stage shapes, a
     ragged M, ViT-S, C = 432, every other width); the attention forward and
     backward (dq, dk, dv) at ATT_CASES (ViT-S, M and B at batch 80 and 197
     tokens, ViT-S at 401 and 577 tokens, vit_micro's head width 16, the
     widths 32, 80 and 128, one token, and 64, 65, 208, 209 and 255 tokens,
     whose last key tile is full or holds 1, 16, 17 or 63 keys) and ViT-S
     with every score below 0; the column reduction alone at the row pass's
     stage-0 shape and at REDUCE_ROWS x REDUCE_COLS, one launch each; the
     7x7 depthwise conv's forward, dx, weight pass and reduction at
     ConvNeXt-T's gated stages (0-2) at batch 80, 224 and 320 px, on a
     ragged map and once in f32, and its one-launch reduction at the three
     stages' partial shapes and a ragged one (the dwconv's plan and blocks
     per SM logged, the first launch of each of its TMA-ring kernels under
     a watchdog); each output within its own tolerance (TOL). Two
     launches must give the same bits (every kernel), the full backward's
     row pass must give the input backward's ds bit for bit (stages 0-2
     at batch 80, C = 432, 512, 768 and 1024, ragged M with a keep), and
     eight planted faults (the last block's partial h left out of rank 0's
     columns in the C = 768, 512 and 1024 clusters' exchange, the C = 432
     forward's LayerNorm statistics taken
     over its padded 512 columns, a slice of M left out of dW1, a row group left
     out of db1, one zero key past N left unmasked in the attention, a
     dwconv band's top halo row read as zero, one block's partial left out
     of the dwconv's dw) must fail the check;
  4. the ConvNeXt evaluation path through its entry point: ConvNeXt-T-CvSt at
     full width and 224 px with random weights from --seed, written to a run
     dir as params.json + .pt, evaluated by `cli.eval.main` (short
     AutoAttack, --use_pallas 1);
  5. the same short AutoAttack with labels set to the model's own clean
     predictions, so APGD-CE and APGD-T run on every point; the logits are
     checked against the CPU plain version on a small input;
  6. the ConvNeXt training step as bench.py builds it: ConvNeXt-T-CvSt, bf16,
     224 px, batch 80, mixup, 2-step APGD Linf 4/255, AdamW on the cosine
     schedule, EMA 0.9999, use_pallas=1; 2 warm-up steps, then 10 timed
     (host clock around a synchronize) in turns with the plain-tail step
     (use_pallas=0), kernel, plain, plain, kernel; one step checked against
     the CPU plain version at batch 2;
  7. the ConvNeXt train CLI: `cli.train.main` on ConvNeXt-T-CvSt at 224 px,
     synthetic data, batch 16, 1 epoch, then `cli.eval.main` on the EMA
     weights it wrote;
  8. timings of the block-tail kernels beside their plain versions, bounds
     and the plain model path's tail, at the stage shapes (forward and input
     backward at batch 200, full backward at batch 80; the forward, input
     backward and row pass also by the profiler's device time, the row pass
     beside the model path's training backward; the weight pass alone
     and with its reduction beside torch.matmul on the same operands, with
     the profiler's device times and its slices of M; the column reduction
     on the full backward's 15 partials beside torch.sum, in turns, with
     both device times), and ms per APGD
     iteration at batch 32 with and without the kernels; torch.profiler
     breakdowns of the training step (phase 6) and of APGD by kernel family;
  9. the ViT evaluation path: ViT-S-CvSt (vit_s, not_original=1) at full
     width and 224 px with random weights from --seed, evaluated by
     `cli.eval.main` (short AutoAttack, --use_pallas 1), once more at 320 px
     and at 384 px (401 and 577 tokens, pos_embed resized); the logits
     checked against the CPU plain version on a small input;
 10. the ViT training step as bench.py builds its vit_s_cvst_at row: the
     step of phase 6 on ViT-S-CvSt, kernel path and use_pallas=0 in turns,
     one step checked against the CPU plain version at batch 2; then one
     step each of vit_micro and convnext_micro (use_pallas=1, 224 px)
     against the CPU plain version;
 11. the ViT train CLI: `cli.train.main` on ViT-S-CvSt, then `cli.eval.main`
     on its EMA weights;
 12. timings of the attention kernels beside their bounds, plain versions,
     the model path's attention (use_pallas=0) and
     scaled_dot_product_attention (in turns over ATT_ROUNDS rounds: medians
     and spreads; and each call's device time from the profiler), at the
     training shapes; torch.profiler's breakdown of the ViT step (phase 10)
     by kernel family;
 13. ConvNeXt-T-CvSt built directly with use_pallas_dwconv=1 and
     use_pallas=1 (no factory or CLI flag sets it): short AutoAttack on
     points labelled by the model, its logits against the CPU plain
     version; the training step of phase 6 on it, timed in turns with
     phase 6's library-conv step (both use_pallas=1), dwconv, library,
     library, dwconv, after 5 warm-up steps, with both profiles (the
     convolutions split into depthwise and the rest) and one step against
     the CPU plain version at batch 2; each dwconv kernel's launches per
     step (60 forwards, 45 dx, 15 weight passes, one reduction each);
 14. FGSM training (bench.py's single-step RS-FGSM, alpha 1.25, 4/255):
     the step on ConvNeXt-T-CvSt with and without the dwconv kernel and on
     ViT-S-CvSt (bench.py's vit_s_fgsm_at), batch 80, timed in turns; the
     dwconv launches per step (45 forwards, 30 dx, 15 weight passes, one
     reduction each) and both ConvNeXt steps' profiles; then
     `cli.train.main --adv.attack fgsm` on ConvNeXt-T-CvSt and
     `cli.eval.main` on its EMA weights;
 15. timings of the dwconv kernels at the gated stage shapes, batch 80,
     beside their bounds, plain versions and the library's depthwise conv
     (F.conv2d(groups=C) on the channels_last bf16 map, and its autograd
     backward for dx and for dw/db; torch.sum for the reduction), each
     kernel and library call also by the profiler's device time, and the
     weight pass with its reduction as one call, per stage and summed;
 16. the full recipe on real images: (a) ImageFolder trees of JPEGs made
     from --seed in a temporary directory (train 8 classes x 60, each
     linked under 5 more names so that an epoch outlasts the loader's
     batches in flight, val 8 x 25, ImageNet's sizes); (b) augment_batch
     (RandAugment, erasing, flip) on the card against the CPU at batch 8
     with the same draws and noise, then timed alone at batch 80, 224 px,
     whole and by part (flip, photometric layers, warp, erasing), each with
     its operator calls, and each photometric op on the whole batch (the
     fixed-shape formulation's cost); (c) the training step of phase 6 with the full
     recipe (uint8 batch from the folder, RandAugment, erasing and flip,
     mixup, APGD, AdamW, EMA, use_pallas=1), 2 warm-up steps that alone
     must launch the tail kernels, then in turns with phase 6's step, and
     profiled (the augmentation as its own span), one step against the CPU
     plain version at batch 2 with the same draws; (d) the loader alone for
     one epoch (images/s with min(8, CPUs) workers), then `cli.train.main`
     on the folders with augmentations for 2 epochs whose ramp goes 192 ->
     224 px, the wait on the loader per step beside the step time once the
     batches in flight at the epoch's start are used up; (e)
     `cli.eval.main --data_dir` on the val folder with its EMA weights;
     then the fork server and the loader workers are stopped, and no
     process this run started may be left running;
 17. full AutoAttack (APGD-CE, APGD-T, FAB-T, Square): (a) `cli.eval.main
     --full_aa 1 --use_pallas 1` on phase 4's ConvNeXt-T-CvSt run at 224 px,
     16 images labelled by the model, Linf and L2 with tiny --l_epss so
     that every attack has a worklist, --save_imgs (each .npy inside its
     eps-ball and the box), 5 iterations, 50 queries; (b) FAB-T alone (10
     iterations, one target) and Square alone (50 queries) through
     AutoAttack at batch 200, Linf 4/255, the kernels and use_pallas=0 in
     turns, ms per iteration or query, points broken, the kernel path
     profiled (device busy share); FAB-T must launch the tail's forward and input
     backward, Square the forward and no backward; the iteration's two
     Linf projections timed alone; (c) on a small f32 tanh MLP, the card
     against the CPU within the CPU tests' tolerances: FAB (3 norms, 20
     iterations), each iteration a step of the card from the CPU's carry
     (the card's own trajectory logged), and Square (3 norms, 30 queries)
     with the same draws; (d) `cli.runner` with one job on the card, after
     which no process it started may be left; (e) `cli.eval.main
     --full_aa 1` on phase 9's ViT-S-CvSt, 8 images labelled by the model,
     which must launch the attention's forward and both backward passes;
 18. the trainer's options and the checkpoints: (a) `cli.train.main` on
     ConvNeXt-T-CvSt at 224 px, batch 80, 2 epochs of 4 synthetic batches,
     with grad_accum 2, adversarial validation every epoch (2 APGD steps,
     one val batch; run again alone, it must launch the tail's forward and
     input backward), EMA, log_flops and profile_steps 2 (the chrome trace
     must name the four tail kernels); then the same run dir without its
     epoch-1 files, resumed with --model.ckpt_path: its epoch-1 full state
     (weights, optimizer, EMA, step) must equal the first run's bit for bit,
     or else lie within what a second uninterrupted run differs by; (c)
     `cli.eval.main` on that run without --torch_ckpt, with --epoch 0
     --use_ema 1 and with --best (each eval set labelled by the weights the
     flags pick), and --use_ema 1 on a copy without EMA files, which must
     fail; (b) phase 6's step with remat 0 and remat 1 from the same
     weights: one step's loss and gradients within phase 6's step
     tolerances, the tail forwards per step (69 and 120: the recomputed
     forwards run the kernel), remat's peak memory above the resident
     state below the other's; then both and a grad_accum 2 step in turns,
     and profiled; (c) a ViT-S-CvSt step with remat at batch 32, which must
     launch the attention and tail forwards 84 times a step;
 19. the isotropic ConvNeXt, PGD, the wrapped model and the BN family: (a)
     phase 6's step on ConvNeXt-iso-CvSt (convnext_iso, updated=1: C = 432,
     18 blocks, ConvStem; the tail's TMA + wgmma kernels in clusters of two
     blocks on 512's tiling) at 224 px, batch 80, 2
     warm-up steps, then in turns with use_pallas=0 (kernel, plain, plain,
     kernel), the tail's forward, input backward, row pass, weight pass and
     reduction launched 72, 36, 18, 36 and 90 times a step, profiled; one
     step against the CPU at batch 2; one step with updated=0 (C = 384,
     TMA + wgmma) launching the same kernels as often; `cli.train.main` on
     it (1 epoch of 4 synthetic batches at batch 80), `cli.eval.main`
     (short AutoAttack, --use_ema 1) on what it wrote and `cli.export.main`,
     whose file must strict-load; (b) pgd_attack (Linf and L2, 10 steps)
     and AdversarialModel (apgd, fgsm) on (a)'s weights at B = 32, bf16
     (each must launch the tail's forward and input backward; ms per PGD
     iteration), then on 2 images in f32 the card against the CPU from the
     same start and draws (Linf: at most 5% of the elements apart, none by
     more than 2 eps; L2: the deltas within 5% of each other; the wrapped
     model's logits within 2e-3); (c) the BN family
     on cuDNN: resnet50, densnet201 (224 px) and inception (299 px) with BN
     scales drawn and statistics calibrated as a trained model's, eval
     logits and one training step without attack against the CPU at batch 2
     in f32 (the running statistics within 2e-2; Inception's pool branch
     alone, input gradients within 1e-5, beside the library's pool over a
     channels_last tensor, which it replaces), the APGD step timed at
     batch 80 in bf16; `cli.train.main` on
     resnet50 with model.pretrained=1 from a state_dict made here and saved
     to a temporary .pt (4 steps at batch 80), `cli.eval.main --use_ema 1`
     and `cli.export.main`, whose file must strict-load; (d) phase 6's step on
     ConvNeXt-B-CvSt (convnext_base, ConvStem, 88.75 M parameters: stage 2
     is 27 blocks at C = 512) at 224 px, batch 80, 2 warm-up steps, then in
     turns with use_pallas=0, the tail's kernels launched 141, 72, 33, 66
     and 165 times a step, the kernel step profiled (the tail's row kernels
     also by width: stage 3's C = 1024 forward and input backward 9 and 6
     times a step); one step against the CPU at batch 2.
     The tail's times at the iso shape (M = 196 x 80, C = 432) and at
     ConvNeXt-B's stages 2 (M = 196 x 80, C = 512) and 3 (M = 49 x 80, C =
     1024): forward, input backward, full backward, beside their bounds,
     plain versions and the model path, go into the kernels line
     (`iso432`, `c512`, `c1024`), each kernel with its `design` there.
 20. the distributed paths (parallel/): (a) under a one-rank NCCL process
     group, `cli.train.main` on ConvNeXt-T-CvSt (224 px, batch 80,
     use_pallas=1, 4 synthetic batches; the tail's five kernels must
     launch), then phase 6's step through `ParallelModel` on the one-rank
     mesh against the non-distributed step, timed in turns with it and
     with the plain step: a start-up and NCCL smoke test (a one-rank mesh
     has no group, so no sync runs; parameters and loss bit for bit); the
     syncs are (b)-(d)'s; (b)-(e) two
     ranks of this script (`--phase20-worker`) on the one card over gloo
     (NCCL refuses two ranks on one device), started by
     `parallel.launch.run_ranks` and killed together on a failure: (b)
     data = 2 steps of ConvNeXt-T-CvSt and ViT-S-CvSt (40 images a rank)
     and resnet50 (8; its BatchNorm statistics averaged), each rank
     launching the tail (and attention) kernels, each against one process
     here that runs the two halves with their rank's draws, averages the
     gradients and statistics and takes one AdamW step (loss and
     grad_norm within 2e-2, the update at cosine above 0.99: phase 6's
     tolerances); (c) fsdp = 2 where gloo takes CUDA tensors in
     reduce_scatter_tensor (else its error is printed and the CPU tests
     alone check FSDP at world 2), against one process and the data = 2
     step, its checkpoint strict-loaded by the single-process cli.eval;
     (d) model = 2 (use_pallas=0): logits within 2e-2 of the largest and
     one step against the one-rank plain step, its gradient before the
     AdamW update compared too (the whole within P20_TP_GRAD_TOL, each
     tensor within P20_TP_TENSOR_TOL, relative: a missing all-reduce of
     the split blocks' backward breaks it); (e) `cli.eval --multihost 1`
     on 16 images labelled by the model: both ranks the same global robust
     accuracy, each rank's points a single-process AutoAttack run on its
     round-robin shard. Each part's wall time is printed; no process may
     be left.

The launch counters are zeroed just before each path (phases 4-5, 6, 7, 9,
10, 11, 13, 14, 16, 17, 18, 19 and 20) and read just after it: every kernel the
path runs must have launched there. The `launches` of the kernels line are phase 6's for
the block tail, phase 10's for the attention and phase 13's training step
for the dwconv. The second-to-last line is a
JSON object {"kernels": [...]}, the last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

# Tolerance of each kernel output against its plain version on the card:
# max |kernel - plain| <= TOL[output] * max |plain|. Both round the same
# operands to bf16 and differ in f32 summation order, which can flip a bf16
# rounding of u16, g16 or dh16. Each bound is four to eight times the
# largest reading over the shapes of phase 3 on an H100 (700 W):
TOL = {
    # bf16 outputs: a flip moves a value by one bf16 ulp, 2^-8 to 2^-7 of it
    # (largest readings: y 5.4e-3, ds 3.9e-3)
    "fwd": 2e-2, "bwd_input": 2e-2, "ds": 2e-2,
    # f32 sums over M rows of bf16 products: a flipped g16 or dh16 rounding
    # moves one term; the fewer the rows, the more it shows (largest readings,
    # at M = 103: dw1 1.1e-3, A 1.3e-3, dw2 1.4e-3; dgamma 1.6e-4)
    "dw1": 5e-3, "A": 5e-3, "dw2": 5e-3, "dgamma": 1e-3,
    # f32 column sums of f32 terms (largest readings: dLN 2.3e-4, db1 5.4e-5)
    "dln_g": 1e-3, "dln_b": 1e-3, "db1": 2.5e-4,
    # db2 is the same host code on the same kdy on both sides (reading 0)
    "db2": 1e-6,
    # the weight pass and the reduction alone, on the same operands: f32
    # summation order only (largest readings 2.9e-6 and 2.6e-7; the TMA +
    # wgmma weight pass, which sums up to 8,960 rows per slice in its
    # accumulators, 9.2e-6 at stage 0, so 2.2 times under this bound: the
    # error grows with the rows per slice, 6.2e-6 at 5,760)
    "wgrad": 2e-5, "reduce": 2e-6,
    # attention, bf16 outputs: a score one f32 ulp apart can flip the bf16
    # rounding of p or ds16, which moves an output by one bf16 ulp of a term
    # (largest readings over the ATT_CASES and the all-negative scores: o
    # 3.3e-3, dq 2.0e-3, dk 2.1e-3, dv 2.8e-3 with the TMA + wgmma kernels,
    # which form e and p within a few f32 ulp of the plain version's)
    "att_o": 1e-2, "att_dq": 8e-3, "att_dk": 1e-2, "att_dv": 1e-2,
    # dwconv: y and dx round an f32 sum to the map's type on both sides,
    # the kernel's made of fused multiply-adds, the plain version's of
    # separate ones, so a bf16 rounding can flip by one ulp (largest
    # readings: y 3.7e-3, dx 3.7e-3); dw, db and the reduction are f32 sums
    # in another order (largest readings: dw 5.1e-7, db 3.1e-7, 2.4e-7; the
    # one-launch reduction 1.7e-7)
    "dw_y": 2e-2, "dw_dx": 2e-2, "dw_dw": 3e-6, "dw_db": 2e-6, "dw_reduce": 1.5e-6,
}

TRAIN_BATCH = 80  # the training step's batch (bench.py's configuration)
# ConvNeXt-T stage shapes: (rows per image at 224 px, C)
STAGES = [(3136, 96), (784, 192), (196, 384), (49, 768)]
# convnext_iso (updated=1): 14x14 tokens at 224 px, C = 432
ISO_ROWS = 196
# weight-pass checks (name, M, C): ConvNeXt-T's stages 0-2 at the training
# batch, a ragged M, ViT-S (197 tokens), convnext_iso, the other widths built
WGRAD_CASES = [("stage 0", 3136 * TRAIN_BATCH, 96), ("stage 1", 784 * TRAIN_BATCH, 192),
               ("stage 2", 196 * TRAIN_BATCH, 384), ("ragged", 3136 * 2 + 40, 96),
               ("ViT-S", 197 * TRAIN_BATCH, 384), ("convnext_iso", ISO_ROWS * TRAIN_BATCH, 432),
               ("C=128", 3136 + 40, 128), ("C=256", 784 + 40, 256), ("C=512", 196 * 2 + 8, 512),
               ("C=768", 49 * 2 + 5, 768), ("C=1024", 49 * 2 + 5, 1024),
               ("C=16", 3136 * 2 + 40, 16), ("C=32", 784 * 2 + 8, 32), ("C=64", 196 * 4 + 5, 64)]
# widths whose tail kernels phase 3 also checks for the same bits over two
# launches (beside the first case): the cluster widths and the smallest
# padded one
BITWISE_WIDTHS = (16, 432, 512, 768, 1024)
# the port's CUDA kernels (anonymous namespace of csrc/*.cu), for profiles
TAIL_KERNEL_NAMES = ("fwd_kernel", "bwd_kernel", "wgrad_kernel", "reduce_kernel")
ATT_KERNEL_NAMES = ("attn_fwd_kernel", "attn_bwd_rows_kernel", "attn_bwd_cols_kernel")
DW_KERNEL_NAMES = ("dwconv_fwd_kernel", "dwconv_wgrad_kernel", "dwconv_reduce_kernel")
TAIL_KERNELS = ("block_mlp_fwd", "block_mlp_bwd_input", "block_mlp_bwd_full_rows",
                "block_mlp_wgrad", "block_mlp_reduce")
ATT_KERNELS = ("attention_fwd", "attention_bwd_rows", "attention_bwd_cols")
# attention checks: (name, batch, tokens, heads, head width): ViT-S/M/B at
# the training batch, 224, 320 and 384 px; vit_micro's head width 16; the
# other widths built (32 and 128 at ViT-S's width, 80 with a second,
# partial TMA box); one token; a last key tile that is full or holds 1, 16,
# 17 or 63 keys (the forward's S as wide as the live keys, its PV as deep)
ATT_CASES = [("ViT-S", TRAIN_BATCH, 197, 6, 64), ("ViT-M", TRAIN_BATCH, 197, 8, 64),
             ("ViT-B", TRAIN_BATCH, 197, 12, 64), ("ViT-S@320", TRAIN_BATCH, 401, 6, 64),
             ("ViT-S@384", TRAIN_BATCH, 577, 6, 64), ("vit_micro", TRAIN_BATCH, 197, 2, 16),
             ("hd=32", TRAIN_BATCH, 197, 12, 32), ("hd=128", TRAIN_BATCH, 197, 3, 128),
             ("hd=80", 8, 300, 2, 80), ("N=1", TRAIN_BATCH, 1, 6, 64),
             ("N=64", TRAIN_BATCH, 64, 6, 64), ("N=65", TRAIN_BATCH, 65, 6, 64),
             ("N=208", TRAIN_BATCH, 208, 6, 64), ("N=209", TRAIN_BATCH, 209, 6, 64),
             ("N=255", TRAIN_BATCH, 255, 6, 64)]
# reduction checks: rows R x columns N of the partials (R*N past REDUCE_MAX_ELEMS
# skipped), beside the main path's shapes checked elsewhere
REDUCE_ROWS = (1, 63, 64, 65, 3920, 247)
REDUCE_COLS = (8, 96, 1536, 589824, 1001)  # 1001: ragged, no 16-byte loads
REDUCE_MAX_ELEMS = 1 << 28
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 outside
# the tensor cores, HBM
PEAK_BF16, PEAK_FP32, PEAK_HBM = 989e12, 67e12, 3.35e12
# rounds of the attention kernels against scaled_dot_product_attention in phase 12
ATT_ROUNDS = 5
DW_KERNELS = ("dwconv_fwd", "dwconv_dx", "dwconv_wgrad", "dwconv_reduce")
# ConvNeXt-T's stages the dwconv gate (C <= 384) admits: (map side at 224 px, C)
DW_STAGES = [(56, 96), (28, 192), (14, 384)]
# dwconv launches per training step over the 15 gated blocks: (forward, dx, weight pass)
DW_PER_STEP = {"apgd": (60, 45, 15), "fgsm": (45, 30, 15)}
# kernels-line names: <module>_<LAUNCHES key> for block_mlp, attention and dwconv
REPLACES = {"block_mlp_fwd": "revisiting_at_tpu/ops/block_mlp.py:108",
            "block_mlp_bwd_input": "revisiting_at_tpu/ops/block_mlp.py:237",
            "block_mlp_bwd_full_rows": "revisiting_at_tpu/ops/block_mlp.py:124",
            "block_mlp_wgrad": "revisiting_at_tpu/ops/block_mlp.py:124",
            "block_mlp_reduce": "revisiting_at_tpu/ops/block_mlp.py:124",
            "attention_fwd": "revisiting_at_tpu/ops/attention.py:213",
            "attention_bwd_rows": "revisiting_at_tpu/ops/attention.py:238",
            "attention_bwd_cols": "revisiting_at_tpu/ops/attention.py:238",
            "dwconv_fwd": "revisiting_at_tpu/ops/dwconv.py:37",
            "dwconv_dx": "revisiting_at_tpu/ops/dwconv.py:49",
            "dwconv_wgrad": "revisiting_at_tpu/ops/dwconv.py:49",
            "dwconv_reduce": "revisiting_at_tpu/ops/dwconv.py:49"}
SOURCE = {"block_mlp_fwd": "revisiting_at_tpu_torch/csrc/block_mlp.cu",
          "block_mlp_bwd_input": "revisiting_at_tpu_torch/csrc/block_mlp.cu",
          "block_mlp_bwd_full_rows": "revisiting_at_tpu_torch/csrc/block_mlp_bwd.cu",
          "block_mlp_wgrad": "revisiting_at_tpu_torch/csrc/block_mlp_bwd.cu",
          "block_mlp_reduce": "revisiting_at_tpu_torch/csrc/block_mlp_bwd.cu",
          "attention_fwd": "revisiting_at_tpu_torch/csrc/attention.cu",
          "attention_bwd_rows": "revisiting_at_tpu_torch/csrc/attention.cu",
          "attention_bwd_cols": "revisiting_at_tpu_torch/csrc/attention.cu",
          **dict.fromkeys(DW_KERNELS, "revisiting_at_tpu_torch/csrc/dwconv.cu")}
FULL_COTANGENTS = ("ds", "dln_g", "dln_b", "dw1", "db1", "A", "dw2", "db2", "dgamma")
# which kernel's error each cotangent of the full backward is booked under
FULL_ERR_KEY = {"ds": "bwd_full_rows", "dln_g": "reduce", "dln_b": "reduce", "db1": "reduce",
                "dw1": "wgrad", "A": "wgrad", "dw2": "wgrad", "db2": "bwd_full_rows",
                "dgamma": "wgrad"}


def log(msg):
    print(msg, flush=True)


class Recorder:
    """AutoAttack logger that prints each line and keeps it."""

    def __init__(self):
        self.lines: list[str] = []

    def log(self, msg: str) -> None:
        log(msg)
        self.lines.append(msg)


def first_launch(torch, what, fn, limit_s=60.0):
    """fn() (a kernel's first launch), then a CUDA event recorded after it
    and polled until the device has passed it. A launch that has not ended
    within limit_s hangs: the process ends at once (exit code 3) with a
    message, before anything waits on the device forever."""
    out = fn()
    done = torch.cuda.Event()
    done.record()
    t0 = time.time()
    while not done.query():
        if time.time() - t0 > limit_s:
            log(f"watchdog: {what} has not finished after {limit_s:.0f} s: the kernel hangs")
            os._exit(3)
        time.sleep(0.001)
    log(f"watchdog: the first launch of {what} finished within {time.time() - t0:.4f} s")
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def tail_inputs(torch, M, C, dtype, gen, keep_rows=0):
    dev = "cuda"
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    d = dict(s=rnd(M, C).to(dtype), r=rnd(M, C).to(dtype),
             ln_g=1.0 + 0.1 * rnd(C), ln_b=0.1 * rnd(C),
             w1=rnd(C, 4 * C) / C ** 0.5, b1=0.1 * rnd(4 * C),
             w2=rnd(4 * C, C) / (4 * C) ** 0.5, b2=0.1 * rnd(C),
             gamma=0.1 + 0.9 * torch.rand(C, generator=gen, device=dev),
             dy=rnd(M, C).to(dtype), keep=None, rows=M)
    if keep_rows:
        d["keep"] = torch.where(torch.arange(M // keep_rows, device=dev) % 2 == 0, 1.0, 2.0)
        d["rows"] = keep_rows
    return d


def run_tail(bm, d, which, kernel: bool):
    w2g16 = (d["w2"].bfloat16().float() * d["gamma"]).bfloat16()
    if which == "fwd":
        args = (d["s"], d["r"], d["keep"], d["rows"], d["ln_g"], d["ln_b"], d["w1"].bfloat16(),
                d["b1"], d["w2"].bfloat16(), d["b2"], d["gamma"])
        return bm.fwd_cuda(*args) if kernel else bm.fwd_plain(*args)
    args = (d["s"], d["keep"], d["rows"], d["ln_g"], d["ln_b"], d["w1"].bfloat16(), d["b1"],
            w2g16, d["dy"])
    return bm.bwd_input_cuda(*args) if kernel else bm.bwd_input_plain(*args)


def tail_design(bm, C, mode) -> str:
    """The tail kernel's design at width C, as phase 8 logs it."""
    plan = bm.tail_plan(C, mode)
    return plan.design + (f", clusters of {plan.cluster}" if plan.cluster > 1 else "")


def time_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, n, tries=3):
    """Device time per call of fn from torch.profiler over n calls: for each
    CUDA kernel name, its mean duration times its launches per call (its
    count over n, rounded), summed over the names. Means, not totals:
    kernels launched just as tracing starts can go unrecorded. Beside
    time_ms's event loop it shows whether a call is bound by the host. The
    profiler can miss every kernel of a run: then it traces again, and after
    `tries` empty traces the time is not measured (None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total / e.count * max(1, round(e.count / n))
                 for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count)
        if us > 0:
            return us / 1000
        log(f"device time: the profiler saw no device time in trace {attempt} of {tries}")
    return None


def ms_or_na(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def sum_or_none(a, b):
    return None if a is None or b is None else a + b


def run_full(bm, d, kernel: bool):
    """The full backward's nine cotangents (keep gets none), kernel or plain."""
    w2g16 = (d["w2"].bfloat16().float() * d["gamma"]).bfloat16()
    args = (d["s"], d["keep"], d["rows"], d["ln_g"], d["ln_b"], d["w1"].bfloat16(), d["b1"],
            w2g16, d["dy"])
    out = (bm.bwd_full_cuda if kernel else bm.bwd_full_plain)(*args)
    rec = bm.recover_gamma_cotangents(out[5], d["dy"], d["keep"], d["rows"], d["w2"], d["b2"],
                                      d["gamma"])
    return list(out) + list(rec)


def compare(got, ref) -> tuple[float, float]:
    """(max |got - ref|, max |ref|)."""
    return (got.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()


def check(torch, what, got, ref, tol) -> float:
    """max |got - ref|, fatal unless finite and within tol * max |ref|."""
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    e, scale = compare(got, ref)
    rel = e / scale if scale else (0.0 if e == 0 else float("inf"))  # an all-zero reference
    log(f"check {what}: max_abs_err={e:.3e} max|ref|={scale:.3e} ({rel:.2e} of it, "
        f"tolerance {tol:.1e})")
    if not e <= tol * scale:
        raise AssertionError(f"{what}: error {e} > {tol} * {scale}")
    return e


def planted_fault(what, got, ref, tol) -> None:
    """A deliberately wrong result: fatal unless `check` at tol would reject it."""
    e, scale = compare(got, ref)
    if e <= tol * scale:
        raise AssertionError(f"planted fault {what}: error {e} within {tol} * {scale}, "
                             "the check is blind to it")
    log(f"planted fault {what}: max_abs_err={e:.3e} ({e / scale:.2e} of max|ref|, "
        f"tolerance {tol:.1e}): rejected")


def padded_ln_forward(torch, bm, d, width):
    """The forward at d's width C with its LayerNorm statistics taken over
    `width` columns: the kernel built for `width` on d's inputs padded with
    zero channels (zero in s, r and the LN and output vectors, zero rows of
    W1 and columns of W2, and zero hidden units, whose GELU is 0), cut back
    to C columns. A planted fault of the padded tiling (statistics over the
    pad)."""
    import torch.nn.functional as F

    C, pad = d["s"].shape[1], width - d["s"].shape[1]
    w1 = d["w1"].new_zeros(width, 4 * width)
    w1[:C, :4 * C] = d["w1"]
    w2 = d["w2"].new_zeros(4 * width, width)
    w2[:4 * C, :C] = d["w2"]
    v = lambda t: F.pad(t, (0, pad))  # noqa: E731
    y = bm.fwd_cuda(v(d["s"]), v(d["r"]), d["keep"], d["rows"], v(d["ln_g"]), v(d["ln_b"]),
                    w1.bfloat16(), F.pad(d["b1"], (0, 4 * pad)), w2.bfloat16(), v(d["b2"]),
                    v(d["gamma"]))
    torch.cuda.synchronize()
    return y[:, :C]


def counter_modules():
    from revisiting_at_tpu_torch.ops import attention, block_mlp, dwconv
    return {"block_mlp": block_mlp, "attention": attention, "dwconv": dwconv}


def zero_launches() -> None:
    for mod in counter_modules().values():
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def launch_counts() -> dict:
    """{kernels-line name: launches since zero_launches}."""
    return {f"{prefix}_{k}": v for prefix, mod in counter_modules().items()
            for k, v in mod.LAUNCHES.items()}


def require_launches(path: str, kernels) -> dict:
    """The counts since zero_launches; fatal if a kernel of the path has none."""
    launches = launch_counts()
    log(f"launches in {path}: {launches}")
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on {path}")
    return launches


def wgrad_operands(torch, M, C, gen):
    """The weight pass's operands as the row pass leaves them: bf16 [Mpad, C]
    and [Mpad, 4C], Mpad = M rounded up to 64, rows past M zero."""
    m_pad = -(-M // 64) * 64
    u = torch.randn(m_pad, C, generator=gen, device="cuda").bfloat16()
    h = torch.randn(m_pad, 4 * C, generator=gen, device="cuda").bfloat16()
    u[M:] = 0
    h[M:] = 0
    return u, h


def check_wgrad(torch, bm, gen) -> float:
    """The weight pass with its reduction against wgrad_plain, for both
    products (dW1 = u16^T @ dh16 [C, 4C], A = g16^T @ kdy16 [4C, C]) at
    WGRAD_CASES: each within TOL["wgrad"], the same bits over two launches
    and as the partials summed by a separate reduction launch. Logs the
    slices of M per product. Returns the largest error."""
    worst = 0.0
    for name, M, C in WGRAD_CASES:
        u, h = wgrad_operands(torch, M, C, gen)
        for x16, y16 in ((u, h), (h, u)):
            what = (f"wgrad {name} M={M} {tuple(x16.shape)}^T @ {tuple(y16.shape)[1:]}, "
                    f"{bm.wgrad_plan(*x16.shape, y16.shape[1])[1]} slices of M")
            got = bm.wgrad_cuda(x16, y16)
            ref = bm.wgrad_plain(x16, y16)
            torch.cuda.synchronize()
            worst = max(worst, check(torch, what, got, ref, TOL["wgrad"]))
            if not torch.equal(got, bm.wgrad_cuda(x16, y16)):
                raise AssertionError(f"{what}: two launches differ")
            part = bm.wgrad_partials_cuda(x16, y16)
            if not torch.equal(got, bm.reduce_cuda(part.view(part.shape[0], -1)).view(got.shape)):
                raise AssertionError(f"{what}: the one-call sum differs from the partials' sum")
            del got, ref, part
        del u, h
        torch.cuda.empty_cache()
    log(f"wgrad: bitwise equal over two launches and to the partials' separate sum in all "
        f"{2 * len(WGRAD_CASES)} products")
    return worst


def check_reduce(torch, bm, gen, shapes) -> float:
    """The column reduction alone on random partials [R, N] at each shape:
    one launch of reduce_cuda, within TOL["reduce"] of reduce_plain, the
    same bits over two launches. Returns the largest error."""
    worst = 0.0
    for R, N in shapes:
        part = torch.randn(R, N, generator=gen, device="cuda")
        lanes, splits, rows = bm.reduce_plan(R, N)
        what = f"reduce {R}x{N} ({lanes} column lanes, {splits} splits of {rows} rows)"
        before = bm.LAUNCHES["reduce"]
        got = bm.reduce_cuda(part)
        if bm.LAUNCHES["reduce"] != before + 1:
            raise AssertionError(f"{what}: not one launch")
        torch.cuda.synchronize()
        worst = max(worst, check(torch, what, got, bm.reduce_plain(part), TOL["reduce"]))
        if not torch.equal(got, bm.reduce_cuda(part)):
            raise AssertionError(f"{what}: two launches differ")
        del part, got
    torch.cuda.empty_cache()
    log(f"reduce: one launch each, bitwise equal over two launches at {len(shapes)} shapes")
    return worst


def att_inputs(torch, B, N, H, hd, gen, negative=False):
    """bf16 qkv [B, N, 3D] and a cotangent do [B, N, D], D = hd * H. With
    `negative`, q >= 0 and k <= 0, so every score is about -20: softmax is
    shift-invariant, but a key that wrongly scores 0 then takes the mass."""
    D = hd * H
    qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda")
    if negative:
        qkv[..., :D] = 2.0 * qkv[..., :D].abs()
        qkv[..., D:2 * D] = -2.0 * qkv[..., D:2 * D].abs()
    return qkv.bfloat16(), torch.randn(B, N, D, generator=gen, device="cuda").bfloat16()


def check_attention(torch, att, gen) -> dict:
    """The attention kernels against their plain versions in bf16 at
    ATT_CASES and with every score below 0: o, dq, dk and dv each within its
    own tolerance; the same bits over two launches in every case; and the planted fault
    (one zero key past N left unmasked) rejected. Returns the largest error
    per kernel."""
    err = dict.fromkeys(ATT_KERNELS, 0.0)
    cases = [case + (False,) for case in ATT_CASES]
    cases += [("ViT-S, scores < 0", TRAIN_BATCH, 197, 6, 64, True)]
    for i, (name, B, N, H, hd, negative) in enumerate(cases):
        qkv, do = att_inputs(torch, B, N, H, hd, gen, negative)
        D = hd * H
        what = f"{name} B={B} N={N} H={H} hd={hd}"
        o = att.attention_fwd_cuda(qkv, H)
        o_ref = att.attention_qkv_fwd_plain(qkv, H)
        torch.cuda.synchronize()
        err["attention_fwd"] = max(err["attention_fwd"],
                                   check(torch, f"attention o  {what}", o, o_ref, TOL["att_o"]))
        d = att.attention_bwd_cuda(qkv, do, H)
        d_ref = att.attention_qkv_bwd_plain(qkv, do, H)
        torch.cuda.synchronize()
        for j, part in enumerate(("dq", "dk", "dv")):
            sl = slice(j * D, (j + 1) * D)
            e = check(torch, f"attention {part} {what}", d[..., sl], d_ref[..., sl],
                      TOL[f"att_{part}"])
            key = "attention_bwd_rows" if part == "dq" else "attention_bwd_cols"
            err[key] = max(err[key], e)
        if not (torch.equal(o, att.attention_fwd_cuda(qkv, H))
                and torch.equal(d, att.attention_bwd_cuda(qkv, do, H))):
            raise AssertionError(f"attention {what}: two launches differ")
        log(f"attention o, dqkv {what}: bitwise equal over two launches")
        if negative:
            padded = torch.cat([qkv, torch.zeros_like(qkv[:, :1])], dim=1)
            planted_fault(f"attention o with one zero key past N unmasked, {what}",
                          att.attention_qkv_fwd_plain(padded, H)[:, :N], o_ref, TOL["att_o"])
        del qkv, do, o, o_ref, d, d_ref
        torch.cuda.empty_cache()
    return err


def convnext_t_dwconv(torch, dtype, use_pallas: bool = True):
    """ConvNeXt-T-CvSt built directly with use_pallas_dwconv=1, as the JAX
    package's tests/test_dwconv.py builds its model: no factory or config
    flag sets it. Its state_dict is convnext_tiny's (not_original=1)."""
    from functools import partial

    from revisiting_at_tpu_torch.models import CONVNEXT_CFGS, ConvNeXt, ConvStem1

    return ConvNeXt(**CONVNEXT_CFGS["tiny"], stem_factory=partial(ConvStem1, siz=48),
                    dtype=dtype, use_pallas=use_pallas, use_pallas_dwconv=True)


_MODELS: dict = {}  # model_copy's models, one per configuration


def model_copy(key, build):
    """A copy of what build() makes (a model, or a model and its meta), built
    once per key, on the card: build_train_step loads a state_dict into its
    model and moves it to its device, so a copy of any model of the
    configuration serves, and a new one would pay the random init again
    (on the host, seconds a model: ConvNeXt-B has 88.75 M parameters)."""
    import copy

    import torch

    if key not in _MODELS:
        with torch.device("cuda"):
            _MODELS[key] = build()
    return copy.deepcopy(_MODELS[key])


def build_train_step(torch, state_dict, *, use_pallas: bool, device: str, seed: int,
                     arch: str = "convnext_tiny", dwconv: bool = False,
                     attack: str = "apgd", randaug: bool = False, augment_draws=None,
                     remat: bool = False, grad_accum: int = 1, updated: bool = False,
                     dtype=None):
    """The training step as bench.py builds it, on the port: the arch with
    ConvStem (ConvNeXt-T-CvSt, or ViT-S-CvSt for vit_s) in bf16 with f32
    params, AdamW(wd 0.05, the family's decay rule) on the cosine schedule
    (lr 1e-3, peak epoch 20, 300 epochs, 5,000 iterations per epoch), mixup
    with label smoothing 0.1, 2-step APGD Linf 4/255 (or, attack='fgsm',
    bench.py's RS-FGSM: alpha 1.25, 4/255), EMA 0.9999. dwconv: ConvNeXt-T-
    CvSt with use_pallas_dwconv=1 (convnext_t_dwconv). randaug: the full
    recipe's RandAugment, erasing and flip before mixup (bench.py's aug=True
    row), with augment_draws injected when given. remat: every block
    recomputed in the backward (training.remat); grad_accum: the optimizer
    updates every grad_accum steps (training.grad_accum); updated: convnext_iso's
    432-wide variant (model.updated); dtype: the compute dtype (bf16 unless
    given)."""
    from revisiting_at_tpu_torch.ckpt.convert import load_state_dict
    from revisiting_at_tpu_torch.data import MixupConfig, RandAugmentConfig
    from revisiting_at_tpu_torch.models import get_model
    from revisiting_at_tpu_torch.train import (AdvConfig, LRConfig, TrainState, ema_init,
                                               make_lr_schedule, make_optimizer,
                                               make_train_step)

    if dwconv:
        model, family = model_copy(("dwconv", use_pallas), lambda: convnext_t_dwconv(
            torch, torch.bfloat16, use_pallas)), "convnext"
    else:
        model, meta = model_copy((arch, use_pallas, remat, updated, dtype), lambda: get_model(
            arch, not_original=True, dtype=dtype or torch.bfloat16, use_pallas=use_pallas,
            remat=remat, updated=updated))
        family = meta.family
    load_state_dict(model, state_dict)
    model.to(device).train()
    sched = make_lr_schedule(LRConfig(lr=1e-3, lr_peak_epoch=20, epochs=300),
                             5000 // grad_accum)
    opt = make_optimizer(model, optimizer="adamw", weight_decay=0.05, family=family,
                         learning_rate=sched, grad_accum=grad_accum)
    step = make_train_step(model, adv=AdvConfig(attack=attack, norm="Linf", eps=4.0 / 255.0,
                                                n_iter=2, alpha=1.25),
                           mixup=MixupConfig(num_classes=1000, label_smoothing=0.1),
                           randaug=RandAugmentConfig() if randaug else None,
                           augment_draws=augment_draws, ema_decay=0.9999, seed=seed)
    return TrainState(model, opt, ema_init(model)), step


def run_steps(torch, state, step, x, y, n):
    """n steps; returns (ms per step on the host clock, the losses)."""
    torch.cuda.synchronize()
    t0 = time.time()
    losses = [step(state, x, y)["loss"] for _ in range(n)]
    torch.cuda.synchronize()
    return (time.time() - t0) * 1000 / n, [float(v) for v in losses]


def steps_in_turns(torch, steps, inputs, order, warm, require=None):
    """`warm` warm-up steps of each {name: (state, step)} on its {name: (x,
    y)}, then runs of 5 steps in `order`. require {name: (path, kernels)}:
    the launch counts are zeroed just before that step's warm-up and
    checked just after it, so that they are its own. Returns ({name: ms per
    step of each run}, {name: the losses})."""
    losses = {}
    for name in steps:
        if require and name in require:
            zero_launches()
        losses[name] = run_steps(torch, *steps[name], *inputs[name], warm)[1]
        if require and name in require:
            require_launches(*require[name])
    step_ms = {name: [] for name in steps}
    for name in order:
        ms, ls = run_steps(torch, *steps[name], *inputs[name], 5)
        step_ms[name].append(ms)
        losses[name] += ls
    return step_ms, losses


def check_dw_per_step(launches, n_steps, attack) -> None:
    """The dwconv launches per training step over n_steps steps, fatal
    unless they are DW_PER_STEP[attack] (forward, dx, weight pass) and the
    reductions are one per weight pass."""
    per_step = tuple(launches[k] / n_steps for k in DW_KERNELS)
    log(f"dwconv launches per {attack.upper()} training step ({n_steps} steps): forward "
        f"{per_step[0]}, dx {per_step[1]}, weight pass {per_step[2]}, reductions "
        f"{per_step[3]} (expected {DW_PER_STEP[attack]} and one reduction per weight pass)")
    if per_step[:3] != DW_PER_STEP[attack] or per_step[3] != per_step[2]:
        raise AssertionError(f"dwconv launches per {attack} step {per_step}, "
                             f"expected {DW_PER_STEP[attack]} and reductions = weight passes")


def check_step_against_cpu(torch, np, state_dict, seed, arch="convnext_tiny",
                           probes=("stages.0.blocks.0.mlp.fc1.weight",), dwconv=False,
                           augment=False, updated=False, img=224, dtype=None,
                           attack="apgd"):
    """One kernel step on the card against the same step on the CPU, where
    every kernel takes its plain version, at batch 2: the loss and the
    global gradient norm within 2e-2, and the gradient of each probe (a
    block's W1: full-backward kernel; a ViT block's qkv weight: attention
    backward; a block's conv_dw weight on the dwconv route: dwconv weight
    pass) at cosine similarity above 0.99. bf16 convolutions and the
    attack's sign steps round differently on the two devices, so this is a
    check of the path, not of the last bits. augment: the full recipe on a
    uint8 batch, both devices given the same augmentation draws and erasing
    noise (a rotation and a shear, equalize and color, one image erased).
    A BN model's running statistics after the step (the training forward
    moved them once, by flax's rule) are held within 2e-2 of the largest.
    img: the image side (Inception's 299); dtype: the compute dtype (bf16
    unless given); attack: the step's attack ('apgd', 'fgsm' or 'none')."""
    rng = np.random.RandomState(seed + 1)
    x = torch.from_numpy(rng.uniform(0, 1, (2, img, img, 3)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, 2))
    kw = {}
    if augment:
        x = (x * 255).to(torch.uint8)
        kw = dict(randaug=True, augment_draws=lambda step, b, h, w: fixed_draws(torch, b, h, w))
    out, stats = {}, {}
    for device in ("cuda", "cpu"):
        state, step = build_train_step(torch, state_dict, use_pallas=True, device=device,
                                       seed=seed, arch=arch, dwconv=dwconv, updated=updated,
                                       dtype=dtype, attack=attack, **kw)
        metrics = step(state, x.to(device), y.to(device))
        grads = [state.model.get_parameter(name).grad.float().cpu() for name in probes]
        out[device] = (float(metrics["loss"]), float(metrics["grad_norm"]), grads)
        stats[device] = {k: v.float().cpu() for k, v in state.model.state_dict().items()
                         if k.endswith(("running_mean", "running_var"))}
    (lc, nc, gc), (lp, np_, gp) = out["cuda"], out["cpu"]
    cos = [float((a * b).sum() / (a.norm() * b.norm())) for a, b in zip(gc, gp)]
    if stats["cpu"]:
        moved = sum(not torch.equal(v, state_dict[k].float()) for k, v in stats["cpu"].items())
        rel = max(float((stats["cuda"][k] - v).abs().max() / v.abs().max())
                  for k, v in stats["cpu"].items())
        log(f"{arch} running statistics after one step, card vs CPU "
            f"({dtype or torch.bfloat16}, batch 2): {moved} of {len(stats['cpu'])} moved on the "
            f"CPU, largest difference {rel:.3e} of the largest value (tolerance 2e-2)")
        if not (moved == len(stats["cpu"]) and rel <= 2e-2):
            raise AssertionError(f"the {arch} running statistics disagree with the CPU's")
    log(f"{arch}{' (dwconv kernel)' if dwconv else ''}{' (full recipe)' if augment else ''} "
        f"train step vs CPU plain version "
        f"(batch 2): loss {lc:.5f} / {lp:.5f}, "
        f"grad_norm {nc:.4f} / {np_:.4f}, gradient cosine "
        + ", ".join(f"{n} {c:.5f}" for n, c in zip(probes, cos)))
    if not (abs(lc - lp) <= 2e-2 * abs(lp) and abs(nc - np_) <= 2e-2 * abs(np_)
            and min(cos) > 0.99):
        raise AssertionError(f"the {arch} training step disagrees with the CPU plain version")


def _depthwise_7x7(shapes) -> bool:
    """A depthwise 7x7 weight [C, 1, 7, 7] among an op's input shapes."""
    return any(isinstance(sh, list) and len(sh) == 4 and sh[1] == 1 and sh[2:] == [7, 7]
               for sh in shapes)


def profile_breakdown(torch, what: str, fn, n: int, label: str, tries: int = 3):
    """torch.profiler over n calls of fn: wall and device time per call, the
    device's busy share, and device time by kernel family. The library's
    depthwise 7x7 convolutions are split out of "conv" by their ops
    (aten::convolution and aten::convolution_backward with a [C, 1, 7, 7]
    weight; every kernel those ops launch). The profiler inflates host time,
    so the shares are what to read. Returns the families in ms per call, or
    None (not measured) when `tries` traces in a row record no device time."""
    for attempt in range(1, tries + 1):
        out = _profile_once(torch, what, fn, n, label)
        if out is not None:
            return out
        log(f"profile {what}: the profiler saw no device time in trace {attempt} of {tries}")
    return None


def _profile_once(torch, what: str, fn, n: int, label: str):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.time()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1000 / n
    families = {"attention kernels": 0.0, "tail kernels": 0.0, "dwconv kernels": 0.0,
                "gemm": 0.0, "conv": 0.0, "other": 0.0}
    top, tail_kernels = [], {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key == "augment":
            continue  # "augment": the step's span on the device, not a kernel
        us = e.self_device_time_total / n
        name = e.key
        low = name.lower()
        if any(f"(anonymous namespace)::{k}" in name for k in ATT_KERNEL_NAMES):
            families["attention kernels"] += us
        elif any(f"(anonymous namespace)::{k}" in name for k in DW_KERNEL_NAMES):
            families["dwconv kernels"] += us
        elif any(f"(anonymous namespace)::{k}" in name for k in TAIL_KERNEL_NAMES):
            families["tail kernels"] += us
            tail_kernels[name] = (us / 1000, e.count / n)
        elif any(k in low for k in ("conv", "dgrad", "wgrad", "fprop", "cudnn", "implicit")):
            families["conv"] += us
        elif any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet")):
            families["gemm"] += us
        else:
            families["other"] += us
        top.append((us, name[:70]))
    lib_dw = sum(e.device_time_total for e in prof.key_averages(group_by_input_shape=True)
                 if e.key in ("aten::convolution", "aten::convolution_backward")
                 and e.device_type == DeviceType.CPU and _depthwise_7x7(e.input_shapes)) / n
    # the kernels of the train step's "augment" span: RandAugment, erasing and flip
    aug = sum(e.device_time_total for e in prof.key_averages()
              if e.key == "augment" and e.device_type == DeviceType.CPU) / n
    device = sum(families.values()) / 1000
    if device <= 0:
        return None
    top.sort(reverse=True)
    log(f"profile {what}: wall {wall:.2f} ms, device {device:.2f} ms "
        f"(busy {100 * device / wall:.1f}%), "
        + ", ".join(f"{k} {v / 1000:.2f} ms" for k, v in families.items())
        + f"; depthwise 7x7 convolutions: dwconv kernels {families['dwconv kernels'] / 1000:.2f}"
        f" ms, library ops {lib_dw / 1000:.2f} ms (conv less those: "
        f"{max(families['conv'] - lib_dw, 0.0) / 1000:.2f} ms)"
        + f"; augmentation (the step's augment span, within the families) {aug / 1000:.2f} ms"
        + "; top: " + "; ".join(f"{name} {us / 1000:.2f} ms" for us, name in top[:6])
        + f" {label}")
    out = {k: v / 1000 for k, v in families.items()}
    out.update(wall=wall, device=device, library_depthwise=lib_dw / 1000, augment=aug / 1000,
               tail_kernels=tail_kernels)
    return out


# a tail row kernel's name in a profile: kernel, width, I/O type, and FULL
# for bwd_kernel (the row pass: true, the input backward: false)
TAIL_TEMPLATE = re.compile(r"::(fwd_kernel|bwd_kernel)<(\d+), [\w:]+(?:, (true|false))?>")


def tail_by_width(prof, C: int) -> dict:
    """{LAUNCHES key: (device ms, launches) per call} of the tail's row
    kernels at width C in a profile_breakdown result ({} when it saw no
    device time): the forward, the input backward and the row pass, each
    summed over its I/O types."""
    out = {}
    for name, (ms, count) in ((prof or {}).get("tail_kernels") or {}).items():
        m = TAIL_TEMPLATE.search(name)
        if m is None or int(m[2]) != C:
            continue
        key = {"fwd_kernel": "fwd", "false": "bwd_input", "true": "bwd_full_rows"}[
            m[1] if m[3] is None else m[3]]
        ms0, count0 = out.get(key, (0.0, 0.0))
        out[key] = (ms0 + ms, count0 + count)
    return out


def vit_eval_phase(torch, np, repo, seed) -> dict:
    """Phase 9: ViT-S-CvSt through cli.eval (224 px, then 320 px with the
    checkpoint's pos_embed resized), short AutoAttack on points labelled by
    the model, and its logits against the CPU plain version. Returns the
    run's state_dict for the training phases."""
    from revisiting_at_tpu_torch.ckpt.convert import load_torch_checkpoint, save_torch_checkpoint
    from revisiting_at_tpu_torch.cli import eval as eval_cli
    from revisiting_at_tpu_torch.config import Config
    from revisiting_at_tpu_torch.evals import AutoAttack, AutoAttackConfig
    from revisiting_at_tpu_torch.models import get_model
    from revisiting_at_tpu_torch.train.train_step import input_grad_view

    run_dir = repo / "build" / "smoke_run_vit"
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg = Config()
    cfg.model.arch, cfg.model.not_original, cfg.model.add_normalization = "vit_s", 1, 0
    cfg.dump_params_json(run_dir / "params.json")
    torch.manual_seed(seed)
    model, _ = get_model("vit_s", not_original=True, dtype=torch.float32)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: vit_s + ConvStem, {n_params / 1e6:.2f} M params, seed {seed}")
    if not 22.7e6 < n_params < 22.9e6:
        raise AssertionError(f"unexpected parameter count {n_params}")
    save_torch_checkpoint(model, run_dir / "weights.pt")
    del model

    zero_launches()
    t0 = time.time()
    base = ["--run_dir", str(run_dir), "--torch_ckpt", str(run_dir / "weights.pt"),
            "--use_pallas", "1", "--synthetic", "--l_norms", "Linf", "--device", "cuda"]
    res = eval_cli.main(base + ["--n_ex", "32", "--batch_size", "32", "--n_iter", "10"])
    res320 = eval_cli.main(base + ["--n_ex", "8", "--batch_size", "8", "--n_iter", "2",
                                   "--img_size", "320"])
    res384 = eval_cli.main(base + ["--n_ex", "8", "--batch_size", "8", "--n_iter", "2",
                                   "--img_size", "384"])
    log(f"cli.eval vit_s: {res}; at 320 px (401 tokens): {res320}; at 384 px (577 tokens): "
        f"{res384}; {time.time() - t0:.1f} s")
    for r, n in ((res, 32), (res320, 8), (res384, 8)):
        if not 0.0 <= r["Linf"]["robust"] <= 1.0 or r["Linf"]["n"] != n:
            raise AssertionError(f"bad eval result {r}")

    m, _ = get_model("vit_s", not_original=True, dtype=torch.bfloat16, use_pallas=True)
    load_torch_checkpoint(run_dir / "weights.pt", m)
    fused = input_grad_view(m.cuda().eval().requires_grad_(False))
    x = np.random.RandomState(seed).uniform(0, 1, (16, 224, 224, 3)).astype(np.float32)
    xt = torch.from_numpy(x).cuda()
    with torch.no_grad():
        y = fused(xt).argmax(-1).cpu().numpy()
    eps = 0.25 / 255.0  # points must survive APGD-CE for APGD-T to run
    aa_log = Recorder()
    aa = AutoAttack(fused, AutoAttackConfig(norm="Linf", eps=eps,
                                            attacks_to_run=("apgd-ce", "apgd-t"), n_iter=5,
                                            batch_size=16, seed=seed),
                    logger=aa_log, device="cuda")
    x_adv, robust = aa.run_standard_evaluation(x, y)
    require_launches("the ViT eval path (phase 9)",
                     ATT_KERNELS + ("block_mlp_fwd", "block_mlp_bwd_input"))
    if not any("after APGD-CE:" in line for line in aa_log.lines):
        raise AssertionError("APGD-CE did not run on the ViT")
    if not np.isfinite(x_adv).all() or np.abs(x_adv - x).max() > eps * 1.001 + 1e-6:
        raise AssertionError("ViT x_adv is non-finite or leaves the eps ball")
    log(f"autoattack short vit_s (eps 0.25/255): robust acc {robust.mean():.4f} on 16 pts "
        f"labelled by the model")

    cpu_model, _ = get_model("vit_s", not_original=True, dtype=torch.bfloat16, use_pallas=True)
    load_torch_checkpoint(run_dir / "weights.pt", cpu_model)
    with torch.no_grad():
        ref = cpu_model.eval()(xt[:2].cpu())
        got = fused(xt[:2]).cpu()
    e, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    log(f"vit_s logits vs CPU plain version (2 images): max_abs_err {e:.3e}, max|ref| "
        f"{scale:.3e}, argmax equal {bool((got.argmax(-1) == ref.argmax(-1)).all())}")
    if not (torch.isfinite(got).all() and e <= 5e-2 * scale):
        raise AssertionError("ViT logits disagree with the CPU plain version")
    del fused, m, cpu_model, xt
    torch.cuda.empty_cache()
    return torch.load(run_dir / "weights.pt", weights_only=True)


def vit_step_phase(torch, np, init, seed, label):
    """Phase 10: the ViT-S-CvSt training step as bench.py's vit_s_cvst_at
    row builds it, kernel path (use_pallas=1) and use_pallas=0 in turns,
    with their profiles, and one step against the CPU plain version.
    Returns the step's launches."""
    steps = {name: build_train_step(torch, init, use_pallas=name == "kernel", device="cuda",
                                    seed=seed, arch="vit_s") for name in ("kernel", "plain")}
    rng = np.random.RandomState(seed)
    xb = torch.from_numpy(rng.uniform(0, 1, (TRAIN_BATCH, 224, 224, 3)).astype(np.float32))
    yb = torch.from_numpy(rng.randint(0, 1000, TRAIN_BATCH))
    xb, yb = xb.cuda(), yb.cuda()
    probe = steps["kernel"][0].model.blocks[0].attn.qkv.weight
    before = probe.detach().clone()
    zero_launches()
    step_ms, losses = steps_in_turns(torch, steps, dict.fromkeys(steps, (xb, yb)),
                                     ("kernel", "plain", "plain", "kernel"), warm=2)
    launches = require_launches("the ViT training step (phase 10)", TAIL_KERNELS + ATT_KERNELS)
    for name, ls in losses.items():
        if not all(np.isfinite(ls)):
            raise AssertionError(f"vit_s {name} step: non-finite loss {ls}")
    if torch.equal(before, probe.detach()):
        raise AssertionError("the ViT training step did not change the weights")
    for name, prm in steps["kernel"][0].model.blocks[0].named_parameters():
        if prm.grad is None or not torch.isfinite(prm.grad).all() or not prm.grad.abs().max() > 0:
            raise AssertionError(f"vit_s blocks.0 {name}: no finite non-zero gradient")
    for name, v in step_ms.items():
        ms = sum(v) / len(v)
        log(f"train step vit_s+ConvStem bf16 B={TRAIN_BATCH} 224px 2-step APGD "
            f"({name} path): {ms:.2f} ms/step, {2000.0 / ms:.3f} attack-steps/s "
            f"(runs of 5: {', '.join('%.2f' % t for t in v)}) {label}")
    log(f"vit_s step losses: kernel {losses['kernel'][:3]}..., plain {losses['plain'][:3]}...")
    for name in ("kernel", "plain"):
        profile_breakdown(torch, f"vit_s train step B={TRAIN_BATCH} ({name} path), per step",
                          lambda: steps[name][1](steps[name][0], xb, yb), 3, label)
    del steps, probe, before, xb, yb
    torch.cuda.empty_cache()
    check_step_against_cpu(torch, np, init, seed, arch="vit_s",
                           probes=("blocks.0.mlp.fc1.weight", "blocks.0.attn.qkv.weight"))
    return launches


def micro_phase(torch, np, seed) -> None:
    """Phase 10, the micro models: vit_micro (head width 16, tail at C = 32)
    and convnext_micro (tail at C = 16, 32, 64, 128) with ConvStem at 224
    px, random weights from the seed (LayerScale from U(0.1, 1)), one
    training step with use_pallas=1 on the card against the same step on
    the CPU (check_step_against_cpu); every tail kernel, and for vit_micro
    every attention kernel, must launch on the card."""
    from revisiting_at_tpu_torch.models import get_model

    probes = {"vit_micro": ("blocks.0.mlp.fc1.weight", "blocks.0.attn.qkv.weight"),
              "convnext_micro": ("stages.0.blocks.0.mlp.fc1.weight",
                                 "stages.2.blocks.0.mlp.fc1.weight")}
    for arch, names in probes.items():
        torch.manual_seed(seed)
        model, _ = get_model(arch, not_original=True, dtype=torch.float32)
        with torch.no_grad():
            for name, prm in model.named_parameters():
                if name.endswith("gamma"):
                    prm.uniform_(0.1, 1.0)
        init = model.state_dict()
        zero_launches()
        check_step_against_cpu(torch, np, init, seed, arch=arch, probes=names)
        require_launches(f"the {arch} training step (phase 10)",
                         TAIL_KERNELS + (ATT_KERNELS if arch == "vit_micro" else ()))
        del model, init
    torch.cuda.empty_cache()


def vit_cli_phase(torch, np, repo) -> None:
    """Phase 11: cli.train on ViT-S-CvSt for one short epoch, then cli.eval
    on the EMA weights it wrote."""
    from revisiting_at_tpu_torch.cli import eval as eval_cli
    from revisiting_at_tpu_torch.cli import train as train_cli

    zero_launches()
    t0 = time.time()
    trainer = train_cli.main([
        "--model.arch", "vit_s", "--model.not_original", "1", "--model.add_normalization", "0",
        "--model.model_ema", "1", "--model.drop_path_rate", "0.1", "--adv.attack", "apgd",
        "--adv.n_iter", "2", "--data.dataset", "synthetic", "--training.batch_size", "16",
        "--training.epochs", "1", "--training.use_pallas", "1", "--validation.batch_size", "16",
        "--validation.max_batches", "2", "--logging.folder",
        str(repo / "build" / "smoke_train_vit"), "--logging.log_every_steps", "2",
        "--device", "cuda", "--synthetic_batches", "4"])
    run = trainer.logger.dir
    records = [json.loads(line) for line in (run / "log").read_text().splitlines()]
    epoch = [r for r in records if "train_loss" in r]
    if not (epoch and np.isfinite(epoch[0]["train_loss"])
            and records[-1].get("event") == "final_val"):
        raise AssertionError(f"cli.train vit_s: bad records {records}")
    del trainer
    torch.cuda.empty_cache()
    res = eval_cli.main(["--run_dir", str(run), "--torch_ckpt",
                         str(run / "ckpt" / "weights_ema_0.pt"), "--use_pallas", "1",
                         "--synthetic", "--n_ex", "16", "--batch_size", "16", "--n_iter", "5",
                         "--device", "cuda"])
    if not 0.0 <= res["Linf"]["robust"] <= 1.0:
        raise AssertionError(f"cli.eval on the trained ViT run: bad result {res}")
    log(f"cli.train + cli.eval vit_s: epoch {epoch[0]}, eval {res}, {time.time() - t0:.1f} s")
    require_launches("the ViT train CLI (phase 11)", TAIL_KERNELS + ATT_KERNELS)


def attention_timings(torch, att, gen, label) -> dict:
    """Phase 12: each attention kernel at the training shapes (ViT-S, batch
    80, 197 tokens) beside its plain version, its bound, the model path's
    attention (use_pallas=0, models/vit.py plain_attention) and
    scaled_dot_product_attention. The kernels and the library are timed in
    turns over ATT_ROUNDS rounds (the library's small calls move by up to 2x
    between runs), each round kernel then library or library then kernel
    by turns: medians and [min, max] are reported, the medians kept. Plain
    versions in turns p, k, k, p. Each call's device time also comes from
    the profiler. Returns {kernel: (ms, plain_ms, bound_ms, bound_by,
    library_ms)} and {kernel: (device_ms, library_device_ms)}."""
    import statistics

    import torch.nn.functional as F
    from revisiting_at_tpu_torch.models.vit import plain_attention

    B, N, H, hd = TRAIN_BATCH, 197, 6, 64
    D = H * hd
    qkv, do = att_inputs(torch, B, N, H, hd, gen)
    dqkv, stats = att.attention_bwd_rows_cuda(qkv, do, H)

    def plain_turns(k_fn, p_fn, iters=10):
        p1, k1, k2, p2 = (time_ms(torch, f, iters) for f in (p_fn, k_fn, k_fn, p_fn))
        return (p1 + p2) / 2

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_HBM * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    def sdpa(x):  # strided [B, H, N, hd] views of qkv, no copies by the caller
        q, k, v = x.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v)

    leaf = qkv.detach().requires_grad_(True)
    o_lib = sdpa(leaf)
    do_lib = do.view(B, N, H, hd).permute(0, 2, 1, 3)
    fns = {"fwd": lambda: att.attention_fwd_cuda(qkv, H),
           "sdpa": lambda: sdpa(qkv),
           "bwd": lambda: att.attention_bwd_cuda(qkv, do, H),
           "rows": lambda: att.attention_bwd_rows_cuda(qkv, do, H),
           "cols": lambda: att.attention_bwd_cols_cuda(qkv, do, H, stats, dqkv),
           "sdpa_bwd": lambda: torch.autograd.grad(o_lib, leaf, do_lib, retain_graph=True)}
    pairs = (("fwd", "sdpa"), ("bwd", "sdpa_bwd"), ("rows", "cols"))
    runs = {k: [] for k in fns}
    for r in range(ATT_ROUNDS):
        for first, second in pairs:
            for k in ((first, second) if r % 2 == 0 else (second, first)):
                runs[k].append(time_ms(torch, fns[k], 20))
    med = {k: statistics.median(v) for k, v in runs.items()}
    spread = {k: f"[{min(v):.4f}, {max(v):.4f}]" for k, v in runs.items()}
    # the profiler's device time per call: the event loop also times the
    # host where a call's own dispatch outlasts its device work (SDPA's does)
    dev = {k: device_ms(torch, fns[k], 10) for k in fns}

    def ratio(a, b):
        return "n/a" if a is None or b is None else f"{a / b:.3f}"

    flop = B * H * N * N * hd
    out = {}
    p_ms = plain_turns(fns["fwd"], lambda: att.attention_qkv_fwd_plain(qkv, H))
    model_ms = time_ms(torch, lambda: plain_attention(qkv, H, torch.bfloat16), 10)
    out["attention_fwd"] = (med["fwd"], p_ms, *bound(4 * flop, B * N * 4 * D * 2), med["sdpa"])
    log(f"time attention fwd B={B} N={N} H={H}, {ATT_ROUNDS} rounds in turns: kernel median "
        f"{med['fwd']:.4f} ms {spread['fwd']} ({4 * flop / med['fwd'] / 1e9:.1f} TFLOP/s), sdpa "
        f"median {med['sdpa']:.4f} ms {spread['sdpa']}, kernel / sdpa "
        f"{med['fwd'] / med['sdpa']:.3f}; device time kernel {ms_or_na(dev['fwd'])} ms, sdpa "
        f"{ms_or_na(dev['sdpa'])} ms, kernel / sdpa {ratio(dev['fwd'], dev['sdpa'])}; plain "
        f"{p_ms:.4f} ms, model path {model_ms:.4f} ms, bound {out['attention_fwd'][2]:.4f} ms "
        f"({out['attention_fwd'][3]}) {label}")

    rows_p = plain_turns(fns["rows"], lambda: att.attention_bwd_rows_plain(qkv, do, H))
    cols_p = plain_turns(fns["cols"], lambda: att.attention_bwd_cols_plain(qkv, do, H))
    whole_p = plain_turns(fns["bwd"], lambda: att.attention_qkv_bwd_plain(qkv, do, H))
    o_model = plain_attention(leaf, H, torch.bfloat16)
    model_bwd = time_ms(torch, lambda: torch.autograd.grad(o_model, leaf, do, retain_graph=True),
                        10)
    lib_both = time_ms(torch, lambda: torch.autograd.grad(sdpa(leaf), leaf, do_lib), 10)
    # the backward's work (10 * B*H*N^2*hd; qkv and dO read, dqkv written),
    # split over the two kernels: the dq pass s, dp and dq and the reads,
    # the dk/dv pass dv, dk and their writes
    out["attention_bwd_rows"] = (med["rows"], rows_p, *bound(6 * flop, B * N * 5 * D * 2),
                                 med["sdpa_bwd"])
    out["attention_bwd_cols"] = (med["cols"], cols_p, *bound(4 * flop, B * N * 2 * D * 2), None)
    whole_bound = bound(10 * flop, B * N * 7 * D * 2)
    design = 2 * stats.numel() * 4
    log(f"time attention bwd B={B} N={N} H={H}, {ATT_ROUNDS} rounds in turns: kernels median "
        f"{med['bwd']:.4f} ms {spread['bwd']} ({10 * flop / med['bwd'] / 1e9:.1f} TFLOP/s; dq pass "
        f"{med['rows']:.4f} {spread['rows']}, dk/dv pass {med['cols']:.4f} {spread['cols']}), "
        f"sdpa backward median {med['sdpa_bwd']:.4f} ms {spread['sdpa_bwd']}, kernels / sdpa "
        f"{med['bwd'] / med['sdpa_bwd']:.3f}; device time kernels {ms_or_na(dev['bwd'])} ms (dq "
        f"{ms_or_na(dev['rows'])}, dk/dv {ms_or_na(dev['cols'])}), sdpa backward "
        f"{ms_or_na(dev['sdpa_bwd'])} ms, kernels / sdpa {ratio(dev['bwd'], dev['sdpa_bwd'])}; "
        f"plain {whole_p:.4f} ms (dq "
        f"{rows_p:.4f}, dk/dv {cols_p:.4f}), model path backward {model_bwd:.4f} ms, sdpa forward + "
        f"backward {lib_both:.4f} ms, bound {whole_bound[0]:.4f} ms ({whole_bound[1]}); the design's own "
        f"work: side buffer {design / 1e6:.2f} MB, recomputed products {8 * flop / 1e9:.2f} "
        f"GFLOP {label}")
    del qkv, do, dqkv, stats, leaf, o_model, o_lib
    torch.cuda.empty_cache()
    device = {"attention_fwd": (dev["fwd"], dev["sdpa"]),
              "attention_bwd_rows": (dev["rows"], dev["sdpa_bwd"]),
              "attention_bwd_cols": (dev["cols"], None)}
    return out, device


def dw_inputs(torch, B, H, W, C, dtype, gen):
    """A map x [B, H, W, C] in dtype, tap-major weights w49 [49, C] and a
    bias [C] in f32 (not symmetric: a transposed kernel would show), and a
    cotangent dy in dtype."""
    rnd = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")  # noqa: E731
    return (rnd(B, H, W, C).to(dtype), 0.2 * rnd(49, C), 0.1 * rnd(C),
            rnd(B, H, W, C).to(dtype))


def run_dwconv(dw, x, w49, b, dy):
    """The dwconv kernels on one input: y, dx, dw, db."""
    return (dw.fwd_cuda(x, w49, b), dw.dx_cuda(dy, w49), *dw.wgrad_cuda(x, dy))


def check_dwconv(torch, dw, gen) -> dict:
    """The dwconv kernels against their plain versions: ConvNeXt-T's gated
    stages at batch 80, 224 and 320 px, in bf16; a ragged map (an odd
    number of 14-row bands, a ragged column tile and channel group); once
    in f32. y, dx, dw and db each within its own tolerance; the same bits
    over two launches; and two planted faults rejected: a band's top halo
    row read as zero (a seam), one block's partial left out of dw. Returns
    the largest error per kernel."""
    err = dict.fromkeys(DW_KERNELS, 0.0)
    cases = [(f"stage {i} {px} px", TRAIN_BATCH, side * px // 224, C, torch.bfloat16)
             for px in (224, 320) for i, (side, C) in enumerate(DW_STAGES)]
    cases += [("ragged", 3, (37, 13), 40, torch.bfloat16),
              ("stage 1 224 px, f32", 4, 28, 192, torch.float32)]
    th = dw.TILE
    lib = dw._lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        plan = dw.dwconv_plan(TRAIN_BATCH, 56, 56, 96, dtype, sms)
        log(f"dwconv {dtype}: blocks per SM planned / fitting: forward and dx "
            f"{plan.fwd_blocks_per_sm} / {lib.dwconv_occupancy(0, code)}, weight pass "
            f"{plan.wgrad_blocks_per_sm} / {lib.dwconv_occupancy(1, code)} (shared memory "
            f"{plan.fwd_smem} and {plan.wgrad_smem} bytes a block)")
    # the first launch of each kernel under a watchdog: a ring stage whose
    # bytes never land waits forever
    for dtype in (torch.bfloat16, torch.float32):
        x, w49, b, dy = dw_inputs(torch, 2, 30, 17, 40, dtype, gen)
        first_launch(torch, f"dwconv forward {dtype}", lambda: dw.fwd_cuda(x, w49, b))
        first_launch(torch, f"dwconv dx {dtype}", lambda: dw.dx_cuda(dy, w49))
        first_launch(torch, f"dwconv weight pass {dtype}", lambda: dw.wgrad_partials_cuda(x, dy))
    for i, (name, B, side, C, dtype) in enumerate(cases):
        H, W = side if isinstance(side, tuple) else (side, side)
        what = f"{name} B={B} {H}x{W} C={C} {dtype}"
        x, w49, b, dy = dw_inputs(torch, B, H, W, C, dtype, gen)
        got = run_dwconv(dw, x, w49, b, dy)
        ref = (dw.fwd_plain(x, w49, b), dw.dx_plain(dy, w49, x.dtype), *dw.wgrad_plain(x, dy))
        torch.cuda.synchronize()
        for out, key, g, r in zip(("y", "dx", "dw", "db"),
                                  ("dwconv_fwd", "dwconv_dx", "dwconv_wgrad", "dwconv_wgrad"),
                                  got, ref):
            err[key] = max(err[key], check(torch, f"dwconv {out:2s} {what}", g, r,
                                           TOL[f"dw_{out}"]))
        again = run_dwconv(dw, x, w49, b, dy)
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"dwconv {what}: two launches differ")
        if i == 0:
            # a seam: band 1's top halo row (input row 14 - 3) read as zero
            x_seam = x.clone()
            x_seam[:, th - 3] = 0
            y_seam = ref[0].clone()
            y_seam[:, th:2 * th] = dw.fwd_plain(x_seam, w49, b)[:, th:2 * th]
            planted_fault(f"dwconv y with band 1's top halo row read as zero, {what}", y_seam,
                          ref[0], TOL["dw_y"])
            part = dw.wgrad_partials_cuda(x, dy)
            dw_bad = dw.reduce_cuda(part[1:])[:49 * C].view(49, C)
            planted_fault(f"dwconv dw without 1 of {part.shape[0]} block partials, {what}",
                          dw_bad, ref[2], TOL["dw_dw"])
            del x_seam, y_seam, part, dw_bad
        del x, dy, got, ref, again
        torch.cuda.empty_cache()
    log(f"dwconv y, dx, dw, db: bitwise equal over two launches in all {len(cases)} cases")
    # the reduction alone, in one launch: on partials of each gated stage's
    # shape at the training batch, and of a ragged shape (37 rows, a strip of
    # columns cut short)
    shapes = []
    for side, C in DW_STAGES:
        x, _, _, dy = dw_inputs(torch, TRAIN_BATCH, side, side, C, torch.bfloat16, gen)
        shapes.append(tuple(dw.wgrad_partials_cuda(x, dy).shape))
        del x, dy
    for R, N in shapes + [(37, 50 * 40)]:
        part = torch.randn(R, N, generator=gen, device="cuda")
        before = dw.LAUNCHES["reduce"]
        got = dw.reduce_cuda(part)
        if dw.LAUNCHES["reduce"] != before + 1:
            raise AssertionError(f"dwconv reduce {R}x{N}: not one launch")
        err["dwconv_reduce"] = max(err["dwconv_reduce"], check(
            torch, f"dwconv reduce {R}x{N} (one launch)", got, dw.reduce_plain(part),
            TOL["dw_reduce"]))
        if not torch.equal(got, dw.reduce_cuda(part)):
            raise AssertionError(f"dwconv reduce {R}x{N}: two launches differ")
        del part, got
    log(f"dwconv reduce: bitwise equal over two launches at {shapes + [(37, 50 * 40)]}")
    torch.cuda.empty_cache()
    return err


def dwconv_timings(torch, dw, gen, label):
    """Phase 15: each dwconv kernel at ConvNeXt-T's gated stage shapes,
    batch 80, 224 px, beside its bound, its plain version (kernel and plain
    in turns p, k, k, p) and the library's depthwise conv: F.conv2d(groups=C)
    on the channels_last bf16 map with bf16 weights for the forward, its
    autograd backward with only the map requiring grad for dx, and with
    only the weight and bias for dw/db; torch.sum for the reduction. Each
    kernel and library call also by the profiler's device time, and the
    weight pass with its reduction (one call, the library's function).
    Returns ({kernel: (ms, plain_ms, bound_ms, bound_by, library_ms)},
    {kernel: (device_ms, library_device_ms)}, the weight pass with its
    reduction (ms, device_ms)), summed over the three stages."""
    from revisiting_at_tpu_torch.tools.tree_compare import dwconv_library

    keys = DW_KERNELS
    tot = {k: [0.0, 0.0, 0.0, 0.0, 0.0] for k in keys}  # ms, plain, ops, bytes, library
    dev_tot = {k: [0.0, 0.0] for k in keys}  # device: kernel, library
    whole = [0.0, 0.0]  # the weight pass with its reduction: ms, device

    def turns(k_fn, p_fn, iters=10):
        p1, k1, k2, p2 = (time_ms(torch, f, iters) for f in (p_fn, k_fn, k_fn, p_fn))
        return (k1 + k2) / 2, (p1 + p2) / 2

    log(f"dwconv library timings: torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32} (bf16 maps: TF32 does not apply)")
    for side, C in DW_STAGES:
        B, n = TRAIN_BATCH, TRAIN_BATCH * side * side * C
        x, w49, b, dy = dw_inputs(torch, B, side, side, C, torch.bfloat16, gen)
        part = dw.wgrad_partials_cuda(x, dy)
        # the library's calls on NCHW views of the NHWC maps (channels_last)
        # and timm's [C, 1, 7, 7] weight in bf16
        lib = dwconv_library(x, w49, b, dy)
        runs = {
            "dwconv_fwd": (lambda: dw.fwd_cuda(x, w49, b), lambda: dw.fwd_plain(x, w49, b),
                           lib["fwd"], 98 * n, 2 * n * 2 + 50 * C * 4),
            "dwconv_dx": (lambda: dw.dx_cuda(dy, w49), lambda: dw.dx_plain(dy, w49, x.dtype),
                          lib["dx"], 98 * n, 2 * n * 2 + 49 * C * 4),
            # dw and db: 98 + 1 flops per element against reading x and dy;
            # the reduction writes the f32 results
            "dwconv_wgrad": (lambda: dw.wgrad_partials_cuda(x, dy),
                             lambda: dw.wgrad_plain(x, dy), lib["wgrad"], 99 * n, 2 * n * 2),
            # the reduction reads the partials once and writes the f32 dw and db
            "dwconv_reduce": (lambda: dw.reduce_cuda(part), lambda: dw.reduce_plain(part),
                              lambda: torch.sum(part, 0), 0, part.numel() * 4 + 50 * C * 4),
        }
        for k, (k_fn, p_fn, lib_fn, flops, nbytes) in runs.items():
            k_ms, p_ms = turns(k_fn, p_fn)
            lib_ms = time_ms(torch, lib_fn, 10)
            t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_HBM * 1e3
            for j, v in enumerate((k_ms, p_ms, t_ops, t_bytes, lib_ms)):
                tot[k][j] += v
            # the profiler's device time: the event loop also times the host
            # where a call's dispatch outlasts its device work
            dev_k, dev_lib = device_ms(torch, k_fn, 20), device_ms(torch, lib_fn, 20)
            dev_tot[k] = [sum_or_none(dev_tot[k][0], dev_k), sum_or_none(dev_tot[k][1], dev_lib)]
            log(f"time {k:13s} B={B} {side}x{side} C={C:3d}: kernel {k_ms:.4f} ms"
                + (f" ({flops / k_ms / 1e9:.1f} TFLOP/s fp32)" if flops else "")
                + f", device {ms_or_na(dev_k)} ms, bound "
                f"{max(t_ops, t_bytes):.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'})"
                f", plain {p_ms:.4f} ms, library {lib_ms:.4f} ms (device {ms_or_na(dev_lib)} ms)"
                f" {label}")
        w_fn = lambda: dw.wgrad_cuda(x, dy)  # noqa: E731
        w_ms, w_dev = time_ms(torch, w_fn, 10), device_ms(torch, w_fn, 20)
        whole = [whole[0] + w_ms, sum_or_none(whole[1], w_dev)]
        design = 2 * part.numel() * 4
        log(f"time dwconv weight pass with its reduction B={B} {side}x{side} C={C}: {w_ms:.4f} "
            f"ms, device {ms_or_na(w_dev)} ms; partials {tuple(part.shape)}, "
            f"{design / 1e6:.2f} MB written and read (the design's own traffic) {label}")
        del x, dy, part, lib, runs
        torch.cuda.empty_cache()
    for k, v in tot.items():
        log(f"{k} over the three stage shapes: kernel {v[0]:.4f} ms, device "
            f"{ms_or_na(dev_tot[k][0])} ms, bound {max(v[2], v[3]):.4f} ms, plain {v[1]:.4f} ms, "
            f"library {v[4]:.4f} ms (device {ms_or_na(dev_tot[k][1])} ms) {label}")
    log(f"dwconv weight pass with its reduction over the three stage shapes: {whole[0]:.4f} ms, "
        f"device {ms_or_na(whole[1])} ms {label}")
    return ({k: (v[0], v[1], max(v[2], v[3]), "operations" if v[2] >= v[3] else "bytes", v[4])
             for k, v in tot.items()}, {k: tuple(v) for k, v in dev_tot.items()}, tuple(whole))


def dwconv_model_phase(torch, np, run_dir, init, seed, label) -> dict:
    """Phase 13: ConvNeXt-T-CvSt with use_pallas_dwconv=1 and use_pallas=1
    (phase 4's weights): short AutoAttack on points labelled by the model,
    its logits against the CPU plain version; the training step against
    phase 6's library-conv step in turns, the dwconv launches per step,
    both profiles, and one step against the CPU plain version. Returns the
    training step's launches."""
    from revisiting_at_tpu_torch.ckpt.convert import load_torch_checkpoint
    from revisiting_at_tpu_torch.evals import AutoAttack, AutoAttackConfig
    from revisiting_at_tpu_torch.train.train_step import input_grad_view

    def load(device):
        m = convnext_t_dwconv(torch, torch.bfloat16)
        load_torch_checkpoint(run_dir / "weights.pt", m)
        return input_grad_view(m.to(device).eval().requires_grad_(False))

    fused = load("cuda")
    x = np.random.RandomState(seed).uniform(0, 1, (32, 224, 224, 3)).astype(np.float32)
    xt = torch.from_numpy(x).cuda()
    zero_launches()
    with torch.no_grad():
        y = fused(xt).argmax(-1).cpu().numpy()
    eps = 0.25 / 255.0  # points must survive APGD-CE for APGD-T to run
    aa_log = Recorder()
    aa = AutoAttack(fused, AutoAttackConfig(norm="Linf", eps=eps,
                                            attacks_to_run=("apgd-ce", "apgd-t"), n_iter=10,
                                            batch_size=32, seed=seed),
                    logger=aa_log, device="cuda")
    t0 = time.time()
    x_adv, robust = aa.run_standard_evaluation(x, y)
    torch.cuda.synchronize()
    launches = require_launches("the dwconv eval path (phase 13)",
                                ("dwconv_fwd", "dwconv_dx", "block_mlp_fwd",
                                 "block_mlp_bwd_input"))
    if launches["dwconv_wgrad"] or launches["dwconv_reduce"]:
        raise AssertionError("the attack ran the dwconv weight pass: it needs dx only")
    for attack in ("APGD-CE", "APGD-T"):
        if not any(f"after {attack}:" in line for line in aa_log.lines):
            raise AssertionError(f"{attack} did not run on the dwconv model")
    if not np.isfinite(x_adv).all() or np.abs(x_adv - x).max() > eps * 1.001 + 1e-6:
        raise AssertionError("dwconv model: x_adv is non-finite or leaves the eps ball")
    log(f"autoattack short convnext_tiny dwconv kernel (eps 0.25/255): robust acc "
        f"{robust.mean():.4f} on 32 pts labelled by the model, {time.time() - t0:.2f} s")
    cpu_model = load("cpu")
    with torch.no_grad():
        ref = cpu_model(xt[:2].cpu())
        got = fused(xt[:2]).cpu()
    e, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    log(f"dwconv model logits vs CPU plain version (2 images): max_abs_err {e:.3e}, max|ref| "
        f"{scale:.3e}, argmax equal {bool((got.argmax(-1) == ref.argmax(-1)).all())}")
    if not (torch.isfinite(got).all() and e <= 5e-2 * scale):
        raise AssertionError("dwconv model logits disagree with the CPU plain version")
    del fused, cpu_model, xt
    torch.cuda.empty_cache()

    steps = {name: build_train_step(torch, init, use_pallas=True, device="cuda", seed=seed,
                                    dwconv=name == "dwconv") for name in ("dwconv", "library")}
    rng = np.random.RandomState(seed)
    xb = torch.from_numpy(rng.uniform(0, 1, (TRAIN_BATCH, 224, 224, 3)).astype(np.float32))
    yb = torch.from_numpy(rng.randint(0, 1000, TRAIN_BATCH))
    xb, yb = xb.cuda(), yb.cuda()
    model = steps["dwconv"][0].model
    before = model.stages[0].blocks[0].conv_dw.weight.detach().clone()
    zero_launches()
    step_ms, losses = steps_in_turns(torch, steps, dict.fromkeys(steps, (xb, yb)),
                                     ("dwconv", "library", "library", "dwconv"), warm=5)
    launches = require_launches("the dwconv training step (phase 13)",
                                DW_KERNELS + TAIL_KERNELS)
    check_dw_per_step(launches, 5 + 10, "apgd")
    for name, ls in losses.items():
        if not all(np.isfinite(ls)):
            raise AssertionError(f"{name} depthwise-conv step: non-finite loss {ls}")
    if torch.equal(before, model.stages[0].blocks[0].conv_dw.weight.detach()):
        raise AssertionError("the dwconv training step did not change the dwconv weights")
    for si in range(3):  # the stages whose blocks take the dwconv kernel
        for prm in ("conv_dw.weight", "conv_dw.bias"):
            g = model.stages[si].blocks[0].get_parameter(prm).grad
            if g is None or not torch.isfinite(g).all() or not g.abs().max() > 0:
                raise AssertionError(f"stage {si} {prm}: no finite non-zero gradient")
    for name, v in step_ms.items():
        ms = sum(v) / len(v)
        log(f"train step convnext_tiny+ConvStem bf16 B={TRAIN_BATCH} 224px 2-step APGD "
            f"use_pallas=1, {name} depthwise conv: {ms:.2f} ms/step, {2000.0 / ms:.3f} "
            f"attack-steps/s (runs of 5: {', '.join('%.2f' % t for t in v)}) {label}")
    log(f"dwconv step losses: kernel {losses['dwconv'][:3]}..., library "
        f"{losses['library'][:3]}...")
    for name in ("dwconv", "library"):
        profile_breakdown(torch, f"train step B={TRAIN_BATCH} ({name} depthwise conv, kernel "
                          "tail), per step", lambda: steps[name][1](steps[name][0], xb, yb), 3,
                          label)
    del steps, model, before, xb, yb
    torch.cuda.empty_cache()
    check_step_against_cpu(torch, np, init, seed, dwconv=True,
                           probes=("stages.0.blocks.0.conv_dw.weight",
                                   "stages.2.blocks.0.conv_dw.weight",
                                   "stages.0.blocks.0.mlp.fc1.weight"))
    return launches


def fgsm_phase(torch, np, repo, init, vit_init, seed, label) -> None:
    """Phase 14: the FGSM training step (bench.py's RS-FGSM) on
    ConvNeXt-T-CvSt with and without the dwconv kernel and on ViT-S-CvSt,
    batch 80, in turns, with the dwconv launches per step and profiles of
    both ConvNeXt steps; then the FGSM train CLI on ConvNeXt-T-CvSt and
    cli.eval on its EMA weights."""
    from revisiting_at_tpu_torch.cli import eval as eval_cli
    from revisiting_at_tpu_torch.cli import train as train_cli

    builds = {"convnext_tiny, dwconv kernel": dict(sd=init, dwconv=True),
              "convnext_tiny, library conv": dict(sd=init),
              "vit_s": dict(sd=vit_init, arch="vit_s")}
    steps = {}
    for name, kw in builds.items():
        kw = dict(kw)
        steps[name] = build_train_step(torch, kw.pop("sd"), use_pallas=True, device="cuda",
                                       seed=seed, attack="fgsm", **kw)
    rng = np.random.RandomState(seed)
    xb = torch.from_numpy(rng.uniform(0, 1, (TRAIN_BATCH, 224, 224, 3)).astype(np.float32))
    yb = torch.from_numpy(rng.randint(0, 1000, TRAIN_BATCH))
    xb, yb = xb.cuda(), yb.cuda()
    zero_launches()
    names = list(steps)
    step_ms, losses = steps_in_turns(torch, steps, dict.fromkeys(steps, (xb, yb)),
                                     names + names[::-1], warm=5)
    launches = require_launches("the FGSM training steps (phase 14)",
                                DW_KERNELS + TAIL_KERNELS + ATT_KERNELS)
    check_dw_per_step(launches, 5 + 10, "fgsm")
    for name, ls in losses.items():
        if not all(np.isfinite(ls)):
            raise AssertionError(f"FGSM step {name}: non-finite loss {ls}")
        ms = sum(step_ms[name]) / len(step_ms[name])
        log(f"train step FGSM {name}+ConvStem bf16 B={TRAIN_BATCH} 224px RS-FGSM 4/255 "
            f"alpha 1.25, use_pallas=1: {ms:.2f} ms/step, {1000.0 / ms:.3f} attack-steps/s "
            f"(= steps/s: one attack step per training step; runs of 5: "
            f"{', '.join('%.2f' % t for t in step_ms[name])}) {label}")
    for name in names[:2]:  # ConvNeXt-T with and without the dwconv kernel
        profile_breakdown(torch, f"FGSM train step B={TRAIN_BATCH} ({name}), per step",
                          lambda: steps[name][1](steps[name][0], xb, yb), 3, label)
    del steps, xb, yb
    torch.cuda.empty_cache()

    zero_launches()
    t0 = time.time()
    trainer = train_cli.main([
        "--model.arch", "convnext_tiny", "--model.not_original", "1",
        "--model.add_normalization", "0", "--model.model_ema", "1", "--adv.attack", "fgsm",
        "--data.dataset", "synthetic", "--training.batch_size", "16", "--training.epochs", "1",
        "--training.use_pallas", "1", "--validation.batch_size", "16",
        "--validation.max_batches", "2", "--logging.folder",
        str(repo / "build" / "smoke_train_fgsm"), "--logging.log_every_steps", "2",
        "--device", "cuda", "--synthetic_batches", "4"])
    run = trainer.logger.dir
    records = [json.loads(line) for line in (run / "log").read_text().splitlines()]
    epoch = [r for r in records if "train_loss" in r]
    if not (epoch and np.isfinite(epoch[0]["train_loss"])
            and records[-1].get("event") == "final_val"):
        raise AssertionError(f"cli.train --adv.attack fgsm: bad records {records}")
    del trainer
    torch.cuda.empty_cache()
    res = eval_cli.main(["--run_dir", str(run), "--torch_ckpt",
                         str(run / "ckpt" / "weights_ema_0.pt"), "--use_pallas", "1",
                         "--synthetic", "--n_ex", "16", "--batch_size", "16", "--n_iter", "5",
                         "--device", "cuda"])
    if not 0.0 <= res["Linf"]["robust"] <= 1.0:
        raise AssertionError(f"cli.eval on the FGSM-trained run: bad result {res}")
    log(f"cli.train --adv.attack fgsm + cli.eval: epoch {epoch[0]}, eval {res}, "
        f"{time.time() - t0:.1f} s")
    require_launches("the FGSM train CLI (phase 14)", TAIL_KERNELS)


def fixed_draws(torch, b, h, w, seed=0):
    """Augmentation draws from a fixed generator, made to cover the paths:
    image 0 rotated then equalized, flipped and erased, image 1 sheared then
    colored; the erasing noise drawn on the host, so that either device
    gets the same draws."""
    import dataclasses

    from revisiting_at_tpu_torch.data import draw_augment

    d = draw_augment(torch.Generator().manual_seed(seed), b, h, w)
    op, apply = d.op_idx.clone(), d.apply.clone()
    flip, erase = d.flip.clone(), d.erase.clone()
    op[:, 0] = torch.tensor([3, 1])
    op[:, min(1, b - 1)] = torch.tensor([11, 7])
    apply[:, :2] = True
    flip[0] = erase[0] = True
    noise = torch.randn((int(erase.sum()), h, w, 3), generator=torch.Generator().manual_seed(seed))
    return dataclasses.replace(d, op_idx=op, apply=apply, flip=flip, erase=erase, noise=noise)


TRAIN_LINKS = 5  # each train JPEG's extra names: 2,880 images, 36 batches of TRAIN_BATCH


def make_image_folder(np, root: Path, seed: int) -> tuple[Path, Path]:
    """Phase 16's ImageFolder trees of JPEGs made with numpy and PIL from the
    seed, at ImageNet's usual sizes (500x375, 375x500 and odd ones): train
    8 classes x 60 images, each also linked under TRAIN_LINKS more names, so
    that an epoch (36 batches) outlasts the 16 batches that 8 loader
    workers have in flight from its start; val 8 x 25 with ILSVRC2012_val_*
    basenames spread over the classes."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    sizes = [(375, 500), (500, 375), (333, 500), (500, 333), (281, 500), (375, 375), (427, 640)]
    grain = rng.randint(-12, 13, (704, 704, 3)).astype(np.int16)  # fine detail, cut per image
    n_classes = 8
    for split, per_class in (("train", 60), ("val", 25)):
        n = n_classes * per_class
        for v in range(n):
            h, w = sizes[v % len(sizes)]
            coarse = rng.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3)).astype(np.uint8)
            img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.int16)
            dy, dx = rng.randint(0, 704 - h + 1), rng.randint(0, 704 - w + 1)
            img = np.clip(img + grain[dy:dy + h, dx:dx + w], 0, 255).astype(np.uint8)
            c = v % n_classes
            d = root / split / f"n{c:08d}"
            d.mkdir(parents=True, exist_ok=True)
            name = (f"ILSVRC2012_val_{(v * 37) % n + 1:08d}" if split == "val"
                    else f"n{c:08d}_{v // n_classes}")
            Image.fromarray(img).save(d / f"{name}.JPEG", quality=90)
            for k in range(TRAIN_LINKS if split == "train" else 0):
                os.link(d / f"{name}.JPEG", d / f"{name}_{k}.JPEG")
    return root / "train", root / "val"


def op_counts(torch, fn, n: int = 3) -> tuple[float, str]:
    """(operators called from Python, device kernels and copies) per call of
    fn, from one torch.profiler trace of n calls: the trace's top-level
    aten:: events and its device events ("not measured" where the trace
    holds none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    ops = sum(e.device_type == DeviceType.CPU and e.cpu_parent is None
              and e.name.startswith("aten::") for e in events)
    kernels = sum(e.device_type == DeviceType.CUDA for e in events) / n
    return ops / n, f"{kernels:.1f}" if kernels else "not measured"


def descendants() -> dict[int, str]:
    """This process's descendants still alive, as pid -> command name,
    from /proc."""
    parent, name = {}, {}
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            head, rest = stat.read_text().rsplit(")", 1)
        except (OSError, ValueError):
            continue
        state, ppid = rest.split()[:2]
        if state != "Z":
            pid = int(stat.parent.name)
            parent[pid], name[pid] = int(ppid), head.split("(", 1)[1]
    out, todo = {}, [os.getpid()]
    while todo:
        p = todo.pop()
        for c, pp in parent.items():
            if pp == p and c not in out:
                out[c] = name[c]
                todo.append(c)
    return out


def recipe_phase(torch, np, init, seed, label) -> None:
    """Phase 16: the full recipe on real images, in a temporary directory
    removed at the end, with the fork server and its loader workers stopped."""
    import shutil
    import tempfile

    from revisiting_at_tpu_torch.data.folder import stop_fork_server

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_images_"))
    try:
        _recipe_phase(torch, np, tmp, init, seed, label)
    finally:
        stop_fork_server()
        shutil.rmtree(tmp, ignore_errors=True)


def _recipe_phase(torch, np, tmp, init, seed, label) -> None:
    import gc

    from revisiting_at_tpu_torch.cli import eval as eval_cli
    from revisiting_at_tpu_torch.cli import train as train_cli
    from revisiting_at_tpu_torch.data import augment as aug
    from revisiting_at_tpu_torch.data import draw_augment
    from revisiting_at_tpu_torch.data.folder import FolderConfig, FolderLoader, fork_server

    took = {}
    # (a) the image folders, while the fork server, from which (d)'s loader
    # workers fork, imports torch
    t0 = time.time()
    fork_server()
    train_dir, val_dir = make_image_folder(np, tmp, seed)
    n_train = 480 * (1 + TRAIN_LINKS)
    first = FolderLoader(FolderConfig(root=str(train_dir), resolution=224, batch_size=TRAIN_BATCH,
                                      num_parallel=0, seed=seed))
    x_real, y_real = next(iter(first))
    del first
    took["a"] = time.time() - t0
    log(f"image folder: 480 train JPEGs under {n_train} names and 200 val JPEGs, "
        f"{took['a']:.1f} s")

    # (b) augment_batch on the card against the CPU, then alone at B = 80, and by part
    t0 = time.time()
    draws = fixed_draws(torch, 8, 224, 224, seed)
    got = aug.augment_batch(x_real[:8].cuda(), draws).cpu()
    ref = aug.augment_batch(x_real[:8], draws)
    d = (got - ref).abs()
    share, worst = float((d <= 1e-5).float().mean()), float(d.max())
    log(f"augment_batch B=8 224px, card vs CPU (same draws and noise): {share:.6f} of the "
        f"elements within 1e-5, max_abs_err {worst:.3e} (tolerance: 0.99 within 1e-5, all "
        f"within 2^-7, as the CPU tests hold the port to JAX)")
    if not (torch.isfinite(got).all() and share >= 0.99 and worst <= 2.0 ** -7):
        raise AssertionError("augment_batch on the card disagrees with the CPU")
    xb, yb = x_real.cuda(), y_real.cuda()
    gen = torch.Generator().manual_seed(seed)
    noise_gen = torch.Generator(device="cuda").manual_seed(seed)

    def augment():
        return aug.augment_batch(xb, draw_augment(gen, TRAIN_BATCH, 224, 224),
                                 generator=noise_gen)

    ev = time_ms(torch, augment, 20)
    dev = device_ms(torch, augment, 10)
    ops, launched = op_counts(torch, augment)
    floor_ms = TRAIN_BATCH * 224 * 224 * 3 * (1 + 4) / PEAK_HBM * 1e3  # uint8 in, f32 out
    log(f"augment_batch B={TRAIN_BATCH} 224px uint8 (draws made on the host each call): "
        f"{ev:.4f} ms (CUDA events), device {ms_or_na(dev)} ms, {ops:.1f} operator calls and "
        f"{launched} device kernels and copies a call; bytes in and out once: "
        f"{floor_ms:.4f} ms {label}")
    t1 = time.perf_counter()
    for _ in range(20):
        d80 = draw_augment(gen, TRAIN_BATCH, 224, 224)
    draw_ms = (time.perf_counter() - t1) * 1000 / 20
    x1 = aug.hflip(xb.float() * (1.0 / 255.0), d80.flip)
    x2, mats = aug.photometric_layers(x1, d80)
    x3 = aug.warp_affine_batch(x2, mats)
    parts = {"uint8 to [0, 1] and flip": lambda: aug.hflip(xb.float() * (1.0 / 255.0), d80.flip),
             "photometric layers and matrices": lambda: aug.photometric_layers(x1, d80),
             "warp, both passes": lambda: aug.warp_affine_batch(x2, mats),
             "erasing": lambda: aug.random_erasing(x3, d80, noise_gen)}
    for name, fn in parts.items():
        ops, launched = op_counts(torch, fn)
        log(f"augment_batch part at B={TRAIN_BATCH} 224px, {name}: {time_ms(torch, fn, 20):.4f} "
            f"ms (CUDA events), device {ms_or_na(device_ms(torch, fn, 10))} ms, {ops:.1f} "
            f"operator calls, {launched} device kernels and copies {label}")
    log(f"augment_batch part: draw_augment at B={TRAIN_BATCH} on the host: {draw_ms:.4f} ms")
    # the fixed-shape alternative (JAX's): every photometric op on the whole
    # batch, then a select per image, in each layer
    lvl, sign = (t.cuda() for t in (d80.lvl[0], d80.sign[0]))
    whole = {k: time_ms(torch, lambda: op(x1, lvl, sign), 10)
             for k, op in aug.PHOTOMETRIC.items()}
    pick = (d80.op_idx[0] == 1).cuda()[:, None, None, None]
    select = time_ms(torch, lambda: torch.where(pick, x2, x1), 10)
    log(f"photometric ops on the whole batch of {TRAIN_BATCH} at 224 px (CUDA events, ms): "
        + ", ".join(f"{aug.PHOTOMETRIC[k].__name__} {v:.4f}" for k, v in whole.items())
        + f"; sum {sum(whole.values()):.4f}, one select {select:.4f}: a layer of the "
        f"fixed-shape formulation at least {sum(whole.values()) + len(whole) * select:.4f} "
        f"{label}")
    del x1, x2, x3, mats
    took["b"] = time.time() - t0

    # (c) the full-recipe step, in turns with phase 6's step; its warm-up
    # alone must launch the tail kernels
    t0 = time.time()
    rng = np.random.RandomState(seed)
    x6 = torch.from_numpy(rng.uniform(0, 1, (TRAIN_BATCH, 224, 224, 3)).astype(np.float32))
    inputs = {"full recipe": (xb, yb),
              "phase 6, no augmentation": (x6.cuda(), torch.from_numpy(
                  rng.randint(0, 1000, TRAIN_BATCH)).cuda())}
    steps = {name: build_train_step(torch, init, use_pallas=True, device="cuda", seed=seed,
                                    randaug=name == "full recipe") for name in inputs}
    step_ms, losses = steps_in_turns(
        torch, steps, inputs, ("full recipe", "phase 6, no augmentation",
                               "phase 6, no augmentation", "full recipe"), warm=2,
        require={"full recipe": ("the full-recipe training step (phase 16)", TAIL_KERNELS)})
    for name, v in step_ms.items():
        if not all(np.isfinite(losses[name])):
            raise AssertionError(f"{name} step: non-finite loss {losses[name]}")
        ms = sum(v) / len(v)
        log(f"train step convnext_tiny+ConvStem bf16 B={TRAIN_BATCH} 224px 2-step APGD, tail "
            f"kernels ({name}): {ms:.2f} ms/step, {2000.0 / ms:.3f} attack-steps/s (runs of 5: "
            f"{', '.join('%.2f' % t for t in v)}) {label}")
    t1 = time.time()
    name = "full recipe"  # phase 6 profiles its own step; one step keeps the trace short
    profile_breakdown(torch, f"train step B={TRAIN_BATCH} ({name}), per step",
                      lambda: steps[name][1](steps[name][0], *inputs[name]), 1, label)
    t2 = time.time()
    del steps, inputs, xb, yb, x6
    torch.cuda.empty_cache()
    check_step_against_cpu(torch, np, init, seed, augment=True)
    took["c"] = time.time() - t0
    log(f"phase 16 (c): steps {t1 - t0:.1f} s, profile {t2 - t1:.1f} s, the step against the "
        f"CPU {time.time() - t2:.1f} s")

    # (d) the loader alone for one epoch, then the folder train CLI with a
    # resolution ramp
    t0 = time.time()
    workers = min(8, os.cpu_count() or 1)
    loader = FolderLoader(FolderConfig(root=str(train_dir), resolution=224, batch_size=TRAIN_BATCH,
                                       num_parallel=workers, pin_memory=True, seed=seed))
    arrivals, t1 = [], time.time()
    for _ in loader:
        arrivals.append(time.time() - t1)
    del loader
    gc.collect()
    # batches arrive in rounds of one per worker: the rate between the ends
    # of the first and the last whole round leaves out the workers' start
    last = workers * (len(arrivals) // workers)
    loader_rate = (last - workers) * TRAIN_BATCH / (arrivals[last - 1] - arrivals[workers - 1])
    log(f"loader, train transform at 224 px, {workers} worker processes ({os.cpu_count()} "
        f"CPUs): {loader_rate:.1f} images/s over batches {workers + 1}-{last} of "
        f"{len(arrivals)}; the first batch after {arrivals[0]:.2f} s (the workers starting, "
        f"forked from the fork server started in (a)) {label}")
    zero_launches()
    log_every = 6
    t1 = time.time()
    trainer = train_cli.main([
        "--model.arch", "convnext_tiny", "--model.not_original", "1",
        "--model.add_normalization", "0", "--model.model_ema", "1", "--adv.attack", "apgd",
        "--adv.n_iter", "2", "--data.dataset", "folder", "--data.augmentations", "1",
        "--data.train_dataset", str(train_dir), "--data.val_dataset", str(val_dir),
        "--data.num_workers", str(workers), "--data.in_memory", "0",
        "--training.batch_size", str(TRAIN_BATCH), "--training.epochs", "2",
        "--training.use_pallas", "1", "--resolution.min_res", "192", "--resolution.max_res",
        "224", "--resolution.start_ramp", "0", "--resolution.end_ramp", "1",
        "--validation.batch_size", "50", "--validation.max_batches", "2", "--logging.folder",
        str(tmp / "runs"), "--logging.log_every_steps", str(log_every), "--device", "cuda"])
    run, steps_per_epoch = trainer.logger.dir, trainer.iters_per_epoch
    del trainer
    gc.collect()
    records = [json.loads(line) for line in (run / "log").read_text().splitlines()]
    changes = [r["res"] for r in records if r.get("event") == "resolution_change"]
    epochs = [r for r in records if "train_loss" in r]
    if not (changes == [192, 224] and [e["res"] for e in epochs] == [192, 224]
            and all(np.isfinite(e["train_loss"]) for e in epochs)
            and records[-1].get("event") == "final_val"):
        raise AssertionError(f"cli.train on the image folder: bad records {records}")
    windows = [r for r in records if r.get("event") == "step"]
    steady = 3 * log_every  # past the 2 * workers batches in flight from the epoch's start
    for e in epochs:
        late = [r for r in windows if r["epoch"] == e["epoch"]][steady // log_every:]
        n_steps = log_every * len(late)
        step_ms = sum(log_every * TRAIN_BATCH * 1000 / r["imgs_per_s"] for r in late) / n_steps
        wait_ms = 1000 * sum(r["data_wait"] for r in late) / n_steps
        log(f"cli.train folder epoch {e['epoch']} at {e['res']} px, {steps_per_epoch} steps of "
            f"{TRAIN_BATCH}: {e['epoch_time']:.2f} s, the first batch waited "
            f"{e['data_wait_first']:.2f} s, all {steps_per_epoch} waited {e['data_wait']:.2f} s; "
            f"steps {steady + 1}-{steady + n_steps}: {step_ms:.1f} ms a step, of which "
            f"{wait_ms:.1f} ms waiting on the loader ({workers} workers, {os.cpu_count()} CPUs); "
            f"the loader alone at {loader_rate:.1f} images/s would keep such steps waiting "
            f"{max(0.0, 1000 * TRAIN_BATCH / loader_rate - step_ms):.1f} ms; loss "
            f"{e['train_loss']:.4f} {label}")
    log(f"cli.train on the image folder: resolution changes {changes}, "
        f"{time.time() - t1:.1f} s with model build and validation")
    require_launches("the image-folder train CLI (phase 16)", TAIL_KERNELS)
    torch.cuda.empty_cache()
    took["d"] = time.time() - t0

    # (e) the eval CLI on the val folder with the EMA weights
    zero_launches()
    t0 = time.time()
    res = eval_cli.main(["--run_dir", str(run), "--torch_ckpt",
                         str(run / "ckpt" / "weights_ema_1.pt"), "--use_pallas", "1",
                         "--data_dir", str(val_dir), "--n_ex", "100", "--batch_size", "50",
                         "--n_iter", "5", "--device", "cuda"])
    if res["Linf"]["n"] != 100 or not 0.0 <= res["Linf"]["robust"] <= 1.0:
        raise AssertionError(f"cli.eval --data_dir: bad result {res}")
    took["e"] = time.time() - t0
    log(f"cli.eval --data_dir (100 val images, short AutoAttack): {res}, {took['e']:.1f} s")
    # the attacks run only on points the 12-step model classifies right
    require_launches("the image-folder eval CLI (phase 16)", ("block_mlp_fwd",))
    log(f"phase 16: {sum(took.values()):.1f} s; "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in took.items()))


# -------------------------------------------------------------- phase 17

FULL_AA_BATCH = 200  # AutoAttack's batch
FAB_ITERS, SQUARE_QUERIES = 10, 50  # phase 17 (b): one FAB target, Square's queries


def eval_model(torch, arch, weights, use_pallas=True, img_size=224, updated=False):
    """The bf16 model cli.eval builds from a run, on the card, input-only tail backward."""
    from revisiting_at_tpu_torch.ckpt.convert import load_torch_checkpoint
    from revisiting_at_tpu_torch.models import get_model
    from revisiting_at_tpu_torch.train.train_step import input_grad_view

    m, _ = get_model(arch, not_original=True, dtype=torch.bfloat16, use_pallas=use_pallas,
                     img_size=img_size, updated=updated)
    load_torch_checkpoint(weights, m)
    return input_grad_view(m.cuda().eval().requires_grad_(False))


def predicted(torch, np, model, x, bs=50) -> "np.ndarray":
    """The model's own labels for x (NHWC f32 numpy), so that every point starts robust."""
    out = []
    with torch.no_grad():
        for i in range(0, len(x), bs):
            out.append(model(torch.from_numpy(x[i:i + bs]).cuda()).argmax(-1).cpu().numpy())
    return np.concatenate(out)


def own_labels(torch, np, eval_cli, model, argv):
    """The eval set cli.eval.main(argv) loads, labelled with `model`'s
    predictions (a random-weight model is right about no random label, and
    the attacks run only on points it gets right). Run before the counts are
    set to 0, so that these launches are not counted with cli.eval's."""
    from revisiting_at_tpu_torch.config import load_params_json

    args = eval_cli.get_args(argv)
    x, _ = eval_cli.load_eval_set(
        args, load_params_json(Path(args.run_dir) / "params.json").data.num_classes)
    return x, predicted(torch, np, model, x)


def eval_on(eval_cli, argv, x, y):
    """cli.eval.main(argv) on the eval set (x, y) in place of the one it loads."""
    load = eval_cli.load_eval_set
    eval_cli.load_eval_set = lambda args, num_classes: (x, y)
    try:
        return eval_cli.main(argv)
    finally:
        eval_cli.load_eval_set = load


def attacks_in_log(path: Path, start: int) -> list[str]:
    """The 'robust accuracy after <ATTACK>' lines written to a log after its line `start`."""
    lines = path.read_text().splitlines()[start:] if path.exists() else []
    return [line for line in lines if line.startswith("robust accuracy after")]


def check_saved(np, res, x, norm, eps) -> float:
    """The .npy x_adv that cli.eval saved for norm: shape, finite, the eps-ball
    and the box. Returns its largest perturbation."""
    adv = np.load(res[norm]["adv_path"], mmap_mode="r")
    d = (np.asarray(adv) - x).reshape(len(x), -1)
    size = float((np.abs(d).max(1) if norm == "Linf" else np.sqrt((d * d).sum(1))).max())
    if adv.shape != x.shape or not np.isfinite(adv).all():
        raise AssertionError(f"saved {norm} x_adv: shape {adv.shape} or non-finite values")
    if size > eps * 1.001 + 1e-6 or adv.min() < 0 or adv.max() > 1:
        raise AssertionError(f"saved {norm} x_adv leaves the eps ball ({size} > {eps}) or the box")
    return size


def fab_against_cpu(torch, fab, mlp, xs, ys, yt, norm, n_iter) -> None:
    """FAB on the card against the CPU, one target. Each iteration the card
    steps from the CPU's carry, and its carry must agree with the CPU's
    within the CPU tests' tolerances (res rtol 2e-3, atol 1e-5; x1 and
    x_best atol 2e-3): that holds the math of every step. The card's own
    trajectory is compared at the end and only logged: a misclassification
    decided at the boundary (FAB walks along it) can go the other way after
    a few iterations of 1e-6 differences, and the trajectories then part."""
    cpu = fab.fab_single_init(xs)
    own = fab.fab_single_init(xs.cuda())
    args = lambda dev: (mlp(dev), xs.to(dev), ys.to(dev), yt.to(dev))  # noqa: E731
    worst = [0.0, 0.0]
    for it in range(n_iter):
        step = fab.fab_single_chunk(*args("cuda"), tuple(t.cuda() for t in cpu), 1, norm=norm)
        cpu = fab.fab_single_chunk(*args("cpu"), cpu, 1, norm=norm)
        own = fab.fab_single_chunk(*args("cuda"), own, 1, norm=norm)
        x1, xb, res = (t.cpu() for t in step)
        e_x = max((x1 - cpu[0]).abs().max().item(), (xb - cpu[1]).abs().max().item())
        e_res = (res - cpu[2]).abs().max().item()
        worst = [max(worst[0], e_x), max(worst[1], e_res)]
        if not (e_x <= 2e-3 and torch.allclose(res, cpu[2], rtol=2e-3, atol=1e-5)):
            raise AssertionError(f"FAB {norm} iteration {it}: the card's step from the CPU's "
                                 f"carry disagrees with the CPU's (x {e_x:.3e}, res {e_res:.3e})")
    found = cpu[2] < 1e9
    own_res = (own[2].cpu() - cpu[2]).abs().max().item()
    own_x = (own[1].cpu() - cpu[1])[found].abs().max().item() if found.any() else 0.0
    log(f"phase 17 (c) FAB {norm} card vs CPU, {n_iter} iterations, {int(found.sum())}/8 points "
        f"found: each step from the CPU's carry within x {worst[0]:.3e}, res {worst[1]:.3e}; "
        f"the card's own trajectory at the end: x_best max_abs_err {own_x:.3e}, res "
        f"{own_res:.3e}")


def full_aa_phase(torch, np, repo, seed, label) -> None:
    """Phase 17: full AutoAttack (APGD-CE, APGD-T, FAB-T, Square) through
    cli.eval on ConvNeXt-T-CvSt and ViT-S-CvSt, FAB-T and Square alone at
    batch 200 (kernels and use_pallas=0 in turns), the attack math on the
    card against the CPU, and cli.runner."""
    from revisiting_at_tpu_torch.cli import eval as eval_cli
    from revisiting_at_tpu_torch.cli import runner
    from revisiting_at_tpu_torch.evals import AutoAttack, AutoAttackConfig, TorchSquareDraws
    from revisiting_at_tpu_torch.evals import fab, square

    took = {}
    run_dir, vit_dir = repo / "build" / "smoke_run", repo / "build" / "smoke_run_vit"
    weights = run_dir / "weights.pt"
    # points must survive APGD for FAB-T and Square to have a worklist
    epss = {"Linf": 0.1 / 255.0, "L2": 0.05}

    # (a) cli.eval --full_aa 1 on phase 4's run, labels the model's own
    t0 = time.time()
    fused = eval_model(torch, "convnext_tiny", weights)
    log_path = run_dir / "evaluated_logs_Linf,L2_1.txt"
    start = len(log_path.read_text().splitlines()) if log_path.exists() else 0
    argv = ["--run_dir", str(run_dir), "--torch_ckpt", str(weights), "--use_pallas", "1",
            "--synthetic", "--full_aa", "1", "--l_norms", "Linf,L2",
            "--l_epss", f"{epss['Linf']:.8f},{epss['L2']}", "--save_imgs", "--n_ex", "16",
            "--batch_size", "16", "--img_size", "224", "--n_iter", "5", "--square_queries",
            "50", "--device", "cuda"]
    x_eval, y_eval = own_labels(torch, np, eval_cli, fused, argv)
    zero_launches()
    res = eval_on(eval_cli, argv, x_eval, y_eval)
    require_launches("the full-AA eval path (phase 17 (a))", ("block_mlp_fwd",
                                                              "block_mlp_bwd_input"))
    after = attacks_in_log(log_path, start)
    log(f"phase 17 (a) cli.eval --full_aa 1: {res}; {after}")
    if [line.split(":")[0].split()[-1] for line in after] != ["APGD-CE", "APGD-T", "FAB-T",
                                                               "SQUARE"] * 2:
        raise AssertionError(f"cli.eval --full_aa 1 did not run all four attacks on both norms: "
                             f"{after}")
    for norm, eps in epss.items():
        size = check_saved(np, res, x_eval, norm, eps)
        log(f"phase 17 (a) saved {norm} x_adv {res[norm]['adv_path']}: largest perturbation "
            f"{size:.6f} <= eps {eps:.6f}")
    took["a"] = time.time() - t0

    # (b) FAB-T and Square alone at batch 200, the kernels and use_pallas=0 in turns
    t0 = time.time()
    models = {"kernels": fused, "plain": eval_model(torch, "convnext_tiny", weights, False)}
    x = np.random.RandomState(seed + 17).uniform(0, 1, (FULL_AA_BATCH, 224, 224, 3)) \
        .astype(np.float32)
    y = predicted(torch, np, fused, x)
    eps = 4.0 / 255.0

    def attack(name, kind, n):
        cfg = AutoAttackConfig(norm="Linf", eps=eps, attacks_to_run=(kind,), n_iter=n,
                               n_target_classes=1, square_n_queries=n,
                               batch_size=FULL_AA_BATCH, seed=seed, verbose=False)
        return AutoAttack(models[name], cfg, device="cuda")

    for kind, n, what in (("fab-t", FAB_ITERS, "iteration"), ("square", SQUARE_QUERIES, "query")):
        for name in models:  # warm-up: the first launches, the library's autotuning
            attack(name, kind, 2)._run_attack(kind, 0, x, y)
        times = {name: [] for name in models}
        broke = {}
        zero_launches()
        for name in ("kernels", "plain", "plain", "kernels"):
            aa = attack(name, kind, n)
            torch.cuda.synchronize()
            t1 = time.time()
            _, flipped = aa._run_attack(kind, 0, x, y)
            times[name].append((time.time() - t1) * 1000 / n)
            broke[name] = int(flipped.sum())
        launches = require_launches(
            f"{kind} alone at B={FULL_AA_BATCH} (phase 17 (b))",
            ("block_mlp_fwd", "block_mlp_bwd_input") if kind == "fab-t" else ("block_mlp_fwd",))
        if kind == "square" and launches["block_mlp_bwd_input"]:
            raise AssertionError("Square launched the input backward: it makes no gradient")
        extra = ("the target class's forward" if kind == "fab-t" else "the init query")
        for name, v in times.items():
            log(f"{kind} convnext_tiny+ConvStem bf16 B={FULL_AA_BATCH} 224px Linf 4/255 ({name}): "
                f"{sum(v) / len(v):.2f} ms per {what} (runs {', '.join('%.2f' % t for t in v)}; "
                f"{extra} included), broke {broke[name]}/{FULL_AA_BATCH} {label}")
        t1 = time.time()
        profile_breakdown(torch, f"{kind} B={FULL_AA_BATCH} (kernels), {n} {what}s",
                          lambda: attack("kernels", kind, n)._run_attack(kind, 0, x, y), 1, label)
        log(f"phase 17 (b) {kind}: profile {time.time() - t1:.1f} s")
        if kind == "fab-t":
            # the iteration's two box-and-hyperplane projections alone (Linf:
            # 30 bisection steps each), on a gradient-shaped w
            gen = torch.Generator(device="cuda").manual_seed(seed)
            t = torch.from_numpy(x).cuda().reshape(FULL_AA_BATCH, -1)
            w = torch.randn(t.shape, generator=gen, device="cuda")
            b = (w * t).sum(1) - 0.5 * w.abs().sum(1) * eps
            def both():
                return fab._project(t, w, b, "Linf"), fab._project(t, w, b, "Linf")
            log(f"fab-t B={FULL_AA_BATCH}: the two Linf projections of an iteration "
                f"{time_ms(torch, both, 5):.2f} ms (device {ms_or_na(device_ms(torch, both, 5))} "
                f"ms) {label}")
            del t, w, b
    del models, x, y
    torch.cuda.empty_cache()
    took["b"] = time.time() - t0

    # (c) the attack math on the card against the CPU: a tanh MLP in f32, the same draws
    t0 = time.time()
    rng = np.random.RandomState(seed)
    w1 = torch.from_numpy(rng.randn(300, 24).astype(np.float32) * 0.1)
    w2 = torch.from_numpy(rng.randn(24, 7).astype(np.float32) * 0.8)
    xs = torch.from_numpy(rng.uniform(0.25, 0.75, (8, 10, 10, 3)).astype(np.float32))

    def mlp(dev):
        a, b = w1.to(dev), w2.to(dev)
        return lambda z: torch.tanh(z.reshape(z.shape[0], -1) @ a) @ b

    ys = mlp("cpu")(xs).argmax(-1)
    yt = mlp("cpu")(xs).argsort(-1)[:, -2]
    for norm in ("Linf", "L2", "L1"):
        fab_against_cpu(torch, fab, mlp, xs, ys, yt, norm, 20)
        eps_n = {"Linf": 0.05, "L2": 1.5, "L1": 12.0}[norm]
        kw = dict(norm=norm, eps=eps_n, n_queries=30)
        x_ref, acc_ref = square.square_attack(mlp("cpu"), xs, ys,
                                              draws=TorchSquareDraws(seed, "cpu"), **kw)
        x_got, acc_got = square.square_attack(mlp("cuda"), xs.cuda(), ys.cuda(),
                                              draws=TorchSquareDraws(seed, "cpu", "cuda"), **kw)
        e_sq = (x_got.cpu() - x_ref).abs().max().item()
        tol = 1e-6 if norm == "Linf" else 1e-5
        log(f"phase 17 (c) Square {norm} card vs CPU, 30 queries: x max_abs_err {e_sq:.3e} "
            f"(tolerance {tol:.0e}), acc equal {torch.equal(acc_got.cpu(), acc_ref)}, "
            f"{int((~acc_ref).sum())}/8 broken")
        if not (e_sq <= tol and torch.equal(acc_got.cpu(), acc_ref)):
            raise AssertionError(f"Square {norm} on the card disagrees with the CPU")
    took["c"] = time.time() - t0

    # (d) cli.runner, one job on the card, then no process of it left
    t0 = time.time()
    cwd = os.getcwd()
    os.chdir(repo)  # the job imports the package from the checkout
    try:
        runner.main(["--runs", str(run_dir), "--l_norms", "Linf", "--img_sizes", "224",
                     "--full_aa", "1", "--n_ex", "8", "--batch_size", "8", "--",
                     "--torch_ckpt", str(weights), "--use_pallas", "1", "--synthetic",
                     "--n_iter", "2", "--square_queries", "5", "--device", "cuda"])
    finally:
        os.chdir(cwd)
    left = descendants()
    if left:
        raise AssertionError(f"processes still running after cli.runner: {left}")
    took["d"] = time.time() - t0

    # (e) cli.eval --full_aa 1 on phase 9's ViT-S-CvSt, labels the model's own
    t0 = time.time()
    del fused
    torch.cuda.empty_cache()
    vit = eval_model(torch, "vit_s", vit_dir / "weights.pt")
    log_path = vit_dir / "evaluated_logs_Linf_1.txt"
    start = len(log_path.read_text().splitlines()) if log_path.exists() else 0
    argv = ["--run_dir", str(vit_dir), "--torch_ckpt", str(vit_dir / "weights.pt"),
            "--use_pallas", "1", "--synthetic", "--full_aa", "1", "--l_norms", "Linf",
            "--l_epss", f"{epss['Linf']:.8f}", "--n_ex", "8", "--batch_size", "8",
            "--img_size", "224", "--n_iter", "2", "--square_queries", "10", "--device", "cuda"]
    x_eval, y_eval = own_labels(torch, np, eval_cli, vit, argv)
    del vit
    zero_launches()
    res = eval_on(eval_cli, argv, x_eval, y_eval)
    require_launches("the ViT full-AA eval path (phase 17 (e))",
                     ATT_KERNELS + ("block_mlp_fwd", "block_mlp_bwd_input"))
    after = attacks_in_log(log_path, start)
    log(f"phase 17 (e) cli.eval --full_aa 1 vit_s: {res}; {after}")
    if [line.split(":")[0].split()[-1] for line in after] != ["APGD-CE", "APGD-T", "FAB-T",
                                                               "SQUARE"]:
        raise AssertionError(f"cli.eval --full_aa 1 on the ViT did not run all four attacks: "
                             f"{after}")
    torch.cuda.empty_cache()
    took["e"] = time.time() - t0
    log(f"phase 17: {sum(took.values()):.1f} s; "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in took.items()))


# -------------------------------------------------------------- phase 18
# the training step's block-tail forwards with remat: APGD's n_iter + 1
# forwards and the training forward, then one recompute in each of APGD's
# n_iter input backwards and in the weight backward. ConvNeXt-T fuses all 18
# blocks in the attack and the 15 of stages 0-2 in training, ViT-S all 12.
ATTACK_ITERS = 2


def tail_forwards_per_step(attack_blocks: int, train_blocks: int, remat: bool) -> int:
    fwd = (ATTACK_ITERS + 1) * attack_blocks + train_blocks
    return fwd + (ATTACK_ITERS * attack_blocks + train_blocks if remat else 0)


def _full_state(path: Path) -> dict:
    import torch
    return torch.load(path, map_location="cpu", weights_only=True)


def _state_diff(torch, a, b) -> float:
    """Largest |a - b| over every tensor of two full states (inf if their
    structure or any non-tensor field differs)."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return float("inf")
        return max((_state_diff(torch, a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return float("inf")
        return max((_state_diff(torch, u, v) for u, v in zip(a, b)), default=0.0)
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return float("inf")
        return 0.0 if torch.equal(a, b) else (a.double() - b.double()).abs().max().item()
    return 0.0 if a == b else float("inf")


def trace_kernels(path: Path) -> dict:
    """{tail kernel name: launches} among the kernel events of a chrome trace."""
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(f"(anonymous namespace)::{k}" in n for n in names) for k in TAIL_KERNEL_NAMES}


def trainer_ckpt_phase(torch, np, repo, init, vit_init, seed, label) -> None:
    """Phase 18: the trainer's options and the checkpoints on the card:
    (a) cli.train with grad_accum, adversarial validation, EMA, the FLOP
    count and the profile, then resumed from epoch 0 in its own run dir;
    (b) the phase-6 step with remat 0 and 1 (and grad_accum 2) in turns;
    (c) cli.eval finding run A's checkpoints, and the ViT step with remat."""
    import shutil

    from revisiting_at_tpu_torch.cli import eval as eval_cli
    from revisiting_at_tpu_torch.cli import train as train_cli

    took = {}
    folder = repo / "build" / "smoke_trainer_ckpt"
    shutil.rmtree(folder, ignore_errors=True)
    argv = ["--model.arch", "convnext_tiny", "--model.not_original", "1",
            "--model.add_normalization", "0", "--model.model_ema", "1", "--adv.attack", "apgd",
            "--adv.n_iter", str(ATTACK_ITERS), "--data.dataset", "synthetic",
            "--training.batch_size", str(TRAIN_BATCH), "--training.epochs", "2",
            "--training.use_pallas", "1", "--training.grad_accum", "2",
            "--validation.batch_size", "32", "--validation.max_batches", "1",
            "--validation.adv_val_freq", "1", "--validation.adv_val_iter", "2",
            "--validation.adv_val_batches", "1", "--misc.log_flops", "1",
            "--misc.profile_steps", "2", "--training.seed", str(seed),
            "--logging.log_every_steps", "4", "--device", "cuda", "--synthetic_batches", "4"]

    # (a) run A; its adversarial validation alone, counted
    t0 = time.time()
    trainer = train_cli.main(argv + ["--logging.folder", str(folder / "a")])
    run = trainer.logger.dir
    zero_launches()
    adv_acc = trainer.adv_val()
    require_launches("adversarial validation (phase 18 (a))",
                     ("block_mlp_fwd", "block_mlp_bwd_input"))
    del trainer
    torch.cuda.empty_cache()
    records = [json.loads(line) for line in (run / "log").read_text().splitlines()]
    init_rec = records[0]
    adv = [(r["epoch"], r["adv_acc"]) for r in records if r.get("event") == "adv_val"]
    best = [r["epoch"] for r in records if r.get("event") == "best_adv"]
    written = [r for r in records if r.get("event") == "trace_written"]
    log(f"phase 18 (a) run A: forward_flops {init_rec['forward_flops']:.6e} "
        f"({init_rec['flops_convention']}), params {init_rec['params']}, adv_val {adv}, "
        f"best_adv epochs {best}, adversarial validation again {adv_acc} "
        f"({time.time() - t0:.1f} s)")
    if not (init_rec["forward_flops"] > 2 * init_rec["params"] and [e for e, _ in adv] == [0, 1]
            and best and best[0] == 0 and len(written) == 1):
        raise AssertionError(f"phase 18 (a): bad records {records}")
    in_trace = trace_kernels(Path(written[0]["path"]))
    log(f"phase 18 (a) trace {written[0]['path']}: tail kernel launches {in_trace}")
    if not all(in_trace.values()):
        raise AssertionError(f"the profile trace does not name every tail kernel: {in_trace}")
    a1 = _full_state(run / "ckpt" / "state_1.pt")
    took["a"] = time.time() - t0

    # run B: run A's dir without its epoch-1 files, resumed in place
    t0 = time.time()
    for f in (run / "ckpt").glob("*_1.pt"):
        f.unlink()
    zero_launches()
    trainer = train_cli.main(argv + ["--logging.folder", str(folder / "a"),
                                     "--model.ckpt_path", str(run)])
    require_launches("the resumed run (phase 18 (a))", TAIL_KERNELS)
    if trainer.start_epoch != 1:
        raise AssertionError(f"the resumed run started at epoch {trainer.start_epoch}")
    del trainer
    torch.cuda.empty_cache()
    d_ab = _state_diff(torch, a1, _full_state(run / "ckpt" / "state_1.pt"))
    took["b"] = time.time() - t0
    if d_ab == 0.0:
        log("phase 18 (a) run B (resumed from epoch 0) against run A at epoch 1: weights, "
            "optimizer, EMA and step bit for bit equal (exact)")
    else:  # the tolerance: what a second run of A differs from A by
        t0 = time.time()
        trainer = train_cli.main(argv + ["--logging.folder", str(folder / "a2")])
        d_aa = _state_diff(torch, a1, _full_state(trainer.logger.dir / "ckpt" / "state_1.pt"))
        del trainer
        torch.cuda.empty_cache()
        took["a2"] = time.time() - t0
        log(f"phase 18 (a) run B against run A at epoch 1: max |diff| {d_ab:.3e}; a second "
            f"run of A against A: {d_aa:.3e} (the tolerance)")
        if not d_ab <= d_aa:
            raise AssertionError(f"the resumed run differs from run A by {d_ab}, more than "
                                 f"two runs of A do ({d_aa})")
    del a1

    # (c) cli.eval on run A by its own checkpoints, each eval set labelled
    # by the weights the flags pick (so that APGD has points to attack); a
    # copy without EMA
    t0 = time.time()
    base = ["--run_dir", str(run), "--use_pallas", "1", "--synthetic", "--n_ex", "16",
            "--batch_size", "16", "--n_iter", "2", "--img_size", "224", "--device", "cuda"]
    picks = {"--epoch 0 --use_ema 1": run / "ckpt" / "weights_ema_0.pt",
             "--best": run / "ckpt_best" / f"weights_{best[-1]}.pt"}
    res = {}
    for flags, weights in picks.items():
        model = eval_model(torch, "convnext_tiny", weights)
        x_eval, y_eval = own_labels(torch, np, eval_cli, model, base + flags.split())
        del model
        zero_launches()
        res[flags] = eval_on(eval_cli, base + flags.split(), x_eval, y_eval)
        require_launches(f"cli.eval {flags} on run A (phase 18 (c))",
                         ("block_mlp_fwd", "block_mlp_bwd_input"))
    no_ema = folder / "no_ema"
    (no_ema / "ckpt").mkdir(parents=True)
    shutil.copy(run / "params.json", no_ema / "params.json")
    for f in (run / "ckpt").glob("weights_[0-9]*.pt"):
        shutil.copy(f, no_ema / "ckpt" / f.name)
    try:
        eval_cli.main(["--run_dir", str(no_ema), "--use_ema", "1", "--synthetic",
                       "--only_clean", "--n_ex", "16", "--device", "cuda"])
        raise AssertionError("--use_ema 1 on a run without EMA weights did not fail")
    except ValueError as e:
        log(f"phase 18 (c) cli.eval {res}; --use_ema 1 on a copy without EMA: refused ({e})")
    took["c"] = time.time() - t0
    shutil.rmtree(folder, ignore_errors=True)

    # (b) the phase-6 step: remat 0 and 1 from the same weights, one step
    # each compared, then timed in turns with grad_accum 2, peak memory
    t0 = time.time()
    rng = np.random.RandomState(seed)
    xb = torch.from_numpy(rng.uniform(0, 1, (TRAIN_BATCH, 224, 224, 3)).astype(np.float32))
    yb = torch.from_numpy(rng.randint(0, 1000, TRAIN_BATCH))
    xb, yb = xb.cuda(), yb.cuda()
    variants = {"remat0": {}, "remat1": dict(remat=True), "accum2": dict(grad_accum=2)}
    steps = {name: build_train_step(torch, init, use_pallas=True, device="cuda", seed=seed, **kw)
             for name, kw in variants.items()}
    out, peak, per_step = {}, {}, {}
    for name in ("remat0", "remat1"):  # the first step of each, from the same weights
        state, step = steps[name]
        zero_launches()
        metrics = step(state, xb, yb)
        per_step[name] = require_launches(f"the {name} step (phase 18 (b))", TAIL_KERNELS)
        out[name] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                     {n: p.grad.float() for n, p in state.model.named_parameters()})
    for name in ("remat0", "remat1"):  # the second: every workspace already allocated
        state, step = steps[name]
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(state, xb, yb)
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    (l0, n0, g0), (l1, n1, g1) = out["remat0"], out["remat1"]
    cos = min(float((g0[k] * g1[k]).sum() / (g0[k].norm() * g1[k].norm()))
              for k in g0 if g0[k].norm() > 0)
    err = max((g0[k] - g1[k]).abs().max().item() for k in g0)
    extra = {name: per_step[name]["block_mlp_fwd"] for name in per_step}
    want = {f"remat{int(r)}": tail_forwards_per_step(18, 15, r) for r in (False, True)}
    log(f"phase 18 (b) one step, remat 1 against remat 0: loss {l1:.6f} / {l0:.6f}, grad_norm "
        f"{n1:.5f} / {n0:.5f}, gradients max |diff| {err:.3e}, least cosine {cos:.6f}; "
        f"tail forwards {extra} (expected {want}); peak memory above the resident state "
        f"{peak['remat1']:.3f} GiB with remat, {peak['remat0']:.3f} GiB without {label}")
    if not (abs(l1 - l0) <= 2e-2 * abs(l0) and abs(n1 - n0) <= 2e-2 * abs(n0) and cos > 0.99):
        raise AssertionError("the remat step disagrees with the step without remat")
    if extra != want:
        raise AssertionError(f"tail forwards per step {extra}, expected {want}: remat did not "
                             f"run the recomputed forwards through the kernel")
    if not peak["remat1"] < peak["remat0"]:
        raise AssertionError(f"remat did not lower the step's peak memory: {peak}")
    del out, g0, g1
    step_ms, _ = steps_in_turns(torch, steps, dict.fromkeys(steps, (xb, yb)),
                                ("remat0", "remat1", "accum2", "accum2", "remat1", "remat0"),
                                warm=2)
    for name, v in step_ms.items():
        log(f"phase 18 (b) train step convnext_tiny+ConvStem bf16 B={TRAIN_BATCH} ({name}): "
            f"{sum(v) / len(v):.2f} ms/step (runs of 5: {', '.join('%.2f' % t for t in v)}) "
            f"{label}")
    for name in steps:  # device time and busy share: how much of the cost is the host's
        profile_breakdown(torch, f"phase 18 (b) train step B={TRAIN_BATCH} ({name}), per step",
                          lambda: steps[name][1](steps[name][0], xb, yb), 2, label)
    del steps, xb, yb
    torch.cuda.empty_cache()
    took["b_step"] = time.time() - t0

    # (c) the ViT-S-CvSt step with remat: the attention kernels, recomputed too
    t0 = time.time()
    state, step = build_train_step(torch, vit_init, use_pallas=True, device="cuda", seed=seed,
                                   arch="vit_s", remat=True)
    rng = np.random.RandomState(seed + 2)
    x = torch.from_numpy(rng.uniform(0, 1, (32, 224, 224, 3)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 1000, 32)).cuda()
    zero_launches()
    losses = [float(step(state, x, y)["loss"]) for _ in range(2)]
    launches = require_launches("the ViT-S step with remat (phase 18 (c))",
                                TAIL_KERNELS + ATT_KERNELS)
    want = 2 * tail_forwards_per_step(12, 12, True)
    log(f"phase 18 (c) vit_s remat step B=32: losses {losses}, attention forwards "
        f"{launches['attention_fwd']}, tail forwards {launches['block_mlp_fwd']} "
        f"(expected {want} each)")
    if not (np.isfinite(losses).all() and launches["attention_fwd"] == want
            and launches["block_mlp_fwd"] == want):
        raise AssertionError("the ViT-S remat step: bad losses or forwards")
    del state, step, x, y
    torch.cuda.empty_cache()
    took["c_vit"] = time.time() - t0
    log(f"phase 18: {sum(took.values()):.1f} s; "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in took.items()))


# -------------------------------------------------------------- phase 19
ATTACK_BATCH = 32  # phase 19 (b): PGD and the wrapped model, as APGD-CE's batch in phase 8
ISO_C = 432  # convnext_iso with updated=1
# tail launches per APGD training step of convnext_iso: all 18 blocks fuse
# in the attack and in training (432 <= 512), 5 reductions a full backward
ISO_PER_STEP = {"block_mlp_fwd": tail_forwards_per_step(18, 18, False),
                "block_mlp_bwd_input": ATTACK_ITERS * 18, "block_mlp_bwd_full_rows": 18,
                "block_mlp_wgrad": 2 * 18, "block_mlp_reduce": 5 * 18}


# ConvNeXt-B-CvSt (phase 19 (d)): depths 3, 3, 27, 3 at C = 128, 256, 512,
# 1024. All 36 blocks fuse in the attack (input mode through 1024), the 33 of
# stages 0-2 in training (full mode through 512): stage 2's 27 blocks are the
# C = 512 cluster kernels
B_PER_STEP = {"block_mlp_fwd": tail_forwards_per_step(36, 33, False),
              "block_mlp_bwd_input": ATTACK_ITERS * 36, "block_mlp_bwd_full_rows": 33,
              "block_mlp_wgrad": 2 * 33, "block_mlp_reduce": 5 * 33}
# of those, stage 3's (C = 1024, the clusters of four): its 3 blocks in the
# attack only
B_PER_STEP_1024 = {"block_mlp_fwd": tail_forwards_per_step(3, 0, False),
                   "block_mlp_bwd_input": ATTACK_ITERS * 3, "block_mlp_bwd_full_rows": 0}


def convnext_b_phase(torch, np, seed, label) -> dict:
    """Phase 19 (d): phase 6's step on ConvNeXt-B-CvSt (convnext_base,
    not_original=1, random weights from the seed, LayerScale from U(0.1, 1))
    at 224 px, batch 80: 2 warm-up steps, then in turns with use_pallas=0,
    B_PER_STEP's tail launches a step, the kernel step profiled (its tail
    row kernels split by width); one step against the CPU at batch 2.
    Returns the tail's launches per step of the kernel step, and the C =
    1024 kernels' launches per step as the profile counts them (None: not
    measured)."""
    from revisiting_at_tpu_torch.models import get_model

    t0 = time.time()
    torch.manual_seed(seed)
    with torch.device("cuda"):  # the random init on the card: seconds on the host
        model, _ = get_model("convnext_base", not_original=True, dtype=torch.float32)
    with torch.no_grad():
        for blk in (b for st in model.stages for b in st.blocks):
            blk.gamma.uniform_(0.1, 1.0)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    del model
    log(f"model: convnext_base + ConvStem, {n_params / 1e6:.2f} M params, seed {seed}")
    steps = {name: build_train_step(torch, init, use_pallas=name == "kernel", device="cuda",
                                    seed=seed, arch="convnext_base")
             for name in ("kernel", "plain")}
    rng = np.random.RandomState(seed)
    xb = torch.from_numpy(rng.uniform(0, 1, (TRAIN_BATCH, 224, 224, 3)).astype(np.float32))
    yb = torch.from_numpy(rng.randint(0, 1000, TRAIN_BATCH))
    xb, yb = xb.cuda(), yb.cuda()
    zero_launches()
    step_ms, losses = steps_in_turns(torch, steps, dict.fromkeys(steps, (xb, yb)),
                                     ("kernel", "plain", "plain", "kernel"), warm=2)
    launches = require_launches("the ConvNeXt-B training step (phase 19 (d))", TAIL_KERNELS)
    per_step = per_step_launches(launches, 2 + 10, "the ConvNeXt-B training step, kernel path",
                                 B_PER_STEP)
    for name, v in step_ms.items():
        ms = sum(v) / len(v)
        log(f"phase 19 (d) train step convnext_base+ConvStem bf16 B={TRAIN_BATCH} 224px 2-step "
            f"APGD ({name} tail): {ms:.2f} ms/step, {2000.0 / ms:.3f} attack-steps/s (runs of "
            f"5: {', '.join('%.2f' % t for t in v)}) {label}")
        if not np.isfinite(losses[name]).all():
            raise AssertionError(f"ConvNeXt-B {name}-tail step: non-finite loss {losses[name]}")
    prof = profile_breakdown(torch, f"phase 19 (d) ConvNeXt-B train step B={TRAIN_BATCH} "
                             f"(kernel tail), per step",
                             lambda: steps["kernel"][1](steps["kernel"][0], xb, yb), 3, label)
    for C in (128, 256, 512, 1024):
        for k, (ms, count) in sorted(tail_by_width(prof, C).items()):
            log(f"phase 19 (d) tail {k} at C={C}: {ms:.2f} ms of device time a step, "
                f"{count:.2f} launches a step {label}")
    by_width = tail_by_width(prof, 1024)
    per_step_1024 = {f"block_mlp_{k}": (round(by_width.get(k, (0.0, 0.0))[1]) if prof else None)
                     for k in ("fwd", "bwd_input", "bwd_full_rows")}
    if prof and per_step_1024 != B_PER_STEP_1024:
        log(f"phase 19 (d): the profile counts {per_step_1024} C = 1024 launches a step, "
            f"not {B_PER_STEP_1024} (the profiler can miss kernels as tracing starts)")
    del steps, xb, yb
    torch.cuda.empty_cache()
    t1 = time.time()
    check_step_against_cpu(torch, np, init, seed, arch="convnext_base",
                           probes=("stages.2.blocks.0.mlp.fc1.weight",
                                   "stages.2.blocks.26.mlp.fc2.weight"))
    log(f"phase 19 (d): {time.time() - t0:.1f} s, the step against the CPU "
        f"{time.time() - t1:.1f} s of it")
    return per_step, per_step_1024


def iso_init(torch, seed: int, updated: bool) -> dict:
    """ConvNeXt-iso-CvSt's random weights from the seed, an f32 state_dict."""
    from revisiting_at_tpu_torch.models import get_model

    torch.manual_seed(seed)
    model, _ = get_model("convnext_iso", not_original=True, updated=updated, dtype=torch.float32)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def wide_tail_timings(torch, bm, gen, label, C, rows) -> dict:
    """The block tail at `rows` x 80 rows of width C: convnext_iso's shape
    (C = 432, 196 rows an image), ConvNeXt-B's stage 2 (C = 512, 196) or
    stage 3 (C = 1024, 49), on the cluster kernels (two blocks, four at
    1024): forward and input backward beside their plain versions (in turns
    p, k, k, p), the plain model path's tail (bf16 cuBLAS, erf GELU) and
    bounds as phase 8 books them; the full backward (row pass, weight passes
    and reductions) beside its plain version and the model path's weight
    backward, bound as _bwd_kernel's work."""
    from revisiting_at_tpu_torch.models.convnext import plain_tail

    M = rows * TRAIN_BATCH
    tag = "iso" if C == ISO_C else f"C={C}"
    d = tail_inputs(torch, M, C, torch.bfloat16, gen)
    s_in, r_in = d["s"].clone().requires_grad_(True), d["r"].clone().requires_grad_(True)
    model_args = (d["ln_g"], d["ln_b"], d["w1"].t(), d["b1"], d["w2"].t(), d["b2"], d["gamma"],
                  torch.bfloat16)
    y_model = plain_tail(s_in, r_in, *model_args)
    model_fn = {"fwd": lambda: plain_tail(d["s"], d["r"], *model_args),
                "bwd_input": lambda: torch.autograd.grad(y_model, (s_in, r_in), d["dy"],
                                                         retain_graph=True)}
    weights = 2 * 4 * C * C * 2 + 7 * C * 4
    out = {}
    for which in ("fwd", "bwd_input"):
        k_fn = lambda: run_tail(bm, d, which, kernel=True)  # noqa: E731
        p_fn = lambda: run_tail(bm, d, which, kernel=False)  # noqa: E731
        p1, k1, k2, p2 = (time_ms(torch, f, 10) for f in (p_fn, k_fn, k_fn, p_fn))
        flops = (16 if which == "fwd" else 24) * M * C * C
        bound = max(flops / PEAK_BF16, (3 * M * C * 2 + weights) / PEAK_HBM) * 1e3
        out[which] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                          model_ms=time_ms(torch, model_fn[which], 10),
                          device_ms=device_ms(torch, k_fn, 10), bound_ms=bound,
                          design=tail_design(bm, C, which))
        o = out[which]
        log(f"time {which:9s} {tag} B={TRAIN_BATCH} M={M} C={C}: kernel {o['ms']:.3f} ms "
            f"({flops / o['ms'] / 1e9:.1f} TFLOP/s; device {ms_or_na(o['device_ms'])} ms, "
            f"{o['design']}), plain {o['plain_ms']:.3f} ms, model bf16 path "
            f"{o['model_ms']:.3f} ms, bound {bound:.4f} ms {label}")
    w2g16 = (d["w2"].bfloat16().float() * d["gamma"]).bfloat16()
    a = (d["s"], None, M, d["ln_g"], d["ln_b"], d["w1"].bfloat16(), d["b1"], w2g16, d["dy"])
    leaves = [d["s"].clone(), d["r"].clone(), d["ln_g"], d["ln_b"], d["w1"].t().contiguous(),
              d["b1"], d["w2"].t().contiguous(), d["b2"], d["gamma"]]
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    y_full = plain_tail(*leaves, torch.bfloat16)
    flops = 40 * M * C * C  # _bwd_kernel's work: rows (24), dW1 and A (16)
    nbytes = (3 * M * C * 2 + 2 * 4 * C * C * 2 + 6 * C * 4) + (2 * 4 * C * C + 6 * C) * 4
    out["bwd_full"] = dict(
        ms=time_ms(torch, lambda: bm.bwd_full_cuda(*a), 10),
        rows_ms=time_ms(torch, lambda: bm.bwd_full_rows_cuda(*a), 10),
        plain_ms=time_ms(torch, lambda: bm.bwd_full_plain(*a), 5),
        model_ms=time_ms(torch, lambda: torch.autograd.grad(y_full, leaves, d["dy"],
                                                            retain_graph=True), 10),
        device_ms=device_ms(torch, lambda: bm.bwd_full_cuda(*a), 10),
        bound_ms=max(flops / PEAK_BF16, nbytes / PEAK_HBM) * 1e3,
        design=tail_design(bm, C, "bwd_full_rows"))
    o = out["bwd_full"]
    log(f"time bwd_full  {tag} B={TRAIN_BATCH} M={M} C={C}: kernels {o['ms']:.3f} ms "
        f"({flops / o['ms'] / 1e9:.1f} TFLOP/s; device {ms_or_na(o['device_ms'])} ms; row pass "
        f"{o['rows_ms']:.3f} ms, {o['design']}), plain {o['plain_ms']:.3f} ms, model bf16 path "
        f"weight backward {o['model_ms']:.3f} ms, bound {o['bound_ms']:.4f} ms {label}")
    del d, s_in, r_in, y_model, leaves, y_full, a
    torch.cuda.empty_cache()
    return out


def per_step_launches(launches: dict, n_steps: int, what: str, expected: dict) -> dict:
    """The tail launches per step over n_steps kernel steps; fatal unless
    they are `expected`."""
    got = {k: launches[k] / n_steps for k in expected}
    log(f"tail launches per step of {what}: {got} (expected {expected})")
    if got != expected:
        raise AssertionError(f"{what}: tail launches per step {got}, expected {expected}")
    return got


def attack_agreement(torch, got, ref, x, eps, norm) -> float:
    """How far two attack points of the card and the CPU lie apart, fatal
    unless both lie in the eps ball and the box and, for Linf, at most 5% of
    the elements are more than 1e-5 apart, none by more than 2 eps (a sign
    step of a gradient component near zero goes the other way: the kernels
    round u, g and dh to bf16 after an f32 sum in an order of their own, so
    a rounding can flip where the CPU plain version's does not; first
    reading 1.14% of the elements over 10 PGD steps on 2 images), or, for
    L2, each image's |delta_card - delta_cpu| is at most 5% of |delta_cpu|
    (L2 steps move every element by the normalised gradient). Returns the
    share apart (Linf) or the largest relative distance (L2)."""
    got, ref, x = got.float().cpu(), ref.float().cpu(), x.float().cpu()
    for z in (got, ref):
        delta = (z - x).reshape(len(z), -1)
        size = delta.abs().max() if norm == "Linf" else delta.norm(dim=1).max()
        if not (float(size) <= eps * (1 + 1e-4) and 0.0 <= float(z.min()) <= float(z.max()) <= 1.0):
            raise AssertionError(f"{norm} attack point outside the eps ball or the box")
    diff = (got - ref).abs()
    if norm == "Linf":
        share, worst = float((diff > 1e-5).float().mean()), float(diff.max())
        if not (share <= 5e-2 and worst <= 2 * eps + 1e-6):
            raise AssertionError(f"Linf attack points, card vs CPU: {share:.2%} of the elements "
                                 f"apart, largest {worst:.3e} (allowed 5% and 2 eps)")
        return share
    d_ref = (ref - x).reshape(len(x), -1)
    rel = float(((got - ref).reshape(len(x), -1).norm(dim=1) / d_ref.norm(dim=1)).max())
    if not rel <= 5e-2:
        raise AssertionError(f"L2 attack points, card vs CPU: |delta difference| {rel:.3e} of "
                             f"|delta| (allowed 5e-2)")
    return rel


def iso_attacks_phase(torch, np, init, seed, label) -> None:
    """Phase 19 (b): pgd_attack (Linf, L2; 10 steps) and AdversarialModel
    (apgd, fgsm) on ConvNeXt-iso-CvSt (updated=1) at B = 32 on the card
    with the kernels (bf16, as the step's attack runs; each must launch the
    tail's forward and input backward, and run in attack mode: no weight
    gradient); then on 2 of the images, the f32 build of the same weights on
    the card against the CPU from the same start and draws (f32, so that the
    comparison reads the attack and the kernels, not bf16 convolutions)."""
    from revisiting_at_tpu_torch.attacks import AdversarialModel, pgd_attack
    from revisiting_at_tpu_torch.ckpt.convert import load_state_dict
    from revisiting_at_tpu_torch.models import get_model

    def model_on(device, dtype):
        m, _ = get_model("convnext_iso", not_original=True, updated=True, dtype=dtype,
                         use_pallas=True)
        load_state_dict(m, init)
        return m.to(device).eval()

    rng = np.random.RandomState(seed + 3)
    x = torch.from_numpy(rng.uniform(0, 1, (ATTACK_BATCH, 224, 224, 3)).astype(np.float32))
    eps = {"Linf": 4.0 / 255.0, "L2": 0.5}
    gen = torch.Generator().manual_seed(seed)
    starts = {"Linf": torch.rand(x.shape, generator=gen) * (2 * eps["Linf"]) - eps["Linf"],
              "L2": torch.randn(x.shape, generator=gen)}
    fgsm_draw = torch.rand(x.shape, generator=gen)
    card = model_on("cuda", torch.bfloat16)
    with torch.no_grad():
        y = card(x.cuda()).argmax(-1)
    xc = x.cuda()
    for norm in ("Linf", "L2"):
        pgd_attack(card, xc, y, norm=norm, eps=eps[norm], n_iter=2, noise=starts[norm])  # warm
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        z = pgd_attack(card, xc, y, norm=norm, eps=eps[norm], n_iter=10, noise=starts[norm])
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1000 / 10
        launches = require_launches(f"pgd_attack {norm} (phase 19 (b))",
                                    ("block_mlp_fwd", "block_mlp_bwd_input"))
        with torch.no_grad():
            broken = float((card(z).argmax(-1) != y).float().mean())
        log(f"phase 19 (b) pgd_attack {norm} eps {eps[norm]:.5f} iso B={ATTACK_BATCH} bf16, 10 "
            f"steps: {ms:.2f} ms/iteration, {broken:.2%} of the points broken, tail forwards "
            f"{launches['block_mlp_fwd']}, input backwards {launches['block_mlp_bwd_input']} "
            f"{label}")
        if any(p.grad is not None for p in card.parameters()):
            raise AssertionError("pgd_attack left weight gradients: not in attack mode")
    for attack in ("apgd", "fgsm"):
        wrapped = AdversarialModel(card, attack=attack, eps=eps["Linf"], n_iter=2, seed=seed,
                                   attack_draws=lambda calls, shape: fgsm_draw)
        wrapped.set_perturb(True)
        zero_launches()
        logits = wrapped(xc, y, train=True)
        require_launches(f"AdversarialModel {attack} (phase 19 (b))",
                         ("block_mlp_fwd", "block_mlp_bwd_input"))
        if not (torch.isfinite(logits).all() and card.training):
            raise AssertionError(f"AdversarialModel {attack}: bad logits or mode")
        card.eval()
    del card
    torch.cuda.empty_cache()

    # card vs CPU, f32, 2 images, same starts and draws
    n = 2
    models = {dev: model_on(dev, torch.float32) for dev in ("cuda", "cpu")}
    xs, ys = x[:n], y[:n].cpu()
    for norm in ("Linf", "L2"):
        z = {dev: pgd_attack(m, xs.to(dev), ys.to(dev), norm=norm, eps=eps[norm], n_iter=10,
                             noise=starts[norm][:n]) for dev, m in models.items()}
        apart = attack_agreement(torch, z["cuda"], z["cpu"], xs, eps[norm], norm)
        log(f"phase 19 (b) pgd_attack {norm} card vs CPU (f32, {n} images, 10 steps, same "
            f"start): " + (f"{apart:.3%} of the elements more than 1e-5 apart" if norm == "Linf"
                           else f"|delta difference| {apart:.3e} of |delta|"))
    for attack in ("apgd", "fgsm"):
        out = {}
        for dev, m in models.items():
            wrapped = AdversarialModel(m, attack=attack, eps=eps["Linf"], n_iter=2, seed=seed,
                                       attack_draws=lambda calls, shape: fgsm_draw[:n])
            z = wrapped.perturb(xs.to(dev), ys.to(dev))
            with torch.no_grad():
                out[dev] = (z, m.train()(z).float().cpu())
        share = attack_agreement(torch, out["cuda"][0], out["cpu"][0], xs, eps["Linf"], "Linf")
        e, scale = compare(out["cuda"][1], out["cpu"][1])
        log(f"phase 19 (b) AdversarialModel {attack} card vs CPU (f32, {n} images): "
            f"{share:.3%} of the points' elements more than 1e-5 apart; train-mode logits "
            f"max_abs_err {e:.3e}, max|ref| {scale:.3e} (tolerance 2e-3 of it)")
        if not e <= 2e-3 * scale:
            raise AssertionError(f"AdversarialModel {attack}: logits disagree with the CPU's")
    del models
    torch.cuda.empty_cache()


def bn_phase(torch, np, repo, seed, label) -> None:
    """Phase 19 (c): the BN family at full width on cuDNN. resnet50 at 224
    px, batch 80: cli.train for 4 steps with model.pretrained=1 from a
    state_dict made here and saved to a temporary .pt (every parameter and
    statistic must load), one step against the CPU at batch 2 (its running
    statistics by flax's rule), cli.eval (short AutoAttack) on its EMA
    weights and cli.export; densnet201 at 224 px and inception at 299 px:
    one eval forward and one training step each against the CPU at batch
    2 (f32, the step without attack: the running statistics' rule); the three
    APGD steps at batch 80 timed (ms/step)."""
    import shutil
    import tempfile

    from revisiting_at_tpu_torch.cli import eval as eval_cli
    from revisiting_at_tpu_torch.cli import export as export_cli
    from revisiting_at_tpu_torch.cli import train as train_cli
    from revisiting_at_tpu_torch.ckpt.convert import load_state_dict
    from revisiting_at_tpu_torch.models import BatchNorm, get_model

    def init_of(arch, img):
        """Weights as a trained model's: BN scales from U(0.5, 1.5), not the
        init's (bn3's zero scale would leave each block's convs without a
        gradient), and running statistics that normalise (one train-mode
        pass over 4 random images with momentum 0: random statistics leave
        the eval-mode network unnormalised, and an attack on it diverges
        between two devices)."""
        torch.manual_seed(seed + 7)  # not the trainer's seed: a load must show
        m, _ = get_model(arch, dtype=torch.float32)
        bns = [b for b in m.modules() if isinstance(b, BatchNorm)]
        with torch.no_grad():
            for b in bns:
                b.weight.uniform_(0.5, 1.5)
                b.momentum = 0.0
            m.train()(torch.rand(4, img, img, 3))
            for b in bns:
                b.momentum = 0.9
                b.num_batches_tracked.zero_()
        return {k: v.detach().clone() for k, v in m.state_dict().items()}

    # Inception's pool branch, input gradients card vs CPU at its three map
    # shapes: the port's pool (on an NCHW copy) must agree; the library's
    # padded pool over the channels_last view, which it replaces, is logged
    import torch.nn.functional as F

    from revisiting_at_tpu_torch.models.inception import _avg_pool_3x3
    from revisiting_at_tpu_torch.models.layers import to_nchw, to_nhwc

    def pool_grads(fn, x, dy):
        out = {}
        for dev in ("cuda", "cpu"):
            xs = x.to(dev).requires_grad_(True)
            (out[dev],) = torch.autograd.grad(fn(xs), xs, dy.to(dev))
        return float((out["cuda"].cpu() - out["cpu"]).abs().max() / out["cpu"].abs().max())

    gen = torch.Generator().manual_seed(seed)
    for side, chans in ((35, 288), (17, 768), (8, 1280)):
        x = torch.randn(2, side, side, chans, generator=gen)
        dy = torch.randn(2, side, side, chans, generator=gen)
        port = pool_grads(_avg_pool_3x3, x, dy)
        lib = pool_grads(lambda t: to_nhwc(F.avg_pool2d(to_nchw(t), 3, 1, 1)), x, dy)
        log(f"phase 19 (c) inception's 3x3 average pool {side}x{side}x{chans}, input gradient "
            f"card vs CPU: the port's (NCHW copy) {port:.3e}, the library's on the "
            f"channels_last view {lib:.3e} of max |grad| (tolerance 1e-5 for the port's)")
        if not port <= 1e-5:
            raise AssertionError("inception's average pool: the card's gradient differs")

    sizes = {"resnet50": 224, "densnet201": 224, "inception": 299}
    probes = {"resnet50": ("layer1.0.conv1.weight", "fc.weight"),
              "densnet201": ("features.denseblock1.denselayer1.conv1.weight", "classifier.weight"),
              "inception": ("Mixed_5b.branch1x1.conv.weight", "fc.weight")}
    inits = {arch: init_of(arch, img) for arch, img in sizes.items()}
    for arch, img in sizes.items():
        rng = np.random.RandomState(seed + 4)
        x = torch.from_numpy(rng.uniform(0, 1, (2, img, img, 3)).astype(np.float32))
        logits = {}
        for dev in ("cuda", "cpu"):  # f32: bf16 logits differ by up to 6% (inception)
            m, _ = get_model(arch, dtype=torch.float32)
            load_state_dict(m, inits[arch])
            with torch.no_grad():
                logits[dev] = m.to(dev).eval()(x.to(dev)).cpu()
        e, scale = compare(logits["cuda"], logits["cpu"])
        log(f"phase 19 (c) {arch} {img} px eval logits card vs CPU (f32, 2 images): "
            f"max_abs_err {e:.3e}, max|ref| {scale:.3e} (tolerance 1e-3 of it)")
        if not (torch.isfinite(logits["cuda"]).all() and e <= 1e-3 * scale):
            raise AssertionError(f"{arch}: eval logits disagree with the CPU's")
        # f32 and no attack: bf16 convolutions round differently on the two
        # devices, and APGD's sign steps and the BatchNorms carry that to 1e-1
        # of a statistic; the batch-80 steps below run APGD
        check_step_against_cpu(torch, np, inits[arch], seed, arch=arch, probes=probes[arch],
                                img=img, dtype=torch.float32, attack="none")
        state, step = build_train_step(torch, inits[arch], use_pallas=True, device="cuda",
                                       seed=seed, arch=arch)
        xb = torch.from_numpy(rng.uniform(0, 1, (TRAIN_BATCH, img, img, 3)).astype(np.float32))
        yb = torch.from_numpy(rng.randint(0, 1000, TRAIN_BATCH))
        run_steps(torch, state, step, xb.cuda(), yb.cuda(), 1)
        ms, losses = run_steps(torch, state, step, xb.cuda(), yb.cuda(), 3)
        log(f"phase 19 (c) train step {arch} bf16 B={TRAIN_BATCH} {img}px 2-step APGD (cuDNN, "
            f"no hand kernel): {ms:.2f} ms/step, losses {losses} {label}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{arch}: non-finite training loss")
        del state, step, xb, yb
        torch.cuda.empty_cache()

    folder = repo / "build" / "smoke_bn"
    shutil.rmtree(folder, ignore_errors=True)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "resnet50_pretrained.pt"
        torch.save({"state_dict": {f"module.{k}": v for k, v in inits["resnet50"].items()}}, src)
        t0 = time.time()
        trainer = train_cli.main([
            "--model.arch", "resnet50", "--model.pretrained", "1", "--model.pretrained_path",
            str(src), "--model.add_normalization", "0", "--model.model_ema", "1",
            "--adv.attack", "apgd", "--adv.n_iter", str(ATTACK_ITERS), "--data.dataset",
            "synthetic", "--training.batch_size", str(TRAIN_BATCH), "--training.epochs", "1",
            "--validation.batch_size", "32", "--validation.max_batches", "1",
            "--training.seed", str(seed), "--logging.folder", str(folder), "--device", "cuda",
            "--synthetic_batches", "4"])
    run, ema = trainer.logger.dir, trainer.state.ema
    records = [json.loads(line) for line in (run / "log").read_text().splitlines()]
    epoch = [r for r in records if "train_loss" in r]
    # EMA 0.9999 over 4 steps: 4e-4 of the way from the loaded file to the
    # weights and statistics the steps reach, so within 1e-3 of the file
    far = max(float((ema[k].cpu() - v.float()).abs().max())
              for k, v in inits["resnet50"].items() if k in ema)
    log(f"phase 19 (c) cli.train resnet50 pretrained, 4 steps B={TRAIN_BATCH}: epoch {epoch}, "
        f"the EMA's largest departure from the loaded file {far:.2e}, "
        f"{time.time() - t0:.1f} s {label}")
    if not (epoch and np.isfinite(epoch[0]["train_loss"]) and far < 1e-3
            and int(trainer.model.bn1.num_batches_tracked) == 4):
        raise AssertionError(f"cli.train resnet50: bad records, pretrained init or statistics "
                             f"{records}")
    del trainer
    torch.cuda.empty_cache()
    base = ["--run_dir", str(run), "--synthetic", "--n_ex", "16", "--batch_size", "16",
            "--n_iter", "2", "--img_size", "224", "--device", "cuda"]
    m, _ = get_model("resnet50", dtype=torch.bfloat16)
    load_state_dict(m, torch.load(run / "ckpt" / "weights_ema_0.pt", weights_only=True))
    x_eval, y_eval = own_labels(torch, np, eval_cli, m.cuda().eval().requires_grad_(False),
                                base + ["--use_ema", "1"])
    del m
    res = eval_on(eval_cli, base + ["--use_ema", "1"], x_eval, y_eval)
    out = export_cli.main(["--run_dir", str(run), "--out", str(folder / "resnet50_ema.pt"),
                           "--use_ema", "1"])
    m, _ = get_model("resnet50", dtype=torch.float32)
    m.load_state_dict(torch.load(out, weights_only=True), strict=True)
    log(f"phase 19 (c) cli.eval --use_ema 1 resnet50: {res}; cli.export {out} strict-loads")
    if not 0.0 <= res["Linf"]["robust"] <= 1.0:
        raise AssertionError(f"cli.eval resnet50: bad result {res}")
    shutil.rmtree(folder, ignore_errors=True)


def iso_phase(torch, np, repo, seed, label) -> dict:
    """Phase 19: ConvNeXt-iso-CvSt (a), its attacks (b), the BN family (c);
    returns the tail's launches per step of (a)'s kernel step."""
    import shutil

    from revisiting_at_tpu_torch.cli import eval as eval_cli
    from revisiting_at_tpu_torch.cli import export as export_cli
    from revisiting_at_tpu_torch.cli import train as train_cli
    from revisiting_at_tpu_torch.models import get_model
    from revisiting_at_tpu_torch.ops import block_mlp as bm

    took = {}
    t0 = time.time()
    init = iso_init(torch, seed, True)
    n_params = sum(v.numel() for k, v in init.items())
    log(f"model: convnext_iso (updated=1, C = {ISO_C}) + ConvStem, {n_params / 1e6:.2f} M "
        f"params, seed {seed}")
    steps = {name: build_train_step(torch, init, use_pallas=name == "kernel", device="cuda",
                                    seed=seed, arch="convnext_iso", updated=True)
             for name in ("kernel", "plain")}
    rng = np.random.RandomState(seed)
    xb = torch.from_numpy(rng.uniform(0, 1, (TRAIN_BATCH, 224, 224, 3)).astype(np.float32))
    yb = torch.from_numpy(rng.randint(0, 1000, TRAIN_BATCH))
    xb, yb = xb.cuda(), yb.cuda()
    zero_launches()
    step_ms, losses = steps_in_turns(torch, steps, dict.fromkeys(steps, (xb, yb)),
                                     ("kernel", "plain", "plain", "kernel"), warm=2)
    launches = require_launches("the iso training step (phase 19 (a))", TAIL_KERNELS)
    per_step = per_step_launches(launches, 2 + 10, "the iso training step, kernel path",
                                 ISO_PER_STEP)
    for name, v in step_ms.items():
        ms = sum(v) / len(v)
        log(f"phase 19 (a) train step convnext_iso+ConvStem (C={ISO_C}) bf16 B={TRAIN_BATCH} "
            f"224px 2-step APGD ({name} tail): {ms:.2f} ms/step, {2000.0 / ms:.3f} "
            f"attack-steps/s (runs of 5: {', '.join('%.2f' % t for t in v)}) {label}")
        if not np.isfinite(losses[name]).all():
            raise AssertionError(f"iso {name}-tail step: non-finite loss {losses[name]}")
    for name in ("kernel", "plain"):
        profile_breakdown(torch, f"phase 19 (a) iso train step B={TRAIN_BATCH} ({name} tail), "
                          f"per step", lambda: steps[name][1](steps[name][0], xb, yb), 3, label)
    del steps
    torch.cuda.empty_cache()
    check_step_against_cpu(torch, np, init, seed, arch="convnext_iso", updated=True,
                           probes=("blocks.0.pwconv1.weight", "blocks.17.pwconv2.weight"))
    # updated=0: C = 384, the TMA + wgmma kernels
    init0 = iso_init(torch, seed, False)
    state, step = build_train_step(torch, init0, use_pallas=True, device="cuda", seed=seed,
                                   arch="convnext_iso", updated=False)
    zero_launches()
    _, loss0 = run_steps(torch, state, step, xb, yb, 1)
    per_step_launches(require_launches("the iso step at C = 384 (phase 19 (a))", TAIL_KERNELS),
                      1, f"the iso step at C = 384 ({tail_design(bm, 384, 'fwd')})",
                      ISO_PER_STEP)
    if not np.isfinite(loss0).all():
        raise AssertionError(f"iso step at C = 384: non-finite loss {loss0}")
    del state, step, init0
    torch.cuda.empty_cache()
    took["a_step"] = time.time() - t0

    t0 = time.time()
    folder = repo / "build" / "smoke_iso"
    shutil.rmtree(folder, ignore_errors=True)
    zero_launches()
    trainer = train_cli.main([
        "--model.arch", "convnext_iso", "--model.not_original", "1", "--model.updated", "1",
        "--model.add_normalization", "0", "--model.model_ema", "1", "--adv.attack", "apgd",
        "--adv.n_iter", str(ATTACK_ITERS), "--data.dataset", "synthetic",
        "--training.batch_size", str(TRAIN_BATCH), "--training.epochs", "1",
        "--training.use_pallas", "1", "--validation.batch_size", "32",
        "--validation.max_batches", "1", "--training.seed", str(seed),
        "--logging.folder", str(folder), "--device", "cuda", "--synthetic_batches", "4"])
    require_launches("the iso train CLI (phase 19 (a))", TAIL_KERNELS)
    run = trainer.logger.dir
    records = [json.loads(line) for line in (run / "log").read_text().splitlines()]
    epoch = [r for r in records if "train_loss" in r]
    if not (epoch and np.isfinite(epoch[0]["train_loss"])
            and records[-1].get("event") == "final_val"):
        raise AssertionError(f"cli.train convnext_iso: bad records {records}")
    del trainer
    torch.cuda.empty_cache()
    base = ["--run_dir", str(run), "--use_pallas", "1", "--synthetic", "--n_ex", "16",
            "--batch_size", "16", "--n_iter", "5", "--img_size", "224", "--device", "cuda",
            "--use_ema", "1"]
    model = eval_model(torch, "convnext_iso", run / "ckpt" / "weights_ema_0.pt", updated=True)
    x_eval, y_eval = own_labels(torch, np, eval_cli, model, base)
    del model
    zero_launches()
    res = eval_on(eval_cli, base, x_eval, y_eval)
    require_launches("cli.eval --use_ema 1 on the iso run (phase 19 (a))",
                     ("block_mlp_fwd", "block_mlp_bwd_input"))
    out = export_cli.main(["--run_dir", str(run), "--out", str(folder / "iso_ema.pt"),
                           "--use_ema", "1"])
    exported, _ = get_model("convnext_iso", not_original=True, updated=True,
                            dtype=torch.float32)
    exported.load_state_dict(torch.load(out, weights_only=True), strict=True)
    log(f"phase 19 (a) cli.train + cli.eval --use_ema 1 + cli.export convnext_iso: epoch "
        f"{epoch[0]}, eval {res}, {out} strict-loads, {time.time() - t0:.1f} s")
    if not 0.0 <= res["Linf"]["robust"] <= 1.0:
        raise AssertionError(f"cli.eval on the iso run: bad result {res}")
    shutil.rmtree(folder, ignore_errors=True)
    took["a_cli"] = time.time() - t0

    t0 = time.time()
    iso_attacks_phase(torch, np, init, seed, label)
    took["b"] = time.time() - t0
    t0 = time.time()
    bn_phase(torch, np, repo, seed, label)
    took["c"] = time.time() - t0
    log(f"phase 19: {sum(took.values()):.1f} s; "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in took.items()))
    return per_step



# -------------------------------------------------------------- phase 20
# phase 20's parts: DDP and FSDP batches a rank, the TP and eval batches
P20_BATCH = {"convnext_tiny": 40, "vit_s": 40, "resnet50": 8}
P20_LR = 1e-3  # a constant LR: one AdamW step moves each weight by about LR
P20_TP_BATCH, P20_EVAL_N = 8, 16
# (d)'s bounds on the TP gradient, relative: the whole, and each tensor
# (measured on the H100: 3.2e-3 and at most 4.8e-3)
P20_TP_GRAD_TOL, P20_TP_TENSOR_TOL = 1e-2, 2e-2


def p20_step(torch, arch, state_dict, *, use_pallas=True, mesh=None):
    """Phase 20's step: phase 6's (bf16 compute, f32 parameters, mixup with
    label smoothing 0.1, 2-step APGD Linf 4/255, AdamW wd 0.05 with the
    family's decay rule) at the constant LR P20_LR and without EMA, on the
    current card. With a mesh of more than one rank, the model is split over
    its "model" axis and synced over the others (parallel/)."""
    from revisiting_at_tpu_torch.ckpt.convert import load_state_dict, param_layout
    from revisiting_at_tpu_torch.data import MixupConfig
    from revisiting_at_tpu_torch.models import get_model
    from revisiting_at_tpu_torch.parallel.tp import apply_tensor_parallel
    from revisiting_at_tpu_torch.parallel.zero import ParallelModel
    from revisiting_at_tpu_torch.train import (AdvConfig, TrainState, make_optimizer,
                                               make_train_step)

    model, meta = get_model(arch, not_original=arch != "resnet50", dtype=torch.bfloat16,
                            use_pallas=use_pallas)
    load_state_dict(model, state_dict)
    model.cuda().train()
    par = None
    if mesh is not None and mesh.size > 1:
        par = ParallelModel(model, mesh, apply_tensor_parallel(model, mesh, param_layout(arch)))
    opt = make_optimizer(model, optimizer="adamw", weight_decay=0.05, family=meta.family,
                         learning_rate=P20_LR,
                         params=par.named_master() if par is not None else None)
    step = make_train_step(model, adv=AdvConfig(attack="apgd", norm="Linf", eps=4.0 / 255.0,
                                                n_iter=2),
                           mixup=MixupConfig(num_classes=1000, label_smoothing=0.1), seed=0)
    return TrainState(model, opt, None, parallel=par), step


class _RankStandIn:
    """Rank r of a data = 2 mesh played by one process for phase 20's
    reference: the step's draws of that rank, its local gradients and
    BatchNorm statistics kept, no collective, no update."""

    def __init__(self, model, rank):
        from types import SimpleNamespace

        self.model, self.mesh, self.grads = model, SimpleNamespace(batch_rank=rank), None

    def average_stats(self):
        pass

    def sync_grads(self):
        self.grads = [p.grad.detach().clone() if p.grad is not None else None
                      for p in self.model.parameters()]
        return self.grads[0].new_zeros(())

    def after_update(self):
        pass

    def named_master(self):
        return list(self.model.named_parameters())

    def mean(self, tensors):
        return tensors


class _NoUpdate:
    def __init__(self, model):
        self.model = model

    def zero_grad(self):
        self.model.zero_grad(set_to_none=True)

    def update(self):
        return False


def p20_reference(torch, arch, state_dict, x, y):
    """The data = 2 step in one process: each half of (x, y) through the
    step with that rank's draws from the same weights and statistics, the
    two gradients averaged, the statistics averaged, one AdamW update.
    Returns (loss, grad_norm, {name: parameter and statistic})."""
    from revisiting_at_tpu_torch.models.layers import bn_stat_names

    state, step = p20_step(torch, arch, state_dict)
    model, opt = state.model, state.optimizer
    stats = bn_stat_names(model)
    buffers = dict(model.named_buffers())
    start = {n: buffers[n].clone() for n in stats}
    n = x.shape[0] // 2
    grads, moved, losses = [], [], []
    for r in range(2):
        for k in stats:
            buffers[k].copy_(start[k])
        half = _RankStandIn(model, r)
        state.parallel, state.optimizer, state.step = half, _NoUpdate(model), 0
        losses.append(float(step(state, x[r * n:(r + 1) * n], y[r * n:(r + 1) * n])["loss"]))
        grads.append(half.grads)
        moved.append({k: buffers[k].clone() for k in stats})
    with torch.no_grad():
        for k in stats:
            buffers[k].copy_((moved[0][k] + moved[1][k]) / 2)
    for p, g0, g1 in zip(model.parameters(), *grads):
        p.grad = None if g0 is None else (g0 + g1) / 2
    norm = float(torch.linalg.vector_norm(torch.stack(
        [p.grad.float().norm() for p in model.parameters() if p.grad is not None])))
    opt.update()
    return sum(losses) / 2, norm, {k: v.detach().cpu().clone()
                                   for k, v in model.state_dict().items()}


def p20_compare(torch, what, got, ref, start) -> str:
    """Phase 6's tolerances for one distributed step against its reference:
    loss and grad_norm within 2e-2, and the update (after - before) of the
    whole model at cosine above 0.99 (AdamW's first step is about LR *
    sign(g): an element whose gradient is within rounding of zero can step
    the other way, so elements are counted, not bounded); the BatchNorm
    statistics within 2e-2 of the largest. Fatal on a miss."""
    (gl, gn, gp), (rl, rn, rp) = got, ref
    num = den_a = den_b = 0.0
    same = total = 0
    stat_err = 0.0
    for k, r in rp.items():
        if not r.is_floating_point():  # num_batches_tracked: no JAX counterpart
            continue
        g, r = gp[k].float(), r.float()
        if k.endswith(("running_mean", "running_var")):
            stat_err = max(stat_err, float((g - r).abs().max() / r.abs().max()))
            continue
        a, b = (g - start[k].float()).flatten(), (r - start[k].float()).flatten()
        num += float(a @ b)
        den_a += float(a @ a)
        den_b += float(b @ b)
        same += int((g == r).sum())
        total += r.numel()
    cos = num / max((den_a * den_b) ** 0.5, 1e-30)
    worst = max(float((gp[k].float() - r.float()).abs().max()) for k, r in rp.items()
                if r.is_floating_point() and not k.endswith(("running_mean", "running_var")))
    line = (f"{what}: loss {gl:.6f} / {rl:.6f}, grad_norm {gn:.5f} / {rn:.5f}, update cosine "
            f"{cos:.6f}, {same / total:.4%} of the weights the same bits (largest difference "
            f"{worst:.3e})"
            + (f", statistics {stat_err:.3e} of the largest apart" if stat_err else ""))
    log(line)
    if not (abs(gl - rl) <= 2e-2 * abs(rl) and abs(gn - rn) <= 2e-2 * abs(rn) and cos > 0.99
            and stat_err <= 2e-2):
        raise AssertionError(f"phase 20: {line}")
    return line


def p20_grad_compare(got, ref) -> None:
    """(d)'s gradients before the update: the whole within P20_TP_GRAD_TOL
    and every tensor within P20_TP_TENSOR_TOL of its norm (bf16 rounding,
    and the attack's sign steps on pixels whose gradient is near zero). A
    split block whose backward lost its all-reduce gives the tensors
    upstream of it their gradient through half the MLP only. Fatal on a
    miss."""
    assert got.keys() == ref.keys(), sorted(set(got) ^ set(ref))
    num = den = 0.0
    rel = {}
    for k, r in ref.items():
        d = float((got[k] - r).norm())
        num, den = num + d * d, den + float(r.norm()) ** 2
        rel[k] = d / max(float(r.norm()), 1e-30)
    whole = (num / den) ** 0.5
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    log(f"phase 20 (d) tp = 2 gradient before the update against the one-rank plain step's: "
        f"{whole:.3e} of its norm apart, the farthest tensors "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst)
        + f" (median {sorted(rel.values())[len(rel) // 2]:.3e}, {len(rel)} tensors)")
    if not (whole <= P20_TP_GRAD_TOL and worst[0][1] <= P20_TP_TENSOR_TOL):
        raise AssertionError("phase 20 (d): the TP gradient disagrees")


def phase20_worker(spec_path: str, out_path: str) -> int:
    """One of phase 20's two ranks on the one card (gloo over CUDA tensors):
    (b) the data = 2 steps of ConvNeXt-T-CvSt, ViT-S-CvSt and resnet50, (c)
    the fsdp = 2 step and its checkpoint, (d) the model = 2 logits and step
    (use_pallas=0), (e) cli.eval --multihost 1 on the eval set the parent
    wrote. Writes <out_path>.<rank>."""
    import torch
    import torch.distributed as dist

    from revisiting_at_tpu_torch.ckpt.checkpoint import save_entry
    from revisiting_at_tpu_torch.cli import eval as eval_cli
    from revisiting_at_tpu_torch.config import DistSection
    from revisiting_at_tpu_torch.ops import attention as att
    from revisiting_at_tpu_torch.ops import block_mlp as bm
    from revisiting_at_tpu_torch.parallel.mesh import MeshConfig, init_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bm._lib()  # the libraries phase 2 built, loaded
    att._lib()
    info = init_distributed(DistSection(), "cuda", backend="gloo", timeout_s=300)
    r = info.rank
    spec = torch.load(spec_path, weights_only=False)
    out, took = {}, {}

    def run(name, arch, mesh, x, y, use_pallas=True, prepare=None, grads=False):
        state, step = p20_step(torch, arch, spec["init"][arch], use_pallas=use_pallas, mesh=mesh)
        if prepare is not None:
            prepare(state)
        zero_launches()
        t0 = time.time()
        metrics = step(state, x.cuda(), y.cuda())
        torch.cuda.synchronize()
        took[name] = time.time() - t0
        par = state.parallel
        res = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
               "launches": launch_counts(), "seconds": took[name],
               "sharded": (len(par.fsdp_dims), len(par.tp_dims))}
        sd = par.full_state_dict()  # collective: every rank
        full_grads = {n: par.full(n, t.grad).float().cpu() for n, t in par.named_master()
                      if t.grad is not None} if grads else None  # collective too
        if r == 0:
            res["state"] = {k: v.detach().cpu() for k, v in sd.items()}
            res["grads"] = full_grads
        out[name] = res
        return state

    # (b) data = 2, each rank its half of the batch
    mesh = make_mesh(MeshConfig())
    for arch, n in P20_BATCH.items():
        x, y = spec["data"][arch]
        run(f"ddp {arch}", arch, mesh, x[r * n:(r + 1) * n], y[r * n:(r + 1) * n])
    mesh.release()
    # (c) fsdp = 2: gloo must take CUDA tensors in FSDP's collectives
    try:
        t = torch.arange(4.0, device="cuda")
        part = torch.empty(2, device="cuda")
        dist.reduce_scatter_tensor(part, t)
        out["fsdp_collectives"] = "ok"
    except (RuntimeError, ValueError) as e:  # the backend's answer, reported by the parent
        out["fsdp_collectives"] = f"{type(e).__name__}: {e}"
    if out["fsdp_collectives"] == "ok":
        mesh = make_mesh(MeshConfig(fsdp=2))
        n = P20_BATCH["convnext_tiny"]
        x, y = spec["data"]["convnext_tiny"]
        state = run("fsdp convnext_tiny", "convnext_tiny", mesh, x[r * n:(r + 1) * n],
                    y[r * n:(r + 1) * n])
        save_entry(Path(spec["fsdp_run"]) / "ckpt", 0, state)
        mesh.release()
    # (d) model = 2, the plain path, the whole batch on each rank
    mesh = make_mesh(MeshConfig(model=2))
    x, y = spec["data"]["tp"]

    def logits(state):
        state.model.eval()
        with torch.no_grad():
            out["tp logits"] = state.model(x.cuda()).float().cpu()
        state.model.train()

    run("tp convnext_tiny", "convnext_tiny", mesh, x, y, use_pallas=False, prepare=logits,
        grads=True)
    mesh.release()
    # (e) cli.eval --multihost 1: its draws on the parent's eval set
    eval_cli.load_eval_set = lambda args, num_classes: spec["eval_set"]
    zero_launches()
    t0 = time.time()
    out["eval"] = eval_cli.main(spec["eval_argv"])["Linf"]
    took["eval"] = time.time() - t0
    out["eval_launches"] = launch_counts()
    out["took"] = took
    torch.save(out, f"{out_path}.{r}")
    dist.destroy_process_group()
    return 0


def dist_phase(torch, np, repo, init, vit_init, seed, label) -> None:
    """Phase 20: the distributed paths on the card. (a) in this process,
    under a one-rank NCCL process group; (b)-(e) in two ranks on the one
    card over gloo (phase20_worker), each part against its one-process
    reference here."""
    import torch.distributed as dist

    from revisiting_at_tpu_torch.cli import eval as eval_cli
    from revisiting_at_tpu_torch.cli import train as train_cli
    from revisiting_at_tpu_torch.config import Config
    from revisiting_at_tpu_torch.evals import SHORT_ATTACKS, AutoAttack, AutoAttackConfig
    from revisiting_at_tpu_torch.models import get_model
    from revisiting_at_tpu_torch.parallel.launch import free_port, run_ranks
    from revisiting_at_tpu_torch.parallel.mesh import make_mesh
    from revisiting_at_tpu_torch.parallel.zero import ParallelModel
    from revisiting_at_tpu_torch.train import input_grad_view

    took = {}
    folder = repo / "build" / "phase20"
    folder.mkdir(parents=True, exist_ok=True)
    # (a) world 1 over NCCL: cli.train, then phase 6's step on a ParallelModel
    t0 = time.time()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        zero_launches()
        trainer = train_cli.main([
            "--model.arch", "convnext_tiny", "--model.not_original", "1",
            "--model.add_normalization", "0", "--model.model_ema", "1", "--adv.attack", "apgd",
            "--adv.n_iter", "2", "--data.dataset", "synthetic", "--training.batch_size",
            str(TRAIN_BATCH), "--training.epochs", "1", "--training.use_pallas", "1",
            "--validation.batch_size", "16", "--validation.max_batches", "2",
            "--logging.folder", str(folder / "a"), "--device", "cuda",
            "--synthetic_batches", "4"])
        require_launches("cli.train under a one-rank NCCL group (phase 20 (a))", TAIL_KERNELS)
        records = [json.loads(line)
                   for line in (trainer.logger.dir / "log").read_text().splitlines()]
        epoch = [rec for rec in records if "train_loss" in rec]
        if not (epoch and np.isfinite(epoch[0]["train_loss"]) and records[0]["devices"] == 1
                and trainer.mesh.size == 1 and dist.get_backend() == "nccl"):
            raise AssertionError(f"phase 20 (a) cli.train: bad records {records[:2]}")
        del trainer
        ones = torch.ones(4, device="cuda")
        dist.all_reduce(ones)  # NCCL runs on the card
        rng = np.random.RandomState(seed)
        xb = torch.from_numpy(rng.uniform(0, 1, (TRAIN_BATCH, 224, 224, 3)).astype(np.float32))
        xb, yb = xb.cuda(), torch.from_numpy(rng.randint(0, 1000, TRAIN_BATCH)).cuda()
        steps = {name: build_train_step(torch, init, use_pallas=name != "plain", device="cuda",
                                        seed=seed)
                 for name in ("world-1 kernels", "kernels", "plain")}
        world1 = steps["world-1 kernels"][0]
        world1.parallel = ParallelModel(world1.model, make_mesh())
        got = {name: steps[name][1](steps[name][0], xb, yb) for name in ("world-1 kernels",
                                                                         "kernels")}
        same = all(torch.equal(p, q) for p, q in zip(world1.model.parameters(),
                                                    steps["kernels"][0].model.parameters()))
        ga, gb = (got[k] for k in ("world-1 kernels", "kernels"))
        rel = abs(float(ga["grad_norm"]) - float(gb["grad_norm"])) / float(gb["grad_norm"])
        log(f"phase 20 (a) start-up and NCCL smoke test (a one-rank mesh runs no sync): phase "
            f"6's step through ParallelModel against the non-distributed step: parameters "
            f"{'bit for bit' if same else 'DIFFER'}, loss "
            f"{float(ga['loss']):.6f} / {float(gb['loss']):.6f}, grad_norm {float(ga['grad_norm']):.6f}"
            f" / {float(gb['grad_norm']):.6f} ({rel:.2e} apart: the sum of squares taken per "
            f"tensor and summed, against torch's norm of norms)")
        if not (same and torch.equal(ga["loss"], gb["loss"]) and rel <= 1e-5):
            raise AssertionError("phase 20 (a): the one-rank distributed step differs")
        zero_launches()
        step_ms, _ = steps_in_turns(
            torch, steps, dict.fromkeys(steps, (xb, yb)),
            ("world-1 kernels", "plain", "kernels", "kernels", "plain", "world-1 kernels"),
            warm=2, require={"world-1 kernels": ("phase 20 (a)'s step", TAIL_KERNELS)})
        for name, v in step_ms.items():
            log(f"phase 20 (a) train step convnext_tiny+ConvStem bf16 B={TRAIN_BATCH} under the "
                f"one-rank NCCL group ({name}): {sum(v) / len(v):.2f} ms/step (runs of 5: "
                f"{', '.join('%.2f' % t for t in v)}) {label}")
        del steps, world1, xb, yb
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    took["a"] = time.time() - t0

    # the inputs of (b)-(e): weights from the seed, batches, the eval set
    t0 = time.time()
    rng = np.random.RandomState(seed + 20)
    torch.manual_seed(seed + 20)
    r50, _ = get_model("resnet50", dtype=torch.float32)
    inits = {"convnext_tiny": init, "vit_s": vit_init, "resnet50": r50.state_dict()}
    data = {arch: (torch.from_numpy(rng.uniform(0, 1, (2 * n, 224, 224, 3)).astype(np.float32)),
                   torch.from_numpy(rng.randint(0, 1000, 2 * n)))
            for arch, n in P20_BATCH.items()}
    data["tp"] = (torch.from_numpy(rng.uniform(0, 1, (P20_TP_BATCH, 224, 224, 3))
                                   .astype(np.float32)),
                  torch.from_numpy(rng.randint(0, 1000, P20_TP_BATCH)))
    eval_run = folder / "eval_run"
    eval_run.mkdir(exist_ok=True)
    cfg = Config()
    cfg.model.arch, cfg.model.not_original, cfg.model.add_normalization = "convnext_tiny", 1, 0
    cfg.dump_params_json(eval_run / "params.json")
    fsdp_run = folder / "fsdp_run"
    fsdp_run.mkdir(exist_ok=True)
    cfg.dump_params_json(fsdp_run / "params.json")
    torch.save(init, eval_run / "weights.pt")
    m, _ = get_model("convnext_tiny", not_original=True, dtype=torch.bfloat16, use_pallas=True)
    m.load_state_dict(init)
    view = input_grad_view(m.cuda().eval().requires_grad_(False))
    ex = rng.uniform(0, 1, (P20_EVAL_N, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        ey = view(torch.from_numpy(ex).cuda()).argmax(-1).cpu().numpy()
    eps = 0.25 / 255.0  # points must survive APGD-CE for APGD-T to run
    eval_argv = ["--run_dir", str(eval_run), "--torch_ckpt", str(eval_run / "weights.pt"),
                 "--use_pallas", "1", "--synthetic", "--n_ex", str(P20_EVAL_N), "--batch_size",
                 "8", "--n_iter", "3", "--eps", str(eps), "--device", "cuda", "--multihost",
                 "1"]
    spec = {"init": inits, "data": data, "fsdp_run": str(fsdp_run), "eval_argv": eval_argv,
            "eval_set": (ex, ey)}
    spec_path, out_path = folder / "spec.pt", folder / "out.pt"
    torch.save(spec, spec_path)
    took["inputs"] = time.time() - t0

    # (b)-(e): two ranks on the one card
    t0 = time.time()
    outs = run_ranks([sys.executable, str(repo / "chip_smoke.py"), "--phase20-worker",
                      str(spec_path), str(out_path)], 2, 600, cwd=str(repo),
                     local_ranks=[0, 0])
    took["ranks"] = time.time() - t0
    res = [torch.load(f"{out_path}.{r}", weights_only=False) for r in range(2)]
    for r, (o, text) in enumerate(zip(res, outs)):
        log(f"phase 20 rank {r}: parts {', '.join(f'{k} {v:.1f} s' for k, v in o['took'].items())}"
            f"; its last lines: {' | '.join(text.strip().splitlines()[-2:])[-300:]}")
    t0 = time.time()
    for name, kernels in (("ddp convnext_tiny", TAIL_KERNELS), ("ddp vit_s",
                                                                 TAIL_KERNELS + ATT_KERNELS),
                          ("fsdp convnext_tiny", TAIL_KERNELS)):
        if name not in res[0]:
            continue
        for r in range(2):
            lc = res[r][name]["launches"]
            log(f"phase 20 {name} rank {r}: launches {lc}")
            missing = [k for k in kernels if lc[k] <= 0]
            if missing:
                raise AssertionError(f"phase 20 {name} rank {r}: {missing} not launched")
    for arch in P20_BATCH:
        ref = p20_reference(torch, arch, inits[arch], data[arch][0].cuda(), data[arch][1].cuda())
        for name in (f"ddp {arch}", f"fsdp {arch}"):
            if name in res[0]:
                g = res[0][name]
                if g["loss"] != res[1][name]["loss"]:
                    raise AssertionError(f"phase 20 {name}: the ranks' losses differ")
                p20_compare(torch, f"phase 20 {'(c)' if name[0] == 'f' else '(b)'} {name} "
                            f"(world 2, gloo, one card; sharded leaves {g['sharded']}) against "
                            f"one process", (g["loss"], g["grad_norm"], g["state"]), ref,
                            inits[arch])
        torch.cuda.empty_cache()
    fsdp_state = res[0].get("fsdp convnext_tiny")
    if fsdp_state is None:
        log(f"phase 20 (c) FSDP at world 2 over gloo on CUDA tensors: {res[0]['fsdp_collectives']}")
        log("phase 20 (c): world-2 FSDP is checked by the CPU tests alone "
            "(tests/test_torch_port_dist.py::test_fsdp_step_matches_jax_shard_map)")
    else:
        ddp = res[0]["ddp convnext_tiny"]
        p20_compare(torch, "phase 20 (c) fsdp = 2 against the data = 2 step",
                    (fsdp_state["loss"], fsdp_state["grad_norm"], fsdp_state["state"]),
                    (ddp["loss"], ddp["grad_norm"], ddp["state"]), init)
        r_eval = eval_cli.main(["--run_dir", str(fsdp_run), "--use_pallas", "1", "--synthetic",
                                "--n_ex", "8", "--batch_size", "8", "--n_iter", "2",
                                "--device", "cuda"])
        log(f"phase 20 (c) single-process cli.eval on the FSDP run's checkpoint (strict load): "
            f"{r_eval['Linf']['robust']:.4f} robust over {r_eval['Linf']['n']}")
    # (d) TP logits and step against the one-rank plain step
    tp = res[0]["tp convnext_tiny"]
    state, step = p20_step(torch, "convnext_tiny", init, use_pallas=False)
    xt, yt = data["tp"]
    state.model.eval()
    with torch.no_grad():
        ref_logits = state.model(xt.cuda()).float().cpu()
    state.model.train()
    err = float((res[0]["tp logits"] - ref_logits).abs().max() / ref_logits.abs().max())
    agree = float((res[0]["tp logits"].argmax(-1) == ref_logits.argmax(-1)).float().mean())
    log(f"phase 20 (d) tp = 2 logits (bf16, use_pallas=0) against one rank: {err:.3e} of the "
        f"largest apart (tolerance 2e-2: the two halves of each block MLP are rounded to bf16 "
        f"before their sum), argmax agreement {agree:.3f}")
    if not (err <= 2e-2 and res[1]["tp logits"].equal(res[0]["tp logits"])):
        raise AssertionError("phase 20 (d): the TP logits disagree")
    m1 = step(state, xt.cuda(), yt.cuda())
    p20_compare(torch, f"phase 20 (d) tp = 2 step (sharded leaves {tp['sharded']}) against the "
                f"one-rank plain step", (tp["loss"], tp["grad_norm"], tp["state"]),
                (float(m1["loss"]), float(m1["grad_norm"]),
                 {k: v.detach().cpu() for k, v in state.model.state_dict().items()}),
                init)
    ref_grads = {n: p.grad.float().cpu() for n, p in state.model.named_parameters()
                 if p.grad is not None}
    p20_grad_compare(tp["grads"], ref_grads)
    del state, step
    torch.cuda.empty_cache()
    # (e) both ranks' global accuracy = the single-process runs on the shards
    e0, e1 = res[0]["eval"], res[1]["eval"]
    points = []
    for r in range(2):
        aa = AutoAttack(view, AutoAttackConfig(norm="Linf", eps=eps, attacks_to_run=SHORT_ATTACKS,
                                               n_iter=3, batch_size=8, verbose=False),
                        device="cuda")
        points.append(aa.run_standard_evaluation(ex[r::2], ey[r::2])[1])
    single = float(np.concatenate(points).mean())
    log(f"phase 20 (e) cli.eval --multihost 1, two ranks: global robust accuracy {e0['robust']}"
        f" / {e1['robust']} over {e0['n']} points; single-process runs on the two round-robin "
        f"shards: {single} (per point: rank 0 {e0['points'] == points[0].tolist()}, rank 1 "
        f"{e1['points'] == points[1].tolist()})")
    for r in range(2):
        lc = res[r]["eval_launches"]
        if lc["block_mlp_fwd"] <= 0 or lc["block_mlp_bwd_input"] <= 0:
            raise AssertionError(f"phase 20 (e) rank {r}: the tail kernels did not launch {lc}")
    if not (e0["robust"] == e1["robust"] == single and e0["n"] == e1["n"] == P20_EVAL_N
            and e0["points"] == points[0].tolist() and e1["points"] == points[1].tolist()):
        raise AssertionError("phase 20 (e): multi-host eval disagrees with the shards' runs")
    took["checks"] = time.time() - t0
    left = descendants()
    if left:
        raise AssertionError(f"phase 20: processes still running: {left}")
    log(f"phase 20: {sum(took.values()):.1f} s; "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in took.items()) + f" {label}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (build and check the kernels)")
    ap.add_argument("--phase20-worker", nargs=2, metavar=("SPEC", "OUT"),
                    help=argparse.SUPPRESS)  # one of phase 20's ranks, started by phase 20
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    # ---------------------------------------------------------------- 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no GPU, no result",
              file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    if args.phase20_worker:
        return phase20_worker(*args.phase20_worker)
    from revisiting_at_tpu_torch.ops import attention as att
    from revisiting_at_tpu_torch.ops import block_mlp as bm
    from revisiting_at_tpu_torch.ops import cuda_build
    from revisiting_at_tpu_torch.ops import dwconv as dw

    # plain versions compare in true f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    label = f"[{card}]"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---------------------------------------------------------------- 2
    t0 = time.time()
    libs = cuda_build.build()
    bm._lib()
    att._lib()
    dw._lib()
    log(f"build: {time.time() - t0:.1f} s ({', '.join(p.name for p in libs.values())})")
    for path in libs.values():
        function = "?"  # the mangled name, as ptxas reports it before its spill line
        for line in Path(f"{path}.ptxas.txt").read_text().splitlines():
            if "Function properties for " in line:
                function = line.split("Function properties for ", 1)[1].strip()
            elif "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
                log(f"ptxas {path.name} {function}: {line.strip()}")

    # ---------------------------------------------------------------- 3
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    err = {k: 0.0 for k in bm.LAUNCHES}  # block tail, keyed as bm.LAUNCHES
    # the stage shapes at batch 32, as phases 4 and 5 give them to the kernels
    cases = [(rows * 32, C, torch.bfloat16, 0) for rows, C in STAGES]
    cases += [(49 * 3, 768, torch.bfloat16, 0),   # ragged: 147 rows, 2 tiles and 19 rows
              (784 * 2, 192, torch.float32, 0),   # f32 I/O
              (196 * 4, 384, torch.bfloat16, 196)]  # per-sample keep
    # stage 3 (C = 768, clusters of two blocks) at the training batch, ragged
    # at 103 rows, f32 I/O, a per-sample keep (49 rows per keep)
    cases += [(49 * TRAIN_BATCH, 768, torch.bfloat16, 0), (49 * 2 + 5, 768, torch.bfloat16, 0),
              (49 * 4, 768, torch.float32, 0), (49 * 5, 768, torch.bfloat16, 49)]
    # the other widths built for ConvNeXt-B/L, at a few ragged tiles each
    cases += [(3136 + 40, 128, torch.bfloat16, 0), (784 + 40, 256, torch.bfloat16, 0),
              (49 * 2 + 5, 1024, torch.bfloat16, 0)]
    # ConvNeXt-B's stage 3 (C = 1024, clusters of four blocks) at APGD-CE's
    # and the training batch, ragged at 147 rows with a per-sample keep, f32
    cases += [(49 * 32, 1024, torch.bfloat16, 0), (49 * TRAIN_BATCH, 1024, torch.bfloat16, 0),
              (49 * 3, 1024, torch.bfloat16, 49), (49 * 4, 1024, torch.float32, 0)]
    # convnext_iso's C = 432 (14x14 tokens) and ConvNeXt-B's stage 2 (C =
    # 512, 196 rows an image), both clusters of two blocks on 512's tiling:
    # batch 32, ragged with a keep, f32
    for C in (ISO_C, 512):
        cases += [(ISO_ROWS * 32, C, torch.bfloat16, 0),
                  (ISO_ROWS * 3, C, torch.bfloat16, ISO_ROWS),
                  (ISO_ROWS * 2 + 5, C, torch.float32, 0)]
    # the micro models' widths: convnext_micro's stages 0-2 at 224 px, batch
    # 32 (3136, 784, 196 rows an image), vit_micro's 32 (197 tokens), ragged
    # and f32 once
    cases += [(3136 * 32, 16, torch.bfloat16, 0), (784 * 32, 32, torch.bfloat16, 0),
              (196 * 32, 64, torch.bfloat16, 0), (197 * 32, 32, torch.bfloat16, 197),
              (3136 + 40, 16, torch.float32, 0), (196 * 2 + 5, 64, torch.bfloat16, 0)]
    # the first launch of each cluster kernel under a watchdog: a block
    # whose peer never arrives, a ring stage whose bytes never land (or a
    # setmaxnreg raise past the pool) waits forever, and the process ends
    # with a message instead. The plan and the clusters the card holds at a
    # time (a wave) are logged.
    for C, rows in ((768, 49), (ISO_C, ISO_ROWS), (512, ISO_ROWS), (1024, 49)):
        for which in bm.TAIL_MODES:
            log(f"plan {which} C={C}: {bm.tail_plan(C, which)}; "
                f"{bm.tail_max_clusters(C, which)} clusters at a time")
        d = tail_inputs(torch, rows * 3, C, torch.bfloat16, gen, rows)
        for which in ("fwd", "bwd_input"):
            first_launch(torch, f"{which} C={C} (cluster of {bm.tail_plan(C, which).cluster})",
                         lambda: run_tail(bm, d, which, kernel=True))
        w2g16 = (d["w2"].bfloat16().float() * d["gamma"]).bfloat16()
        first_launch(torch, f"bwd_full_rows C={C}", lambda: bm.bwd_full_rows_cuda(
            d["s"], d["keep"], d["rows"], d["ln_g"], d["ln_b"], d["w1"].bfloat16(), d["b1"],
            w2g16, d["dy"]))
        del d, w2g16
    for i, (M, C, dtype, keep_rows) in enumerate(cases):
        d = tail_inputs(torch, M, C, dtype, gen, keep_rows)
        for which in ("fwd", "bwd_input"):
            got = run_tail(bm, d, which, kernel=True)
            ref = run_tail(bm, d, which, kernel=False)
            torch.cuda.synchronize()
            what = f"{which} M={M} C={C} {dtype} keep={bool(keep_rows)}"
            err[which] = max(err[which], check(torch, what, got, ref, TOL[which]))
            if (i == 0 or C in BITWISE_WIDTHS) and not torch.equal(
                    got, run_tail(bm, d, which, kernel=True)):
                raise AssertionError(f"{what}: two launches differ")
        if i == 0 or C in BITWISE_WIDTHS:
            log(f"fwd, bwd_input M={M} C={C}: bitwise equal over two launches")
        if (M, C) == (ISO_ROWS * 32, ISO_C):
            planted_fault(f"fwd with the LayerNorm statistics over the padded 512 columns, "
                          f"M={M} C={C}", padded_ln_forward(torch, bm, d, 512),
                          run_tail(bm, d, "fwd", kernel=False), TOL["fwd"])
        if (M, C) in ((49 * 32, 768), (ISO_ROWS * 32, 512), (49 * 32, 1024)):
            # planted fault: one block's partial h left out of the exchange.
            # In a cluster of cl blocks, rank 0 finalises the 32 / cl columns
            # of each 32 of 4C that start at a multiple of 32 (one warpgroup's
            # share); W1 zero in the last rank's part of C (rows 384..767 at
            # 768, 256..511 at 512, 768..1023 at 1024) for those columns is
            # exactly that block's partial missing from their h
            cl = bm.tail_plan(C, "fwd").cluster
            w1_bad = d["w1"].clone()
            w1_bad[C - C // cl:, torch.arange(4 * C, device="cuda") % 32 < 32 // cl] = 0
            bad = bm.fwd_cuda(d["s"], d["r"], d["keep"], d["rows"], d["ln_g"], d["ln_b"],
                              w1_bad.bfloat16(), d["b1"], d["w2"].bfloat16(), d["b2"], d["gamma"])
            torch.cuda.synchronize()
            planted_fault(f"fwd without rank {cl - 1}'s partial h in rank 0's columns, M={M} "
                          f"C={C}", bad, run_tail(bm, d, "fwd", kernel=False), TOL["fwd"])
            del w1_bad, bad
    # the full backward: ConvNeXt-T's stages 0-2 at the training batch, where
    # tail_fusable(C, "full") admits the kernel, then ragged M, f32 I/O, a
    # per-sample keep, and the other widths built (B/L, wide_tail)
    full_cases = [(rows * TRAIN_BATCH, C, torch.bfloat16, 0) for rows, C in STAGES[:3]]
    full_cases += [(3136 * 2 + 40, 96, torch.bfloat16, 0), (196 * 3 + 5, 384, torch.bfloat16, 0),
                   (784 * 2, 192, torch.float32, 0), (196 * 4, 384, torch.bfloat16, 196),
                   (3136 + 40, 128, torch.bfloat16, 0), (784 + 40, 256, torch.bfloat16, 0),
                   (49 * 2 + 5, 768, torch.bfloat16, 0), (49 * 2 + 5, 1024, torch.bfloat16, 0)]
    # C = 768 and 1024 (wide_tail's row pass, clusters of two and four
    # blocks) at the training batch, and ragged (147 rows) with a keep; 1024
    # also in f32
    full_cases += [(49 * TRAIN_BATCH, 768, torch.bfloat16, 0), (49 * 3, 768, torch.bfloat16, 49),
                   (49 * TRAIN_BATCH, 1024, torch.bfloat16, 0),
                   (49 * 3, 1024, torch.bfloat16, 49), (49 * 4, 1024, torch.float32, 0)]
    # convnext_iso's C = 432 and ConvNeXt-B's stage 2 (C = 512) at the
    # training batch (full mode admits C <= 512), and ragged with a keep
    for C in (ISO_C, 512):
        full_cases += [(ISO_ROWS * TRAIN_BATCH, C, torch.bfloat16, 0),
                       (ISO_ROWS * 3, C, torch.bfloat16, ISO_ROWS)]
    # ViT-S's tokens, ragged (591 rows: no whole 64-row tile at the end) with a keep
    full_cases += [(197 * 3, 384, torch.bfloat16, 197)]
    # the micro models' widths at the training batch (convnext_micro's stages
    # 0-2, vit_micro's 32), ragged with a keep, f32
    full_cases += [(3136 * TRAIN_BATCH, 16, torch.bfloat16, 0),
                   (784 * TRAIN_BATCH, 32, torch.bfloat16, 0),
                   (196 * TRAIN_BATCH, 64, torch.bfloat16, 0),
                   (197 * 3, 32, torch.bfloat16, 197), (3136 + 40, 16, torch.float32, 0)]
    for i, (M, C, dtype, keep_rows) in enumerate(full_cases):
        d = tail_inputs(torch, M, C, dtype, gen, keep_rows)
        got = run_full(bm, d, kernel=True)
        ref = run_full(bm, d, kernel=False)
        torch.cuda.synchronize()
        what = f"M={M} C={C} {dtype} keep={bool(keep_rows)}"
        for name, g, r in zip(FULL_COTANGENTS, got, ref):
            e = check(torch, f"bwd_full {name:6s} {what}", g, r, TOL[name])
            err[FULL_ERR_KEY[name]] = max(err[FULL_ERR_KEY[name]], e)
        if i < 3 or C in (432, 512, 768, 1024) or (keep_rows and M % 64):
            # the stage shapes at the training batch, the cluster widths and a
            # ragged M with a keep: the row pass's ds is the input
            # backward's, bit for bit
            if not torch.equal(got[0], run_tail(bm, d, "bwd_input", kernel=True)):
                raise AssertionError(f"bwd_full {what}: the row pass's ds differs from the "
                                     "input backward's")
            log(f"bwd_full {what}: the row pass's ds equals the input backward's, bit for bit")
        if C in BITWISE_WIDTHS and not keep_rows:
            again = run_full(bm, d, kernel=True)
            if not all(torch.equal(g, h) for g, h in zip(got, again)):
                raise AssertionError(f"bwd_full {what}: two launches differ")
            log(f"bwd_full {what}: all nine cotangents bitwise equal over two launches")
            del again
        if i == 0:  # stage 0 at the training batch
            # every cotangent is the same bits from run to run
            again = run_full(bm, d, kernel=True)
            for name, g, h in zip(FULL_COTANGENTS, got, again):
                if not torch.equal(g, h):
                    raise AssertionError(f"bwd_full {name} {what}: two launches differ")
            log(f"bwd_full {what}: all nine cotangents bitwise equal over two launches")
            del again
            # planted faults the tolerances must catch: the weight pass with
            # one slice of M left out, the column reduction with one group
            w2g16 = (d["w2"].bfloat16().float() * d["gamma"]).bfloat16()
            _, u16, _, _, dh16, db1_p, _, _ = bm.bwd_full_rows_cuda(
                d["s"], None, M, d["ln_g"], d["ln_b"], d["w1"].bfloat16(), d["b1"], w2g16,
                d["dy"])
            part = bm.wgrad_partials_cuda(u16, dh16)
            n_split = part.shape[0]
            dw1_bad = bm.reduce_cuda(part[1:].reshape(n_split - 1, -1)).view(part.shape[1:])
            j = FULL_COTANGENTS.index
            planted_fault(f"dw1 without 1 of {n_split} slices of M, {what}", dw1_bad,
                          ref[j("dw1")], TOL["dw1"])
            planted_fault(f"db1 without 1 of {db1_p.shape[0]} row groups, {what}",
                          bm.reduce_cuda(db1_p[1:]), ref[j("db1")], TOL["db1"])
            del u16, dh16, db1_p, part, dw1_bad
        del d, got, ref
    err["wgrad"] = max(err["wgrad"], check_wgrad(torch, bm, gen))
    # the reduction alone, on partials of the row pass's shape at stage 0,
    # then at REDUCE_ROWS x REDUCE_COLS
    m0 = STAGES[0][0] * TRAIN_BATCH
    err["reduce"] = max(err["reduce"], check_reduce(torch, bm, gen, [(m0 // 64, 384)] + [
        (R, N) for R in REDUCE_ROWS for N in REDUCE_COLS if R * N <= REDUCE_MAX_ELEMS]))
    att_err = check_attention(torch, att, gen)
    dw_err = check_dwconv(torch, dw, gen)
    if args.kernels_only:
        return 0

    # ---------------------------------------------------------------- 4
    from revisiting_at_tpu_torch.attacks import apgd_attack
    from revisiting_at_tpu_torch.ckpt.convert import load_torch_checkpoint, save_torch_checkpoint
    from revisiting_at_tpu_torch.cli import eval as eval_cli
    from revisiting_at_tpu_torch.cli import train as train_cli
    from revisiting_at_tpu_torch.config import Config
    from revisiting_at_tpu_torch.evals import AutoAttack, AutoAttackConfig
    from revisiting_at_tpu_torch.models import get_model
    from revisiting_at_tpu_torch.models.convnext import plain_tail
    from revisiting_at_tpu_torch.train.train_step import input_grad_view

    run_dir = repo / "build" / "smoke_run"
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg = Config()
    cfg.model.arch, cfg.model.not_original, cfg.model.add_normalization = "convnext_tiny", 1, 0
    cfg.dump_params_json(run_dir / "params.json")
    torch.manual_seed(args.seed)
    model, _ = get_model("convnext_tiny", not_original=True, dtype=torch.float32)
    with torch.no_grad():  # LayerScale from U(0.1, 1): the 1e-6 init would hide the tails
        for blk in (b for st in model.stages for b in st.blocks):
            blk.gamma.uniform_(0.1, 1.0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: convnext_tiny + ConvStem, {n_params / 1e6:.2f} M params, seed {args.seed}")
    if not 28.0e6 < n_params < 29.5e6:
        raise AssertionError(f"unexpected parameter count {n_params}")
    save_torch_checkpoint(model, run_dir / "weights.pt")
    del model

    zero_launches()
    t0 = time.time()
    res = eval_cli.main(["--run_dir", str(run_dir), "--torch_ckpt", str(run_dir / "weights.pt"),
                         "--use_pallas", "1", "--synthetic", "--l_norms", "Linf", "--n_ex",
                         "32", "--batch_size", "32", "--n_iter", "10", "--device", "cuda"])
    log(f"cli.eval: {res} in {time.time() - t0:.1f} s")
    if not 0.0 <= res["Linf"]["robust"] <= 1.0 or res["Linf"]["n"] != 32:
        raise AssertionError(f"bad eval result {res}")

    # ---------------------------------------------------------------- 5
    def load_model(use_pallas):
        m, _ = get_model("convnext_tiny", not_original=True, dtype=torch.bfloat16,
                         use_pallas=use_pallas)
        load_torch_checkpoint(run_dir / "weights.pt", m)
        return input_grad_view(m.cuda().eval().requires_grad_(False))

    fused = load_model(True)
    x = np.random.RandomState(args.seed).uniform(0, 1, (32, 224, 224, 3)).astype(np.float32)
    xt = torch.from_numpy(x).cuda()
    with torch.no_grad():
        y = fused(xt).argmax(-1).cpu().numpy()
    # A random-weight model is broken by APGD-CE alone at 4/255, which would
    # leave APGD-T no work: attack at 0.25/255 so that points survive to it.
    eps = 0.25 / 255.0
    aa_cfg = AutoAttackConfig(norm="Linf", eps=eps, attacks_to_run=("apgd-ce", "apgd-t"),
                              n_iter=10, batch_size=32, seed=args.seed)
    aa_log = Recorder()
    aa = AutoAttack(fused, aa_cfg, logger=aa_log, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    x_adv, robust = aa.run_standard_evaluation(x, y)  # asserts the eps ball itself
    torch.cuda.synchronize()
    aa_s = time.time() - t0
    log(f"autoattack short (eps 0.25/255): robust acc {robust.mean():.4f} on 32 pts labelled "
        f"by the model (clean 1.0), {aa_s:.2f} s")
    require_launches("the eval path (phases 4-5)", ("block_mlp_fwd", "block_mlp_bwd_input"))
    for attack in ("APGD-CE", "APGD-T"):
        if not any(f"after {attack}:" in m for m in aa_log.lines):
            raise AssertionError(f"{attack} did not run: no point was left for it")
    if x_adv.shape != x.shape or not np.isfinite(x_adv).all():
        raise AssertionError("x_adv has the wrong shape or non-finite values")
    if np.abs(x_adv - x).max() > eps * 1.001 + 1e-6 or x_adv.min() < 0 or x_adv.max() > 1:
        raise AssertionError("x_adv leaves the eps ball or the box")

    # logits against the plain version on the CPU (same bf16 model, same cast points)
    cpu_model, _ = get_model("convnext_tiny", not_original=True, dtype=torch.bfloat16,
                             use_pallas=True)
    load_torch_checkpoint(run_dir / "weights.pt", cpu_model)
    cpu_model.eval()
    with torch.no_grad():
        ref = cpu_model(xt[:2].cpu())
        got = fused(xt[:2]).cpu()
    e = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    log(f"logits vs CPU plain version (2 images): max_abs_err {e:.3e}, max|ref| {scale:.3e}, "
        f"argmax equal {bool((got.argmax(-1) == ref.argmax(-1)).all())}")
    if not (torch.isfinite(got).all() and e <= 5e-2 * scale):
        raise AssertionError("end-to-end logits disagree with the CPU plain version")
    del cpu_model

    # ---------------------------------------------------------------- 6
    init = torch.load(run_dir / "weights.pt", weights_only=True)
    steps = {name: build_train_step(torch, init, use_pallas=name == "kernel", device="cuda",
                                    seed=args.seed) for name in ("kernel", "plain")}
    rng = np.random.RandomState(args.seed)
    xb = torch.from_numpy(rng.uniform(0, 1, (TRAIN_BATCH, 224, 224, 3)).astype(np.float32))
    yb = torch.from_numpy(rng.randint(0, 1000, TRAIN_BATCH))
    xb, yb = xb.cuda(), yb.cuda()
    probe = steps["kernel"][0].model.stages[0].blocks[0].mlp.fc1.weight
    before = probe.detach().clone()
    zero_launches()
    step_ms, losses = steps_in_turns(torch, steps, dict.fromkeys(steps, (xb, yb)),
                                     ("kernel", "plain", "plain", "kernel"), warm=2)
    step_launches = require_launches("the training step (phase 6)", TAIL_KERNELS)
    for name, ls in losses.items():
        if not all(np.isfinite(ls)):
            raise AssertionError(f"{name}-tail step: non-finite loss {ls}")
    if torch.equal(before, probe.detach()):
        raise AssertionError("the training step did not change the weights")
    kernel_model = steps["kernel"][0].model
    for si in range(3):  # the stages whose tails run the full-backward kernels
        for name, p in kernel_model.stages[si].named_parameters():
            if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.abs().max() > 0:
                raise AssertionError(f"stage {si} {name}: no finite non-zero gradient")
    for name, v in step_ms.items():
        ms = sum(v) / len(v)
        log(f"train step convnext_tiny+ConvStem bf16 B={TRAIN_BATCH} 224px 2-step APGD "
            f"({name} tail): {ms:.2f} ms/step, {2000.0 / ms:.3f} attack-steps/s "
            f"(runs of 5: {', '.join('%.2f' % t for t in v)}) {label}")
    log(f"train step losses: kernel {losses['kernel'][:3]}..., plain {losses['plain'][:3]}...")
    for name in ("kernel", "plain"):
        profile_breakdown(torch, f"train step B={TRAIN_BATCH} ({name} tail), per step",
                          lambda: steps[name][1](steps[name][0], xb, yb), 3, label)
    del steps, kernel_model, probe, before, xb, yb
    torch.cuda.empty_cache()
    check_step_against_cpu(torch, np, init, args.seed)

    # ---------------------------------------------------------------- 7
    zero_launches()
    t0 = time.time()
    trainer = train_cli.main([
        "--model.arch", "convnext_tiny", "--model.not_original", "1",
        "--model.add_normalization", "0", "--model.model_ema", "1", "--adv.attack", "apgd",
        "--adv.n_iter", "2", "--data.dataset", "synthetic", "--training.batch_size", "16",
        "--training.epochs", "1", "--training.use_pallas", "1", "--validation.batch_size", "16",
        "--validation.max_batches", "2", "--logging.folder", str(repo / "build" / "smoke_train"),
        "--logging.log_every_steps", "2", "--device", "cuda", "--synthetic_batches", "4"])
    run = trainer.logger.dir
    records = [json.loads(line) for line in (run / "log").read_text().splitlines()]
    epoch = [r for r in records if "train_loss" in r]
    if not (epoch and np.isfinite(epoch[0]["train_loss"])
            and records[-1].get("event") == "final_val"):
        raise AssertionError(f"cli.train: bad records {records}")
    del trainer
    torch.cuda.empty_cache()
    res = eval_cli.main(["--run_dir", str(run), "--torch_ckpt",
                         str(run / "ckpt" / "weights_ema_0.pt"), "--use_pallas", "1",
                         "--synthetic", "--n_ex", "16", "--batch_size", "16", "--n_iter", "5",
                         "--device", "cuda"])
    if not 0.0 <= res["Linf"]["robust"] <= 1.0:
        raise AssertionError(f"cli.eval on the trained run: bad result {res}")
    log(f"cli.train + cli.eval: epoch {epoch[0]}, eval {res}, {time.time() - t0:.1f} s")
    require_launches("the train CLI (phase 7)", TAIL_KERNELS)

    # ---------------------------------------------------------------- 8
    # Each kernel beside its plain version (same cast points, f32 matmuls on
    # bf16-rounded operands), its bound, and the plain model path's own tail
    # (bf16 cuBLAS matmuls, erf GELU); kernel and plain in turns p, k, k, p.
    ms = {k: 0.0 for k in bm.LAUNCHES}
    plain_ms = dict(ms)
    ms["bwd_full"] = 0.0  # the whole full backward, logged only
    library_ms = {k: None for k in bm.LAUNCHES}
    library_ms.update(wgrad=0.0, reduce=0.0)
    bounds = {k: [0.0, 0.0] for k in bm.LAUNCHES}  # summed op and byte times, ms
    bound_ms = dict(ms)
    # the profiler's device time of the forward, input backward and row pass
    row_dev = dict.fromkeys(("fwd", "bwd_input", "bwd_full_rows"), 0.0)

    def add_bound(k, flops, nbytes):
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_HBM * 1e3
        bounds[k][0] += t_ops
        bounds[k][1] += t_bytes
        bound_ms[k] += max(t_ops, t_bytes)
        return max(t_ops, t_bytes)

    for rows, C in STAGES:
        B = 200
        d = tail_inputs(torch, rows * B, C, torch.bfloat16, gen)
        s_in = d["s"].clone().requires_grad_(True)
        r_in = d["r"].clone().requires_grad_(True)
        model_args = (d["ln_g"], d["ln_b"], d["w1"].t(), d["b1"], d["w2"].t(), d["b2"],
                      d["gamma"], torch.bfloat16)
        y_model = plain_tail(s_in, r_in, *model_args)
        model_fn = {
            "fwd": lambda: plain_tail(d["s"], d["r"], *model_args),
            "bwd_input": lambda: torch.autograd.grad(y_model, (s_in, r_in), d["dy"],
                                                     retain_graph=True),
        }
        M = rows * B
        weights = 2 * 4 * C * C * 2 + 7 * C * 4
        for which in ("fwd", "bwd_input"):
            k_fn = lambda: run_tail(bm, d, which, kernel=True)  # noqa: E731
            p_fn = lambda: run_tail(bm, d, which, kernel=False)  # noqa: E731
            p1, k1, k2, p2 = (time_ms(torch, f, 10) for f in (p_fn, k_fn, k_fn, p_fn))
            k, p = (k1 + k2) / 2, (p1 + p2) / 2
            mp = time_ms(torch, model_fn[which], 10)
            dev = device_ms(torch, k_fn, 10)
            row_dev[which] = sum_or_none(row_dev[which], dev)
            ms[which] += k
            plain_ms[which] += p
            flops = (16 if which == "fwd" else 24) * M * C * C
            bnd = add_bound(which, flops, 3 * M * C * 2 + weights)
            log(f"time {which:9s} B={B} M={M:6d} C={C:4d}: kernel {k:.3f} ms "
                f"({flops / k / 1e9:.1f} TFLOP/s; device {ms_or_na(dev)} ms, "
                f"{tail_design(bm, C, which)}), plain {p:.3f} ms, "
                f"model bf16 path {mp:.3f} ms, bound {bnd:.3f} ms {label}")
        del d, s_in, r_in, y_model, model_fn
        torch.cuda.empty_cache()

    # Bounds. The row pass is booked its part of `_bwd_kernel`'s own work: 24 *
    # M * C^2 flops (h, dg, du) against reading s, dy, the weights and the
    # vectors and writing ds. The weight pass and the reduction consume
    # operands that lie in HBM, so each is booked what it must move: the
    # weight pass with its reduction the larger of its 8 * M * C^2 flops per
    # product and its bytes (x16 and y16 read once, the f32 [P, Q] product
    # written once), a reduction its partials read once and its row written
    # once. The whole backward's bound, the work of `_bwd_kernel` (40 * M *
    # C^2 flops against s, dy, the weights, ds and the f32 gradients), is
    # logged beside them; the side buffers and the weight pass's partials
    # (as many [P, Q] as `wgrad_plan` cuts M into) are the two-pass design's
    # own traffic, logged apart. The kernels line's wgrad `ms` is the pass
    # with its reduction, the function torch.matmul computes; the pass alone
    # is its `pass_ms`.
    wg = dict.fromkeys(("pass", "with_reduce", "matmul", "pass_dev", "with_reduce_dev",
                        "matmul_dev", "bound"), 0.0)
    red = {"dev": 0.0, "lib_dev": 0.0}  # the reductions' and torch.sum's device times
    for rows, C in STAGES[:3]:  # the full backward runs in stages 0-2
        M = rows * TRAIN_BATCH
        d = tail_inputs(torch, M, C, torch.bfloat16, gen)
        w2g16 = (d["w2"].bfloat16().float() * d["gamma"]).bfloat16()
        a = (d["s"], None, M, d["ln_g"], d["ln_b"], d["w1"].bfloat16(), d["b1"], w2g16, d["dy"])
        ds, u16, kdy16, g16, dh16, *col_parts = bm.bwd_full_rows_cuda(*a)
        k_rows = time_ms(torch, lambda: bm.bwd_full_rows_cuda(*a), 10)
        dev_rows = device_ms(torch, lambda: bm.bwd_full_rows_cuda(*a), 10)
        row_dev["bwd_full_rows"] = sum_or_none(row_dev["bwd_full_rows"], dev_rows)
        p_rows = time_ms(torch, lambda: bm.bwd_full_rows_plain(*a), 5)
        ms["bwd_full_rows"] += k_rows
        plain_ms["bwd_full_rows"] += p_rows
        whole = {"bwd_full_rows": (24 * M * C * C, 3 * M * C * 2 + 2 * 4 * C * C * 2 + 6 * C * 4),
                 "wgrad": (16 * M * C * C, 0),
                 "reduce": (0, (2 * 4 * C * C + 4 * C + 2 * C) * 4)}
        add_bound("bwd_full_rows", *whole["bwd_full_rows"])
        w_parts = []
        for x16, y16 in ((u16, dh16), (g16, kdy16)):
            part = bm.wgrad_partials_cuda(x16, y16)
            w_parts.append(part.view(part.shape[0], -1))
            (m_pad, P), Q = x16.shape, y16.shape[1]
            k_pass = time_ms(torch, lambda: bm.wgrad_partials_cuda(x16, y16), 10)
            k_both = time_ms(torch, lambda: bm.wgrad_cuda(x16, y16), 10)
            lib = time_ms(torch, lambda: torch.matmul(x16.t(), y16), 10)
            dev_pass = device_ms(torch, lambda: bm.wgrad_partials_cuda(x16, y16), 10)
            dev_both = device_ms(torch, lambda: bm.wgrad_cuda(x16, y16), 10)
            dev_lib = device_ms(torch, lambda: torch.matmul(x16.t(), y16), 10)
            nbytes = (x16.numel() + y16.numel()) * 2 + P * Q * 4
            bnd = add_bound("wgrad", 2 * m_pad * P * Q, nbytes)
            ms["wgrad"] += k_both
            plain_ms["wgrad"] += time_ms(torch, lambda: bm.wgrad_plain(x16, y16), 5)
            library_ms["wgrad"] += lib
            for k, v in zip(wg, (k_pass, k_both, lib, dev_pass, dev_both, dev_lib, bnd)):
                wg[k] = sum_or_none(wg[k], v)
            log(f"time wgrad     B={TRAIN_BATCH} M={M:6d} {P:4d}x{Q:4d}: {part.shape[0]} slices of "
                f"M; pass {k_pass:.4f} ms (device {ms_or_na(dev_pass)}), pass + reduction "
                f"{k_both:.4f} ms (device {ms_or_na(dev_both)}), torch.matmul {lib:.4f} ms "
                f"(device {ms_or_na(dev_lib)}), "
                f"bound {bnd:.4f} ms ({nbytes / 1e6:.1f} MB; {2 * m_pad * P * Q / 1e9:.1f} GFLOP); "
                f"partials {part.numel() * 4 / 1e6:.1f} MB, the design's own traffic {label}")
        for part in col_parts + w_parts:
            # kernel and torch.sum in turns k, l, l, k; then each call's device time
            k1, l1, l2, k2 = (time_ms(torch, f, 10) for f in (
                lambda: bm.reduce_cuda(part), lambda: torch.sum(part, 0),
                lambda: torch.sum(part, 0), lambda: bm.reduce_cuda(part)))
            dev_k = device_ms(torch, lambda: bm.reduce_cuda(part), 20)
            dev_l = device_ms(torch, lambda: torch.sum(part, 0), 20)
            ms["reduce"] += (k1 + k2) / 2
            library_ms["reduce"] += (l1 + l2) / 2
            red["dev"], red["lib_dev"] = sum_or_none(red["dev"], dev_k), sum_or_none(red["lib_dev"],
                                                                                       dev_l)
            plain_ms["reduce"] += time_ms(torch, lambda: bm.reduce_plain(part), 10)
            bnd = add_bound("reduce", 0, part.numel() * 4 + part.shape[1] * 4)
            R, N = part.shape
            log(f"time reduce    B={TRAIN_BATCH} {R}x{N} (plan {bm.reduce_plan(R, N)}): kernel "
                f"{(k1 + k2) / 2:.4f} ms (device {ms_or_na(dev_k)}), torch.sum "
                f"{(l1 + l2) / 2:.4f} ms (device {ms_or_na(dev_l)}), bound {bnd:.4f} ms {label}")
        # the side buffers written once and read once, the partials likewise
        design = 2 * sum(t.numel() * t.element_size() for t in (u16, kdy16, g16, dh16))
        design += 2 * sum(t.numel() * 4 for t in col_parts + w_parts)
        # the whole full backward, its plain version and the model path's weight backward
        k_full = time_ms(torch, lambda: bm.bwd_full_cuda(*a), 10)
        p_full = time_ms(torch, lambda: bm.bwd_full_plain(*a), 5)
        leaves = [d["s"].clone(), d["r"].clone(), d["ln_g"], d["ln_b"], d["w1"].t().contiguous(),
                  d["b1"], d["w2"].t().contiguous(), d["b2"], d["gamma"]]
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        y_model = plain_tail(*leaves, torch.bfloat16)
        m_full = time_ms(torch, lambda: torch.autograd.grad(y_model, leaves, d["dy"],
                                                            retain_graph=True), 10)
        b_full = max(sum(f for f, _ in whole.values()) / PEAK_BF16,
                     sum(b for _, b in whole.values()) / PEAK_HBM) * 1e3
        ms["bwd_full"] += k_full
        bound_ms["bwd_full"] += b_full
        b_rows = max(whole["bwd_full_rows"][0] / PEAK_BF16, whole["bwd_full_rows"][1] / PEAK_HBM)
        log(f"time rows      B={TRAIN_BATCH} M={M:6d} C={C:4d}: kernel {k_rows:.3f} ms "
            f"({24 * M * C * C / k_rows / 1e9:.1f} TFLOP/s; device {ms_or_na(dev_rows)} ms, "
            f"{tail_design(bm, C, 'bwd_full_rows')}), plain {p_rows:.3f} ms, model bf16 path "
            f"training backward (every cotangent) {m_full:.3f} ms, bound {b_rows * 1e3:.3f} ms "
            f"{label}")
        log(f"time bwd_full  B={TRAIN_BATCH} M={M:6d} C={C:4d}: kernels {k_full:.3f} ms "
            f"({40 * M * C * C / k_full / 1e9:.1f} TFLOP/s; rows pass {k_rows:.3f}), "
            f"plain {p_full:.3f} ms, model bf16 path weight backward {m_full:.3f} ms, "
            f"bound of _bwd_kernel's work {b_full:.3f} ms; the design's own traffic (side "
            f"buffers, partials) {design / 1e6:.1f} MB, {design / PEAK_HBM * 1e3:.3f} ms at the "
            f"HBM rate {label}")
        del d, a, ds, u16, kdy16, g16, dh16, col_parts, w_parts, leaves, y_model
        torch.cuda.empty_cache()
    log(f"reduce over the 15 sums of stages 0-2 (B={TRAIN_BATCH}), one launch each: event loop "
        f"{ms['reduce']:.4f} ms (torch.sum {library_ms['reduce']:.4f} ms, kernel / torch.sum "
        f"{ms['reduce'] / library_ms['reduce']:.3f}), device {ms_or_na(red['dev'])} ms (torch.sum "
        f"{ms_or_na(red['lib_dev'])} ms), bound {bound_ms['reduce']:.4f} ms {label}")
    log(f"forward over the four stages (B=200) {ms['fwd']:.3f} ms, device "
        f"{ms_or_na(row_dev['fwd'])} ms; input backward {ms['bwd_input']:.3f} ms, device "
        f"{ms_or_na(row_dev['bwd_input'])} ms; row pass over stages 0-2 (B={TRAIN_BATCH}) "
        f"{ms['bwd_full_rows']:.3f} ms, device {ms_or_na(row_dev['bwd_full_rows'])} ms {label}")
    log(f"wgrad over the six products of stages 0-2 (B={TRAIN_BATCH}): pass {wg['pass']:.4f} ms "
        f"(device {ms_or_na(wg['pass_dev'])}), pass + reductions {wg['with_reduce']:.4f} ms "
        f"(device {ms_or_na(wg['with_reduce_dev'])}), torch.matmul {wg['matmul']:.4f} ms "
        f"(device {ms_or_na(wg['matmul_dev'])}), bound "
        f"{wg['bound']:.4f} ms: pass + reductions at {100 * wg['bound'] / wg['with_reduce']:.1f}% "
        f"of the bound, {wg['with_reduce'] / wg['matmul']:.3f}x torch.matmul; the whole full "
        f"backward {ms['bwd_full']:.3f} ms against _bwd_kernel's bound {bound_ms['bwd_full']:.3f}"
        f" ms {label}")

    plain = load_model(False)
    yb = torch.from_numpy(y).cuda()
    per_iter = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        m = fused if name == "kernel" else plain
        for n_iter in (2, 10):  # warm-up, then the timed run
            gen_i = torch.Generator(device="cuda").manual_seed(1)
            torch.cuda.synchronize()
            t0 = time.time()
            apgd_attack(m, xt, yb, eps=4.0 / 255.0, n_iter=n_iter, is_train=False,
                        random_start=True, generator=gen_i)
            torch.cuda.synchronize()
        per_iter[name].append((time.time() - t0) * 1000 / 10)
    for name, v in per_iter.items():
        log(f"apgd-ce convnext_tiny+ConvStem bf16 B=32 224px ({name} tail): "
            f"{sum(v) / len(v):.2f} ms/iteration (runs {', '.join('%.2f' % t for t in v)}) "
            f"{label}")
    for name, m in (("kernel", fused), ("plain", plain)):
        profile_breakdown(torch, f"apgd-ce B=32 ({name} tail), per 5 iterations",
                          lambda: apgd_attack(m, xt, yb, eps=4.0 / 255.0, n_iter=5,
                                              is_train=False, random_start=True,
                                              generator=torch.Generator(device="cuda")
                                              .manual_seed(1)), 1, label)

    del fused, plain, xt, yb
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 9-12
    vit_init = vit_eval_phase(torch, np, repo, args.seed)
    vit_launches = vit_step_phase(torch, np, vit_init, args.seed, label)
    micro_phase(torch, np, args.seed)
    vit_cli_phase(torch, np, repo)
    att_times, att_device = attention_timings(torch, att, gen, label)

    # ---------------------------------------------------------------- 13-15
    dw_launches = dwconv_model_phase(torch, np, run_dir, init, args.seed, label)
    fgsm_phase(torch, np, repo, init, vit_init, args.seed, label)
    dw_times, dw_device, dw_whole = dwconv_timings(torch, dw, gen, label)

    # ---------------------------------------------------------------- 16
    recipe_phase(torch, np, init, args.seed, label)
    left = descendants()
    if left:
        raise AssertionError(f"processes still running after the last phase: {left}")
    log("no process of this run is left running")

    # ---------------------------------------------------------------- 17
    full_aa_phase(torch, np, repo, args.seed, label)

    # ---------------------------------------------------------------- 18
    trainer_ckpt_phase(torch, np, repo, init, vit_init, args.seed, label)

    # ---------------------------------------------------------------- 19
    iso_per_step = iso_phase(torch, np, repo, args.seed, label)
    b_per_step, b_per_step_1024 = convnext_b_phase(torch, np, args.seed, label)
    wide_times = {C: wide_tail_timings(torch, bm, gen, label, C, rows)
                  for C, rows in ((ISO_C, ISO_ROWS), (512, 196), (1024, 49))}

    # ---------------------------------------------------------------- 20
    dist_phase(torch, np, repo, init, vit_init, args.seed, label)

    kernels = [dict(name=f"block_mlp_{k}", route="cuda", source=SOURCE[f"block_mlp_{k}"],
                    replaces=REPLACES[f"block_mlp_{k}"], launches=step_launches[f"block_mlp_{k}"],
                    max_abs_err=err[k], ms=ms[k], plain_ms=plain_ms[k], bound_ms=bound_ms[k],
                    bound_by="operations" if bounds[k][0] >= bounds[k][1] else "bytes",
                    library_ms=library_ms[k]) for k in bm.LAUNCHES]
    # the weight pass: ms is the pass with its reduction (torch.matmul's function)
    kernels[list(bm.LAUNCHES).index("wgrad")].update(
        pass_ms=wg["pass"], device_ms=wg["with_reduce_dev"], pass_device_ms=wg["pass_dev"],
        library_device_ms=wg["matmul_dev"])
    kernels[list(bm.LAUNCHES).index("reduce")].update(device_ms=red["dev"],
                                                      library_device_ms=red["lib_dev"])
    for k, v in row_dev.items():
        kernels[list(bm.LAUNCHES).index(k)].update(device_ms=v)
    # the tail at convnext_iso's shape and ConvNeXt-B's stages 2 and 3 (phase
    # 19): times, bounds and the model path beside them; the full backward's
    # under the row pass; the launches per step of each model's training
    # step (at C = 1024 the 1024 kernels' own, from the step's profile)
    for row, C, per_step in (("iso432", ISO_C, iso_per_step), ("c512", 512, b_per_step),
                             ("c1024", 1024, b_per_step_1024)):
        for k, which in (("fwd", "fwd"), ("bwd_input", "bwd_input"),
                         ("bwd_full_rows", "bwd_full")):
            kernels[list(bm.LAUNCHES).index(k)][row] = dict(wide_times[C][which])
        for k in bm.LAUNCHES:
            if f"block_mlp_{k}" in per_step:
                kernels[list(bm.LAUNCHES).index(k)].setdefault(row, {})[
                    "launches_per_step"] = per_step[f"block_mlp_{k}"]
    for k in ATT_KERNELS:
        k_ms, p_ms, b_ms, b_by, lib = att_times[k]
        kernels.append(dict(name=k, route="cuda", source=SOURCE[k], replaces=REPLACES[k],
                            launches=vit_launches[k], max_abs_err=att_err[k], ms=k_ms,
                            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                            device_ms=att_device[k][0], library_device_ms=att_device[k][1]))
    for k in DW_KERNELS:
        k_ms, p_ms, b_ms, b_by, lib = dw_times[k]
        kernels.append(dict(name=k, route="cuda", source=SOURCE[k], replaces=REPLACES[k],
                            launches=dw_launches[k], max_abs_err=dw_err[k], ms=k_ms,
                            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                            device_ms=dw_device[k][0], library_device_ms=dw_device[k][1]))
    # the weight pass: also with its reduction, one call (the library's function)
    next(k for k in kernels if k["name"] == "dwconv_wgrad").update(
        with_reduce_ms=dw_whole[0], with_reduce_device_ms=dw_whole[1])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
