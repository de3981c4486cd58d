#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (revisiting_at_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--kernels-only]

Phases, each fatal on failure:
  1. environment: CUDA present; card name and power limit, torch and CUDA versions;
  2. build the block-tail kernels (csrc/block_mlp.cu and csrc/block_mlp_bwd.cu,
     sm_90a), one nvcc per source, started together; ptxas spills are printed;
  3. each kernel against its plain PyTorch version, in bf16: the forward and
     the input backward at the four ConvNeXt-T stage shapes at batch 32; the
     full backward (row pass, weight pass, reductions, and the host recovery
     of dW2, db2, dgamma) on all nine cotangents at stages 0-2 at batch 80;
     both also at a ragged M, in f32 once, with a per-sample keep once, and
     at the other widths built (ConvNeXt-B/L); each output within its own
     tolerance (TOL). Two launches must give the same bits (every kernel,
     all nine cotangents of the full backward), and two planted faults (a
     slice of M left out of dW1, a row group left out of db1) must fail
     the check;
  4. the evaluation path through its entry point: ConvNeXt-T-CvSt at full
     width and 224 px with random weights from --seed, written to a run dir
     as params.json + .pt, evaluated by `cli.eval.main` (short AutoAttack,
     --use_pallas 1);
  5. the same short AutoAttack with labels set to the model's own clean
     predictions, so APGD-CE and APGD-T run on every point; the logits are
     checked against the CPU plain version on a small input;
  6. the training step as bench.py builds it: ConvNeXt-T-CvSt, bf16, 224 px,
     batch 80, mixup, 2-step APGD Linf 4/255, AdamW on the cosine schedule,
     EMA 0.9999, use_pallas=1; 2 warm-up steps, then 10 timed (host clock
     around a synchronize) in turns with the plain-tail step (use_pallas=0),
     kernel, plain, plain, kernel; one step checked against the CPU plain
     version at batch 2;
  7. the train CLI: `cli.train.main` on ConvNeXt-T-CvSt at 224 px, synthetic
     data, batch 16, 1 epoch, then `cli.eval.main` on the EMA weights it wrote;
  8. timings: each kernel beside its plain version, its bound and the plain
     model path's tail, at the stage shapes (forward and input backward at
     batch 200, full backward at batch 80), and ms per APGD iteration at
     batch 32 with and without the kernels; torch.profiler breakdowns of
     the training step (phase 6) and of APGD by kernel family.

The launch counters are zeroed just before each path (phases 4-5, 6, 7) and
read just after it: every kernel the path runs must have launched there.
The `launches` of the kernels line are phase 6's. The second-to-last line
is a JSON object {"kernels": [...]}, the last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
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
    # summation order only (largest readings 2.9e-6 and 2.6e-7)
    "wgrad": 2e-5, "reduce": 2e-6,
}

# ConvNeXt-T stage shapes: (rows per image at 224 px, C)
STAGES = [(3136, 96), (784, 192), (196, 384), (49, 768)]
TRAIN_BATCH = 80  # the training step's batch (bench.py's configuration)
# the port's CUDA kernels (anonymous namespace of csrc/*.cu), for profiles
TAIL_KERNEL_NAMES = ("fwd_kernel", "bwd_kernel", "wgrad_kernel", "reduce_kernel")
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM
PEAK_BF16, PEAK_HBM = 989e12, 3.35e12
REPLACES = {"fwd": "revisiting_at_tpu/ops/block_mlp.py:108",
            "bwd_input": "revisiting_at_tpu/ops/block_mlp.py:237",
            "bwd_full_rows": "revisiting_at_tpu/ops/block_mlp.py:124",
            "wgrad": "revisiting_at_tpu/ops/block_mlp.py:124",
            "reduce": "revisiting_at_tpu/ops/block_mlp.py:124"}
SOURCE = {"fwd": "revisiting_at_tpu_torch/csrc/block_mlp.cu",
          "bwd_input": "revisiting_at_tpu_torch/csrc/block_mlp.cu",
          "bwd_full_rows": "revisiting_at_tpu_torch/csrc/block_mlp_bwd.cu",
          "wgrad": "revisiting_at_tpu_torch/csrc/block_mlp_bwd.cu",
          "reduce": "revisiting_at_tpu_torch/csrc/block_mlp_bwd.cu"}
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
    log(f"check {what}: max_abs_err={e:.3e} max|ref|={scale:.3e} ({e / scale:.2e} of it, "
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


def zero_launches(bm) -> None:
    for k in bm.LAUNCHES:
        bm.LAUNCHES[k] = 0


def require_launches(bm, path: str, kernels) -> dict:
    """The counts since zero_launches; fatal if a kernel of the path has none."""
    launches = dict(bm.LAUNCHES)
    log(f"launches in {path}: {launches}")
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on {path}")
    return launches


def build_train_step(torch, state_dict, *, use_pallas: bool, device: str, seed: int):
    """The training step as bench.py builds it, on the port: ConvNeXt-T-CvSt
    in bf16 with f32 params, AdamW(wd 0.05) on the cosine schedule (lr 1e-3,
    peak epoch 20, 300 epochs, 5,000 iterations per epoch), mixup with
    label smoothing 0.1, 2-step APGD Linf 4/255, EMA 0.9999."""
    from revisiting_at_tpu_torch.ckpt.convert import load_state_dict
    from revisiting_at_tpu_torch.data import MixupConfig
    from revisiting_at_tpu_torch.models import get_model
    from revisiting_at_tpu_torch.train import (AdvConfig, LRConfig, TrainState, ema_init,
                                               make_lr_schedule, make_optimizer,
                                               make_train_step)

    model, meta = get_model("convnext_tiny", not_original=True, dtype=torch.bfloat16,
                            use_pallas=use_pallas)
    load_state_dict(model, state_dict)
    model.to(device).train()
    sched = make_lr_schedule(LRConfig(lr=1e-3, lr_peak_epoch=20, epochs=300), 5000)
    opt = make_optimizer(model, optimizer="adamw", weight_decay=0.05, family=meta.family,
                         learning_rate=sched)
    step = make_train_step(model, adv=AdvConfig(attack="apgd", norm="Linf", eps=4.0 / 255.0,
                                                n_iter=2),
                           mixup=MixupConfig(num_classes=1000, label_smoothing=0.1),
                           ema_decay=0.9999, seed=seed)
    return TrainState(model, opt, ema_init(model)), step


def run_steps(torch, state, step, x, y, n):
    """n steps; returns (ms per step on the host clock, the losses)."""
    torch.cuda.synchronize()
    t0 = time.time()
    losses = [step(state, x, y)["loss"] for _ in range(n)]
    torch.cuda.synchronize()
    return (time.time() - t0) * 1000 / n, [float(v) for v in losses]


def check_step_against_cpu(torch, np, state_dict, seed):
    """One kernel-tail step on the card against the same step on the CPU,
    where the tail takes its plain version, at batch 2: the loss and the
    global gradient norm within 2e-2, and the gradient of a stage-0 block's
    W1 (full-backward kernel) at cosine similarity above 0.99. bf16
    convolutions and the attack's sign steps round differently on the two
    devices, so this is a check of the path, not of the last bits."""
    rng = np.random.RandomState(seed + 1)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 224, 224, 3)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, 2))
    out = {}
    for device in ("cuda", "cpu"):
        state, step = build_train_step(torch, state_dict, use_pallas=True, device=device,
                                       seed=seed)
        metrics = step(state, x.to(device), y.to(device))
        grad = state.model.stages[0].blocks[0].mlp.fc1.weight.grad.float().cpu()
        out[device] = (float(metrics["loss"]), float(metrics["grad_norm"]), grad)
    (lc, nc, gc), (lp, np_, gp) = out["cuda"], out["cpu"]
    cos = float((gc * gp).sum() / (gc.norm() * gp.norm()))
    log(f"train step vs CPU plain version (batch 2): loss {lc:.5f} / {lp:.5f}, grad_norm "
        f"{nc:.4f} / {np_:.4f}, stage-0 W1 gradient cosine {cos:.5f}")
    if not (abs(lc - lp) <= 2e-2 * abs(lp) and abs(nc - np_) <= 2e-2 * abs(np_) and cos > 0.99):
        raise AssertionError("the training step disagrees with the CPU plain version")


def profile_breakdown(torch, what: str, fn, n: int, label: str) -> None:
    """torch.profiler over n calls of fn: wall and device time per call, the
    device's busy share, and device time by kernel family. The profiler
    inflates host time, so the shares are what to read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1000 / n
    families = {"tail kernels": 0.0, "gemm": 0.0, "conv": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total / n
        name = e.key
        low = name.lower()
        if any(f"(anonymous namespace)::{k}" in name for k in TAIL_KERNEL_NAMES):
            families["tail kernels"] += us
        elif any(k in low for k in ("conv", "dgrad", "wgrad", "fprop", "cudnn", "implicit")):
            families["conv"] += us
        elif any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet")):
            families["gemm"] += us
        else:
            families["other"] += us
        top.append((us, name[:70]))
    device = sum(families.values()) / 1000
    if device <= 0:
        raise AssertionError(f"profile {what}: the profiler saw no device time")
    top.sort(reverse=True)
    log(f"profile {what}: wall {wall:.2f} ms, device {device:.2f} ms "
        f"(busy {100 * device / wall:.1f}%), "
        + ", ".join(f"{k} {v / 1000:.2f} ms" for k, v in families.items())
        + "; top: " + "; ".join(f"{name} {us / 1000:.2f} ms" for us, name in top[:6])
        + f" {label}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (build and check the kernels)")
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
    from revisiting_at_tpu_torch.ops import block_mlp as bm

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
    libs = bm.build()
    bm._lib()
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
    err = {k: 0.0 for k in bm.LAUNCHES}
    # the stage shapes at batch 32, as phases 4 and 5 give them to the kernels
    cases = [(rows * 32, C, torch.bfloat16, 0) for rows, C in STAGES]
    cases += [(49 * 3, 768, torch.bfloat16, 0),   # ragged: 147 rows, tiles of 32
              (784 * 2, 192, torch.float32, 0),   # f32 I/O
              (196 * 4, 384, torch.bfloat16, 196)]  # per-sample keep
    # the other widths built for ConvNeXt-B/L, at a few ragged tiles each
    cases += [(3136 + 40, 128, torch.bfloat16, 0), (784 + 40, 256, torch.bfloat16, 0),
              (196 * 2 + 8, 512, torch.bfloat16, 0), (49 * 2 + 5, 1024, torch.bfloat16, 0)]
    for i, (M, C, dtype, keep_rows) in enumerate(cases):
        d = tail_inputs(torch, M, C, dtype, gen, keep_rows)
        for which in ("fwd", "bwd_input"):
            got = run_tail(bm, d, which, kernel=True)
            ref = run_tail(bm, d, which, kernel=False)
            torch.cuda.synchronize()
            what = f"{which} M={M} C={C} {dtype} keep={bool(keep_rows)}"
            err[which] = max(err[which], check(torch, what, got, ref, TOL[which]))
            if i == 0 and not torch.equal(got, run_tail(bm, d, which, kernel=True)):
                raise AssertionError(f"{what}: two launches differ")
        if i == 0:
            log(f"fwd, bwd_input M={M} C={C}: bitwise equal over two launches")
    # the full backward: ConvNeXt-T's stages 0-2 at the training batch, where
    # tail_fusable(C, "full") admits the kernel, then ragged M, f32 I/O, a
    # per-sample keep, and the other widths built (B/L, wide_tail)
    full_cases = [(rows * TRAIN_BATCH, C, torch.bfloat16, 0) for rows, C in STAGES[:3]]
    full_cases += [(3136 * 2 + 40, 96, torch.bfloat16, 0), (196 * 3 + 5, 384, torch.bfloat16, 0),
                   (784 * 2, 192, torch.float32, 0), (196 * 4, 384, torch.bfloat16, 196),
                   (3136 + 40, 128, torch.bfloat16, 0), (784 + 40, 256, torch.bfloat16, 0),
                   (196 * 2 + 8, 512, torch.bfloat16, 0), (49 * 2 + 5, 768, torch.bfloat16, 0),
                   (49 * 2 + 5, 1024, torch.bfloat16, 0)]
    for i, (M, C, dtype, keep_rows) in enumerate(full_cases):
        d = tail_inputs(torch, M, C, dtype, gen, keep_rows)
        got = run_full(bm, d, kernel=True)
        ref = run_full(bm, d, kernel=False)
        torch.cuda.synchronize()
        what = f"M={M} C={C} {dtype} keep={bool(keep_rows)}"
        for name, g, r in zip(FULL_COTANGENTS, got, ref):
            e = check(torch, f"bwd_full {name:6s} {what}", g, r, TOL[name])
            err[FULL_ERR_KEY[name]] = max(err[FULL_ERR_KEY[name]], e)
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
    # the weight pass and the reduction alone, at stage 0's training shapes
    m0 = STAGES[0][0] * TRAIN_BATCH
    x16 = torch.randn(m0, 96, generator=gen, device="cuda").bfloat16()
    y16 = torch.randn(m0, 384, generator=gen, device="cuda").bfloat16()
    err["wgrad"] = max(err["wgrad"], check(torch, f"wgrad M={m0} 96x384", bm.wgrad_cuda(x16, y16),
                                           bm.wgrad_plain(x16, y16), TOL["wgrad"]))
    part = torch.randn(m0 // 64, 384, generator=gen, device="cuda")
    err["reduce"] = max(err["reduce"], check(torch, f"reduce {m0 // 64}x384", bm.reduce_cuda(part),
                                             bm.reduce_plain(part), TOL["reduce"]))
    del x16, y16, part
    torch.cuda.empty_cache()
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

    zero_launches(bm)
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
    require_launches(bm, "the eval path (phases 4-5)", ("fwd", "bwd_input"))
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
    zero_launches(bm)
    losses = {"kernel": [], "plain": []}
    for name in ("kernel", "plain"):  # warm-up
        losses[name] += run_steps(torch, *steps[name], xb, yb, 2)[1]
    step_ms = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        ms, ls = run_steps(torch, *steps[name], xb, yb, 5)
        step_ms[name].append(ms)
        losses[name] += ls
    step_launches = require_launches(bm, "the training step (phase 6)", tuple(bm.LAUNCHES))
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
    zero_launches(bm)
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
    require_launches(bm, "the train CLI (phase 7)", tuple(bm.LAUNCHES))

    # ---------------------------------------------------------------- 8
    # Each kernel beside its plain version (same cast points, f32 matmuls on
    # bf16-rounded operands), its bound, and the plain model path's own tail
    # (bf16 cuBLAS matmuls, erf GELU); kernel and plain in turns p, k, k, p.
    ms = {k: 0.0 for k in bm.LAUNCHES}
    plain_ms = dict(ms)
    library_ms = {k: None for k in bm.LAUNCHES}
    library_ms.update(wgrad=0.0, reduce=0.0)
    bounds = {k: [0.0, 0.0] for k in bm.LAUNCHES}  # summed op and byte times, ms
    bound_ms = dict(ms)

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
            ms[which] += k
            plain_ms[which] += p
            flops = (16 if which == "fwd" else 24) * M * C * C
            bnd = add_bound(which, flops, 3 * M * C * 2 + weights)
            log(f"time {which:9s} B={B} M={M:6d} C={C:4d}: kernel {k:.3f} ms "
                f"({flops / k / 1e9:.1f} TFLOP/s), plain {p:.3f} ms, "
                f"model bf16 path {mp:.3f} ms, bound {bnd:.3f} ms {label}")
        del d, s_in, r_in, y_model, model_fn
        torch.cuda.empty_cache()

    # The full backward's bound is that of the work `_bwd_kernel` does: 40 *
    # M * C^2 flops (h, dg, du; dW1, A) against reading s, dy, W1, w2g and the
    # vectors and writing ds and the f32 gradients. Each of its three kernels
    # is booked the part of that work it does: the row pass the first 24 *
    # M * C^2 flops and the activations, the weight pass the other 16 * M *
    # C^2, the reduction (which writes the final f32 gradients) their bytes.
    # The side buffers and partials between them are the two-pass design's
    # own traffic, not part of any bound; they are logged beside it.
    for rows, C in STAGES[:3]:  # the full backward runs in stages 0-2
        M = rows * TRAIN_BATCH
        d = tail_inputs(torch, M, C, torch.bfloat16, gen)
        w2g16 = (d["w2"].bfloat16().float() * d["gamma"]).bfloat16()
        a = (d["s"], None, M, d["ln_g"], d["ln_b"], d["w1"].bfloat16(), d["b1"], w2g16, d["dy"])
        ds, u16, kdy16, g16, dh16, *col_parts = bm.bwd_full_rows_cuda(*a)
        k_rows = time_ms(torch, lambda: bm.bwd_full_rows_cuda(*a), 10)
        p_rows = time_ms(torch, lambda: bm.bwd_full_rows_plain(*a), 5)
        ms["bwd_full_rows"] += k_rows
        plain_ms["bwd_full_rows"] += p_rows
        part_ops = {"bwd_full_rows": (24 * M * C * C, 3 * M * C * 2 + 2 * 4 * C * C * 2 + 6 * C * 4),
                    "wgrad": (16 * M * C * C, 0),
                    "reduce": (0, (2 * 4 * C * C + 4 * C + 2 * C) * 4)}
        for k, (flops, nbytes) in part_ops.items():
            add_bound(k, flops, nbytes)
        w_parts = []
        for x16, y16 in ((u16, dh16), (g16, kdy16)):
            part = bm.wgrad_partials_cuda(x16, y16)
            w_parts.append(part.view(part.shape[0], -1))
            ms["wgrad"] += time_ms(torch, lambda: bm.wgrad_partials_cuda(x16, y16), 10)
            plain_ms["wgrad"] += time_ms(torch, lambda: bm.wgrad_plain(x16, y16), 5)
            library_ms["wgrad"] += time_ms(torch, lambda: torch.matmul(x16.t(), y16), 10)
        for part in col_parts + w_parts:
            ms["reduce"] += time_ms(torch, lambda: bm.reduce_cuda(part), 10)
            plain_ms["reduce"] += time_ms(torch, lambda: bm.reduce_plain(part), 10)
            library_ms["reduce"] += time_ms(torch, lambda: torch.sum(part, 0), 10)
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
        b_full = max(sum(f for f, _ in part_ops.values()) / PEAK_BF16,
                     sum(b for _, b in part_ops.values()) / PEAK_HBM) * 1e3
        log(f"time bwd_full  B={TRAIN_BATCH} M={M:6d} C={C:4d}: kernels {k_full:.3f} ms "
            f"({40 * M * C * C / k_full / 1e9:.1f} TFLOP/s; rows pass {k_rows:.3f}), "
            f"plain {p_full:.3f} ms, model bf16 path weight backward {m_full:.3f} ms, "
            f"bound {b_full:.3f} ms; the design's own traffic (side buffers, partials) "
            f"{design / 1e6:.1f} MB, {design / PEAK_HBM * 1e3:.3f} ms at the HBM rate {label}")
        del d, a, ds, u16, kdy16, g16, dh16, col_parts, w_parts, leaves, y_model
        torch.cuda.empty_cache()

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

    kernels = [dict(name=f"block_mlp_{k}", route="cuda", source=SOURCE[k], replaces=REPLACES[k],
                    launches=step_launches[k], max_abs_err=err[k], ms=ms[k],
                    plain_ms=plain_ms[k], bound_ms=bound_ms[k],
                    bound_by="operations" if bounds[k][0] >= bounds[k][1] else "bytes",
                    library_ms=library_ms[k]) for k in bm.LAUNCHES]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
