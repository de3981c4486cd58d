#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (revisiting_at_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--kernels-only]

Phases, each fatal on failure:
  1. environment: CUDA present; card name and power limit, torch and CUDA versions;
  2. build the fused block-tail kernels (csrc/block_mlp.cu, sm_90a) with nvcc;
  3. each kernel against its plain PyTorch version, in bf16, at the four
     ConvNeXt-T stage shapes at batch 32 and at a ragged stage-3 M, in f32
     once, with a per-sample keep once, and at the other widths the
     kernels are built for (ConvNeXt-B/L);
  4. the slice through its entry point: ConvNeXt-T-CvSt at full width and
     224 px with random weights from --seed, written to a run dir as
     params.json + .pt, evaluated by `cli.eval.main` (short AutoAttack,
     --use_pallas 1);
  5. the same short AutoAttack on the same model with labels set to its own
     clean predictions, so APGD-CE and APGD-T run on every point; the
     logits are checked against the CPU plain version on a small input;
  6. timings: each kernel beside its plain version and beside the plain
     model path's tail at batch 200, and ms per APGD iteration at batch 32
     with and without the kernels.

The launch counters are zeroed just before phase 4 and read after phase 5:
both kernels must have launched there. The second-to-last line is a JSON
object {"kernels": [...]}, the last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# Tolerance of a kernel against its plain version, both in bf16 on the card:
# max |kernel - plain| <= 2e-2 * max |plain|. Both round the same operands to
# bf16; they differ in f32 summation order, which can flip a bf16 rounding of
# g16 or dh16 and so move an output by a few bf16 ulps of its largest value.
KERNEL_RTOL = 2e-2

# ConvNeXt-T stage shapes: (rows per image at 224 px, C)
STAGES = [(3136, 96), (784, 192), (196, 384), (49, 768)]
REPLACES = {"fwd": "revisiting_at_tpu/ops/block_mlp.py:108",
            "bwd_input": "revisiting_at_tpu/ops/block_mlp.py:237"}
SOURCE = "revisiting_at_tpu_torch/csrc/block_mlp.cu"


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
    bm._lib()
    log(f"build: {time.time() - t0:.1f} s ({bm.build().name})")

    # ---------------------------------------------------------------- 3
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    err = {"fwd": 0.0, "bwd_input": 0.0}
    # the stage shapes at batch 32, as phases 4 and 5 give them to the kernels
    cases = [(rows * 32, C, torch.bfloat16, 0) for rows, C in STAGES]
    cases += [(49 * 3, 768, torch.bfloat16, 0),   # ragged: 147 rows, tiles of 32
              (784 * 2, 192, torch.float32, 0),   # f32 I/O
              (196 * 4, 384, torch.bfloat16, 196)]  # per-sample keep
    # the other widths built for ConvNeXt-B/L, at a few ragged tiles each
    cases += [(3136 + 40, 128, torch.bfloat16, 0), (784 + 40, 256, torch.bfloat16, 0),
              (196 * 2 + 8, 512, torch.bfloat16, 0), (49 * 2 + 5, 1024, torch.bfloat16, 0)]
    for M, C, dtype, keep_rows in cases:
        d = tail_inputs(torch, M, C, dtype, gen, keep_rows)
        for which in ("fwd", "bwd_input"):
            got = run_tail(bm, d, which, kernel=True)
            ref = run_tail(bm, d, which, kernel=False)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{which} M={M} C={C}: non-finite kernel output")
            e = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            log(f"check {which:9s} M={M:6d} C={C:4d} {str(dtype):14s} keep={bool(keep_rows)} "
                f"max_abs_err={e:.3e} max|ref|={scale:.3e}")
            if not e <= KERNEL_RTOL * scale:
                raise AssertionError(f"{which} M={M} C={C}: error {e} > {KERNEL_RTOL} * {scale}")
            err[which] = max(err[which], e)
    if args.kernels_only:
        return 0

    # ---------------------------------------------------------------- 4
    from revisiting_at_tpu_torch.attacks import apgd_attack
    from revisiting_at_tpu_torch.ckpt.convert import load_torch_checkpoint, save_torch_checkpoint
    from revisiting_at_tpu_torch.cli import eval as eval_cli
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

    for k in bm.LAUNCHES:
        bm.LAUNCHES[k] = 0
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
    launches = dict(bm.LAUNCHES)
    log(f"autoattack short (eps 0.25/255): robust acc {robust.mean():.4f} on 32 pts labelled "
        f"by the model (clean 1.0), {aa_s:.2f} s; launches in phases 4-5: {launches}")
    for attack in ("APGD-CE", "APGD-T"):
        if not any(f"after {attack}:" in m for m in aa_log.lines):
            raise AssertionError(f"{attack} did not run: no point was left for it")
    if x_adv.shape != x.shape or not np.isfinite(x_adv).all():
        raise AssertionError("x_adv has the wrong shape or non-finite values")
    if np.abs(x_adv - x).max() > eps * 1.001 + 1e-6 or x_adv.min() < 0 or x_adv.max() > 1:
        raise AssertionError("x_adv leaves the eps ball or the box")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")

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

    # ---------------------------------------------------------------- 6
    # Each kernel beside its plain version (same cast points, f32 matmuls on
    # bf16-rounded operands) and beside the plain model path's own tail
    # (bf16 cuBLAS matmuls, erf GELU), at batch 200; order p, k, k, p.
    kern_ms = {"fwd": 0.0, "bwd_input": 0.0}
    plain_ms = {"fwd": 0.0, "bwd_input": 0.0}
    for rows, C in STAGES:
        d = tail_inputs(torch, rows * 200, C, torch.bfloat16, gen)
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
        for which in ("fwd", "bwd_input"):
            k_fn = lambda: run_tail(bm, d, which, kernel=True)  # noqa: E731
            p_fn = lambda: run_tail(bm, d, which, kernel=False)  # noqa: E731
            p1, k1, k2, p2 = (time_ms(torch, f, 10) for f in (p_fn, k_fn, k_fn, p_fn))
            k, p = (k1 + k2) / 2, (p1 + p2) / 2
            mp = time_ms(torch, model_fn[which], 10)
            kern_ms[which] += k
            plain_ms[which] += p
            flops = (16 if which == "fwd" else 24) * rows * 200 * C * C
            log(f"time {which:9s} B=200 M={rows * 200:6d} C={C:4d}: kernel {k:.3f} ms "
                f"({flops / k / 1e9:.1f} TFLOP/s), plain {p:.3f} ms, "
                f"model bf16 path {mp:.3f} ms {label}")
        del d, s_in, r_in, y_model, model_fn
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

    kernels = [dict(name=f"block_mlp_{k}", route="cuda", source=SOURCE, replaces=REPLACES[k],
                    launches=launches[k], max_abs_err=err[k], ms=kern_ms[k],
                    plain_ms=plain_ms[k]) for k in ("fwd", "bwd_input")]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
