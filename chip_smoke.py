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
     at batch 32; its full backward (row pass, weight pass, reductions, and
     the host recovery of dW2, db2, dgamma) on all nine cotangents at stages
     0-2 at batch 80; both also at a ragged M, in f32 once, with a per-sample
     keep once, at the other widths built (ConvNeXt-B/L), at convnext_iso's
     C = 432 and at the micro models' C = 16, 32, 64; the weight pass with
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
     stages' partial shapes and a ragged one; each output within its own
     tolerance (TOL). Two launches must give the same bits (every kernel),
     the full backward's row pass must give the input backward's ds bit for
     bit (stages 0-2 at batch 80, ragged M with a keep), and five planted faults (a slice of M left out of dW1, a row group left
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
     reduction each); then
     `cli.train.main --adv.attack fgsm` on ConvNeXt-T-CvSt and
     `cli.eval.main` on its EMA weights;
 15. timings of the dwconv kernels at the gated stage shapes, batch 80,
     beside their bounds, plain versions and the library's depthwise conv
     (F.conv2d(groups=C) on the channels_last bf16 map, and its autograd
     backward for dx and for dw/db; torch.sum for the reduction, both also
     by the profiler's device time).

The launch counters are zeroed just before each path (phases 4-5, 6, 7, 9,
10, 11, 13 and 14) and read just after it: every kernel the path runs must
have launched there. The `launches` of the kernels line are phase 6's for
the block tail, phase 10's for the attention and phase 13's training step
for the dwconv. The second-to-last line is a
JSON object {"kernels": [...]}, the last {"ok": true, "device": {...}}.
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


def build_train_step(torch, state_dict, *, use_pallas: bool, device: str, seed: int,
                     arch: str = "convnext_tiny", dwconv: bool = False,
                     attack: str = "apgd"):
    """The training step as bench.py builds it, on the port: the arch with
    ConvStem (ConvNeXt-T-CvSt, or ViT-S-CvSt for vit_s) in bf16 with f32
    params, AdamW(wd 0.05, the family's decay rule) on the cosine schedule
    (lr 1e-3, peak epoch 20, 300 epochs, 5,000 iterations per epoch), mixup
    with label smoothing 0.1, 2-step APGD Linf 4/255 (or, attack='fgsm',
    bench.py's RS-FGSM: alpha 1.25, 4/255), EMA 0.9999. dwconv: ConvNeXt-T-
    CvSt with use_pallas_dwconv=1 (convnext_t_dwconv)."""
    from revisiting_at_tpu_torch.ckpt.convert import load_state_dict
    from revisiting_at_tpu_torch.data import MixupConfig
    from revisiting_at_tpu_torch.models import get_model
    from revisiting_at_tpu_torch.train import (AdvConfig, LRConfig, TrainState, ema_init,
                                               make_lr_schedule, make_optimizer,
                                               make_train_step)

    if dwconv:
        model, family = convnext_t_dwconv(torch, torch.bfloat16, use_pallas), "convnext"
    else:
        model, meta = get_model(arch, not_original=True, dtype=torch.bfloat16,
                                use_pallas=use_pallas)
        family = meta.family
    load_state_dict(model, state_dict)
    model.to(device).train()
    sched = make_lr_schedule(LRConfig(lr=1e-3, lr_peak_epoch=20, epochs=300), 5000)
    opt = make_optimizer(model, optimizer="adamw", weight_decay=0.05, family=family,
                         learning_rate=sched)
    step = make_train_step(model, adv=AdvConfig(attack=attack, norm="Linf", eps=4.0 / 255.0,
                                                n_iter=2, alpha=1.25),
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


def steps_in_turns(torch, steps, x, y, order, warm):
    """`warm` warm-up steps of each {name: (state, step)}, then runs of 5
    steps in `order`. Returns ({name: ms per step of each run}, {name: the
    losses})."""
    losses = {name: run_steps(torch, *steps[name], x, y, warm)[1] for name in steps}
    step_ms = {name: [] for name in steps}
    for name in order:
        ms, ls = run_steps(torch, *steps[name], x, y, 5)
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
                           probes=("stages.0.blocks.0.mlp.fc1.weight",), dwconv=False):
    """One kernel step on the card against the same step on the CPU, where
    every kernel takes its plain version, at batch 2: the loss and the
    global gradient norm within 2e-2, and the gradient of each probe (a
    block's W1: full-backward kernel; a ViT block's qkv weight: attention
    backward; a block's conv_dw weight on the dwconv route: dwconv weight
    pass) at cosine similarity above 0.99. bf16 convolutions and the
    attack's sign steps round differently on the two devices, so this is a
    check of the path, not of the last bits."""
    rng = np.random.RandomState(seed + 1)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 224, 224, 3)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, 2))
    out = {}
    for device in ("cuda", "cpu"):
        state, step = build_train_step(torch, state_dict, use_pallas=True, device=device,
                                       seed=seed, arch=arch, dwconv=dwconv)
        metrics = step(state, x.to(device), y.to(device))
        grads = [state.model.get_parameter(name).grad.float().cpu() for name in probes]
        out[device] = (float(metrics["loss"]), float(metrics["grad_norm"]), grads)
    (lc, nc, gc), (lp, np_, gp) = out["cuda"], out["cpu"]
    cos = [float((a * b).sum() / (a.norm() * b.norm())) for a, b in zip(gc, gp)]
    log(f"{arch}{' (dwconv kernel)' if dwconv else ''} train step vs CPU plain version "
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
    top = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total / n
        name = e.key
        low = name.lower()
        if any(f"(anonymous namespace)::{k}" in name for k in ATT_KERNEL_NAMES):
            families["attention kernels"] += us
        elif any(f"(anonymous namespace)::{k}" in name for k in DW_KERNEL_NAMES):
            families["dwconv kernels"] += us
        elif any(f"(anonymous namespace)::{k}" in name for k in TAIL_KERNEL_NAMES):
            families["tail kernels"] += us
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
        + "; top: " + "; ".join(f"{name} {us / 1000:.2f} ms" for us, name in top[:6])
        + f" {label}")
    out = {k: v / 1000 for k, v in families.items()}
    out.update(wall=wall, device=device, library_depthwise=lib_dw / 1000)
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
    step_ms, losses = steps_in_turns(torch, steps, xb, yb, ("kernel", "plain", "plain", "kernel"),
                                     warm=2)
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
    th = dw._lib().dwconv_tile_rows()
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


def dwconv_timings(torch, dw, gen, label) -> dict:
    """Phase 15: each dwconv kernel at ConvNeXt-T's gated stage shapes,
    batch 80, 224 px, beside its bound, its plain version (kernel and plain
    in turns p, k, k, p) and the library's depthwise conv: F.conv2d(groups=C)
    on the channels_last bf16 map with bf16 weights for the forward, its
    autograd backward with only the map requiring grad for dx, and with
    only the weight and bias for dw/db; torch.sum for the reduction.
    Returns {kernel: (ms, plain_ms, bound_ms, bound_by, library_ms)} summed
    over the three stages."""
    import torch.nn.functional as F

    keys = DW_KERNELS
    tot = {k: [0.0, 0.0, 0.0, 0.0, 0.0] for k in keys}  # ms, plain, ops, bytes, library
    dev_tot = [0.0, 0.0]  # the reduction's and torch.sum's device time

    def turns(k_fn, p_fn, iters=10):
        p1, k1, k2, p2 = (time_ms(torch, f, iters) for f in (p_fn, k_fn, k_fn, p_fn))
        return (k1 + k2) / 2, (p1 + p2) / 2

    log(f"dwconv library timings: torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32} (bf16 maps: TF32 does not apply)")
    for side, C in DW_STAGES:
        B, n = TRAIN_BATCH, TRAIN_BATCH * side * side * C
        x, w49, b, dy = dw_inputs(torch, B, side, side, C, torch.bfloat16, gen)
        part = dw.wgrad_partials_cuda(x, dy)
        # the library's operands: NCHW views of the NHWC maps (channels_last)
        # and timm's [C, 1, 7, 7] weight in bf16
        x_cl, dy_cl = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        w_lib = w49.t().reshape(C, 1, 7, 7).bfloat16()
        b_lib = b.bfloat16()
        x_leaf = x_cl.detach().requires_grad_(True)
        y_dx = F.conv2d(x_leaf, w_lib, b_lib, padding=3, groups=C)
        w_leaf, b_leaf = w_lib.detach().requires_grad_(True), b_lib.detach().requires_grad_(True)
        y_dw = F.conv2d(x_cl, w_leaf, b_leaf, padding=3, groups=C)
        runs = {
            "dwconv_fwd": (lambda: dw.fwd_cuda(x, w49, b), lambda: dw.fwd_plain(x, w49, b),
                           lambda: F.conv2d(x_cl, w_lib, b_lib, padding=3, groups=C),
                           98 * n, 2 * n * 2 + 50 * C * 4),
            "dwconv_dx": (lambda: dw.dx_cuda(dy, w49), lambda: dw.dx_plain(dy, w49, x.dtype),
                          lambda: torch.autograd.grad(y_dx, x_leaf, dy_cl, retain_graph=True),
                          98 * n, 2 * n * 2 + 49 * C * 4),
            # dw and db: 98 + 1 flops per element against reading x and dy;
            # the reduction writes the f32 results
            "dwconv_wgrad": (lambda: dw.wgrad_partials_cuda(x, dy),
                             lambda: dw.wgrad_plain(x, dy),
                             lambda: torch.autograd.grad(y_dw, (w_leaf, b_leaf), dy_cl,
                                                         retain_graph=True),
                             99 * n, 2 * n * 2),
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
            dev = ""
            if k == "dwconv_reduce":  # a few microseconds: is the event loop timing the host?
                dev_k, dev_lib = device_ms(torch, k_fn, 20), device_ms(torch, lib_fn, 20)
                dev_tot = [sum_or_none(dev_tot[0], dev_k), sum_or_none(dev_tot[1], dev_lib)]
                dev = f" (device {ms_or_na(dev_k)} ms, torch.sum's {ms_or_na(dev_lib)} ms)"
            log(f"time {k:13s} B={B} {side}x{side} C={C:3d}: kernel {k_ms:.4f} ms"
                + (f" ({flops / k_ms / 1e9:.1f} TFLOP/s fp32)" if flops else "")
                + f"{dev}, plain {p_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                f"{max(t_ops, t_bytes):.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'})"
                f" {label}")
        design = 2 * part.numel() * 4
        log(f"dwconv B={B} {side}x{side} C={C}: partials {tuple(part.shape)}, "
            f"{design / 1e6:.2f} MB written and read (the design's own traffic) {label}")
        del x, dy, part, x_cl, dy_cl, x_leaf, y_dx, w_leaf, b_leaf, y_dw, runs
        torch.cuda.empty_cache()
    r = tot["dwconv_reduce"]
    log(f"dwconv reduction over the three stage shapes: event loop {r[0]:.4f} ms (torch.sum "
        f"{r[4]:.4f} ms), device {ms_or_na(dev_tot[0])} ms (torch.sum {ms_or_na(dev_tot[1])} ms), bound "
        f"{r[3]:.4f} ms {label}")
    return {k: (v[0], v[1], max(v[2], v[3]), "operations" if v[2] >= v[3] else "bytes", v[4])
            for k, v in tot.items()}


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
    step_ms, losses = steps_in_turns(torch, steps, xb, yb,
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
    batch 80, in turns, with the dwconv launches per step; then the FGSM
    train CLI on ConvNeXt-T-CvSt and cli.eval on its EMA weights."""
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
    step_ms, losses = steps_in_turns(torch, steps, xb, yb, names + names[::-1], warm=5)
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
    cases += [(49 * 3, 768, torch.bfloat16, 0),   # ragged: 147 rows, tiles of 32
              (784 * 2, 192, torch.float32, 0),   # f32 I/O
              (196 * 4, 384, torch.bfloat16, 196)]  # per-sample keep
    # the other widths built for ConvNeXt-B/L, at a few ragged tiles each
    cases += [(3136 + 40, 128, torch.bfloat16, 0), (784 + 40, 256, torch.bfloat16, 0),
              (196 * 2 + 8, 512, torch.bfloat16, 0), (49 * 2 + 5, 1024, torch.bfloat16, 0)]
    # convnext_iso's C = 432 (14x14 tokens): batch 32, ragged with a keep, f32
    cases += [(ISO_ROWS * 32, 432, torch.bfloat16, 0),
              (ISO_ROWS * 3, 432, torch.bfloat16, ISO_ROWS),
              (ISO_ROWS * 2 + 5, 432, torch.float32, 0)]
    # the micro models' widths: convnext_micro's stages 0-2 at 224 px, batch
    # 32 (3136, 784, 196 rows an image), vit_micro's 32 (197 tokens), ragged
    # and f32 once
    cases += [(3136 * 32, 16, torch.bfloat16, 0), (784 * 32, 32, torch.bfloat16, 0),
              (196 * 32, 64, torch.bfloat16, 0), (197 * 32, 32, torch.bfloat16, 197),
              (3136 + 40, 16, torch.float32, 0), (196 * 2 + 5, 64, torch.bfloat16, 0)]
    for i, (M, C, dtype, keep_rows) in enumerate(cases):
        d = tail_inputs(torch, M, C, dtype, gen, keep_rows)
        for which in ("fwd", "bwd_input"):
            got = run_tail(bm, d, which, kernel=True)
            ref = run_tail(bm, d, which, kernel=False)
            torch.cuda.synchronize()
            what = f"{which} M={M} C={C} {dtype} keep={bool(keep_rows)}"
            err[which] = max(err[which], check(torch, what, got, ref, TOL[which]))
            if (i == 0 or C in (432, 16)) and not torch.equal(
                    got, run_tail(bm, d, which, kernel=True)):
                raise AssertionError(f"{what}: two launches differ")
        if i == 0 or C in (432, 16):
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
    # convnext_iso's C = 432 at the training batch (full mode admits C <= 512),
    # and ragged with a keep
    full_cases += [(ISO_ROWS * TRAIN_BATCH, 432, torch.bfloat16, 0),
                   (ISO_ROWS * 3, 432, torch.bfloat16, ISO_ROWS)]
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
        if i < 3 or (keep_rows and M % 64 and C in bm.WGMMA_WIDTHS):
            # the stage shapes at the training batch and a ragged M with a
            # keep: the row pass's ds is the input backward's, bit for bit
            if not torch.equal(got[0], run_tail(bm, d, "bwd_input", kernel=True)):
                raise AssertionError(f"bwd_full {what}: the row pass's ds differs from the "
                                     "input backward's")
            log(f"bwd_full {what}: the row pass's ds equals the input backward's, bit for bit")
        if C in (432, 16) and not keep_rows:
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
    step_ms, losses = steps_in_turns(torch, steps, xb, yb, ("kernel", "plain", "plain", "kernel"),
                                     warm=2)
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
                f"{bm.tail_plan(C, which).design}), plain {p:.3f} ms, "
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
            f"{bm.tail_plan(C, 'bwd_full_rows').design}), plain {p_rows:.3f} ms, model bf16 path "
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
    dw_times = dwconv_timings(torch, dw, gen, label)

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
                            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
