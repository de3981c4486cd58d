"""Time the block tail's weight pass with its reduction at several numbers
of slices of M, at the full backward's shapes, on one GPU.

    python3 -m revisiting_at_tpu_torch.tools.wgrad_slices [--reps 5] [--out FILE]

For each shape (ConvNeXt-T's stages 0-2, ViT-S and convnext_iso's C = 432,
all at batch 80) and each candidate number of slices, both products (dW1 =
u^T @ dh and A = g^T @ kdy, on random bf16 operands) run the weight pass
and then its reduction; torch.profiler's kernel durations give the device
time of the pass and of the pass with its reduction, torch.matmul's on the
same operands beside them. Each candidate's result is checked against
`wgrad_plain` first. The candidates run in an order that rotates from one
round to the next, so drift in the card's speed falls on all of them; each
prints its mean, min and max over --reps rounds, and `wgrad_plan`'s own
choice is marked. --out writes the readings as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from ..ops import block_mlp as bm
from ..ops import cuda_build

BATCH = 80
# (name, M, C)
SHAPES = [("convnext_t stage 0", 3136 * BATCH, 96), ("convnext_t stage 1", 784 * BATCH, 192),
          ("convnext_t stage 2", 196 * BATCH, 384), ("vit_s", 197 * BATCH, 384),
          ("convnext_iso C=432", 196 * BATCH, 432)]
# shares of the 132 SMs that the blocks of one wave fill
FILLS = (0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0, 2.0)
CALLS = 20  # calls per profiled round


def candidates(m_pad: int, C: int) -> list[int]:
    """Slice counts to try: the plan's and those that fill FILLS of the SMs,
    each as `wgrad_plan` would cut M for it (whole 64-row stages)."""
    tiles = bm._wgrad_tiles(C)
    wanted = {bm.wgrad_plan(m_pad, C, 4 * C)[1]}
    wanted |= {max(1, min(bm._WGRAD_MAX_SLICES, round(f * bm._SMS / tiles))) for f in FILLS}
    return sorted({_cut(m_pad, n)[1] for n in wanted if n <= m_pad // bm.WGRAD_DEPTH})


def _cut(m_pad: int, n: int) -> tuple[int, int]:
    rows = -(-m_pad // n // bm.WGRAD_DEPTH) * bm.WGRAD_DEPTH
    return rows, -(-m_pad // rows)


def wgrad_with(x16, y16, n: int):
    """x16^T @ y16 [P, Q] f32 as `wgrad_cuda` computes it (the pass and its
    reduction in one call), with M cut into n slices."""
    (m_pad, P), Q = x16.shape, y16.shape[1]
    rows, n = _cut(m_pad, n)
    part = torch.empty(n, P, Q, dtype=torch.float32, device=x16.device)
    out = torch.empty(P, Q, dtype=torch.float32, device=x16.device)
    err = cuda_build.launch(x16, bm._lib().block_mlp_wgrad, x16.data_ptr(), P, y16.data_ptr(),
                            Q, m_pad, rows, n, part.data_ptr(), out.data_ptr(),
                            *bm.reduce_plan(n, P * Q))
    if err:
        raise RuntimeError(f"weight pass with {n} slices of M: error {err}")
    return out


def device_times(fn) -> dict[str, float]:
    """ms of device time per call of fn by kernel family (pass, reduce,
    other): each kernel's mean duration times its launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    out = {"pass": 0.0, "reduce": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.count:
            continue
        per_call = max(1, round(e.count / CALLS))
        family = ("pass" if "wgrad_kernel" in e.key else
                  "reduce" if "reduce_kernel" in e.key else "other")
        out[family] += e.self_device_time_total / e.count * per_call / 1000
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wgrad_slices: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = []
    for name, M, C in SHAPES:
        m_pad = -(-M // bm.WGRAD_DEPTH) * bm.WGRAD_DEPTH
        rnd = lambda n: torch.randn(m_pad, n, generator=gen, device="cuda").bfloat16()  # noqa: E731
        pairs = ((rnd(C), rnd(4 * C)), (rnd(4 * C), rnd(C)))  # dW1 = u^T dh, A = g^T kdy
        for x16, y16 in pairs:
            x16[M:], y16[M:] = 0, 0  # the row pass's padding
        plan = bm.wgrad_plan(m_pad, C, 4 * C)[1]
        # a slice sums its rows in one chain of f32 accumulators: the fewer
        # the slices, the longer the chain; a count off by more than
        # chip_smoke.py's TOL["wgrad"] is no candidate and is not timed
        errs, ns = {}, []
        refs = [bm.wgrad_plain(x16, y16) for x16, y16 in pairs]
        for n in candidates(m_pad, C):
            errs[n] = max(((wgrad_with(x16, y16, n) - ref).abs().max() / ref.abs().max()).item()
                          for (x16, y16), ref in zip(pairs, refs))
            if errs[n] <= 2e-5:
                ns.append(n)
        del refs
        print(f"{name}: largest error of max|ref| per slice count: "
              + ", ".join(f"{n}: {e:.2e}{'' if n in ns else ' (not timed)'}"
                          for n, e in errs.items()), flush=True)
        runs = {n: [] for n in ns + ["matmul"]}
        for rep in range(args.reps):
            order = list(runs)
            k = rep % len(order)
            order = order[k:] + order[:k]
            if rep % 2:
                order.reverse()
            for n in order:
                if n == "matmul":
                    fn = lambda: [torch.matmul(x.t(), y) for x, y in pairs]  # noqa: E731
                else:
                    fn = lambda n=n: [wgrad_with(x, y, n) for x, y in pairs]  # noqa: E731
                runs[n].append(device_times(fn))
        tiles = bm._wgrad_tiles(C)
        print(f"{name}: M={M} Mpad={m_pad} C={C}, {tiles} output tiles per slice; device ms "
              f"for both products, mean [min, max] over {args.reps} rounds [{card}]", flush=True)
        for n, reads in runs.items():
            total = [r["pass"] + r["reduce"] + r["other"] for r in reads]
            row = dict(shape=name, M=M, C=C, slices=n, max_err=errs.get(n), total_ms=total,
                       pass_ms=[r["pass"] for r in reads], reduce_ms=[r["reduce"] for r in reads])
            if n == "matmul":
                what = "torch.matmul"
            else:
                what = (f"{n:2d} slices, {n * tiles:3d} blocks, partials "
                        f"{2 * n * 4 * C * C * 4 / 1e6:5.1f} MB{' (plan)' if n == plan else ''}")
                row["plan"] = n == plan
            mean = sum(total) / len(total)
            print(f"  {what:48s} {mean:.4f} [{min(total):.4f}, {max(total):.4f}]; pass "
                  f"{sum(row['pass_ms']) / len(total):.4f}, reduction "
                  f"{sum(row['reduce_ms']) / len(total):.4f}", flush=True)
            results.append(row)
        del pairs
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "reps": args.reps, "rows": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
