"""Evaluation job runner, port of revisiting_at_tpu/cli/runner.py.

Expands a job table (runs x norms x image sizes) and runs one
`python -m revisiting_at_tpu_torch.cli.eval` process per job, one after
another, each on the whole card (the reference's runner_aa_eval.py forks
one AA_eval.py per free GPU). Exits 1 if any job failed.

The arguments after `--` go to every job unchanged (for example
`--use_ema 1`, `--best`, `--epoch N`, `--device`, `--use_pallas`,
`--synthetic`). Each job reads its own run's checkpoint (cli.eval without
`--torch_ckpt`), so the runs of one table may be port runs and JAX runs
alike, each with its own weights.

Usage:
  python -m revisiting_at_tpu_torch.cli.runner \
      --runs runs/run_a runs/run_b --l_norms Linf,L2 --img_sizes 224,256 \
      [--full_aa 1] [--n_ex 5000] [--batch_size 200] [--data_dir ...] [--dry_run] \
      [-- --use_ema 1 --use_pallas 1 ...]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]

    p = argparse.ArgumentParser()
    p.add_argument("--runs", nargs="+", required=True)
    p.add_argument("--l_norms", type=str, default="Linf")
    p.add_argument("--img_sizes", type=str, default="224")
    p.add_argument("--full_aa", type=int, default=0)
    p.add_argument("--n_ex", type=int, default=5000)
    p.add_argument("--batch_size", type=int, default=200)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--dry_run", action="store_true", help="print the job table only")
    args = p.parse_args(argv)

    jobs = []
    for run in args.runs:
        for norm in args.l_norms.split(","):
            for size in args.img_sizes.split(","):
                cmd = [sys.executable, "-m", "revisiting_at_tpu_torch.cli.eval",
                       "--run_dir", run, "--l_norms", norm, "--img_size", size,
                       "--full_aa", str(args.full_aa), "--n_ex", str(args.n_ex),
                       "--batch_size", str(args.batch_size)]
                if args.data_dir:
                    cmd += ["--data_dir", args.data_dir]
                jobs.append(cmd + extra)

    print(f"runner: {len(jobs)} eval jobs queued", flush=True)
    failures = 0
    for i, cmd in enumerate(jobs):
        print(f"[{i + 1}/{len(jobs)}] {' '.join(cmd)}", flush=True)
        if args.dry_run:
            continue
        t0 = time.time()
        rc = subprocess.call(cmd)
        print(f"  -> exit {rc} in {time.time() - t0:.0f}s", flush=True)
        failures += rc != 0
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
