"""Training entry point, port of revisiting_at_tpu/cli/train.py.

  python -m revisiting_at_tpu_torch.cli.train \
      --model.arch convnext_tiny --model.not_original 1 --model.add_normalization 0 \
      --adv.attack apgd --adv.n_iter 2 --model.model_ema 1 --training.use_pallas 1 \
      --data.dataset synthetic --training.batch_size 80 [--device cuda]

The flags are the JAX CLI's flat `--section.param value` (or `=value`), so a
run's params.json keeps the JAX contract. Two more flags are the port's and
are parsed first: `--device` (default cuda; without CUDA the CLI exits with
an error, and `--device cpu` runs on the CPU) and `--synthetic_batches`
(batches per synthetic epoch, default 64 as in the JAX package).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    """Train; returns the Trainer (its logger.dir is the run directory)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--synthetic_batches", type=int, default=64)
    args, rest = ap.parse_known_args(argv)

    import torch

    from ..config import config_from_args
    from ..train.trainer import Trainer

    cfg = config_from_args(rest)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available (pass --device cpu "
                         "to train on the CPU)")
    trainer = Trainer(cfg, device=device, synthetic_batches=args.synthetic_batches)
    if cfg.training.eval_only:
        acc, n = trainer.single_val()
        trainer.logger.log({"eval_only_acc": acc, "points": n})
        return trainer
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
