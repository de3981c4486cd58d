"""Export a run's checkpoint to the reference's PyTorch format, port of
revisiting_at_tpu/cli/export.py.

    python -m revisiting_at_tpu_torch.cli.export --run_dir runs/model_... \
        --out weights.pt [--epoch N] [--best] [--use_ema 1]

Reads the run's params.json and its checkpoint as cli.eval finds it
(ckpt/checkpoint.py restore_run_weights): a port run's
ckpt[_best]/weights[_ema]_<e>.pt, or a JAX run's orbax snapshot where the
tensorstore package is installed. Writes a plain state_dict in the
reference format (timm-0.8 names; Meta's for convnext_iso; torchvision's,
running statistics included, for the BN family), f32 tensors under raw
keys, the file format of the reference's weights_{e}.pt. --use_ema 1 on a
run that kept no EMA is refused. The JAX exporter covers the ConvNeXt and
ViT families only; this one also writes the BN family (ROADMAP C22).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--out", type=str, required=True, help="output .pt path")
    p.add_argument("--epoch", type=int, default=-1, help="-1: latest checkpoint")
    p.add_argument("--best", action="store_true",
                   help="export the best-adv-val checkpoint (ckpt_best)")
    p.add_argument("--use_ema", type=int, default=0,
                   help="export the EMA weights (the reference's weights_ema_{e}.pt)")
    return p.parse_args(argv)


def main(argv=None) -> Path:
    """Write the file; returns its path."""
    args = get_args(argv)
    import torch

    from ..ckpt.checkpoint import restore_run_weights
    from ..config import load_params_json

    run_dir = Path(args.run_dir)
    cfg = load_params_json(run_dir / "params.json")
    sd, epoch = restore_run_weights(run_dir, cfg.model.arch, best=args.best, epoch=args.epoch,
                                    use_ema=bool(args.use_ema))
    torch.save(sd, args.out)
    which = "ema" if args.use_ema else "raw"
    print(f"exported {cfg.model.arch} ({which} params, ckpt step {epoch}) "
          f"-> {args.out} (timm-0.8 state_dict)")
    return Path(args.out)


if __name__ == "__main__":
    main(sys.argv[1:])
