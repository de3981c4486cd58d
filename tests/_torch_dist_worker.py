"""One rank of the two-rank tests of the port's distribution
(tests/test_torch_port_dist*.py), on the CPU over gloo.

`revisiting_at_tpu_torch.parallel.launch.run_ranks` starts two of these with
RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set. The worker imports torch
and the port only: the test writes its inputs (weights, the global batch,
JAX's draws) with torch.save, and reads back what rank 0 writes. Every
process group has a finite timeout (parallel/mesh.py), so a rank that dies
fails the other instead of hanging it.

Usage: python tests/_torch_dist_worker.py <case> <spec.pt> <out.pt>
  step      a mesh, the model sharded over it, `steps` train steps on this
            rank's batch shard; rank 0 writes the metrics, the whole
            parameters, statistics and EMA (and eval logits before the
            first step, with `logits`); DropPath with `drop_path`, the
            augmentations with `augment`, mixup from the step's own
            stream with `mixup` (JAX's draws with `mixup_draws`)
  cli_train cli.train.main(spec["argv"]); each rank writes out.pt.<rank>
  cli_eval  cli.eval.main(spec["argv"]); each rank writes out.pt.<rank>
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)


def _model(spec):
    from revisiting_at_tpu_torch.ckpt.convert import load_state_dict, param_layout
    from revisiting_at_tpu_torch.models import ResNet, get_model

    if spec["arch"] == "resnet_small":  # tests/test_torch_port_bn.py's small ResNet
        model, family, layout = ResNet((1, 1, 1, 1), num_classes=spec["num_classes"]), \
            "resnet", "resnet"
    else:
        model, meta = get_model(spec["arch"], not_original=spec["not_original"],
                                num_classes=spec["num_classes"], dtype=torch.float32,
                                use_pallas=spec["use_pallas"], img_size=32,
                                drop_path_rate=spec.get("drop_path", 0.0))
        family, layout = meta.family, param_layout(spec["arch"])
    load_state_dict(model, spec["sd"])
    return model, family, layout


def step(spec):
    from revisiting_at_tpu_torch.config import DistSection
    from revisiting_at_tpu_torch.data import MixupConfig, RandAugmentConfig
    from revisiting_at_tpu_torch.parallel.mesh import MeshConfig, init_distributed, make_mesh
    from revisiting_at_tpu_torch.parallel.tp import apply_tensor_parallel
    from revisiting_at_tpu_torch.parallel.zero import ParallelModel
    from revisiting_at_tpu_torch.train import (AdvConfig, LRConfig, TrainState, ema_init,
                                               make_lr_schedule, make_optimizer,
                                               make_train_step)

    info = init_distributed(DistSection(), "cpu", timeout_s=120)
    mesh = make_mesh(MeshConfig(fsdp=spec.get("fsdp", 1), model=spec.get("tp", 1)))
    model, family, layout = _model(spec)
    tp_dims = apply_tensor_parallel(model, mesh, layout)
    par = ParallelModel(model, mesh, tp_dims)
    master = par.named_master()
    lr = spec["lr"]
    schedule = make_lr_schedule(LRConfig(**lr), 2) if isinstance(lr, dict) else lr
    opt = make_optimizer(model, optimizer=spec["optimizer"], weight_decay=spec["wd"],
                         momentum=0.9, family=family, learning_rate=schedule,
                         grad_accum=spec.get("grad_accum", 1), params=master)
    state = TrainState(model, opt, ema_init(model, master), parallel=par)
    draws = spec.get("mixup_draws")
    mixup = (MixupConfig(num_classes=spec["num_classes"])
             if draws is not None or spec.get("mixup") else None)
    train_step = make_train_step(model, adv=AdvConfig(attack=spec.get("attack", "apgd"),
                                                      n_iter=2), mixup=mixup,
                                 randaug=RandAugmentConfig() if spec.get("augment") else None,
                                 ema_decay=spec["ema"], seed=0,
                                 mixup_draws=(lambda s, h, w: draws[s]) if draws else None)
    images, labels = torch.from_numpy(spec["images"]), torch.from_numpy(spec["labels"])
    n = images.shape[0] // mesh.batch_count
    x = images[mesh.batch_rank * n:(mesh.batch_rank + 1) * n]
    y = labels[mesh.batch_rank * n:(mesh.batch_rank + 1) * n]
    out = {"fsdp_leaves": len(par.fsdp_dims), "tp_leaves": len(tp_dims),
           "batch_rank": mesh.batch_rank}
    if spec.get("logits"):
        model.eval()
        with torch.no_grad():
            out["logits"] = model(images).numpy()
        model.train()
    out["metrics"] = [{k: float(v) for k, v in train_step(state, x, y).items()}
                      for _ in range(spec["steps"])]
    out["params"] = {k: v.clone() for k, v in par.full_state_dict().items()}
    out["ema"] = par.full_ema(state.ema)
    if spec.get("refuse_no_rule"):
        out["refused"] = _no_rule_refusal(spec)
    mesh.release()
    if info.rank == 0:
        torch.save(out, sys.argv[3])
    dist.destroy_process_group()


def _no_rule_refusal(spec) -> str:
    """A trainer with dist.tp = 2 on a model no TP rule matches raises JAX's
    assert, releases its mesh's groups and leaves the caller's process
    group working."""
    from revisiting_at_tpu_torch.config import Config
    from revisiting_at_tpu_torch.train.trainer import Trainer

    cfg = Config()
    cfg.model.arch, cfg.model.add_normalization = "resnet50", 0
    cfg.data.num_classes, cfg.dist.tp = 10, 2
    cfg.resolution.min_res = cfg.resolution.max_res = cfg.validation.resolution = 32
    cfg.logging.folder = spec["folder"]
    try:
        Trainer(cfg, device="cpu", synthetic_batches=1)
    except AssertionError as e:
        t = torch.ones(1)
        dist.all_reduce(t)  # the caller's group still works
        assert dist.is_initialized() and float(t) == 2.0
        return str(e)
    raise AssertionError("no refusal")


def cli(spec, which):
    if which == "cli_train":
        from revisiting_at_tpu_torch.cli import train as entry
    else:
        from revisiting_at_tpu_torch.cli import eval as entry
    import os

    rank = int(os.environ["RANK"])
    res = entry.main(spec["argv"])
    if which == "cli_train":
        out = {"dir": str(res.logger.dir), "write": res.logger.write,
               "mesh": dict(res.mesh.shape), "step": res.state.step,
               "iters": res.iters_per_epoch, "lr": [res.lr_schedule(s) for s in range(4)],
               "weights": torch.cat([p.detach().reshape(-1) for p in res.model.parameters()]),
               "files": [list(map(str, getattr(res.train_data, "_loader").dataset.files))]
               if hasattr(res.train_data, "_loader") else None}
    else:
        out = {"res": res}
    out["pg_left"] = dist.is_initialized()
    torch.save(out, f"{sys.argv[3]}.{rank}")


def main():
    case = sys.argv[1]
    spec = torch.load(sys.argv[2], weights_only=False)
    np.random.seed(0)
    if case == "step":
        step(spec)
    else:
        cli(spec, case)


if __name__ == "__main__":
    main()
