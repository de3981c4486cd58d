"""The port's distributed entry points on the CPU, two gloo ranks each
(tests/_torch_dist_worker.py, torch and the port only), against the port's
single-process runs, which the other test files hold to JAX:

  * `cli.train` at world 2 with dist.fsdp 2 on a small ImageFolder tree
    (cached decodes, no loader workers): the two ranks' train shards
    partition the files; rank 0 alone writes the run (one run dir, one
    log, the checkpoints); a world-2 resume from epoch 0 gives epoch 1's
    full state bit for bit; the single-process `cli.eval` reads the run;
    on 15 files at batch 4 (shards of 8 and 7) both ranks take JAX's one
    step an epoch, the same LR schedule and the same weights;
  * `cli.eval --multihost 1` at world 2: both ranks log the same global
    robust accuracy over all points, each rank's per-point result is a
    single-process AutoAttack run on its round-robin shard, and
    --save_imgs writes _r0/_r1 files; `--tp 2` gives the single-process
    clean accuracy; `--shard_eval 1` on one device says so.

Equality, not a tolerance: the same process layout on the same inputs
runs the same float operations (a resume restores the exact state; a
rank's shard is attacked as a single process attacks it).

CPU time: about 30 s in one process here (six two-rank runs, 2-4 s of
start-up a rank, and the single-process comparisons).
"""

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from revisiting_at_tpu_torch.ckpt.convert import save_torch_checkpoint
from revisiting_at_tpu_torch.cli import eval as eval_cli
from revisiting_at_tpu_torch.config import Config
from revisiting_at_tpu_torch.models import get_model
from revisiting_at_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")


def run_workers(tmp_path, case, argv, tag):
    spec_path, out = tmp_path / f"{tag}_spec.pt", tmp_path / f"{tag}_out.pt"
    torch.save({"argv": argv}, spec_path)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    outs = run_ranks([sys.executable, WORKER, case, str(spec_path), str(out)], 2, 240,
                     env=env, cwd=REPO)
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)], outs


def make_tree(root: Path, per_class: int, seed: int) -> Path:
    rng = np.random.RandomState(seed)
    for c in range(2):
        d = root / f"n0{c}"
        d.mkdir(parents=True)
        for i in range(per_class):
            img = rng.randint(0, 256, (40 + 4 * (i % 3), 48, 3)).astype(np.uint8)
            Image.fromarray(img).save(d / f"img_{c}_{i}.png")
    return root


TRAIN = ["--model.arch", "convnext_micro", "--model.not_original", "1",
         "--model.add_normalization", "0", "--model.model_ema", "1", "--adv.attack", "apgd",
         "--adv.n_iter", "2", "--data.dataset", "folder", "--data.num_classes", "2",
         "--data.in_memory", "1", "--training.batch_size", "2", "--training.epochs", "2",
         "--training.precision", "fp32", "--training.use_pallas", "1",
         "--resolution.min_res", "32", "--resolution.max_res", "32",
         "--validation.batch_size", "2", "--validation.resolution", "32",
         "--validation.max_batches", "2", "--dist.fsdp", "2", "--device", "cpu"]


def _state(path):
    return torch.load(path, weights_only=True)


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def test_train_cli_world2_fsdp_writes_once_and_resumes_bit_for_bit(tmp_path):
    train = make_tree(tmp_path / "train", 8, 0)
    val = make_tree(tmp_path / "val", 2, 1)
    folder = tmp_path / "runs"
    argv = TRAIN + ["--data.train_dataset", str(train), "--data.val_dataset", str(val),
                    "--logging.folder", str(folder)]
    outs, _ = run_workers(tmp_path, "cli_train", argv, "a")
    # the shards partition the train files
    f0, f1 = (set(o["files"][0]) for o in outs)
    assert not f0 & f1 and len(f0 | f1) == 16 and len(f0) == 8
    # rank 0 alone writes, in the one run dir both ranks name
    assert [o["write"] for o in outs] == [True, False] and outs[0]["dir"] == outs[1]["dir"]
    assert [o["mesh"] for o in outs] == [{"data": 1, "fsdp": 2, "model": 1}] * 2
    assert not any(o["pg_left"] for o in outs) and outs[0]["step"] == 8
    run = Path(outs[0]["dir"])
    assert [p.name for p in folder.iterdir()] == [run.name]
    records = [json.loads(line) for line in (run / "log").read_text().splitlines()]
    init = records[0]
    assert init["devices"] == 2 and init["fsdp_sharded_leaves"] > 0 and init["rank"] == 0
    assert records[-1]["event"] == "final_val" and records[-1]["points"] == 4  # 2 x 2 val
    assert sorted(p.name for p in (run / "ckpt").iterdir()) == [
        f"{k}_{e}.pt" for k in ("state", "weights", "weights_ema") for e in (0, 1)]
    # a world-2 resume from epoch 0 gives epoch 1's state bit for bit
    resumed = tmp_path / "resumed" / run.name
    shutil.copytree(run, resumed)
    for name in ("state_1.pt", "weights_1.pt", "weights_ema_1.pt"):
        (resumed / "ckpt" / name).unlink()
    outs_b, _ = run_workers(tmp_path, "cli_train", argv + ["--model.ckpt_path", str(resumed)],
                            "b")
    assert outs_b[0]["dir"] == str(resumed) and outs_b[0]["step"] == 8
    assert _equal(_state(resumed / "ckpt" / "state_1.pt"), _state(run / "ckpt" / "state_1.pt"))
    # the single-process evaluator reads the distributed run (strict load)
    res = eval_cli.main(["--run_dir", str(run), "--device", "cpu", "--synthetic", "--n_ex",
                         "2", "--batch_size", "2", "--img_size", "32", "--n_iter", "1",
                         "--use_ema", "1", "--use_pallas", "1"])
    assert res["Linf"]["n"] == 2


def test_train_cli_world2_uneven_shards_take_the_same_steps(tmp_path):
    """15 train files over two ranks at batch 4: rank 0's shard holds 8
    files (two batches), rank 1's 7 (one). Both take JAX's count, 15 // (4
    * 2) = 1 step an epoch (revisiting_at_tpu/data/folder.py:190), build the
    same LR schedule and end with the same weights; a rank that took a
    step more would run a collective the other never joins."""
    train = make_tree(tmp_path / "train", 8, 0)
    (train / "n01" / "img_1_7.png").unlink()
    argv = TRAIN[:TRAIN.index("--dist.fsdp")] + ["--device", "cpu"]  # data = 2
    argv[argv.index("--training.batch_size") + 1] = "4"
    argv[argv.index("--training.epochs") + 1] = "1"
    argv += ["--data.train_dataset", str(train), "--logging.folder", str(tmp_path / "runs")]
    outs, _ = run_workers(tmp_path, "cli_train", argv, "uneven")
    assert [len(o["files"][0]) for o in outs] == [8, 7]
    assert [o["iters"] for o in outs] == [1, 1] and [o["step"] for o in outs] == [1, 1]
    assert outs[0]["lr"] == outs[1]["lr"]
    assert torch.equal(outs[0]["weights"], outs[1]["weights"])
    assert not any(o["pg_left"] for o in outs)


@pytest.fixture()
def eval_run(tmp_path):
    """A convnext_micro run dir of 2 classes: params.json and weights."""
    run = tmp_path / "run"
    run.mkdir()
    cfg = Config()
    cfg.model.arch, cfg.model.not_original, cfg.model.add_normalization = "convnext_micro", 1, 0
    cfg.data.num_classes = 2
    cfg.dump_params_json(run / "params.json")
    torch.manual_seed(0)
    model, _ = get_model("convnext_micro", not_original=True, num_classes=2)
    for blk in (b for st in model.stages for b in st.blocks):
        torch.nn.init.uniform_(blk.gamma, 0.1, 1.0)
    save_torch_checkpoint(model, run / "w.pt")
    return run


EVAL = ["--device", "cpu", "--synthetic", "--n_ex", "8", "--batch_size", "4", "--n_iter",
        "2", "--img_size", "32", "--eps", "0.02", "--use_pallas", "1"]


def test_eval_cli_multihost_sums_the_shards(eval_run, tmp_path):
    base = ["--run_dir", str(eval_run), "--torch_ckpt", str(eval_run / "w.pt")] + EVAL
    outs, _ = run_workers(tmp_path, "cli_eval", base + ["--multihost", "1", "--save_imgs"], "mh")
    res = [o["res"]["Linf"] for o in outs]
    assert res[0]["robust"] == res[1]["robust"] and res[0]["n"] == res[1]["n"] == 8
    assert not any(o["pg_left"] for o in outs)
    # each rank's points are a single-process run on its round-robin shard
    from revisiting_at_tpu_torch.ckpt.convert import load_torch_checkpoint
    from revisiting_at_tpu_torch.evals import SHORT_ATTACKS, AutoAttack, AutoAttackConfig
    from revisiting_at_tpu_torch.train import input_grad_view

    model, _ = get_model("convnext_micro", not_original=True, num_classes=2,
                         dtype=torch.bfloat16, use_pallas=True, img_size=32)
    load_torch_checkpoint(eval_run / "w.pt", model)
    view = input_grad_view(model.eval().requires_grad_(False))
    x, y = eval_cli.load_eval_set(eval_cli.get_args(base), 2)
    points = []
    for r in range(2):
        aa = AutoAttack(view, AutoAttackConfig(norm="Linf", eps=0.02, attacks_to_run=SHORT_ATTACKS,
                                               n_iter=2, batch_size=4, verbose=False),
                        device="cpu")
        points.append(aa.run_standard_evaluation(x[r::2], y[r::2])[1])
        assert res[r]["points"] == points[r].tolist(), r
        adv = np.load(eval_run / f"aa_adv_8_Linf_0.02000_r{r}.npy")
        assert adv.shape == (4, 32, 32, 3)
    assert res[0]["robust"] == np.concatenate(points).mean()
    log = (eval_run / "evaluated_logs_Linf_0.txt").read_text()
    assert log.count("robust accuracy (Linf)") == 1 and "(8 pts)" in log


def test_eval_cli_tp_and_shard_eval(eval_run, tmp_path, capfd):
    base = ["--run_dir", str(eval_run), "--torch_ckpt", str(eval_run / "w.pt")] + EVAL[:-2] + [
        "--only_clean", "--use_pallas", "0"]
    single = eval_cli.main(base + ["--shard_eval", "1"])["Linf"]
    assert "one cpu device" in capfd.readouterr().out
    outs, _ = run_workers(tmp_path, "cli_eval", base + ["--tp", "2"], "tp")
    for o in outs:
        assert o["res"]["Linf"]["n"] == 8 and o["res"]["Linf"]["clean"] == single["clean"]
        assert o["res"]["Linf"]["points"] == single["points"]
    with pytest.raises(SystemExit, match="use_pallas"):
        eval_cli.main(base[:-2] + ["--tp", "2", "--use_pallas", "1"])
