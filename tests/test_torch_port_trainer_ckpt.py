"""Port parity of the rest of the trainer and the checkpoints: grad_accum,
adversarial validation, true resume, the best slot, remat, the profile
trace, the FLOP count, cli.eval finding a run's checkpoint, and the bridges
between the port's runs and the JAX package's (orbax) runs, on the CPU,
convnext_micro and vit_micro at 32 px, fp32, seeds drawn with numpy.

Tolerances:
  * grad_accum, two half batches against one full batch: the applied
    gradient within 1e-5 of max |g| per tensor (the mean of two half-batch
    means is the full-batch mean up to f32 summation order, which moves the
    stem's bias gradient by 1.2e-6 of it), the weights after one SGD step
    within 1e-6; against JAX's
    optax.MultiSteps over 4 micro-steps: `step_mismatches` of
    _torch_port_util (loss and grad_norm 1e-4 relative, accuracies equal,
    every parameter and EMA element within 1e-4), with the LR of the
    optimizer's update count: one read per micro-step moves the weights by
    about 1e-3 and fails it;
  * the adversarial-validation count: equal to JAX's (APGD starts at x,
    no draw; labels are the model's own, so the count is how many survive);
  * resume: bit for bit (torch.equal on every tensor of the full state,
    the weights and the EMA weights, equal step and counts);
  * remat: the loss and every gradient bit for bit (the recompute repeats
    the same operations on the same inputs and keeps);
  * the orbax reader and the .pt bridge: logits within 1e-5 of max |logit|
    (the same f32 weights through two frameworks' plain paths).

CPU time: 84 s of wall time and 111 s of CPU in one pytest process on 8
cores with an empty JAX compile cache, most of it JAX compiling its
reference programs (the MultiSteps step about 11 s, two APGD evaluations,
the models' forwards), the two cli.runner subprocesses (about 8 s; torch
on one thread there, as here) and the port's training runs (about 1-2 s
each).
"""

import functools
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import (NCLS, images, jax_mixup_draws, jax_params, model_pair,
                              shaped_params, step_mismatches)
from revisiting_at_tpu.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from revisiting_at_tpu.ckpt.torch_import import load_torch_checkpoint as jax_load_torch_checkpoint
from revisiting_at_tpu.config import Config as JaxConfig
from revisiting_at_tpu.data import mixup as jmix
from revisiting_at_tpu.models import get_model as jax_get_model
from revisiting_at_tpu.train import ema as jema
from revisiting_at_tpu.train import optimizer as jopt
from revisiting_at_tpu.train import schedule as jsched
from revisiting_at_tpu.train.state import TrainState as JaxState
from revisiting_at_tpu.train.train_step import AdvConfig as JaxAdv
from revisiting_at_tpu.train.train_step import make_adv_eval_step as jax_make_adv_eval_step
from revisiting_at_tpu.train.train_step import make_train_step as jax_make_train_step
from revisiting_at_tpu.utils.flops import forward_flops as jax_forward_flops
from revisiting_at_tpu.utils.flops import sizeof_fmt as jax_sizeof_fmt
from revisiting_at_tpu_torch.ckpt import orbax_reader
from revisiting_at_tpu_torch.ckpt.checkpoint import restore_run_weights
from revisiting_at_tpu_torch.ckpt.convert import jax_params_to_state_dict, load_state_dict
from revisiting_at_tpu_torch.cli import eval as eval_cli
from revisiting_at_tpu_torch.cli import runner
from revisiting_at_tpu_torch.cli import train as train_cli
from revisiting_at_tpu_torch.config import config_from_args
from revisiting_at_tpu_torch.data import MixupConfig
from revisiting_at_tpu_torch.models import get_model
from revisiting_at_tpu_torch.train import (AdvConfig, LRConfig, TrainState, ema_init,
                                           make_adv_eval_step, make_lr_schedule,
                                           make_optimizer, make_train_step)
from revisiting_at_tpu_torch.train.trainer import Trainer
from revisiting_at_tpu_torch.utils.flops import forward_flops, param_count, sizeof_fmt

torch.set_num_threads(1)
T = torch.from_numpy
REPO = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------ grad_accum

LR = dict(lr=2e-3, schedule_type="cosine", lr_peak_epoch=1, epochs=3)
WD, EMA = 0.5, 0.5


def _labels(n, seed):
    return np.random.RandomState(seed).randint(0, NCLS, n).astype(np.int32)


def test_grad_accum_two_halves_equal_one_full_batch_step():
    """k = 2 on two half batches applies one update, on the mean gradient,
    equal to k = 1 on the whole batch; the first micro-step moves nothing."""
    x, y = T(images(n=4, seed=3)), T(_labels(4, 4))
    grads, states = {}, {}
    for k in (1, 2):
        model, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS,
                             dtype=torch.float32)
        load_state_dict(model, _sd(jax_params("convnext_micro", True, 32, 0)))
        opt = make_optimizer(model, optimizer="sgd", weight_decay=WD, family="convnext",
                             learning_rate=0.1, grad_accum=k)
        state = TrainState(model, opt, ema_init(model))
        step = make_train_step(model, adv=AdvConfig(attack="none"), mixup=None,
                               ema_decay=EMA, seed=0)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        if k == 1:
            step(state, x, y)
        else:
            step(state, x[:2], y[:2])
            assert opt.count == 0 and opt.mini_step == 1
            assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
            step(state, x[2:], y[2:])
        assert opt.count == 1 and opt.mini_step == 0 and state.step == k
        grads[k] = {n: p.grad.clone() for n, p in model.named_parameters()}
        states[k] = {n: p.detach().clone() for n, p in model.named_parameters()}
    for n, g in grads[1].items():
        scale = float(g.abs().max())
        assert float((grads[2][n] - g).abs().max()) <= 1e-5 * max(scale, 1e-12), n
        assert float((states[2][n] - states[1][n]).abs().max()) <= 1e-6, n


def _sd(params, arch="convnext_micro"):
    return jax_params_to_state_dict(jax.tree.map(np.asarray, params), arch)


def test_grad_accum_matches_jax_multisteps(tmp_path):
    """4 micro-steps with grad_accum 2 against JAX's optax.MultiSteps step
    (mixup keyed on the micro-step, EMA after every micro-step, the LR of
    the update count on a schedule of iters_per_epoch // k); and the
    trainer's schedule is JAX's."""
    jm, _ = jax_get_model("convnext_micro", not_original=True, num_classes=NCLS,
                          dtype=jnp.float32)
    params = jax_params("convnext_micro", True, 32, 0)
    tx = jopt.make_optimizer(optimizer="adamw", weight_decay=WD, family="convnext",
                             learning_rate=jsched.make_lr_schedule(jsched.LRConfig(**LR), 2),
                             params=params, grad_accum=2)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                     ema_params=jema.ema_init(params))
    step = jax_make_train_step(jm, tx, adv=JaxAdv(attack="none"),
                               mixup=jmix.MixupConfig(num_classes=NCLS), ema_decay=EMA, seed=0,
                               donate=False)
    x, y = images(n=4, seed=3), _labels(4, 4)
    trajectory = []
    for _ in range(4):
        state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
        trajectory.append(({k: float(v) for k, v in metrics.items()}, _sd(state.params),
                           _sd(state.ema_params)))

    def port(schedule):
        model, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS,
                             dtype=torch.float32)
        load_state_dict(model, _sd(params))
        opt = make_optimizer(model, weight_decay=WD, family="convnext", learning_rate=schedule,
                             grad_accum=2)
        cfg = MixupConfig(num_classes=NCLS)
        st = make_train_step(model, adv=AdvConfig(attack="none"), mixup=cfg, ema_decay=EMA,
                             seed=0, mixup_draws=jax_mixup_draws(0, cfg))
        return TrainState(model, opt, ema_init(model)), st

    sched = make_lr_schedule(LRConfig(**LR), 2)
    port_state, port_step = port(sched)
    assert step_mismatches(port_state, port_step, trajectory, x, y) == []
    assert port_state.step == 4 and port_state.optimizer.count == 2
    # the LR read per micro-step instead: the weights leave the 1e-4 bound
    port_state, port_step = port(lambda c: sched(2 * c))
    assert any(b[1] == "param" for b in step_mismatches(port_state, port_step, trajectory, x, y))

    cfg = config_from_args(_flags(["--training.grad_accum", "2", "--logging.folder",
                                   str(tmp_path)]))
    trainer = Trainer(cfg, device="cpu", synthetic_batches=5)
    lr = cfg.lr
    ref = jsched.make_lr_schedule(jsched.LRConfig(
        lr=lr.lr, schedule_type=lr.lr_schedule_type, lr_peak_epoch=lr.lr_peak_epoch,
        step_ratio=lr.step_ratio, step_length=lr.step_length, epochs=cfg.training.epochs), 5 // 2)
    assert [trainer.lr_schedule(i) for i in range(6)] == pytest.approx(
        [float(ref(i)) for i in range(6)], rel=1e-6)


# -------------------------------------------------- adversarial validation

@pytest.mark.parametrize("arch", ["convnext_micro", "vit_micro"])
def test_adv_eval_count_matches_jax(arch):
    """The robust count of APGD-CE (3 steps, 1/255) on 8 images labelled by
    the model equals JAX's make_adv_eval_step on the same weights, and the
    step leaves the model in train mode as it found it."""
    params = shaped_params(arch, True, 32, 0) if arch == "vit_micro" else None
    jm, variables, tm = model_pair(arch, not_original=True, params=params)
    x = images(n=8, seed=5)
    with torch.no_grad():
        y = tm(T(x)).argmax(-1).numpy().astype(np.int32)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=variables["params"], opt_state=None)
    ref = int(jax_make_adv_eval_step(jm, adv=JaxAdv(attack="apgd", eps=1 / 255, n_iter=3))(
        jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0)))
    tm.train()
    got = int(make_adv_eval_step(tm, adv=AdvConfig(attack="apgd", eps=1 / 255, n_iter=3))(
        T(x), T(y)))
    assert got == ref and 0 < ref < 8
    assert tm.training and all(p.requires_grad for p in tm.parameters())


# ------------------------------------------------------ training runs

def _flags(extra=()):
    return ["--model.arch", "convnext_micro", "--model.not_original", "1",
            "--model.add_normalization", "0", "--model.model_ema", "1",
            "--adv.attack", "apgd", "--adv.n_iter", "2", "--data.dataset", "synthetic",
            "--data.num_classes", str(NCLS), "--training.batch_size", "4",
            "--training.epochs", "2", "--training.use_pallas", "1",
            "--training.precision", "fp32", "--resolution.min_res", "32",
            "--resolution.max_res", "32", "--validation.batch_size", "4",
            "--validation.resolution", "32", "--validation.max_batches", "1",
            "--logging.log_every_steps", "1", *extra]


def _argv(extra=(), batches=3):
    return _flags(extra) + ["--device", "cpu", "--synthetic_batches", str(batches)]


# every option of A7 on: grad_accum 2 over 3 batches (so that epoch 0 ends
# between the two micro-steps of an update), adversarial validation, remat
# with DropPath, the profile and the FLOP count
RUNS = {
    "convnext_micro": ["--training.grad_accum", "2", "--validation.adv_val_freq", "1",
                       "--validation.adv_val_iter", "2", "--validation.adv_val_batches", "1",
                       "--misc.log_flops", "1", "--misc.profile_steps", "1"],
    "vit_micro": ["--model.arch", "vit_micro", "--training.remat", "1",
                  "--model.drop_path_rate", "0.2", "--validation.adv_val_freq", "1",
                  "--validation.adv_val_iter", "1", "--validation.adv_val_batches", "1"],
}


@functools.lru_cache(maxsize=None)
def _trained(kind: str, root: str) -> Path:
    """A 2-epoch port run of RUNS[kind] under root (one per session)."""
    trainer = train_cli.main(_argv(RUNS[kind]) + ["--logging.folder", f"{root}/{kind}"])
    return trainer.logger.dir


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("runs"))


def _records(run: Path):
    return [json.loads(line) for line in (run / "log").read_text().splitlines()]


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("kind", list(RUNS))
def test_resume_is_bit_exact(root, kind, tmp_path):
    """A copy of run A without its epoch-1 files, resumed with
    --model.ckpt_path, writes epoch 1 as A did, bit for bit: the weights,
    the optimizer (state, update count, partial accumulation), the EMA,
    the step and the best accuracy."""
    run = _trained(kind, root)
    resumed = tmp_path / "B"
    shutil.copytree(run, resumed)
    for f in (resumed / "ckpt").glob("*_1.pt"):
        f.unlink()
    train_cli.main(_argv(RUNS[kind]) + ["--logging.folder", str(tmp_path),
                                        "--model.ckpt_path", str(resumed)])
    a = torch.load(run / "ckpt" / "state_1.pt", weights_only=True)
    b = torch.load(resumed / "ckpt" / "state_1.pt", weights_only=True)
    assert _same(a, b)
    assert a["step"] == 6 and a["epoch"] == 1 and a["ema"] is not None
    for name in ("weights_1.pt", "weights_ema_1.pt"):
        assert _same(torch.load(run / "ckpt" / name), torch.load(resumed / "ckpt" / name))
    log = _records(resumed)
    assert [r for r in log if r.get("event") == "resume"][0]["epoch"] == 0
    assert [r["epoch"] for r in log if "train_loss" in r] == [0, 1, 1]
    if kind == "convnext_micro":  # epoch 0 ended between two micro-steps
        s0 = torch.load(run / "ckpt" / "state_0.pt", weights_only=True)["optimizer"]
        assert s0["mini_step"] == 1 and s0["count"] == 1 and s0["acc"] is not None


def test_best_slot_and_records(root, tmp_path, monkeypatch):
    """adv_val records at the frequency and the last epoch; an improvement
    gives a best_adv record and replaces the best slot's one entry, which
    equals that epoch's checkpoint; a resumed run keeps the best accuracy."""
    run = _trained("convnext_micro", root)
    log = _records(run)
    adv = [r for r in log if r.get("event") == "adv_val"]
    assert [r["epoch"] for r in adv] == [0, 1] and all(r["points"] == 4 for r in adv)
    best = [r["epoch"] for r in log if r.get("event") == "best_adv"]
    assert best[0] == 0 and sorted(p.name for p in (run / "ckpt_best").iterdir()) == [
        f"{k}_{best[-1]}.pt" for k in ("state", "weights", "weights_ema")]
    assert _same(torch.load(run / "ckpt_best" / f"weights_{best[-1]}.pt"),
                 torch.load(run / "ckpt" / f"weights_{best[-1]}.pt"))

    scripted = iter([0.25, 0.5])
    monkeypatch.setattr(Trainer, "adv_val", lambda self: (next(scripted), 4))
    extra = ["--validation.adv_val_freq", "2", "--training.epochs", "4",
             "--logging.folder", str(tmp_path)]
    trainer = train_cli.main(_argv(extra, batches=1))
    run = trainer.logger.dir
    log = _records(run)
    assert [(r["epoch"], r["adv_acc"]) for r in log if r.get("event") == "adv_val"] == [
        (1, 0.25), (3, 0.5)]
    assert [r["epoch"] for r in log if r.get("event") == "best_adv"] == [1, 3]
    in_slot = ["state_3.pt", "weights_3.pt", "weights_ema_3.pt"]
    assert sorted(p.name for p in (run / "ckpt_best").iterdir()) == in_slot
    # resumed from epoch 2 (epoch 3's files gone), the best so far is epoch
    # 1's 0.25 (ROADMAP C18; JAX's resumed run starts from -1): a worse
    # epoch 3 does not replace the slot
    for f in (run / "ckpt").glob("*_3.pt"):
        f.unlink()
    monkeypatch.setattr(Trainer, "adv_val", lambda self: (0.2, 4))
    n = len(log)
    resumed = train_cli.main(_argv(extra + ["--model.ckpt_path", str(run)], batches=1))
    assert resumed.start_epoch == 3 and resumed.best_adv_acc == 0.25
    assert not [r for r in _records(run)[n:] if r.get("event") == "best_adv"]
    assert sorted(p.name for p in (run / "ckpt_best").iterdir()) == in_slot


# ------------------------------------------------------------------ remat

def _loss_and_grads(arch, remat, params):
    model, _ = get_model(arch, not_original=True, num_classes=NCLS, dtype=torch.float32,
                         use_pallas=True, drop_path_rate=0.2, img_size=32, remat=remat)
    load_state_dict(model, _sd(params, arch))
    model.train()
    calls = []
    blocks = model.blocks if arch == "vit_micro" else [b for s in model.stages for b in s.blocks]
    for blk in blocks:  # count each block's body runs: remat runs it again in the backward
        blk.body = functools.partial(lambda f, *a: calls.append(1) or f(*a), blk.body)
    model.drop_generator = torch.Generator().manual_seed(7)
    x = T(images(n=4, seed=3)).requires_grad_(True)
    loss = torch.nn.functional.cross_entropy(model(x), T(_labels(4, 4)).long())
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return loss.detach(), grads, x.grad, len(calls) // len(blocks)


@pytest.mark.parametrize("arch", ["convnext_micro", "vit_micro"])
def test_remat_matches_no_remat_with_drop_path(arch):
    """remat=1 recomputes every block in the backward and gives the loss,
    every weight gradient and the input gradient of remat=0, bit for bit,
    with DropPath at 0.2 (its keeps drawn before the checkpointed call)
    through the fused tail's autograd.Function (its plain version here);
    vit_micro takes remat too (ROADMAP C8: JAX's factory drops it there)."""
    params = shaped_params(arch, True, 32, 0) if arch == "vit_micro" else jax_params(
        arch, True, 32, 0)
    loss0, g0, x0, runs0 = _loss_and_grads(arch, False, params)
    loss1, g1, x1, runs1 = _loss_and_grads(arch, True, params)
    assert (runs0, runs1) == (1, 2)
    assert torch.equal(loss0, loss1) and torch.equal(x0, x1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)


# ------------------------------------------------------- profile and flops

def test_profile_trace_written_and_logged(root):
    """profile_steps 1 traces step 1 of the first epoch into <run>/trace/ as
    a chrome trace of the step's operators, logged as trace_written; the
    init record holds forward_flops and its convention."""
    run = _trained("convnext_micro", root)
    log = _records(run)
    written = [r for r in log if r.get("event") == "trace_written"]
    assert len(written) == 1 and Path(written[0]["dir"]) == run / "trace"
    trace = json.loads(Path(written[0]["path"]).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert "aten::linear" in names or "aten::addmm" in names
    init = log[0]
    model, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS,
                         dtype=torch.float32)
    assert init["forward_flops"] == forward_flops(model, (1, 32, 32, 3))
    assert "2 per multiply-add" in init["flops_convention"]


@pytest.fixture(scope="module")
def micro():
    model, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS,
                         dtype=torch.float32)
    return model


def test_forward_flops_sane(micro):
    """JAX's test_flops.py checks: above 2 * params, 32 -> 64 px 3.0-4.5x;
    and below JAX's XLA count, which adds the elementwise operations."""
    f32 = forward_flops(micro, (1, 32, 32, 3))
    assert f32 > 2 * param_count(micro) > 0
    assert 3.0 < forward_flops(micro, (1, 64, 64, 3)) / f32 < 4.5
    jm, _ = jax_get_model("convnext_micro", not_original=True, num_classes=NCLS,
                          dtype=jnp.float32)
    assert f32 < jax_forward_flops(jm, {"params": jax_params("convnext_micro", True, 32, 0)},
                                   input_shape=(1, 32, 32, 3))


def test_flops_batch_scaling_on_meta(micro):
    """batch 1 -> 4 gives 3.5-4.5x, and a twin on the meta device counts
    what the CPU model does."""
    f1 = forward_flops(micro, (1, 32, 32, 3))
    assert 3.5 < forward_flops(micro, (4, 32, 32, 3)) / f1 < 4.5
    with torch.device("meta"):
        twin, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS)
    assert forward_flops(twin, (1, 32, 32, 3)) == f1


@pytest.mark.parametrize("n", [1.5e9, 123.0, 4.2e13])
def test_sizeof_fmt_matches_jax(n):
    assert sizeof_fmt(n) == jax_sizeof_fmt(n)


# ----------------------------------------------------- cli.eval, the port

@functools.lru_cache(maxsize=None)
def _no_ema_run(root) -> Path:
    trainer = train_cli.main(_argv(["--model.model_ema", "0", "--training.epochs", "1"],
                                   batches=1) + ["--logging.folder", f"{root}/no_ema"])
    return trainer.logger.dir


def test_restore_run_weights_picks_epoch_best_and_ema(root):
    run = _trained("convnext_micro", root)
    best = [r["epoch"] for r in _records(run) if r.get("event") == "best_adv"][-1]
    cases = [(dict(), "ckpt/weights_1.pt", 1), (dict(epoch=0), "ckpt/weights_0.pt", 0),
             (dict(use_ema=True), "ckpt/weights_ema_1.pt", 1),
             (dict(best=True, use_ema=True), f"ckpt_best/weights_ema_{best}.pt", best)]
    for kw, name, epoch in cases:
        sd, e = restore_run_weights(run, "convnext_micro", **kw)
        assert e == epoch and _same(sd, torch.load(run / name, weights_only=True)), kw
    with pytest.raises(FileNotFoundError, match="epoch 5"):
        restore_run_weights(run, "convnext_micro", epoch=5)


def test_eval_cli_finds_the_checkpoint_and_refuses_missing_ema(root, capsys):
    """cli.eval without --torch_ckpt: --epoch, --best and --use_ema pick the
    file (its clean accuracy is that of the same file through
    --torch_ckpt); --use_ema 1 on a run without EMA raises JAX's error."""
    run = _trained("convnext_micro", root)
    base = ["--run_dir", str(run), "--device", "cpu", "--synthetic", "--n_ex", "8",
            "--batch_size", "8", "--img_size", "32", "--only_clean", "--use_pallas", "1"]
    for flags, name in ((["--epoch", "0"], "ckpt/weights_0.pt"),
                        (["--best", "--use_ema", "1"], None)):
        got = eval_cli.main(base + flags)
        said = capsys.readouterr().out
        epoch = int(said.split("weights: ")[1].split("epoch ")[1].split()[0])
        name = name or f"ckpt_best/weights_ema_{epoch}.pt"
        assert eval_cli.main(base + ["--torch_ckpt", str(run / name)]) == got
    no_ema = _no_ema_run(root)
    with pytest.raises(ValueError, match="kept no EMA"):
        eval_cli.main(["--run_dir", str(no_ema), "--device", "cpu", "--synthetic",
                       "--use_ema", "1", "--img_size", "32", "--n_ex", "4", "--only_clean"])


def test_resume_refuses_a_different_ema_setting(root, tmp_path):
    """A run saved without EMA does not resume with model.model_ema 1."""
    run = _no_ema_run(root)
    with pytest.raises(ValueError, match="EMA"):
        train_cli.main(_argv(["--training.epochs", "2"], batches=1)
                       + ["--logging.folder", str(tmp_path), "--model.ckpt_path", str(run)])


# -------------------------------------------------- JAX runs and the port

def _jax_run(run: Path, arch: str, ema: bool) -> dict:
    """A JAX run dir written by JAX's own CheckpointManager: params.json and
    orbax snapshots of epochs 0 and 1 (epoch 1 also in the best slot), the
    EMA a second set of weights. Returns {collection: params} of epoch 1."""
    cfg = JaxConfig()
    cfg.model.arch, cfg.model.not_original, cfg.model.add_normalization = arch, 1, 0
    cfg.data.num_classes = NCLS
    run.mkdir(parents=True)
    cfg.dump_params_json(run / "params.json")
    params = shaped_params(arch, True, 32, 0) if arch == "vit_micro" else jax_params(
        arch, True, 32, 0)
    tx = jopt.make_optimizer(optimizer="adamw", weight_decay=WD, family="convnext",
                             learning_rate=1e-3, params=params)
    mgr = JaxCheckpointManager(run)
    out = {}
    for epoch in (0, 1):
        p = jax.tree.map(lambda v: v * (1.0 + 0.1 * epoch), params)
        e = jax.tree.map(lambda v: v * 0.9 - 0.01, p) if ema else None
        state = JaxState(step=jnp.asarray(epoch, jnp.int32), params=p,
                         opt_state=tx.init(p), ema_params=e)
        mgr.maybe_save(epoch, state)
        out = {"params": p, "ema_params": e}
    mgr.save_best(1, state)
    mgr.wait()
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_runs")
    return {"convnext_micro": (root / "cnx", _jax_run(root / "cnx", "convnext_micro", True)),
            "no_ema": (root / "no_ema", _jax_run(root / "no_ema", "convnext_micro", False))}


def _jax_logits(arch, params, x):
    jm, _ = jax_get_model(arch, not_original=True, num_classes=NCLS, dtype=jnp.float32)
    return np.asarray(jax.jit(lambda p, xx: jm.apply({"params": p}, xx, train=False))(
        params, jnp.asarray(x)))


def _port_logits(arch, sd, x):
    model, _ = get_model(arch, not_original=True, num_classes=NCLS, dtype=torch.float32,
                         img_size=32)
    load_state_dict(model, sd)
    with torch.no_grad():
        return model.eval()(T(x)).numpy()


@pytest.mark.parametrize("collection", ["params", "ema_params"])
def test_orbax_reader_gives_jax_logits(jax_runs, collection):
    """A JAX run written by JAX's CheckpointManager, read by the port's
    orbax reader (no JAX, no orbax): the latest epoch, its params or EMA,
    give the logits JAX gives, and --best reads the best slot."""
    run, saved = jax_runs["convnext_micro"]
    assert orbax_reader.steps(run / "ckpt") == [0, 1]
    x = images(n=2, seed=6)
    ref = _jax_logits("convnext_micro", saved[collection], x)
    for best in (False, True):
        sd, epoch = restore_run_weights(run, "convnext_micro", best=best,
                                        use_ema=collection == "ema_params")
        got = _port_logits("convnext_micro", sd, x)
        assert epoch == 1 and np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_jax_run_without_ema_is_refused(jax_runs):
    run, _ = jax_runs["no_ema"]
    assert orbax_reader.read_params(run / "ckpt" / "1", "ema_params") is None
    with pytest.raises(ValueError, match="kept no EMA"):
        restore_run_weights(run, "convnext_micro", use_ema=True)
    sd, _ = restore_run_weights(run, "convnext_micro", epoch=0)
    assert "head.fc.weight" in sd


def test_orbax_reader_without_tensorstore_names_the_export(jax_runs, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="revisiting_at_tpu.cli.export"):
        orbax_reader.read_params(jax_runs["convnext_micro"][0] / "ckpt" / "0")


def test_orbax_reader_imports_neither_jax_nor_tensorstore():
    code = ("import sys; import revisiting_at_tpu_torch.ckpt.orbax_reader, "
            "revisiting_at_tpu_torch.ckpt.checkpoint, revisiting_at_tpu_torch.cli.eval; "
            "bad = {'jax', 'tensorstore', 'orbax', 'flax'} & set(sys.modules); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)


@pytest.mark.parametrize("kind", list(RUNS))
def test_port_weights_load_into_jax(root, kind):
    """The reverse bridge: a port run's weights_<e>.pt strict-loaded by
    JAX's ckpt/torch_import.py gives the port's logits."""
    run = _trained(kind, root)
    arch = "vit_micro" if kind == "vit_micro" else "convnext_micro"
    path = run / "ckpt" / "weights_ema_1.pt"
    target = shaped_params(arch, True, 32, 0) if arch == "vit_micro" else jax_params(
        arch, True, 32, 0)
    params = jax_load_torch_checkpoint(str(path), arch, target, not_original=True)
    x = images(n=2, seed=6)
    ref = _port_logits(arch, torch.load(path, weights_only=True), x)
    got = _jax_logits(arch, params, x)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_runner_over_a_port_run_and_a_jax_run(root, jax_runs, capfd, monkeypatch):
    """cli.runner runs one job per run, each reading its own checkpoint (a
    port run's .pt, a JAX run's orbax snapshot), with no --torch_ckpt."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the jobs' torch: one thread, as this process
    runs = [str(_trained("convnext_micro", root)), str(jax_runs["convnext_micro"][0])]
    runner.main(["--runs", *runs, "--l_norms", "Linf", "--img_sizes", "32", "--n_ex", "2",
                 "--batch_size", "2", "--", "--device", "cpu", "--synthetic", "--n_iter", "1",
                 "--use_ema", "1"])
    out = capfd.readouterr().out
    assert out.count("-> exit 0") == 2
    assert out.count("weights: ckpt epoch 1 (EMA)") == 2
