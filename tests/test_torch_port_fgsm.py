"""Port parity of FGSM training: attacks/fgsm.py, the FGSM arm of
train/train_step.py on the dwconv route, the trainer's FGSM config and the
train CLI of revisiting_at_tpu_torch against the JAX package, on the CPU,
with JAX's random draws injected (mixup through `mixup_draws`, FGSM's
uniform start through `attack_draws`). About 50 s of CPU time on one core,
most of it the JAX step's interpret-mode compile.

Tolerances:
  * fgsm_train on a linear model: 1e-6 absolute. The same f32 arithmetic
    on the same draw; the input gradient's sign decides the step, and with
    random weights no component is near enough to zero to flip.
  * 2 FGSM steps on convnext_micro with use_pallas=1 and
    use_pallas_dwconv=1: as tests/test_torch_port_train.py, loss and
    grad_norm to 1e-4 relative, accuracies equal, every parameter and EMA
    element within 1e-4.
Negative controls: the FGSM step with alpha 1.0 in place of 1.25, and
adv_acc scored on the mixup targets in place of the hard labels (C3),
each fail the comparison.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import (NCLS, dwconv_step_batch, images, jax_dwconv_trajectory,
                              port_dwconv_step, step_mismatches)
from revisiting_at_tpu.attacks import fgsm_train as jax_fgsm_train
from revisiting_at_tpu.train.train_step import AdvConfig as JaxAdv
from revisiting_at_tpu_torch.attacks import fgsm_train
from revisiting_at_tpu_torch.cli import eval as eval_cli
from revisiting_at_tpu_torch.cli import train as train_cli
from revisiting_at_tpu_torch.config import config_from_args
from revisiting_at_tpu_torch.ops import dwconv as tdw
from revisiting_at_tpu_torch.ops.losses import is_correct
from revisiting_at_tpu_torch.train import AdvConfig
from revisiting_at_tpu_torch.train import train_step as tstep
from revisiting_at_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)
T = torch.from_numpy
EPS = 8.0 / 255.0  # fgsm_train's tests; the train steps keep the configs' 4/255


# ------------------------------------------------------------ fgsm_train

@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("skip_projection", [False, True])
@pytest.mark.parametrize("use_rs", [False, True])
def test_fgsm_train_matches_jax(use_rs, skip_projection, soft):
    """The FGSM point on a linear model, int labels or soft targets, with
    JAX's uniform draw injected as `noise`."""
    rng = np.random.RandomState(0)
    x = images(n=6, img=8, seed=2)
    wm = rng.randn(8 * 8 * 3, NCLS).astype(np.float32)
    y = rng.randint(0, NCLS, 6)
    if soft:
        y = (0.7 * np.eye(NCLS)[y] + 0.3 * np.eye(NCLS)[y[::-1]]).astype(np.float32)
    key = jax.random.PRNGKey(3)
    kw = dict(eps=EPS, alpha=1.25, use_rs=use_rs, noise_level=1.0,
              skip_projection=skip_projection)
    ref = jax_fgsm_train(lambda xx: xx.reshape(6, -1) @ jnp.asarray(wm), jnp.asarray(x),
                         jnp.asarray(y), rng=key, **kw)
    noise = T(np.array(jax.random.uniform(key, x.shape, jnp.float32)))
    got = fgsm_train(lambda xx: xx.reshape(6, -1) @ T(wm), T(x), T(y), noise=noise, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    step = np.abs(got.numpy() - x)
    if skip_projection:  # the step leaves the ball where the start was near its edge
        assert step.max() > EPS * 1.01
    else:
        assert step.max() <= EPS * (1 + 1e-6) and got.min() >= 0 and got.max() <= 1


def test_fgsm_train_draws_from_generator():
    """Without injected noise the start comes from the generator: the same
    seed gives the same point, another seed another."""
    x = T(images(n=2, img=8, seed=2))
    y = torch.tensor([1, 2])
    f = lambda xx: xx.reshape(2, -1)[:, :NCLS] * 3.0  # noqa: E731
    a, b, c = (fgsm_train(f, x, y, eps=EPS, use_rs=True,
                          generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)


# ------------------------------------------------------- the train steps

@pytest.fixture(scope="module")
def fgsm_trajectory():
    return jax_dwconv_trajectory(JaxAdv(attack="fgsm", alpha=1.25), 2)


def test_fgsm_train_step_matches_jax(fgsm_trajectory, monkeypatch):
    """2 FGSM steps on the dwconv route: metrics, parameters and EMA. The
    attack's backward runs dx alone; the training backward dx and dw."""
    params, trajectory = fgsm_trajectory
    calls = []
    real = tdw.dwconv_wgrad
    monkeypatch.setattr(tdw, "dwconv_wgrad", lambda *a: calls.append(1) or real(*a))
    state, step = port_dwconv_step(params, AdvConfig(attack="fgsm", alpha=1.25))
    assert step_mismatches(state, step, trajectory, *dwconv_step_batch()) == []
    assert state.step == 2 and len(calls) == 2 * 4  # 4 gated blocks, training backward only


def test_fgsm_step_with_alpha_1_fails(fgsm_trajectory):
    """The comparison above fails for an FGSM step of alpha 1.0, the
    config's default, in place of the 1.25 the JAX step ran."""
    params, trajectory = fgsm_trajectory
    state, step = port_dwconv_step(params, AdvConfig(attack="fgsm", alpha=1.0))
    bad = step_mismatches(state, step, trajectory, *dwconv_step_batch())
    assert any(b[1] in ("param", "ema") for b in bad)


def test_fgsm_adv_acc_on_mixup_targets_fails(fgsm_trajectory, monkeypatch):
    """adv_acc scored on the mixup targets, as the APGD arm scores (C3),
    disagrees with the JAX FGSM step's, which scores on the hard labels."""
    params, trajectory = fgsm_trajectory
    on_targets = []
    real = tstep.fgsm_train

    def spy(logits_fn, x, y, **kw):  # y: the mixup targets the attack ran on
        x_adv = real(logits_fn, x, y, **kw)
        with torch.no_grad():
            on_targets.append(float(is_correct(logits_fn(x_adv), y).float().mean()))
        return x_adv

    monkeypatch.setattr(tstep, "fgsm_train", spy)
    state, step = port_dwconv_step(params, AdvConfig(attack="fgsm", alpha=1.25))
    # the spy changes nothing; its scores differ from JAX's at some step
    assert step_mismatches(state, step, trajectory, *dwconv_step_batch()) == []
    assert len(on_targets) == 2
    assert any(acc != ref["adv_acc"] for acc, (ref, _, _) in zip(on_targets, trajectory))


# ------------------------------------------------------ trainer and CLI

FGSM_CLI = ["--model.arch", "convnext_micro", "--model.not_original", "1",
            "--model.add_normalization", "0", "--model.model_ema", "1", "--adv.attack", "fgsm",
            "--data.dataset", "synthetic", "--data.num_classes", str(NCLS),
            "--training.batch_size", "4", "--training.epochs", "1", "--training.precision",
            "fp32", "--training.use_pallas", "1", "--resolution.min_res", "32",
            "--resolution.max_res", "32", "--validation.batch_size", "4",
            "--validation.resolution", "32", "--validation.max_batches", "1",
            "--logging.log_every_steps", "1"]


@pytest.mark.parametrize("attack,alpha", [("fgsm", 0.75), ("apgd", 1.25)])
def test_trainer_adv_config_follows_jax(tmp_path, monkeypatch, attack, alpha):
    """The trainer's AdvConfig as the JAX trainer builds it: adv.alpha for
    FGSM only (else 1.25), noise_level and skip_projection passed on."""
    seen = []
    real = ttrainer.make_train_step
    monkeypatch.setattr(ttrainer, "make_train_step",
                        lambda model, *, adv, **kw: seen.append(adv) or real(model, adv=adv, **kw))
    cfg = config_from_args(FGSM_CLI + ["--logging.folder", str(tmp_path), "--adv.attack", attack,
                                       "--adv.alpha", "0.75", "--adv.noise_level", "0.5",
                                       "--adv.skip_projection", "1"])
    ttrainer.Trainer(cfg, device="cpu", synthetic_batches=1)
    assert seen == [AdvConfig(attack=attack, eps=cfg.adv.eps, n_iter=2, alpha=alpha,
                              noise_level=0.5, skip_projection=True)]


def test_fgsm_train_cli_end_to_end_on_cpu(tmp_path):
    """--adv.attack fgsm trains one epoch and writes weights cli.eval reads."""
    trainer = train_cli.main(FGSM_CLI + ["--logging.folder", str(tmp_path), "--device", "cpu",
                                         "--synthetic_batches", "2"])
    run = trainer.logger.dir
    records = [json.loads(line) for line in (run / "log").read_text().splitlines()]
    epoch = [r for r in records if "train_loss" in r]
    assert len(epoch) == 1 and np.isfinite(epoch[0]["train_loss"])
    assert records[-1]["event"] == "final_val"
    assert json.loads((run / "params.json").read_text())["adv.attack"] == "fgsm"
    res = eval_cli.main(["--run_dir", str(run), "--torch_ckpt",
                         str(run / "ckpt" / "weights_ema_0.pt"), "--device", "cpu",
                         "--synthetic", "--n_ex", "4", "--batch_size", "4", "--n_iter", "2",
                         "--img_size", "32", "--use_pallas", "1"])
    assert 0.0 <= res["Linf"]["robust"] <= 1.0 and res["Linf"]["n"] == 4
