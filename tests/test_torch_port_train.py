"""Port parity of the training slice: the block tail's full backward, mixup,
the LR schedule, the weight-decay mask, EMA, the adversarial train step and
the train CLI of revisiting_at_tpu_torch against the JAX package, on the
CPU, with JAX's random draws injected.

Tolerances:
  * full backward: 2e-3 of max |ref| per cotangent. Both sides round the
    same operands to bf16 (u16, g16, kdy16, dh16); a one-ulp difference in
    an f32 LayerNorm statistic can flip one bf16 rounding and move a sum by
    about that much.
  * mixup, schedule, EMA: the same f32 arithmetic, so 1e-6 (mixup images
    and targets, EMA) and 1e-6 relative (LR).
  * train step, 3 steps on convnext_micro: loss and grad_norm to 1e-4
    relative, accuracies equal, every parameter and EMA element within
    1e-4. AdamW's first steps move each weight by about +-LR (here up to
    2e-3); the two frameworks' gradients differ by bf16 rounding flips in
    the fused tails and by summation order, which moves a few elements by
    up to 5e-5. A flipped weight-decay mask (LN scales and gamma decay by
    LR * 0.5 * |p| per step) and an LR read one step late (step 1 at 2e-7
    instead of 1e-3) each break the 1e-4 bound: the test shows both.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import (NCLS, TAIL_ARGS, images, jax_params, jax_tail_cotangents,
                              rel_err, tail_inputs)
from revisiting_at_tpu.data import mixup as jmix
from revisiting_at_tpu.models import get_model as jax_get_model
from revisiting_at_tpu.train import ema as jema
from revisiting_at_tpu.train import optimizer as jopt
from revisiting_at_tpu.train import schedule as jsched
from revisiting_at_tpu.train.state import TrainState as JaxState
from revisiting_at_tpu.train.train_step import AdvConfig as JaxAdv
from revisiting_at_tpu.train.train_step import make_train_step as jax_make_train_step
from revisiting_at_tpu.config import load_params_json as jax_load_params_json
from revisiting_at_tpu_torch.ckpt.convert import jax_params_to_state_dict, load_state_dict
from revisiting_at_tpu_torch.cli import eval as eval_cli
from revisiting_at_tpu_torch.cli import train as train_cli
from revisiting_at_tpu_torch.config import config_from_args
from revisiting_at_tpu_torch.data import MixupConfig, MixupDraws, draw_mixup, mixup_cutmix
from revisiting_at_tpu_torch.models import get_model
from revisiting_at_tpu_torch.models.convnext import ConvNeXtBlock, drop_path_keep
from revisiting_at_tpu_torch.ops import block_mlp as tbm
from revisiting_at_tpu_torch.train import (AdvConfig, LRConfig, TrainState, attack_grad_mode,
                                           ema_init, ema_update, epoch_lr, freeze_labels,
                                           get_resolution, make_lr_schedule, make_optimizer,
                                           make_train_step, wd_mask)
from revisiting_at_tpu_torch.train import optimizer as topt
from revisiting_at_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
T = torch.from_numpy


# ---------------------------------------------------------- full backward

@pytest.mark.parametrize("M,C,B,keep,jax_mode", [
    (40, 16, 1, None, "full"),            # M not a multiple of any power-of-two tile
    (2 * 24, 16, 2, [1.0, 0.5], "full"),  # per-sample DropPath scale
    (196, 384, 1, None, "full"),          # one ConvNeXt-T stage-2 block at 14x14
    (2 * 24, 16, 2, [1.0, 0.5], "split"),  # the JAX package's _bwd_split
])
def test_full_backward_matches_jax(M, C, B, keep, jax_mode):
    """All nine cotangents (keep gets none) of the port's full backward on
    the CPU (its plain version, through the autograd Function) against the
    JAX kernels in interpret mode: `_bwd_kernel`, and its two-pass variant
    `_bwd_split`, which the port's one full backward also stands for."""
    d = tail_inputs(M, C)
    refs = jax_tail_cotangents(d, B, keep, jax_mode)
    t = {k: T(d[k]).requires_grad_(True) for k in TAIL_ARGS}
    kp = None if keep is None else torch.tensor(keep)
    y = tbm.block_mlp(t["s"], t["r"], kp, M // B, *(t[k] for k in TAIL_ARGS[2:]),
                      grad_mode="full")
    y.backward(T(d["dy"]))
    for k, ref in zip(TAIL_ARGS, refs):
        assert t[k].grad.dtype == torch.float32, k
        assert rel_err(t[k].grad, ref) < 2e-3, (k, rel_err(t[k].grad, ref))


# ------------------------------------------------------------------ mixup

def jax_mixup_key(seed, step):
    """The JAX step's mixup key: split(fold_in(PRNGKey(seed), step), 4)[0]."""
    return jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), step), 4)[0]


def jax_mixup_draws(seed, cfg):
    """mixup_draws(step, h, w) replaying the JAX step's draws."""
    def draws(step, h, w):
        k_apply, k_switch, k_lam_m, k_lam_c, k_box = jax.random.split(jax_mixup_key(seed, step),
                                                                      5)
        ky, kx = jax.random.split(k_box)
        return MixupDraws(
            float(jax.random.uniform(k_apply)), float(jax.random.uniform(k_switch)),
            float(jax.random.beta(k_lam_m, cfg.mixup_alpha, cfg.mixup_alpha)),
            float(jax.random.beta(k_lam_c, cfg.cutmix_alpha, cfg.cutmix_alpha)),
            int(jax.random.randint(ky, (), 0, h)), int(jax.random.randint(kx, (), 0, w)))
    return draws


@pytest.mark.parametrize("step,prob,branch", [
    (0, 1.0, "cutmix"),  # switch draw 0.08 < 0.5
    (1, 1.0, "mixup"),   # switch draw 0.71
    (1, 0.5, "none"),    # apply draw 0.63 >= prob
])
def test_mixup_matches_jax(step, prob, branch):
    cfg = MixupConfig(prob=prob, num_classes=NCLS)
    draws = jax_mixup_draws(0, cfg)(step, 16, 16)
    assert (draws.apply >= prob) == (branch == "none")
    assert (draws.switch < cfg.switch_prob) == (branch == "cutmix") or branch == "none"
    x = images(n=4, img=16, seed=7)
    y = np.random.RandomState(8).randint(0, NCLS, 4)
    jx, jt = jmix.mixup_cutmix(jax_mixup_key(0, step), jnp.asarray(x), jnp.asarray(y),
                               jmix.MixupConfig(prob=prob, num_classes=NCLS))
    tx, tt = mixup_cutmix(T(x), T(y), cfg, draws)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
    changed = not np.array_equal(tx.numpy(), x)
    assert changed == (branch != "none")


def test_mixup_generator_draws():
    """The default draws: reproducible per seed, in range, and Beta(0.8, 0.8)
    by its mean and variance (0.5, 0.0962) over 2,000 draws."""
    cfg = MixupConfig()
    a = draw_mixup(torch.Generator().manual_seed(3), 32, 24, cfg)
    assert a == draw_mixup(torch.Generator().manual_seed(3), 32, 24, cfg)
    assert 0 <= a.cy < 32 and 0 <= a.cx < 24 and 0 < a.lam_mix < 1 and 0 < a.lam_cut < 1
    gen = torch.Generator().manual_seed(0)
    lam = np.asarray([draw_mixup(gen, 8, 8, cfg).lam_mix for _ in range(2000)])
    assert abs(lam.mean() - 0.5) < 0.02 and abs(lam.var() - 0.0962) < 0.01


# ------------------------------------------- schedule, wd mask, freeze, EMA

@pytest.mark.parametrize("kind", ["cosine", "cyclic", "step"])
def test_lr_schedule_matches_jax(kind):
    cfg = dict(lr=1e-3, schedule_type=kind, lr_peak_epoch=1, epochs=3, step_length=1)
    sched = make_lr_schedule(LRConfig(**cfg), 4)
    ref = jsched.make_lr_schedule(jsched.LRConfig(**cfg), 4)
    for step in range(13):  # the first three epochs and the first step past them
        np.testing.assert_allclose(sched(step), float(ref(step)), rtol=1e-6, err_msg=str(step))
    for e in (0, 1, 2, 3, 5):
        np.testing.assert_allclose(epoch_lr(LRConfig(**cfg), e),
                                   float(jsched.epoch_lr(jsched.LRConfig(**cfg), e)),
                                   rtol=1e-6, atol=1e-12)


def test_resolution_ramp_matches_jax():
    for e in range(0, 12):
        assert get_resolution(e, 160, 224, 2, 9) == jsched.get_resolution(e, 160, 224, 2, 9)


def _decayed_names(mask_tree, params):
    full = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), mask_tree,
                        params)
    return {k for k, v in jax_params_to_state_dict(full, "convnext_micro").items() if v.all()}


@pytest.mark.parametrize("family", ["convnext", "vit"])
def test_wd_mask_matches_jax(family):
    params = jax_params("convnext_micro", True, 32, 0)
    model, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS)
    mine = {k for k, v in wd_mask(model, family).items() if v}
    assert mine == _decayed_names(jopt.wd_mask(params, family), params)
    if family == "convnext":  # LN scales and gamma decay, biases do not
        assert "stages.0.blocks.0.norm.weight" in mine and "stages.0.blocks.0.gamma" in mine
        assert "stages.0.blocks.0.mlp.fc1.bias" not in mine


@pytest.mark.parametrize("early", [True, False])
def test_freeze_labels_match_jax(early):
    params = jax_params("convnext_micro", True, 32, 0)
    model, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS)
    mine = {k for k, v in freeze_labels(model, early).items() if v == "train"}
    ref = jax.tree.map(lambda v: v == "train", jopt.freeze_labels(params, early))
    assert mine == _decayed_names(ref, params)


def test_ema_matches_jax():
    model, _ = get_model("convnext_micro", num_classes=NCLS)
    ema = ema_init(model)
    tree = {k: v.numpy().copy() for k, v in ema.items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1)
    ema_update(ema, model, 0.9)
    ref = jema.ema_update(tree, {k: p.detach().numpy() for k, p in model.named_parameters()},
                          0.9)
    for k, v in ema.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]), rtol=0, atol=1e-6)
        assert v.dtype == torch.float32


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_optimizer_updates_match_optax(kind):
    """Two updates with the convnext decay groups and a scheduled LR against
    the JAX package's optax chain on the same named arrays (the convnext
    rule reads only the last name, so timm names give the same mask)."""
    model, _ = get_model("convnext_micro", num_classes=NCLS)
    rng = np.random.RandomState(0)
    grads = [{k: rng.randn(*p.shape).astype(np.float32) for k, p in model.named_parameters()}
             for _ in range(2)]
    params = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    cfg = dict(lr=1e-2, schedule_type="cyclic", lr_peak_epoch=1, epochs=3)
    tx = jopt.make_optimizer(optimizer=kind, weight_decay=0.5, momentum=0.9, family="convnext",
                             learning_rate=jsched.make_lr_schedule(jsched.LRConfig(**cfg), 2),
                             params=params)
    opt_state, ref = tx.init(params), params
    opt = make_optimizer(model, optimizer=kind, weight_decay=0.5, momentum=0.9,
                         learning_rate=make_lr_schedule(LRConfig(**cfg), 2))
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, ref)
        ref = jax.tree.map(lambda p, u: p + u, ref, updates)
        for k, p in model.named_parameters():
            p.grad = T(g[k])
        opt.step()
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-7)


# -------------------------------------------------------------- the step

LR = dict(lr=2e-3, schedule_type="cosine", lr_peak_epoch=1, epochs=3)  # 2e-7, 1e-3, 2e-3
WD, EMA, STEPS = 0.5, 0.5, 3


def _step_batch():
    x = images(n=4, seed=3)
    y = np.random.RandomState(4).randint(0, NCLS, 4).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def jax_trajectory():
    """3 JAX steps on convnext_micro + ConvStem, fp32, use_pallas=1 in
    interpret mode, mixup, 2-step APGD, EMA: per step the metrics and the
    params and EMA as port state_dicts."""
    jm, _ = jax_get_model("convnext_micro", not_original=True, num_classes=NCLS,
                          dtype=jnp.float32, use_pallas=True, pallas_interpret=True)
    params = jax_params("convnext_micro", True, 32, 0)
    tx = jopt.make_optimizer(optimizer="adamw", weight_decay=WD, family="convnext",
                             learning_rate=jsched.make_lr_schedule(jsched.LRConfig(**LR), 2),
                             params=params)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                     ema_params=jema.ema_init(params))
    step = jax_make_train_step(jm, tx, adv=JaxAdv(attack="apgd", n_iter=2),
                               mixup=jmix.MixupConfig(num_classes=NCLS), ema_decay=EMA, seed=0,
                               donate=False)
    x, y = _step_batch()
    out = []
    for _ in range(STEPS):
        state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
        out.append(({k: float(v) for k, v in metrics.items()},
                    jax_params_to_state_dict(jax.tree.map(np.asarray, state.params),
                                             "convnext_micro"),
                    jax_params_to_state_dict(jax.tree.map(np.asarray, state.ema_params),
                                             "convnext_micro")))
    return params, out


def _port_step(params, *, learning_rate=None):
    model, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS,
                         dtype=torch.float32, use_pallas=True)
    load_state_dict(model, jax_params_to_state_dict(params, "convnext_micro"))
    opt = make_optimizer(model, weight_decay=WD, family="convnext",
                         learning_rate=learning_rate or make_lr_schedule(LRConfig(**LR), 2))
    state = TrainState(model, opt, ema_init(model))
    cfg = MixupConfig(num_classes=NCLS)
    step = make_train_step(model, adv=AdvConfig(attack="apgd", n_iter=2), mixup=cfg,
                           ema_decay=EMA, seed=0, mixup_draws=jax_mixup_draws(0, cfg))
    return state, step


def _step_mismatches(state, step, trajectory):
    """Run the port's steps beside the JAX trajectory; list what disagrees."""
    x, y = _step_batch()
    bad = []
    for i, (ref, ref_params, ref_ema) in enumerate(trajectory):
        got = {k: float(v) for k, v in step(state, T(x), T(y)).items()}
        for k in ("loss", "grad_norm"):
            if abs(got[k] - ref[k]) > 1e-4 * abs(ref[k]):
                bad.append((i, k, got[k], ref[k]))
        for k in ("adv_acc", "train_acc"):
            if got[k] != ref[k]:
                bad.append((i, k, got[k], ref[k]))
        for name, p in state.model.named_parameters():
            for what, mine, theirs in (("param", p.detach(), ref_params[name]),
                                       ("ema", state.ema[name], ref_ema[name])):
                e = float((mine - theirs).abs().max())
                if e > 1e-4:
                    bad.append((i, what, name, e))
    return bad


def test_train_step_matches_jax(jax_trajectory):
    params, trajectory = jax_trajectory
    state, step = _port_step(params)
    assert _step_mismatches(state, step, trajectory) == []
    assert state.step == STEPS and state.optimizer.count == STEPS


@pytest.mark.parametrize("fault", ["flipped_wd_mask", "lr_one_step_late"])
def test_train_step_parity_has_teeth(jax_trajectory, fault, monkeypatch):
    """The comparison above fails for a port with a flipped weight-decay mask
    or with the LR read one step late."""
    params, trajectory = jax_trajectory
    sched = make_lr_schedule(LRConfig(**LR), 2)
    if fault == "flipped_wd_mask":
        real = topt.wd_mask
        monkeypatch.setattr(topt, "wd_mask",
                            lambda m, f: {k: not v for k, v in real(m, f).items()})
        state, step = _port_step(params)
    else:
        state, step = _port_step(params, learning_rate=lambda c: sched(max(c - 1, 0)))
    bad = _step_mismatches(state, step, trajectory)
    assert any(b[1] in ("param", "ema") for b in bad)


def test_attack_scope_restores_training_and_fused_blocks_get_weight_grads():
    """After the step's eval-mode, input-only, frozen-weights attack, the
    training backward runs the full backward: every fused block's weights
    get non-zero gradients, and the model is back in full mode."""
    torch.manual_seed(0)
    model, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS,
                         dtype=torch.float32, use_pallas=True)
    for blk in (b for st in model.stages for b in st.blocks):
        torch.nn.init.uniform_(blk.gamma, 0.1, 1.0)
    state = TrainState(model, make_optimizer(model, learning_rate=1e-3))
    step = make_train_step(model, adv=AdvConfig(attack="apgd", n_iter=2), mixup=None)
    x, y = _step_batch()
    model.train()
    metrics = step(state, T(x), T(y))
    assert model.grad_mode == "full" and model.training
    assert all(p.requires_grad for p in model.parameters())
    for si, st in enumerate(model.stages):
        for name in ("mlp.fc1.weight", "mlp.fc2.weight", "norm.weight", "gamma"):
            g = st.blocks[0].get_parameter(name).grad
            assert g is not None and float(g.abs().max()) > 0, (si, name)
    assert np.isfinite(float(metrics["loss"]))
    with pytest.raises(RuntimeError), attack_grad_mode(model):
        assert model.grad_mode == "input" and not model.training
        raise RuntimeError("restored on the way out")
    assert model.grad_mode == "full" and model.training


@pytest.mark.parametrize("use_pallas", [True, False])
def test_drop_path_per_sample_keep(use_pallas):
    """In train mode a block scales its residual branch per sample by the
    keep drawn from the generator (0 or 1/keep_p); in eval mode it does not
    draw. Fused and plain paths apply the same keep."""
    blk = ConvNeXtBlock(32, drop_path=0.5, use_pallas=use_pallas)
    torch.nn.init.uniform_(blk.gamma, 0.1, 1.0)
    x = T(images(n=6, img=8, seed=9)[..., :1].repeat(32, -1)) - 0.5
    y_eval = blk.eval()(x)
    blk.train()
    y = blk(x, "full", torch.Generator().manual_seed(5))
    keep = drop_path_keep(6, 0.5, torch.Generator().manual_seed(5), x.device)
    assert set(keep.tolist()) <= {0.0, 2.0} and 0.0 in keep.tolist() and 2.0 in keep.tolist()
    np.testing.assert_allclose((y - x).detach().numpy(),
                               (keep.reshape(-1, 1, 1, 1) * (y_eval - x)).detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    y.sum().backward()
    assert float(blk.mlp.fc1.weight.grad.abs().max()) > 0


def test_split_bwd_knob_takes_the_full_backward(tmp_path):
    """training.split_bwd is accepted, kept in params.json and ignored: the
    trainer's model takes the one full backward either way, to the bit."""
    grads = []
    for split in ("0", "1"):
        cfg = config_from_args(BASE + ["--logging.folder", str(tmp_path),
                                       "--training.split_bwd", split])
        assert cfg.to_flat_dict()["training.split_bwd"] == int(split)
        model = Trainer(cfg, device="cpu", synthetic_batches=1).model
        load_state_dict(model, jax_params_to_state_dict(jax_params(not_original=True),
                                                        "convnext_micro"))
        model(T(images(n=2))).sum().backward()
        grads.append(model.stages[0].blocks[0].mlp.fc1.weight.grad)
    assert float(grads[0].abs().max()) > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


# ------------------------------------------------------------------ CLI

BASE = ["--model.arch", "convnext_micro", "--model.not_original", "1",
        "--model.add_normalization", "0", "--model.model_ema", "1", "--adv.attack", "apgd",
        "--adv.n_iter", "2", "--data.dataset", "synthetic", "--data.num_classes", str(NCLS),
        "--training.batch_size", "4", "--training.epochs", "1", "--training.precision",
        "fp32", "--training.use_pallas", "1", "--resolution.min_res", "32",
        "--resolution.max_res", "32", "--validation.batch_size", "4",
        "--validation.resolution", "32", "--validation.max_batches", "1",
        "--logging.log_every_steps", "1"]


def test_train_cli_end_to_end_on_cpu(tmp_path):
    trainer = train_cli.main(BASE + ["--logging.folder", str(tmp_path), "--device", "cpu",
                                     "--synthetic_batches", "2"])
    run = trainer.logger.dir
    records = [json.loads(line) for line in (run / "log").read_text().splitlines()]
    assert records[0]["event"] == "init" and records[0]["device"] == "cpu"
    assert "Validation acc" in records[1] and "event" not in records[1]
    steps = [r for r in records if r.get("event") == "step"]
    assert [r["step"] for r in steps] == [1, 2]
    epoch = [r for r in records if "train_loss" in r]
    assert len(epoch) == 1 and np.isfinite(epoch[0]["train_loss"])
    assert records[-1]["event"] == "final_val" and records[-1]["points"] == 4
    params = json.loads((run / "params.json").read_text())
    assert params["model.arch"] == "convnext_micro" and params["training.use_pallas"] == 1
    assert jax_load_params_json(run / "params.json").to_flat_dict() == params
    for name in ("weights_0.pt", "weights_ema_0.pt"):
        res = eval_cli.main(["--run_dir", str(run), "--torch_ckpt", str(run / "ckpt" / name),
                             "--device", "cpu", "--synthetic", "--n_ex", "4", "--batch_size",
                             "4", "--n_iter", "2", "--img_size", "32", "--use_pallas", "1"])
        assert 0.0 <= res["Linf"]["robust"] <= 1.0 and res["Linf"]["n"] == 4
    w = torch.load(run / "ckpt" / "weights_0.pt")
    e = torch.load(run / "ckpt" / "weights_ema_0.pt")
    assert w.keys() == e.keys() and not torch.equal(w["head.fc.weight"], e["head.fc.weight"])


@pytest.mark.parametrize("extra,err", [
    (["--data.augmentations", "1"], NotImplementedError),
    (["--data.dataset", "folder"], NotImplementedError),
    (["--dist.fsdp", "2"], NotImplementedError),
    (["--dist.multihost", "1"], NotImplementedError),
    (["--validation.adv_val_freq", "1"], NotImplementedError),
    (["--model.ckpt_path", "runs/x"], NotImplementedError),
    (["--model.pretrained", "1"], NotImplementedError),
    (["--training.grad_accum", "2"], NotImplementedError),
    (["--training.remat", "1"], NotImplementedError),
    (["--misc.log_flops", "1"], NotImplementedError),
    (["--misc.profile_steps", "1"], NotImplementedError),
    (["--adv.attack", "fgsm"], NotImplementedError),
    (["--adv.attack", "pgd"], ValueError),
    (["--training.batch_size"], ValueError),
])
def test_train_cli_refuses(tmp_path, extra, err):
    with pytest.raises(err):
        train_cli.main(BASE + ["--logging.folder", str(tmp_path), "--device", "cpu"] + extra)


def test_train_cli_needs_cuda_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for hosts without one")
    with pytest.raises(SystemExit, match="CUDA"):
        train_cli.main(BASE + ["--logging.folder", str(tmp_path)])


def test_trainer_fp32_val_twin_and_lr_tta(tmp_path):
    """validation.precision=fp32 under bf16 training validates an f32 twin
    holding the trained weights; lr_tta adds the flipped batch's logits."""
    cfg = config_from_args(BASE + ["--logging.folder", str(tmp_path), "--training.precision",
                                   "bf16", "--validation.precision", "fp32",
                                   "--validation.lr_tta", "1"])
    trainer = Trainer(cfg, device="cpu", synthetic_batches=1)
    with torch.no_grad():
        trainer.model.head.fc.bias.add_(1.0)
    acc, n = trainer.single_val()
    twin = trainer.val_model
    assert twin is not trainer.model and twin.dtype == torch.float32 and n == 4
    torch.testing.assert_close(twin.head.fc.bias, trainer.model.head.fc.bias)
    x, y = next(iter(trainer.val_data))
    with torch.no_grad():
        logits = twin(T(x)) + twin(T(x).flip(2))
    assert acc == float((logits.argmax(-1) == T(y).long()).float().mean())


def test_config_from_args_forms():
    cfg = config_from_args(["--training.batch_size", "80", "--lr.lr=0.002",
                            "--adv.eps=0.0156862745"])
    assert cfg.training.batch_size == 80 and cfg.lr.lr == 0.002 and cfg.adv.eps == 0.0156862745
    with pytest.raises(KeyError):
        config_from_args(["--training.nonexistent", "1"])
    with pytest.raises(ValueError):
        config_from_args(["--resolution.min_res", "256"])
