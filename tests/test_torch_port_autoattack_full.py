"""Port parity of the rest of AutoAttack: FAB-T, Square, the full driver
(APGD-CE, APGD-T, FAB-T, Square), the eval CLI's full mode and the job
runner, revisiting_at_tpu_torch against the JAX package on the CPU, fp32,
on the same numpy inputs; Square with JAX's threefry draws replayed
(`_torch_port_util.JaxSquareDraws`).

Tolerances:
- projections (Linf, L2, L1): delta within 1e-5 of JAX's, element by element;
- FAB single target (tanh MLP of tests/test_fab.py, n_iter 20): res rtol 2e-3,
  atol 1e-5; x_best atol 2e-3 where a point was found (test_fab.py's);
  FAB-T over targets: success masks identical;
- Square (tests/test_square.py's linear model, 30 queries): x atol 1e-6
  (Linf) or 1e-5 (L2, L1), acc identical (test_square.py's);
- the eta pattern: atol 1e-6;
- the full driver (the tanh MLP, Linf): robust masks identical, x_adv as
  in test_torch_port_slice.py (1e-4 but for at most 0.1% of its elements,
  each within 2 eps).

CPU time: 49 s of wall time and 63 s of CPU in one pytest process on 8
cores with an empty JAX compile cache; nearly all of it is JAX compiling
its reference programs: the full run's six (about 15 s), each Square norm's
init and scan (5-8 s), FAB's scans (about 2 s a norm). The runner's job
runs torch on one thread, as the tests do.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import NCLS, JaxSquareDraws, jax_fold_in_noise, jax_square_draws
from revisiting_at_tpu.evals import AutoAttack as JaxAutoAttack
from revisiting_at_tpu.evals import AutoAttackConfig as JaxConfig
from revisiting_at_tpu.evals import fab as jfab
from revisiting_at_tpu.evals import square as jsq
from revisiting_at_tpu_torch.ckpt.convert import save_torch_checkpoint
from revisiting_at_tpu_torch.cli import eval as eval_cli
from revisiting_at_tpu_torch.cli import runner
from revisiting_at_tpu_torch.evals import (STANDARD_ATTACKS, AutoAttack, AutoAttackConfig,
                                           TorchSquareDraws)
from revisiting_at_tpu_torch.evals import fab as tfab
from revisiting_at_tpu_torch.evals import square as tsq
from revisiting_at_tpu_torch.models import get_model

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
T = torch.from_numpy


class Recorder:
    def __init__(self):
        self.lines = []

    def log(self, msg):
        self.lines.append(msg)


def mlp_problem(seed=11, bs=6, nc=5):
    """tests/test_fab.py's tanh MLP on 4x4x3 images, in both frameworks:
    (jax_fn, torch_fn, x, y = clean predictions, 2 targets per point)."""
    rng = np.random.RandomState(seed)
    w1 = rng.randn(48, 24).astype(np.float32) * 0.6
    w2 = rng.randn(24, nc).astype(np.float32) * 0.8
    tw1, tw2 = T(w1), T(w2)

    def jax_fn(xa):
        return jnp.tanh(xa.reshape(xa.shape[0], -1) @ w1) @ w2

    def torch_fn(xa):
        return torch.tanh(xa.reshape(xa.shape[0], -1) @ tw1.to(xa.device)) @ tw2.to(xa.device)

    x = rng.uniform(0.25, 0.75, size=(bs, 4, 4, 3)).astype(np.float32)
    logits = np.asarray(jax_fn(jnp.asarray(x)))
    y = logits.argmax(-1).astype(np.int64)
    targets = np.argsort(logits, -1)[:, -2:-4:-1].astype(np.int64)
    return jax_fn, torch_fn, x, y, targets


def linear_problem(seed, data_seed, b=4, h=10, w=10, c=3, nc=7):
    """tests/test_square.py's linear model and images, labelled with the
    model's predictions so that every row is attacked."""
    wm = (np.random.RandomState(seed).randn(h * w * c, nc) * 0.8).astype(np.float32)
    tw = T(wm)
    x = np.random.RandomState(data_seed).uniform(0.25, 0.75, (b, h, w, c)).astype(np.float32)
    y = (x.reshape(b, -1) @ wm).argmax(-1).astype(np.int64)
    return (lambda xa: xa.reshape(xa.shape[0], -1) @ wm,
            lambda xa: xa.reshape(xa.shape[0], -1) @ tw, x, y)


# ------------------------------------------------------------------- FAB

def hyperplane_problem(bs=16, d=40, seed=0):
    """Random (t, w, b) cutting the box: about half the rows already
    feasible. Columns 0-7 of w are zero and 8-15 are +-0.5: ties in |w|."""
    rng = np.random.RandomState(seed)
    t = rng.uniform(0.05, 0.95, (bs, d)).astype(np.float32)
    w = rng.randn(bs, d).astype(np.float32)
    w[:, :8] = 0.0
    w[:, 8:16] = np.where(rng.rand(bs, 8) < 0.5, 0.5, -0.5)
    b = (w * t).sum(-1) - rng.uniform(-1.0, 1.0, bs).astype(np.float32)
    return t, w, b


@pytest.mark.parametrize("norm", ["Linf", "L2", "L1"])
def test_projection_matches_jax(norm):
    t, w, b = hyperplane_problem(seed={"Linf": 1, "L2": 3, "L1": 7}[norm])
    fn = {"Linf": "_proj_hyperplane_box_linf", "L2": "_proj_hyperplane_box_l2",
          "L1": "_proj_hyperplane_box_l1"}[norm]
    ref = np.asarray(getattr(jfab, fn)(jnp.asarray(t), jnp.asarray(w), jnp.asarray(b)))
    got = getattr(tfab, fn)(T(t), T(w), T(b)).numpy()
    feasible = (w * t).sum(-1) <= b
    assert 0 < feasible.sum() < len(t)  # both kinds of rows occur
    np.testing.assert_array_equal(got[feasible], 0.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("norm", ["Linf", "L2", "L1"])
def test_fab_single_target_matches_jax(norm):
    jax_fn, torch_fn, x, y, targets = mlp_problem()
    yt = targets[:, 0]
    xb_ref, res_ref = jfab.fab_attack_single_target(
        jax_fn, jnp.asarray(x), jnp.asarray(y), jnp.asarray(yt), norm=norm, eps=10.0, n_iter=20)
    xb, res = tfab.fab_attack_single_target(torch_fn, T(x), T(y), T(yt), norm=norm, eps=10.0,
                                            n_iter=20)
    res_ref = np.asarray(res_ref)
    found = res_ref < 1e9
    assert found.any()
    np.testing.assert_allclose(res.numpy(), res_ref, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(xb.numpy()[found], np.asarray(xb_ref)[found], atol=2e-3)


def test_fab_targeted_success_matches_jax():
    jax_fn, torch_fn, x, y, targets = mlp_problem(seed=12)
    x_ref, s_ref = jfab.fab_attack_targeted(jax_fn, jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(targets), norm="L2", eps=0.25, n_iter=10)
    x_adv, success = tfab.fab_attack_targeted(torch_fn, T(x), T(y), T(targets), norm="L2",
                                              eps=0.25, n_iter=10)
    np.testing.assert_array_equal(success.numpy(), np.asarray(s_ref))
    assert 0 < success.sum() < len(x)
    np.testing.assert_array_equal(x_adv.numpy()[~success.numpy()], x[~success.numpy()])


# ---------------------------------------------------------------- Square

@pytest.mark.parametrize("norm,seeds,eps,key,atol", [
    ("Linf", (5, 6), 0.05, 13, 1e-6), ("L2", (1, 2), 1.5, 7, 1e-5),
    ("L1", (3, 4), 12.0, 11, 1e-5)])
def test_square_matches_jax(norm, seeds, eps, key, atol):
    jax_fn, torch_fn, x, y = linear_problem(*seeds)
    x_ref, acc_ref = jsq.square_attack(jax_fn, jnp.asarray(x), jnp.asarray(y), norm=norm,
                                       eps=eps, n_queries=30, rng=jax.random.PRNGKey(key))
    x_adv, acc = tsq.square_attack(torch_fn, T(x), T(y), norm=norm, eps=eps, n_queries=30,
                                   draws=JaxSquareDraws(jax.random.PRNGKey(key)))
    np.testing.assert_allclose(x_adv.numpy(), np.asarray(x_ref), rtol=0, atol=atol)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_ref))
    assert not np.array_equal(x_adv.numpy(), x)


def test_eta_pattern_matches_jax():
    size = 48
    jtail, ttail = jsq._tail_table(size + 2), tsq._tail_table(size + 2, "cpu")
    di = jax.lax.broadcasted_iota(jnp.int32, (size, size), 0)
    dj = jax.lax.broadcasted_iota(jnp.int32, (size, size), 1)
    ti, tj = torch.meshgrid(torch.arange(size), torch.arange(size), indexing="ij")
    eta = jax.jit(jsq._eta_value)  # s and the coin traced: one program
    for s in (2, 3, 5, 7, 9, 15, 44):
        for coin in (False, True):
            ref = np.asarray(eta(di, dj, jnp.asarray(s), jtail, jnp.asarray(coin)))
            got = tsq._eta_value(ti, tj, s, ttail, torch.tensor(coin)).numpy()
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=f"s={s} {coin}")


def test_torch_square_draws_are_keyed_on_the_query():
    """A query's draws depend on (seed, query) only, not on the order of the
    calls, and come back on out_device."""
    first = TorchSquareDraws(3, "cpu")
    later = [first.lp_query(it, 2, 3) for it in (0, 1, 2)]
    fresh = TorchSquareDraws(3, "cpu")
    for it in (2, 0, 1):
        for a, b in zip(fresh.lp_query(it, 2, 3), later[it]):
            assert torch.equal(a, b)
    assert not torch.equal(later[0][0], later[1][0])
    assert not torch.equal(first.linf_query(4, 2, 3, 8, 8, 3)[2],
                           TorchSquareDraws(4, "cpu").linf_query(4, 2, 3, 8, 8, 3)[2])
    moved = TorchSquareDraws(3, "cpu", out_device="meta")
    assert all(t.device.type == "meta" for t in moved.grid_init(2, 3, 4))
    assert moved.linf_init(2, 8, 3).device.type == "meta"


# ---------------------------------------------------------------- driver

def test_full_autoattack_matches_jax():
    """The driver on the tanh MLP, Linf: the worklist through the four
    attacks. (The model's own parity, and APGD's through the driver on
    convnext_micro, are test_torch_port_slice.py's.)"""
    jax_fn, torch_fn, x, y, _ = mlp_problem(seed=18, bs=8)
    x_before = x.copy()
    kw = dict(norm="Linf", eps=0.03, attacks_to_run=STANDARD_ATTACKS, n_iter=3,
              n_target_classes=2, square_n_queries=20, batch_size=8, seed=0, verbose=False)
    ref_log, log = Recorder(), Recorder()
    # one JAX program per attack: its chunks span n_iter and the queries
    x_ref, robust_ref = JaxAutoAttack(
        jax_fn, JaxConfig(**kw, fab_iter_chunk=3, square_query_chunk=19),
        logger=ref_log).run_standard_evaluation(x, y)
    aa = AutoAttack(torch_fn, AutoAttackConfig(**kw), logger=log, noise_fn=jax_fold_in_noise(0),
                    square_draws=jax_square_draws(0), device="cpu")
    x_adv, robust = aa.run_standard_evaluation(x, y)
    assert x.tobytes() == x_before.tobytes()
    np.testing.assert_array_equal(robust, robust_ref)
    diff = np.abs(x_adv - x_ref)
    assert (diff > 1e-4).mean() <= 1e-3, (diff > 1e-4).sum()
    assert diff.max() <= 2 * kw["eps"] + 1e-6
    after = [line for line in log.lines if line.startswith("robust accuracy after")]
    assert [line.split(":")[0] for line in after] == [
        f"robust accuracy after {a.upper()}" for a in STANDARD_ATTACKS]
    broke = {line.split(":")[0].split()[-1]: int(line.split("broke ")[1].split("/")[0])
             for line in after}
    assert broke["FAB-T"] + broke["SQUARE"] > 0, after
    # the same number of points broken by each attack
    assert after == [line for line in ref_log.lines if line.startswith("robust accuracy after")]


@pytest.mark.parametrize("to_file", [False, True])
def test_evaluation_leaves_f32_input_unchanged(to_file, tmp_path):
    _, torch_fn, x, y, _ = mlp_problem(seed=14, bs=8)
    x_before = x.copy()
    cfg = AutoAttackConfig(norm="L2", eps=1.0, attacks_to_run=("fab-t", "square"), n_iter=10,
                           n_target_classes=2, square_n_queries=20, batch_size=8, verbose=False)
    out = tmp_path / "adv.npy" if to_file else None
    x_adv, robust = AutoAttack(torch_fn, cfg, device="cpu").run_standard_evaluation(x, y, out)
    assert not robust.all()  # points flipped
    assert x.tobytes() == x_before.tobytes()
    assert not np.array_equal(x_adv[~robust], x[~robust])
    if to_file:
        np.testing.assert_array_equal(np.load(out), x_adv)


# ------------------------------------------------------- CLI and runner

@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("run")
    params = {"model.arch": "convnext_micro", "model.not_original": 1,
              "model.add_normalization": 1, "data.num_classes": NCLS}
    (d / "params.json").write_text(json.dumps(params))
    torch.manual_seed(0)
    model, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS,
                         add_normalization=True)
    save_torch_checkpoint(model, d / "w.pt")
    return d


def test_eval_cli_full_aa_saves_images(run_dir):
    res = eval_cli.main([
        "--run_dir", str(run_dir), "--torch_ckpt", str(run_dir / "w.pt"), "--device", "cpu",
        "--synthetic", "--n_ex", "4", "--batch_size", "4", "--img_size", "32", "--n_iter", "2",
        "--full_aa", "1", "--square_queries", "5", "--l_norms", "Linf,L2",
        "--l_epss", "8,0.5", "--save_imgs", "--stem_s2d", "1", "--use_pallas", "1"])
    x = np.random.RandomState(0).uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    for norm, eps in (("Linf", 8 / 255), ("L2", 0.5)):
        assert res[norm]["eps"] == pytest.approx(eps)
        path = run_dir / f"aa_adv_4_{norm}_{eps:.5f}.npy"
        assert res[norm]["adv_path"] == str(path)
        adv = np.load(path)
        assert adv.shape == x.shape and adv.dtype == np.float32
        d = (adv - x).reshape(4, -1)
        size = np.abs(d).max(1) if norm == "Linf" else np.sqrt((d * d).sum(1))
        assert size.max() <= eps * 1.001 + 1e-6 and adv.min() >= 0 and adv.max() <= 1
    log = (run_dir / "evaluated_logs_Linf,L2_1.txt").read_text()
    assert "attacks=('apgd-ce', 'apgd-t', 'fab-t', 'square')" in log


def test_eval_cli_chunk_flags_change_nothing(run_dir, tmp_path):
    """--fab_iter_chunk and --square_query_chunk are accepted and ignored."""
    out = []
    for extra in ([], ["--fab_iter_chunk", "1", "--square_query_chunk", "2"]):
        d = tmp_path / str(len(extra))
        d.mkdir()
        (d / "params.json").write_text((run_dir / "params.json").read_text())
        res = eval_cli.main([
            "--run_dir", str(d), "--torch_ckpt", str(run_dir / "w.pt"), "--device", "cpu",
            "--synthetic", "--n_ex", "2", "--batch_size", "2", "--img_size", "32",
            "--n_iter", "2", "--full_aa", "1", "--square_queries", "4", "--l_norms", "L2",
            "--eps", "0.5", "--save_imgs", *extra])
        out.append((res["L2"]["robust"], np.load(res["L2"]["adv_path"])))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_runner_dry_run_prints_the_table(capsys):
    runner.main(["--runs", "runs/a", "runs/b", "--l_norms", "Linf,L2", "--img_sizes", "224,288",
                 "--full_aa", "1", "--dry_run", "--", "--torch_ckpt", "w.pt", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "runner: 8 eval jobs queued"
    jobs = out[1:]
    assert len(jobs) == 8 and all("-m revisiting_at_tpu_torch.cli.eval" in j for j in jobs)
    assert all(j.endswith("--torch_ckpt w.pt --device cpu") for j in jobs)
    assert "--run_dir runs/b --l_norms L2 --img_size 288 --full_aa 1" in jobs[-1]


def test_runner_runs_a_job(run_dir, monkeypatch, capsys):
    monkeypatch.chdir(REPO)  # the job imports the package from the checkout
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the job's torch: one thread, as this process
    runner.main(["--runs", str(run_dir), "--l_norms", "L1", "--img_sizes", "32", "--n_ex", "2",
                 "--batch_size", "2", "--full_aa", "1", "--", "--torch_ckpt",
                 str(run_dir / "w.pt"), "--device", "cpu", "--synthetic", "--n_iter", "1",
                 "--square_queries", "3"])
    assert "-> exit 0" in capsys.readouterr().out
    assert "robust accuracy (L1)" in (run_dir / "evaluated_logs_L1_1.txt").read_text()


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
