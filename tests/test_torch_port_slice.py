"""Port parity of the whole slice: short-mode AutoAttack (APGD-CE then
APGD-T) of revisiting_at_tpu_torch against the JAX package on
convnext_micro at 32 px, fp32, with JAX's start noise injected through
its fold_in key chain; then the eval CLI end to end on the CPU, and the
rule that the port never imports JAX.

Tolerance: robust masks identical; x_adv to 1e-4 except for at most 0.1%
of its elements, each within one step (2 eps). The input gradients of the
two frameworks agree to ~5e-7 relative, but over some 20 gradient
evaluations of 24,576 pixels a component close enough to zero can take the
other sign; momentum then carries that one-step difference to a few
neighbouring iterates (7 of 24,576 elements in this setup).

CPU time: 31 s of wall time and 48 s of CPU in one pytest process on 8
cores with an empty JAX compile cache.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import NCLS, images, jax_fold_in_noise, model_pair
from revisiting_at_tpu.evals import AutoAttack as JaxAutoAttack
from revisiting_at_tpu.evals import AutoAttackConfig as JaxConfig
from revisiting_at_tpu_torch.ckpt.convert import save_torch_checkpoint
from revisiting_at_tpu_torch.cli import eval as eval_cli
from revisiting_at_tpu_torch.evals import AutoAttack, AutoAttackConfig
from revisiting_at_tpu_torch.models import get_model

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_short_autoattack_matches_jax():
    jm, v, tm = model_pair(not_original=True)
    fwd = jax.jit(lambda xx: jm.apply(v, xx, train=False))
    x = images(n=8, seed=5)
    y = np.asarray(fwd(jnp.asarray(x))).argmax(-1).astype(np.int64)
    kw = dict(norm="Linf", eps=1.0 / 255.0, attacks_to_run=("apgd-ce", "apgd-t"), n_iter=5,
              n_target_classes=3, batch_size=8, seed=0, verbose=False)
    x_ref, robust_ref = JaxAutoAttack(fwd, JaxConfig(**kw)).run_standard_evaluation(x, y)
    aa = AutoAttack(tm, AutoAttackConfig(**kw), noise_fn=jax_fold_in_noise(0), device="cpu")
    x_adv, robust = aa.run_standard_evaluation(x, y)
    np.testing.assert_array_equal(robust, robust_ref)
    diff = np.abs(x_adv - x_ref)
    assert (diff > 1e-4).mean() <= 1e-3, (diff > 1e-4).sum()
    assert diff.max() <= 2 * kw["eps"] + 1e-6
    assert 0 < robust.sum() < len(x)  # both outcomes occur
    np.testing.assert_allclose(x_adv[robust], x[robust])  # robust points untouched


def test_unknown_attack_raises():
    with pytest.raises(ValueError, match="unknown attack"):
        AutoAttack(lambda t: t, AutoAttackConfig(attacks_to_run=("apgd-ce", "fab")),
                   device="cpu")


def test_autoattack_runs_on_the_card_by_default():
    cfg = AutoAttackConfig(attacks_to_run=("apgd-ce", "apgd-t"))
    assert AutoAttack(lambda t: t, cfg).device == torch.device("cuda")


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("run")
    params = {"model.arch": "convnext_micro", "model.not_original": 1,
              "model.add_normalization": 1, "data.num_classes": NCLS, "future.key": 3}
    (d / "params.json").write_text(json.dumps(params))
    torch.manual_seed(0)
    model, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS,
                         add_normalization=True)
    save_torch_checkpoint(model, d / "w.pt")
    return d


def test_eval_cli_on_cpu(run_dir):
    args = ["--run_dir", str(run_dir), "--torch_ckpt", str(run_dir / "w.pt"), "--device",
            "cpu", "--synthetic", "--n_ex", "4", "--batch_size", "4", "--n_iter", "2",
            "--img_size", "32", "--use_pallas", "1", "--l_norms", "Linf,L2"]
    res = eval_cli.main(args)
    assert set(res) == {"Linf", "L2"} and res["L2"]["eps"] == 2.0
    assert 0.0 <= res["Linf"]["robust"] <= 1.0 and res["Linf"]["n"] == 4
    log = (run_dir / "evaluated_logs_Linf,L2_0.txt").read_text()
    assert "max Linf perturbation" in log and "robust accuracy (L2)" in log
    clean = eval_cli.main(args[:-2] + ["--only_clean"])
    assert 0.0 <= clean["Linf"]["clean"] <= 1.0


@pytest.mark.parametrize("extra,err", [
    (["--device", "cpu", "--tp", "2"], SystemExit),
    (["--device", "cpu", "--data_dir", "/nonexistent"], FileNotFoundError),
    (["--device", "cpu", "--synthetic", "--l_norms", "Linf,L2", "--l_epss", "1"], SystemExit),
    (["--device", "cpu", "--torch_ckpt", ""], SystemExit),
])
def test_eval_cli_refuses(run_dir, extra, err):
    args = ["--run_dir", str(run_dir), "--torch_ckpt", str(run_dir / "w.pt"), "--n_ex", "2",
            "--batch_size", "2", "--img_size", "32"]
    with pytest.raises(err):
        eval_cli.main(args + extra)


def test_eval_cli_needs_cuda_unless_cpu(run_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for hosts without one")
    with pytest.raises(SystemExit, match="CUDA"):
        eval_cli.main(["--run_dir", str(run_dir), "--torch_ckpt", str(run_dir / "w.pt"),
                       "--synthetic"])


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import revisiting_at_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'revisiting_at_tpu', 'tensorflow', "
        "'torchvision')]\n"
        "assert len(mods) >= 20 and not bad, (len(mods), bad)\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
