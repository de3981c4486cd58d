"""Port parity of the BN family and the checkpoint bridges (models/resnet.py,
densenet.py, inception.py, the flax-semantics BatchNorm of models/layers.py,
the resnet weight-decay rule, the running statistics in the train step, the
EMA and the checkpoints, ckpt/torch_import.py, cli.export) against the JAX
package on the CPU. Weights cross over through ckpt/convert.py; JAX's
params are drawn with numpy on its shapes (no init compile). About 70 s of
CPU time on one core, most of it JAX compiling the models' forwards and
one training step.

Tolerances, relative to the largest reference value, in fp32:
  * eval-mode logits: 1e-4 (measured 1e-6 to 3e-6): f32 rounding of
    differently ordered sums;
  * train-mode logits and the updated running statistics: 1e-4 for ResNet
    and DenseNet at 64 px, batch 2 (their last stage's BatchNorms reduce 8
    values a channel). Inception at 107 px, batch 2: 5e-3 (measured 8e-4):
    its last blocks' maps are 2x2, and a BatchNorm over 8 values, var =
    E[x^2] - E[x]^2, amplifies the f32 rounding of its input by up to
    |x| / std. (At 75 px those maps are 1x1, 2 values a channel: each
    normalised value is then the sign of a difference near 0, and the two
    frameworks disagree by O(1), measured 0.52; so Inception runs at 107.)
  * one training step of ResNet (stage_sizes (1,1,1,1), 64 px, batch 4,
    2-step APGD, no mixup (the step draws nothing), SGD with momentum and
    the resnet decay rule at LR 0.1, EMA 0.5): loss and
    grad_norm to 1e-4 relative, accuracies equal, every parameter, running
    statistic and EMA element within 1e-4 absolute (as
    tests/test_torch_port_train.py). JAX's step runs in f64 here: in f32 on
    the CPU its weight gradients through the train-mode BatchNorms of
    layers 3-4 (64 and 16 values a channel) are 4% off its own f64 ones
    (0.174935 against 0.174972 at the largest element of layer3's conv1),
    where the port's f32 ones are 4e-6 off. SGD, whose update is the
    gradient's: AdamW's first update is about LR * sign(g), so a gradient
    element near zero in both frameworks (measured: 19 tensors' elements)
    lands 2 LR apart; AdamW's parity is test_torch_port_train.py's. One
    step: a second one starts APGD from weights and statistics that differ
    in their last bits, and its sign steps then move the loss by 0.4%.
Negative controls: a BatchNorm that keeps torch's unbiased running_var,
and a step with a substring weight-decay rule on torch names (which
decays downsample.1.weight), each fail the comparison.
"""

import functools
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as fnn

from _torch_port_util import NCLS, images
from revisiting_at_tpu.ckpt import torch_import as jimport
from revisiting_at_tpu.models.densenet import DenseNet as JaxDenseNet
from revisiting_at_tpu.models.inception import InceptionV3 as JaxInception
from revisiting_at_tpu.models.resnet import ResNet as JaxResNet
from revisiting_at_tpu.models import get_model as jax_get_model
from revisiting_at_tpu.train import ema as jema
from revisiting_at_tpu.train import optimizer as jopt
from revisiting_at_tpu.train.state import TrainState as JaxState
from revisiting_at_tpu.train.train_step import AdvConfig as JaxAdv
from revisiting_at_tpu.train.train_step import make_train_step as jax_make_train_step
from revisiting_at_tpu_torch.attacks import AdversarialModel, apgd_attack, pgd_attack
from revisiting_at_tpu_torch.ckpt import checkpoint as tckpt
from revisiting_at_tpu_torch.ckpt.convert import jax_params_to_state_dict
from revisiting_at_tpu_torch.ckpt.torch_import import load_timm_pretrained
from revisiting_at_tpu_torch.cli import eval as eval_cli
from revisiting_at_tpu_torch.cli import export as export_cli
from revisiting_at_tpu_torch.cli import train as train_cli
from revisiting_at_tpu_torch.config import config_from_args
from revisiting_at_tpu_torch.models import (BatchNorm, DenseNet, InceptionV3, ResNet,
                                            get_model)
from revisiting_at_tpu_torch.models.resnet import gelu_tanh
from revisiting_at_tpu_torch.train import (AdvConfig, TrainState, attack_grad_mode, ema_init,
                                           make_optimizer, make_train_step, wd_mask)
from revisiting_at_tpu_torch.train import optimizer as topt
from revisiting_at_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
T = torch.from_numpy

# name -> (JAX module, port module, arch for the converter, image size)
SMALL = {
    "resnet": (lambda: JaxResNet(stage_sizes=(1, 1, 1, 1), num_classes=NCLS),
               lambda: ResNet((1, 1, 1, 1), num_classes=NCLS), "resnet50", 64),
    "resnet_gelu": (lambda: JaxResNet(stage_sizes=(1, 1, 1, 1), num_classes=NCLS, act=fnn.gelu),
                    lambda: ResNet((1, 1, 1, 1), num_classes=NCLS, act=gelu_tanh),
                    "resnet50_gelu", 64),
    "densenet": (lambda: JaxDenseNet(block_config=(1, 1, 1, 1), num_classes=NCLS),
                 lambda: DenseNet((1, 1, 1, 1), num_classes=NCLS), "densnet201", 64),
    "inception": (lambda: JaxInception(num_classes=NCLS), lambda: InceptionV3(num_classes=NCLS),
                  "inception", 107),
}
TRAIN_TOL = {"resnet": 1e-4, "resnet_gelu": 1e-4, "densenet": 1e-4, "inception": 5e-3}


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@functools.lru_cache(maxsize=None)
def bn_variables(name, seed=0):
    """(params, batch_stats) of SMALL[name]'s JAX module, drawn with numpy:
    kernels N(0, 1/fan_in), BN scales U(0.5, 1.5), biases N(0, 0.1), running
    means N(0, 0.1), running variances U(0.5, 1.5)."""
    jm, _, _, img = SMALL[name]
    shapes = jax.eval_shape(functools.partial(jm().init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, img, img, 3)))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        key = str(path[-1].key)
        if key == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return tree["params"], tree["batch_stats"]


def port_model(name, seed=0):
    """SMALL[name]'s port module with bn_variables' weights and statistics."""
    _, tm, arch, _ = SMALL[name]
    model = tm()
    model.load_state_dict(jax_params_to_state_dict(*bn_variables(name, seed)[:1], arch,
                                                   bn_variables(name, seed)[1]), strict=True)
    return model


def _stats_sd(name, stats):
    """The running statistics of a JAX batch_stats tree, by port name."""
    params = bn_variables(name)[0]
    sd = jax_params_to_state_dict(params, SMALL[name][2], jax.tree.map(np.asarray, stats))
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


@functools.lru_cache(maxsize=None)
def jax_forward(name):
    """(eval logits, train logits, updated batch_stats) of the JAX module on
    2 images: the reference of test_bn_forward_matches_jax."""
    jm, _, _, img = SMALL[name]
    jm = jm()
    params, stats = bn_variables(name)
    x = jnp.asarray(images(n=2, img=img, seed=4))
    v = {"params": params, "batch_stats": stats}

    @jax.jit
    def both(x):
        ev = jm.apply(v, x, train=False)
        tr, mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
        return ev, tr, mut["batch_stats"]

    ev, tr, new = both(x)
    return np.asarray(ev), np.asarray(tr), _stats_sd(name, new)


def _port_forward(name):
    model = port_model(name)
    x = T(images(n=2, img=SMALL[name][3], seed=4))
    with torch.no_grad():
        ev = model.eval()(x)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        tr = model.train()(x)
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return ev, tr, stats, before, model


@pytest.mark.parametrize("name", list(SMALL))
def test_bn_forward_matches_jax(name):
    """Eval logits (running statistics read), then train-mode logits (batch
    statistics) and the running statistics that one train forward leaves
    (flax's rule: biased variance), each against JAX's."""
    ev_ref, tr_ref, stats_ref = jax_forward(name)
    ev, tr, stats, before, model = _port_forward(name)
    assert ev.dtype == torch.float32 and tuple(ev.shape) == (2, NCLS)
    assert _rel(ev, ev_ref) < 1e-4
    assert _rel(tr, tr_ref) < TRAIN_TOL[name]
    assert stats.keys() == stats_ref.keys()
    for k, v in stats.items():
        assert _rel(v, stats_ref[k]) < TRAIN_TOL[name], k
        assert not torch.equal(v, before[k]), k  # every statistic moved
    counts = [v for k, v in model.state_dict().items() if k.endswith("num_batches_tracked")]
    assert counts and all(int(c) == 1 for c in counts)


def test_unbiased_running_var_fails_the_comparison(monkeypatch):
    """Negative control: torch's running_var rule (the unbiased variance
    n / (n - 1) var) breaks the statistics comparison above."""
    real = BatchNorm.forward

    def unbiased(self, x):
        if not self.training:
            return real(self, x)
        var_before = self.running_var.clone()
        y = real(self, x)
        n = x.numel() // x.shape[-1]
        with torch.no_grad():
            var = (self.running_var - self.momentum * var_before) / (1 - self.momentum)
            self.running_var.copy_(self.momentum * var_before
                                   + (1 - self.momentum) * var * n / (n - 1))
        return y

    monkeypatch.setattr(BatchNorm, "forward", unbiased)
    _, _, stats_ref = jax_forward("resnet")
    _, _, stats, _, _ = _port_forward("resnet")
    assert max(_rel(v, stats_ref[k]) for k, v in stats.items()) > 1e-4


def test_resnet50_gelu_takes_jax_tanh_gelu():
    """ROADMAP C20: JAX's resnet50_gelu uses nn.gelu, whose default is the
    tanh approximation, and the port follows it, not the reference's erf."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    assert np.abs(gelu_tanh(T(x)).numpy() - np.asarray(jax.nn.gelu(jnp.asarray(x)))).max() < 1e-6
    assert float((gelu_tanh(T(x)) - torch.nn.functional.gelu(T(x))).abs().max()) > 1e-4
    model, meta = get_model("resnet50_gelu", num_classes=NCLS, dtype=torch.float32)
    assert model.act is gelu_tanh and meta.has_batch_stats and meta.family == "resnet"


# ------------------------------------------------------- weight decay

def _jax_mask_names(name):
    """Port names whose JAX wd_mask(params, 'resnet') leaf is True."""
    params, stats = bn_variables(name)
    mask = jopt.wd_mask(params, "resnet")
    full = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params)
    sd = jax_params_to_state_dict(full, SMALL[name][2], jax.tree.map(np.ones_like, stats))
    return {k for k, v in sd.items() if v.dtype == torch.float32 and v.numel() and v.all()
            and not k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("name", ["resnet", "densenet", "inception"])
def test_wd_mask_matches_jax(name):
    """The resnet rule leaf for leaf against JAX's wd_mask(params, 'resnet')
    (ROADMAP C21): ResNet's downsample BatchNorm is excluded as JAX's
    downsample_bn, DenseNet's norm scales decay, every bias is excluded."""
    model = port_model(name)
    mine = {k for k, v in wd_mask(model, "resnet").items() if v}
    assert mine == _jax_mask_names(name)
    if name == "resnet":
        assert "layer2.0.downsample.1.weight" not in mine
        assert "layer2.0.downsample.0.weight" in mine and "fc.weight" in mine
    if name == "densenet":
        assert "features.norm0.weight" in mine and "features.norm0.bias" not in mine


# ------------------------------------------------------ the train step

STEP_LR, STEPS = 0.1, 1  # SGD at a constant LR


def _step_batch():
    return images(n=4, img=64, seed=3), np.array([2, 2, 2, 4], np.int32)


@pytest.fixture(scope="module")
def jax_bn_step():
    """One JAX step of the small ResNet with has_batch_stats: (params and
    statistics before, metrics, the state after as port state_dicts: raw and
    EMA, each with its statistics)."""
    as_sd = lambda p, s: jax_params_to_state_dict(  # noqa: E731
        jax.tree.map(np.asarray, p), "resnet50", jax.tree.map(np.asarray, s))
    x, y = _step_batch()
    out = []
    with jax.enable_x64(True):  # the reference in f64: see the module docstring
        jm = JaxResNet(stage_sizes=(1, 1, 1, 1), num_classes=NCLS, dtype=jnp.float64)
        params, stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     bn_variables("resnet", seed=1))
        tx = jopt.make_optimizer(optimizer="sgd", weight_decay=0.5, momentum=0.9,
                                 family="resnet", learning_rate=STEP_LR, params=params)
        state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=tx.init(params), ema_params=jema.ema_init(params),
                         batch_stats=stats, ema_batch_stats=jema.ema_init(stats))
        step = jax_make_train_step(jm, tx, adv=JaxAdv(attack="apgd", n_iter=2), mixup=None,
                                   ema_decay=0.5, seed=0, has_batch_stats=True, donate=False)
        for _ in range(STEPS):
            state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
            out.append(({k: float(v) for k, v in metrics.items()},
                        as_sd(state.params, state.batch_stats),
                        as_sd(state.ema_params, state.ema_batch_stats)))
    return out


def _port_bn_step():
    model = ResNet((1, 1, 1, 1), num_classes=NCLS)
    model.load_state_dict(jax_params_to_state_dict(*bn_variables("resnet", 1)[:1], "resnet50",
                                                   bn_variables("resnet", 1)[1]))
    opt = make_optimizer(model, optimizer="sgd", weight_decay=0.5, momentum=0.9,
                         family="resnet", learning_rate=STEP_LR)
    step = make_train_step(model, adv=AdvConfig(attack="apgd", n_iter=2), mixup=None,
                           ema_decay=0.5, seed=0)
    return TrainState(model, opt, ema_init(model)), step


def _bn_step_mismatches(state, step, trajectory):
    x, y = _step_batch()
    bad = []
    for i, (metrics_ref, raw_ref, ema_ref) in enumerate(trajectory):
        got = {k: float(v) for k, v in step(state, T(x), T(y)).items()}
        bad += [(i, k, got[k], metrics_ref[k]) for k in ("loss", "grad_norm")
                if abs(got[k] - metrics_ref[k]) > 1e-4 * abs(metrics_ref[k])]
        bad += [(i, k, got[k], metrics_ref[k]) for k in ("adv_acc", "train_acc")
                if got[k] != metrics_ref[k]]
        raw = state.model.state_dict()
        for k, v in raw_ref.items():
            if k.endswith("num_batches_tracked"):
                continue
            for what, mine, theirs in (("raw", raw[k], v), ("ema", state.ema[k], ema_ref[k])):
                e = float((mine.float() - theirs).abs().max())
                if e > 1e-4:
                    bad.append((i, what, k, e))
    return bad


def test_bn_train_step_matches_jax(jax_bn_step):
    """The step with running statistics: the attack in eval mode with them
    frozen, the training forward moving them once, AdamW with the resnet
    decay rule, and the EMA of the parameters and of the statistics."""
    state, step = _port_bn_step()
    ema_keys = set(state.ema)
    assert "bn1.running_var" in ema_keys and "layer1.0.downsample.1.running_mean" in ema_keys
    assert _bn_step_mismatches(state, step, jax_bn_step) == []
    assert int(state.model.bn1.num_batches_tracked) == STEPS


def test_bn_train_step_parity_has_teeth(jax_bn_step, monkeypatch):
    """A substring rule on torch names (decaying downsample.1.weight, which
    JAX's downsample_bn excludes) fails the comparison above (C21)."""
    real = topt.wd_mask

    def substring(model, family):
        mask = real(model, family)
        return {k: v or ("downsample.1.weight" in k) for k, v in mask.items()}

    monkeypatch.setattr(topt, "wd_mask", substring)
    state, step = _port_bn_step()
    assert any("downsample.1.weight" in str(b) for b in _bn_step_mismatches(state, step,
                                                                           jax_bn_step))


def test_attacks_leave_running_statistics_frozen():
    """APGD in the train step's attack mode, pgd_attack and the wrapped
    model's attack leave a BN model's running statistics and counters as
    they were (a train-mode forward would move them), and the model's mode
    is restored; the training forward then moves them once."""
    model = port_model("resnet").train()
    x, y = T(images(n=2, img=64, seed=8)), torch.tensor([1, 2])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with attack_grad_mode(model):
        apgd_attack(model, x, y, n_iter=2, is_train=True)
    pgd_attack(model, x, y, n_iter=2, generator=torch.Generator().manual_seed(0))
    wrapped = AdversarialModel(model, attack="fgsm", seed=1)
    wrapped.perturb(x, y)
    assert model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    wrapped.set_perturb(True)
    wrapped(x, y, train=True)
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert "bn1.running_var" in moved and int(model.bn1.num_batches_tracked) == 1


# --------------------------------------------------- checkpoint bridges

@pytest.mark.parametrize("name", ["resnet", "densenet", "inception"])
def test_round_trip_through_jax_import(name, tmp_path):
    """The port's state_dict -> the JAX package's load_torch_checkpoint (its
    BN_MAPPERS) -> the port's converter -> the same tensors; a state_dict
    without num_batches_tracked strict-loads with it at 0."""
    model = port_model(name, seed=2)
    sd = model.state_dict()
    torch.save(sd, tmp_path / "w.pt")
    params, stats = bn_variables(name)
    p2, s2 = jimport.load_torch_checkpoint(str(tmp_path / "w.pt"), SMALL[name][2], params,
                                           target_batch_stats=stats)
    back = jax_params_to_state_dict(jax.tree.map(np.asarray, p2), SMALL[name][2],
                                    jax.tree.map(np.asarray, s2))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v if v.dtype == torch.long else v.float()) or (
            k.endswith("num_batches_tracked")), k
    fresh = SMALL[name][1]()
    fresh.load_state_dict({k: v for k, v in sd.items() if "num_batches" not in k}, strict=True)


def _name_map(params, arch, stats=None):
    """{JAX flat path: port name}, one leaf at a time through the converter."""
    out = {}
    flat = {"params": params} if stats is None else {"params": params, "batch_stats": stats}
    for coll, tree in flat.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [str(p.key) for p in path]
            single: dict = {}
            node = single
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = np.zeros(np.shape(leaf), np.float32)
            sd = (jax_params_to_state_dict(single, arch) if stats is None else
                  jax_params_to_state_dict(single if coll == "params" else {}, arch,
                                           single if coll == "batch_stats" else {}))
            out["/".join(keys)] = next(k for k in sd if not k.endswith("num_batches_tracked"))
    return out


def _pretrained_case(arch, tmp_path):
    """(source file, port target, JAX target params, JAX target stats, the
    port arch): a timm-format state dict made in-process (the model without
    ConvStem and with a 1,000-class head) for a ConvStem target of 10
    classes; for the BN family a small ResNet's, wrapped in {'state_dict': ...}
    under DDP's 'module.' prefix."""
    if arch == "resnet":
        src = port_model("resnet", seed=3)
        sd = {f"module.{k}": v for k, v in src.state_dict().items()}
        torch.save({"state_dict": sd}, tmp_path / "src.pt")
        params, stats = bn_variables("resnet")
        return tmp_path / "src.pt", ResNet((1, 1, 1, 1), num_classes=NCLS), params, stats, \
            "resnet50"
    torch.manual_seed(3)
    src, _ = get_model(arch, num_classes=1000, dtype=torch.float32, img_size=32)
    torch.save({"model": src.state_dict()}, tmp_path / "src.pt")
    jm, _ = jax_get_model(arch, not_original=True, num_classes=NCLS, dtype=jnp.float32)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    target, _ = get_model(arch, not_original=True, num_classes=NCLS, dtype=torch.float32,
                          img_size=32)
    return tmp_path / "src.pt", target, params, None, arch


@pytest.mark.parametrize("arch", ["convnext_micro", "vit_micro", "resnet"])
def test_pretrained_loader_matches_jax(arch, tmp_path):
    """load_timm_pretrained against JAX's on the same file: the same
    tensors loaded and kept random (JAX's paths mapped to port names), the
    same values loaded; the ConvStem keeps its init and the 1,000-class head
    is a shape mismatch (a warning)."""
    path, target, params, stats, jarch = _pretrained_case(arch, tmp_path)
    with pytest.warns(UserWarning) if arch != "resnet" else _no_warning():
        jp, jrep = jimport.load_timm_pretrained(str(path), jarch, params,
                                                target_batch_stats=stats)
    init = {k: v.clone() for k, v in target.state_dict().items()}
    with pytest.warns(UserWarning) if arch != "resnet" else _no_warning():
        rep = load_timm_pretrained(path, target, jarch)
    names = _name_map(params, jarch, stats)
    assert set(rep["loaded"]) == {names[k] for k in jrep["loaded"]}
    assert set(rep["kept_random"]) == {names[k] for k in jrep["kept_random"]}
    assert {m[0] for m in rep["shape_mismatch"]} == {names[m[0]] for m in
                                                      jrep["shape_mismatch"]}
    ref = jax_params_to_state_dict(jax.tree.map(np.asarray, jp), jarch,
                                   None if stats is None else
                                   jax.tree.map(np.asarray, jrep["batch_stats"]))
    sd = target.state_dict()
    for k in rep["loaded"]:
        assert torch.equal(sd[k], ref[k]), k
    for k in rep["kept_random"]:
        assert torch.equal(sd[k], init[k]), k
    if arch == "resnet":
        assert not rep["kept_random"] and not rep["stats_kept_random"]
        assert torch.equal(sd["bn1.running_var"], ref["bn1.running_var"])
    else:
        assert any(".stem." in k for k in rep["kept_random"])


class _no_warning:
    def __enter__(self):
        import warnings
        self._w = warnings.catch_warnings()
        self._w.__enter__()
        warnings.simplefilter("error")

    def __exit__(self, *exc):
        self._w.__exit__(*exc)


def test_pretrained_loader_refusals(tmp_path):
    """convnext_iso (no timm layout), a file that matches nothing and a
    BN-family file without its stem raise JAX's ValueErrors; inside the
    ImageNet normalizer the port still loads (ROADMAP C23: JAX's merge
    finds no leaf under its 'model' level and raises)."""
    micro, _ = get_model("convnext_micro", dtype=torch.float32)
    iso, _ = get_model("convnext_iso", dtype=torch.float32)
    torch.save(micro.state_dict(), tmp_path / "micro.pt")
    with pytest.raises(ValueError, match="Meta layout"):
        load_timm_pretrained(tmp_path / "micro.pt", iso, "convnext_iso")
    vit, _ = get_model("vit_micro", dtype=torch.float32, img_size=32)
    with pytest.raises(ValueError, match="matched no parameters"):
        load_timm_pretrained(tmp_path / "micro.pt", vit, "vit_micro")
    with pytest.raises(ValueError, match="missing key 'conv1.weight'"):
        load_timm_pretrained(tmp_path / "micro.pt", ResNet((1, 1, 1, 1)), "resnet50")
    wrapped, _ = get_model("convnext_micro", dtype=torch.float32, add_normalization=True)
    rep = load_timm_pretrained(tmp_path / "micro.pt", wrapped, "convnext_micro")
    assert not rep["kept_random"] and torch.equal(wrapped.model.head.fc.weight,
                                                  micro.head.fc.weight)
    jm, _ = jax_get_model("convnext_micro", num_classes=1000, dtype=jnp.float32,
                          add_normalization=True)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    with pytest.raises(ValueError, match="matched no parameters"):
        jimport.load_timm_pretrained(str(tmp_path / "micro.pt"), "convnext_micro",
                                     jax.tree.map(lambda s: np.zeros(s.shape), shapes))


# -------------------------------------------------- trainer and the CLIs

def _argv(tmp_path, arch, *extra):
    return ["--model.arch", arch, "--data.num_classes", str(NCLS), "--training.batch_size", "2",
            "--resolution.min_res", "32", "--resolution.max_res", "32",
            "--validation.resolution", "32", "--validation.batch_size", "2",
            "--validation.max_batches", "1", "--logging.folder", str(tmp_path),
            "--training.precision", "fp32", "--data.dataset", "synthetic",
            "--model.add_normalization", "0", *extra,
            "--device", "cpu"]


def test_trainer_pretrained_init(tmp_path):
    """model.pretrained=1 or a *_21k arch without a path: JAX's ValueError;
    with a path the weights load before the EMA is made."""
    for extra in (["--model.pretrained", "1"], ["--model.arch", "convnext_tiny_21k"]):
        cfg = config_from_args(_argv(tmp_path, "convnext_micro", *extra)[:-2])
        with pytest.raises(ValueError, match="needs model.pretrained_path"):
            Trainer(cfg, device="cpu", synthetic_batches=1)
    src, _ = get_model("convnext_micro", num_classes=NCLS, dtype=torch.float32)
    torch.save(src.state_dict(), tmp_path / "src.pt")
    cfg = config_from_args(_argv(tmp_path, "convnext_micro", "--model.pretrained", "1",
                                 "--model.pretrained_path", str(tmp_path / "src.pt"),
                                 "--model.model_ema", "1")[:-2])
    trainer = Trainer(cfg, device="cpu", synthetic_batches=1)
    w = src.stages[2].blocks[0].mlp.fc1.weight
    assert torch.equal(trainer.model.stages[2].blocks[0].mlp.fc1.weight, w)
    assert torch.equal(trainer.state.ema["stages.2.blocks.0.mlp.fc1.weight"], w)


def test_bn_run_export_and_eval(tmp_path, capsys):
    """A resnet50 port run (2 epochs, EMA, adversarial validation) through
    cli.export with --epoch, --best and --use_ema (the EMA file carries the
    EMA statistics, which differ from the raw ones) and cli.eval --use_ema 1;
    a run without EMA is refused with JAX's wording (ROADMAP C22: JAX's
    exporter covers ConvNeXt and ViT only)."""
    trainer = train_cli.main(_argv(tmp_path / "runs", "resnet50", "--model.model_ema", "1",
                                   "--adv.attack", "apgd", "--adv.n_iter", "1",
                                   "--training.epochs", "2", "--synthetic_batches", "2",
                                   "--validation.adv_val_freq", "1",
                                   "--validation.adv_val_iter", "1",
                                   "--validation.adv_val_batches", "1"))
    run, ema = trainer.logger.dir, trainer.state.ema
    raw = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    outs = {}
    for flags in ([], ["--epoch", "0"], ["--best"], ["--use_ema", "1"]):
        out = tmp_path / f"out{len(outs)}.pt"
        export_cli.main(["--run_dir", str(run), "--out", str(out), *flags])
        outs[" ".join(flags)] = torch.load(out, weights_only=True)
    printed = capsys.readouterr().out
    assert re.search(r"exported resnet50 \(ema params, ckpt step 1\) -> .* \(timm-0.8 "
                     r"state_dict\)", printed)
    assert all(torch.equal(outs[""][k], v) for k, v in raw.items())
    assert all(torch.equal(outs["--use_ema 1"][k], ema[k]) for k in ema)
    assert not torch.equal(outs["--use_ema 1"]["bn1.running_var"], raw["bn1.running_var"])
    assert not torch.equal(outs["--epoch 0"]["fc.weight"], raw["fc.weight"])
    best = [int(p.stem.split("_")[-1]) for p in (run / "ckpt_best").glob("weights_[0-9]*.pt")]
    assert torch.equal(outs["--best"]["fc.weight"],
                       torch.load(run / "ckpt_best" / f"weights_{best[0]}.pt")["fc.weight"])
    model, _ = get_model("resnet50", num_classes=NCLS)
    model.load_state_dict(outs["--use_ema 1"], strict=True)
    sd, _ = tckpt.restore_run_weights(run, "resnet50", use_ema=True)
    assert torch.equal(sd["layer1.0.bn3.running_mean"], ema["layer1.0.bn3.running_mean"])
    res = eval_cli.main(["--run_dir", str(run), "--use_ema", "1", "--synthetic", "--n_ex", "2",
                         "--batch_size", "2", "--n_iter", "1", "--img_size", "32",
                         "--device", "cpu"])
    assert 0.0 <= res["Linf"]["robust"] <= 1.0
    for f in (run / "ckpt").glob("weights_ema_*.pt"):
        f.unlink()
    with pytest.raises(ValueError, match="use_ema requested but the run kept no EMA params"):
        export_cli.main(["--run_dir", str(run), "--out", str(tmp_path / "x.pt"),
                         "--use_ema", "1"])


def test_jax_bn_run_pairs_ema_weights_with_ema_statistics(tmp_path):
    """A JAX BN run's orbax snapshot (written by JAX's CheckpointManager),
    read by the port's orbax reader: the params with the batch_stats, and
    with use_ema the EMA params with the ema_batch_stats, as JAX's
    TrainState.ema_variables pairs them; JAX's restore_run_params gives the
    raw statistics with the EMA params (ROADMAP C19)."""
    from revisiting_at_tpu.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
    from revisiting_at_tpu.ckpt.checkpoint import restore_run_params

    params, stats = bn_variables("resnet")
    ema_p = jax.tree.map(lambda v: v * 0.9, params)
    ema_s = jax.tree.map(lambda v: v * 0.5 + 0.25, stats)
    tx = jopt.make_optimizer(optimizer="sgd", weight_decay=0.5, family="resnet",
                             learning_rate=0.1, params=params)
    mgr = JaxCheckpointManager(tmp_path)
    mgr.maybe_save(0, JaxState(step=jnp.asarray(0, jnp.int32), params=params,
                               opt_state=tx.init(params), ema_params=ema_p, batch_stats=stats,
                               ema_batch_stats=ema_s))
    mgr.wait()
    for use_ema, (p, s) in ((False, (params, stats)), (True, (ema_p, ema_s))):
        sd, epoch = tckpt.restore_run_weights(tmp_path, "resnet50", use_ema=use_ema)
        ref = jax_params_to_state_dict(jax.tree.map(np.asarray, p), "resnet50",
                                       jax.tree.map(np.asarray, s))
        assert epoch == 0 and sd.keys() == ref.keys()
        assert all(torch.equal(sd[k], v) for k, v in ref.items()), use_ema
    _, jax_stats, _ = restore_run_params(tmp_path, use_ema=True)
    assert np.array_equal(np.asarray(jax_stats["bn1"]["var"]), stats["bn1"]["var"])
