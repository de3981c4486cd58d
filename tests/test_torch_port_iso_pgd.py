"""Port parity of the isotropic ConvNeXt, plain PGD and the wrapped model
(models/convnext.py ConvNeXtIsotropic, the convnext_iso factory entry and
converter, attacks/pgd.py, attacks/wrapped.py) against the JAX package on
the CPU, with the same weights (ckpt/convert.py) and JAX's random draws
injected. CPU time: 101 s of wall time and 147 s of CPU in one pytest
process on 8 cores with an empty JAX compile cache, most of it JAX
compiling the full-width factory models and the interpret-mode kernels.

Tolerances, relative to the largest reference value, in fp32:
  * the full-width factory models (updated 0 and 1, ConvStem, 18 blocks,
    the plain tail): logits and input gradients to 1e-4, f32 rounding of
    differently ordered sums;
  * the small iso model on the fused tail (JAX in Pallas interpret mode,
    the port in its kernels' plain versions): logits, input and weight
    gradients to 2e-3, since a one-ulp LayerNorm difference can flip a
    bf16 rounding of a matmul operand (tests/test_torch_port_models.py);
  * one training step (2-step APGD, mixup, AdamW, EMA): as
    tests/test_torch_port_train.py, loss and grad_norm to 1e-4 relative,
    accuracies equal, every parameter and EMA element within 1e-4;
  * PGD and the wrapped model's attack points: 1e-5 absolute, except for at
    most 0.5% of the elements, each within 2 eps: an input gradient
    component near zero can take the other sign in the other framework, and
    a sign step then moves that pixel the other way (tests/
    test_torch_port_slice.py). Logits of the wrapped model's forward on
    those points: 2e-3.
Negative control: PGD from another start fails the comparison.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import NCLS, images, jax_mixup_draws, perturbed_params, step_mismatches
from revisiting_at_tpu.attacks.pgd import pgd_attack as jax_pgd_attack
from revisiting_at_tpu.attacks.wrapped import AdversarialModel as JaxAdversarialModel
from revisiting_at_tpu.ckpt.torch_export import export_torch_state_dict
from revisiting_at_tpu.data import mixup as jmix
from revisiting_at_tpu.models import get_model as jax_get_model
from revisiting_at_tpu.models.convnext import ConvNeXtIsotropic as JaxIso
from revisiting_at_tpu.models.stems import ConvStem as JaxConvStem
from revisiting_at_tpu.ops.losses import ce_indiv as jax_ce
from revisiting_at_tpu.train import ema as jema
from revisiting_at_tpu.train import optimizer as jopt
from revisiting_at_tpu.train import schedule as jsched
from revisiting_at_tpu.train.state import TrainState as JaxState
from revisiting_at_tpu.train.train_step import AdvConfig as JaxAdv
from revisiting_at_tpu.train.train_step import input_grad_view as jax_input_view
from revisiting_at_tpu.train.train_step import make_train_step as jax_make_train_step
from revisiting_at_tpu_torch.attacks import AdversarialModel, pgd_attack
from revisiting_at_tpu_torch.ckpt.convert import jax_params_to_state_dict, load_state_dict
from revisiting_at_tpu_torch.data import MixupConfig
from revisiting_at_tpu_torch.models import ConvNeXtIsotropic, ConvStem, get_model
from revisiting_at_tpu_torch.ops.losses import ce_indiv
from revisiting_at_tpu_torch.train import (AdvConfig, LRConfig, TrainState, ema_init,
                                           make_lr_schedule, make_optimizer, make_train_step)

torch.set_num_threads(1)
T = torch.from_numpy
ISO = dict(dim=32, depth=2, num_classes=NCLS)
EPS = 8.0 / 255.0


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@functools.lru_cache(maxsize=None)
def _iso_params(cvst: bool):
    """Perturbed f32 init params of the small JAX iso model (32 px)."""
    jm, _ = _iso_pair_models(cvst, use_pallas=False)
    init = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 32, 32, 3))))
    return perturbed_params(init(jax.random.PRNGKey(0))["params"], 0)


def _iso_pair_models(cvst: bool, use_pallas: bool):
    """The small iso model (dim 32, depth 2, ConvStem(4, 8) or the /16
    conv), JAX's in interpret mode with use_pallas, and the port's."""
    jstem = functools.partial(JaxConvStem, siz=4, end_siz=8, fin_dim=32) if cvst else None
    tstem = functools.partial(ConvStem, siz=4, end_siz=8, fin_dim=32) if cvst else None
    jm = JaxIso(**ISO, stem_factory=jstem, dtype=jnp.float32, use_pallas=use_pallas,
                pallas_interpret=use_pallas)
    tm = ConvNeXtIsotropic(**ISO, stem_factory=tstem, use_pallas=use_pallas)
    return jm, tm


def iso_pair(cvst=True, use_pallas=True):
    """(JAX module, its variables, the port's module with the same weights)."""
    jm, tm = _iso_pair_models(cvst, use_pallas)
    params = _iso_params(cvst)
    load_state_dict(tm, jax_params_to_state_dict(params, "convnext_iso"))
    return jm, {"params": params}, tm.eval()


def _numpy_params(jm, img, seed=0):
    """A JAX param tree of jm's shapes drawn with numpy (no init compile):
    kernels N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.1), the rest N(0, 0.05)."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name.endswith("kernel"):
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        base = 1.0 if name.endswith("scale") else 0.0
        return (base + rng.randn(*s.shape) * (0.1 if base else 0.05)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("updated", [0, 1])
def test_iso_factory_matches_jax(updated):
    """convnext_iso through both factories (ConvStem(48, 8) to 432 or 384,
    18 blocks of that width) at 32 px, the plain tail: logits and input
    gradients; the weights go through JAX's exporter and strict-load."""
    jm, _ = jax_get_model("convnext_iso", not_original=True, updated=bool(updated),
                          num_classes=NCLS, dtype=jnp.float32)
    params = _numpy_params(jm, 32, seed=updated)
    tm, meta = get_model("convnext_iso", not_original=True, updated=bool(updated),
                         num_classes=NCLS, dtype=torch.float32)
    assert meta.family == "convnext" and not meta.has_batch_stats
    assert tm.norm.weight.shape == (432 if updated else 384,) and len(tm.blocks) == 18
    sd = export_torch_state_dict(params, "convnext_iso")
    tm.load_state_dict({k: T(np.asarray(v, np.float32)) for k, v in sd.items()}, strict=True)
    x, y = images(n=2), np.array([1, 7])

    def loss(xx):
        logits = jm.apply({"params": params}, xx)
        return jnp.sum(jax_ce(logits, jnp.asarray(y))), logits

    (_, logits), gj = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(x))
    xt = T(x).requires_grad_(True)
    lt = tm.eval()(xt)
    ce_indiv(lt, T(y)).sum().backward()
    assert _rel(lt.detach(), logits) < 1e-4
    assert _rel(xt.grad, gj) < 1e-4


@pytest.mark.parametrize("cvst", [False, True])
def test_iso_converter_equals_jax_export(cvst):
    """The port's converter gives JAX's export, key for key and bit for bit
    (head_norm -> norm, Meta's block names, the ConvStem at stem.stem.<i>),
    and the export strict-loads into the port's model."""
    params = _iso_params(cvst)
    mine = jax_params_to_state_dict(params, "convnext_iso")
    ref = export_torch_state_dict(params, "convnext_iso")
    assert mine.keys() == ref.keys()
    for k, v in ref.items():
        assert np.array_equal(mine[k].numpy(), np.asarray(v, np.float32)), k
    assert "norm.weight" in mine and "blocks.1.pwconv2.weight" in mine
    assert ("stem.stem.12.weight" in mine) == cvst and ("stem.weight" in mine) != cvst
    _, tm = _iso_pair_models(cvst, use_pallas=False)
    tm.load_state_dict(mine, strict=True)
    assert not any(name.endswith("gamma") for name, _ in tm.named_parameters())


def test_iso_kernel_path_matches_jax():
    """The small iso model on the fused tail: logits, the input gradient
    (the attack's input-only backward) and the weight gradients (the full
    backward) against JAX in interpret mode."""
    jm, v, tm = iso_pair()
    x, y = images(n=2), np.array([3, 5])
    yj = jnp.asarray(y)

    def loss(params, xx):  # logits and both gradients from one JAX program
        logits = jm.apply({"params": params}, xx)
        return jnp.sum(jax_ce(logits, yj)), logits

    (_, logits), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        v["params"], jnp.asarray(x))
    xt = T(x).requires_grad_(True)
    lt = tm(xt)
    ce_indiv(lt, T(y)).sum().backward()
    assert _rel(lt.detach(), logits) < 2e-3
    assert _rel(xt.grad, gx) < 2e-3
    ref = jax_params_to_state_dict(jax.tree.map(np.asarray, gp), "convnext_iso")
    for name, p in tm.named_parameters():
        assert _rel(p.grad, ref[name]) < 2e-3, name


def test_iso_train_step_matches_jax():
    """One adversarial training step of the small iso model (2-step APGD,
    mixup with JAX's draws, AdamW with the convnext decay rule, EMA) on the
    fused tail, held to JAX's make_train_step in interpret mode."""
    jm, v, tm = iso_pair()
    params = v["params"]
    lr = dict(lr=2e-3, schedule_type="cosine", lr_peak_epoch=1, epochs=3)
    tx = jopt.make_optimizer(optimizer="adamw", weight_decay=0.5, family="convnext",
                             learning_rate=jsched.make_lr_schedule(jsched.LRConfig(**lr), 2),
                             params=params)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                     ema_params=jema.ema_init(params))
    step = jax_make_train_step(jm, tx, adv=JaxAdv(attack="apgd", n_iter=2),
                               mixup=jmix.MixupConfig(num_classes=NCLS), ema_decay=0.5, seed=0,
                               donate=False)
    x, y = images(n=4, seed=3), np.array([2, 2, 2, 4], np.int32)
    state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
    as_sd = lambda tree: jax_params_to_state_dict(jax.tree.map(np.asarray, tree),  # noqa: E731
                                                  "convnext_iso")
    trajectory = [({k: float(m) for k, m in metrics.items()}, as_sd(state.params),
                   as_sd(state.ema_params))]
    tm.train()
    opt = make_optimizer(tm, weight_decay=0.5, family="convnext",
                         learning_rate=make_lr_schedule(LRConfig(**lr), 2))
    cfg = MixupConfig(num_classes=NCLS)
    port_step = make_train_step(tm, adv=AdvConfig(attack="apgd", n_iter=2), mixup=cfg,
                                ema_decay=0.5, seed=0, mixup_draws=jax_mixup_draws(0, cfg))
    assert step_mismatches(TrainState(tm, opt, ema_init(tm)), port_step, trajectory, x, y) == []


# --------------------------------------------------------------- attacks

def _close_but_for_flips(got, ref, eps):
    """At most 0.5% of the elements beyond 1e-5, none beyond 2 eps."""
    d = np.abs(np.asarray(got) - np.asarray(ref))
    return d.max() <= 2 * eps + 1e-6 and (d > 1e-5).mean() <= 5e-3


def _pgd_start(norm, shape, seed):
    key = jax.random.PRNGKey(seed)
    if norm == "Linf":
        return key, np.asarray(jax.random.uniform(key, shape, jnp.float32, -EPS, EPS))
    return key, np.asarray(jax.random.normal(key, shape, jnp.float32))


@pytest.mark.parametrize("norm", ["Linf", "L2"])
def test_pgd_matches_jax(norm):
    """pgd_attack (5 steps, random start) on the small iso model with the
    fused tail, JAX's start injected; the port runs it in attack mode
    (input-only tail backward) and leaves the model as it found it."""
    jm, v, tm = iso_pair()
    eps = EPS if norm == "Linf" else 0.5
    view = jax_input_view(jm)
    x, y = images(n=4, seed=5), np.array([0, 1, 2, 3])
    key, start = _pgd_start(norm, x.shape, 7)
    start = start.copy()
    ref = jax.jit(lambda xx: jax_pgd_attack(lambda xa: view.apply(v, xa), xx, jnp.asarray(y),
                                            norm=norm, eps=eps, n_iter=5, rng=key))(
        jnp.asarray(x))
    tm.train()
    got = pgd_attack(tm, T(x), T(y), norm=norm, eps=eps, n_iter=5, noise=T(start))
    assert tm.training and tm.grad_mode == "full"
    assert all(p.grad is None and p.requires_grad for p in tm.parameters())
    assert _close_but_for_flips(got, ref, eps)
    delta = (got - T(x)).reshape(4, -1)
    bound = delta.abs().max() if norm == "Linf" else delta.norm(dim=1).max()
    assert float(bound) <= eps * (1 + 1e-5) and 0 <= float(got.min()) <= float(got.max()) <= 1
    # negative control: another start gives another point
    other = pgd_attack(tm, T(x), T(y), norm=norm, eps=eps, n_iter=5,
                       noise=T(_pgd_start(norm, x.shape, 8)[1].copy()))
    assert not _close_but_for_flips(other, ref, eps)


def test_pgd_default_draws_and_step_size():
    """Without `noise` the start comes from the generator (reproducible per
    seed); without a random start and with one step of step_size = eps the
    Linf point is the FGSM point x + eps * sign(g), clipped."""
    _, _, tm = iso_pair(use_pallas=False)
    x, y = T(images(n=2, seed=6)), torch.tensor([1, 2])
    a = pgd_attack(tm, x, y, n_iter=2, generator=torch.Generator().manual_seed(3))
    b = pgd_attack(tm, x, y, n_iter=2, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    xa = x.clone().requires_grad_(True)
    ce_indiv(tm(xa), y).sum().backward()
    one = pgd_attack(tm, x, y, n_iter=1, step_size=EPS, eps=EPS, random_start=False)
    assert torch.allclose(one, (x + EPS * xa.grad.sign()).clamp(0, 1), atol=1e-7)
    with pytest.raises(ValueError):
        pgd_attack(tm, x, y, norm="L1")


@pytest.mark.parametrize("attack", ["apgd", "fgsm"])
def test_adversarial_model_matches_jax(attack):
    """AdversarialModel against JAX's: with perturbation, two calls (FGSM's
    draws from fold_in(PRNGKey(seed), calls), injected), each the attack
    in eval mode then the train-mode forward; the attack points; then a
    clean eval forward. The plain tail: JAX's wrapper runs eagerly, and
    the kernel path's attack mode is test_pgd_matches_jax's."""
    jm, v, tm = iso_pair(use_pallas=False)
    x, y = images(n=4, seed=9), np.array([4, 5, 6, 7])
    jw = JaxAdversarialModel(jm, v, attack=attack, eps=EPS, n_iter=2, seed=3)

    def draws(calls, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(3), calls)
        return T(np.array(jax.random.uniform(key, shape, jnp.float32)))

    tw = AdversarialModel(tm, attack=attack, eps=EPS, n_iter=2, seed=3, attack_draws=draws)
    jw.set_perturb(True)
    tw.set_perturb(True)
    # APGD draws nothing, so JAX's calls compile once; FGSM's run eagerly, one draw a call
    call = (jax.jit(lambda a, b: jw(a, b, train=True)) if attack == "apgd"
            else functools.partial(jw, train=True))
    perturb = jax.jit(jw.perturb) if attack == "apgd" else jw.perturb
    for _ in range(2):
        lj = call(jnp.asarray(x), jnp.asarray(y))
        lt = tw(T(x), T(y), train=True)
        assert tm.training and _rel(lt.detach(), lj) < 2e-3
    zj = perturb(jnp.asarray(x), jnp.asarray(y))
    zt = tw.perturb(T(x), T(y))
    assert tw._calls == (3 if attack == "fgsm" else 0) and _close_but_for_flips(zt, zj, EPS)
    jw.set_perturb(False)
    tw.set_perturb(False)
    lt = tw(T(x))
    assert not tm.training and _rel(lt.detach(), jw(jnp.asarray(x))) < 2e-3
    with pytest.raises(ValueError):
        tw.set_perturb(True) or tw(T(x))
