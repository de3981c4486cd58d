"""Shared helpers of the tests/test_torch_port_*.py parity tests: build a
JAX model and the port's counterpart with the same weights."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from revisiting_at_tpu.data import augment as jaug
from revisiting_at_tpu.data import mixup as jmix
from revisiting_at_tpu.models import ConvStem1 as JaxConvStem1
from revisiting_at_tpu.models import get_model as jax_get_model
from revisiting_at_tpu.models.convnext import ConvNeXt as JaxConvNeXt
from revisiting_at_tpu.train import ema as jema
from revisiting_at_tpu.train import optimizer as jopt
from revisiting_at_tpu.train import schedule as jsched
from revisiting_at_tpu.train.state import TrainState as JaxState
from revisiting_at_tpu.train.train_step import make_train_step as jax_make_train_step
from revisiting_at_tpu_torch.ckpt.convert import jax_params_to_state_dict, load_state_dict
from revisiting_at_tpu_torch.data import AugmentDraws, MixupConfig, MixupDraws
from revisiting_at_tpu_torch.models import ConvNeXt, ConvStem1
from revisiting_at_tpu_torch.models import get_model as torch_get_model
from revisiting_at_tpu_torch.train import (LRConfig, TrainState, ema_init, make_lr_schedule,
                                           make_optimizer, make_train_step)

torch.set_num_threads(1)
NCLS = 10


def perturbed_params(params, seed=0):
    """Init params with LayerScale (ConvNeXt gamma, ViT ls1/ls2) drawn from
    U(0.1, 1), a non-zero class token and non-zero biases: the 1e-6 and zero
    inits would hide the block tails and the class token from the
    comparison."""
    rng = np.random.RandomState(seed)

    def leaf(path, v):
        v = np.asarray(v, np.float32)
        name = str(path[-1].key)
        if name in ("gamma", "ls1", "ls2"):
            return rng.uniform(0.1, 1.0, v.shape).astype(np.float32)
        if name == "cls_token":
            return (rng.randn(*v.shape) * 0.5).astype(np.float32)
        if name == "bias" or name.endswith("_bias"):
            return (rng.randn(*v.shape) * 0.05).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(leaf, params)


@functools.lru_cache(maxsize=None)
def jax_params(arch="convnext_micro", not_original=False, img=32, seed=0):
    """Perturbed f32 init params of the JAX model (one jitted init per key)."""
    jm, _ = jax_get_model(arch, not_original=not_original, num_classes=NCLS, dtype=jnp.float32)
    init = jax.jit(lambda k, x: jm.init(k, x, train=False))
    return perturbed_params(init(jax.random.PRNGKey(seed), jnp.zeros((1, img, img, 3)))["params"],
                            seed)


@functools.lru_cache(maxsize=None)
def shaped_params(arch="vit_micro", not_original=False, img=32, seed=0):
    """Perturbed f32 params of the JAX model's shapes drawn with numpy, with
    no init compile: kernels N(0, 1/fan_in), LayerNorm scales 1, biases 0,
    the other leaves (pos_embed, cls_token, LayerScale) N(0, 0.02)."""
    jm, _ = jax_get_model(arch, not_original=not_original, num_classes=NCLS, dtype=jnp.float32)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False), jax.random.PRNGKey(seed),
                            jnp.zeros((1, img, img, 3)))["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name in ("scale", "bias"):
            return np.full(s.shape, float(name == "scale"), np.float32)
        if name == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (rng.randn(*s.shape) * 0.02).astype(np.float32)

    return perturbed_params(jax.tree_util.tree_map_with_path(leaf, shapes), seed)


def model_pair(arch="convnext_micro", *, not_original=False, use_pallas=False, img=32,
               seed=0, dtype_torch=torch.float32, params=None):
    """(jax_model, jax_variables, torch_model) with the same weights, fp32:
    `params`, or the JAX init's (jax_params)."""
    jm, _ = jax_get_model(arch, not_original=not_original, num_classes=NCLS, dtype=jnp.float32,
                          use_pallas=use_pallas, pallas_interpret=use_pallas)
    if params is None:
        params = jax_params(arch, not_original, img, seed)
    tm, _ = torch_get_model(arch, not_original=not_original, num_classes=NCLS,
                            dtype=dtype_torch, use_pallas=use_pallas, img_size=img)
    load_state_dict(tm, jax_params_to_state_dict(params, arch))
    return jm, {"params": params}, tm.eval()


def jax_fold_in_noise(seed):
    """The JAX evaluator's APGD start draws: fold_in(PRNGKey(seed), *key), U(-1, 1)."""
    def draw(key, shape):
        k = jax.random.PRNGKey(seed)
        for part in key:
            k = jax.random.fold_in(k, part)
        return torch.from_numpy(np.array(jax.random.uniform(k, shape, jnp.float32, -1.0, 1.0)))
    return draw


class JaxSquareDraws:
    """SquareDraws replaying the JAX package's Square on key `rng`: its
    split into (k_init, k_loop), the Linf stripes and per-query
    fold_in/split/randint/bernoulli, and the L2/L1 `_init_randoms` and
    `_iter_randoms` (revisiting_at_tpu/evals/square.py:124-146, 376-400);
    tensors on `device`."""

    def __init__(self, rng, device="cpu"):
        self.k_init, self.k_loop = jax.random.split(rng)
        self.device = device

    def _t(self, a, dtype=np.float32):
        return torch.from_numpy(np.array(a, dtype)).to(self.device)

    def linf_init(self, b, w, c):
        return self._t(np.where(jax.random.bernoulli(self.k_init, 0.5, (b, 1, w, c)), 1.0, -1.0))

    def linf_query(self, it, b, c, h, w, s):
        _, k_pos, k_sign = jax.random.split(jax.random.fold_in(self.k_loop, it), 3)
        vh = jax.random.randint(k_pos, (b, 1, 1, 1), 0, h - s + 1)
        vw = jax.random.randint(jax.random.fold_in(k_pos, 1), (b, 1, 1, 1), 0, w - s + 1)
        signs = np.where(jax.random.bernoulli(k_sign, 0.5, (b, 1, 1, c)), 1.0, -1.0)
        return (self._t(vh, np.int64).view(b), self._t(vw, np.int64).view(b), self._t(signs))

    def grid_init(self, b, c, n_tiles):
        from revisiting_at_tpu.evals.square import _init_randoms

        coins, signs = _init_randoms(self.k_init, b, c, n_tiles)
        return self._t(coins, bool), self._t(signs)

    def lp_query(self, it, b, c):
        from revisiting_at_tpu.evals.square import _iter_randoms

        u, signs, transpose = _iter_randoms(self.k_loop, it, b, c)
        return self._t(u), self._t(signs), self._t(transpose, bool)


def jax_square_draws(seed):
    """AutoAttack's square_draws(key) replaying the JAX driver's Square key,
    fold_in(PRNGKey(seed), *key)."""
    def draws(key):
        k = jax.random.PRNGKey(seed)
        for part in key:
            k = jax.random.fold_in(k, part)
        return JaxSquareDraws(k)
    return draws


def images(n=4, img=32, seed=1):
    rng = np.random.RandomState(seed)
    return rng.uniform(0, 1, size=(n, img, img, 3)).astype(np.float32)


# ------------------------------------------------------------- block tail

TAIL_ARGS = ("s", "r", "ln_g", "ln_b", "w1", "b1", "w2", "b2", "gamma")


def tail_inputs(M, C, seed=0):
    """Numpy inputs of the block tail on [M, C] rows, and a cotangent dy."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(s=f(M, C), r=f(M, C), ln_g=rng.uniform(0.5, 1.5, C).astype(np.float32),
                ln_b=f(C) * 0.1, w1=f(C, 4 * C) * 0.1, b1=f(4 * C) * 0.1,
                w2=f(4 * C, C) * 0.1, b2=f(C) * 0.1,
                gamma=rng.uniform(0.1, 1.0, C).astype(np.float32), dy=f(M, C))


def jax_tail_cotangents(d, B, keep, mode):
    """The JAX block tail's cotangents w.r.t. TAIL_ARGS (f32 W1/W2 cast to
    bf16 inside, as the model does), in interpret mode, as numpy arrays
    shaped like d's. keep: per-sample scale [B] or None (one grid row)."""
    from revisiting_at_tpu.ops import block_mlp as jbm

    M, C = d["s"].shape
    Mb = M // B
    kp = jnp.ones((1,), jnp.float32) if keep is None else jnp.asarray(keep, jnp.float32)
    m_tile = jbm.pick_m_tile(Mb, C, 4 * C, heavy=True)

    def f(s, r, ln_g, ln_b, w1, b1, w2, b2, gamma):
        return jbm.block_mlp(s, r, kp, ln_g, ln_b, w1.astype(jnp.bfloat16), b1,
                             w2.astype(jnp.bfloat16), b2, gamma, m_tile, True, mode, m_tile)

    args = [jnp.asarray(d[k]).reshape(B, Mb, C) if k in ("s", "r") else jnp.asarray(d[k])
            for k in TAIL_ARGS]
    _, vjp = jax.vjp(f, *args)
    cts = vjp(jnp.asarray(d["dy"]).reshape(B, Mb, C))
    return [np.asarray(ct, np.float32).reshape(d[k].shape) for k, ct in zip(TAIL_ARGS, cts)]


def rel_err(got, ref):
    """max |got - ref| / max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


# ------------------------------------------------------------- train step

def jax_step_key(seed, step, i):
    """Key i of the JAX step (0 mixup, 1 attack, 2 DropPath, 3 RandAugment):
    split(fold_in(PRNGKey(seed), step), 4)[i]."""
    return jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), step), 4)[i]


def jax_mixup_key(seed, step):
    """The JAX step's mixup key."""
    return jax_step_key(seed, step, 0)


def jax_mixup_draws_of_key(key, cfg, h, w):
    """The MixupDraws of JAX's mixup_cutmix(key, ...) on h x w images."""
    k_apply, k_switch, k_lam_m, k_lam_c, k_box = jax.random.split(key, 5)
    ky, kx = jax.random.split(k_box)
    return MixupDraws(
        float(jax.random.uniform(k_apply)), float(jax.random.uniform(k_switch)),
        float(jax.random.beta(k_lam_m, cfg.mixup_alpha, cfg.mixup_alpha)),
        float(jax.random.beta(k_lam_c, cfg.cutmix_alpha, cfg.cutmix_alpha)),
        int(jax.random.randint(ky, (), 0, h)), int(jax.random.randint(kx, (), 0, w)))


def jax_mixup_draws(seed, cfg):
    """mixup_draws(step, h, w) replaying the JAX step's draws."""
    def draws(step, h, w):
        return jax_mixup_draws_of_key(jax_mixup_key(seed, step), cfg, h, w)
    return draws


def jax_augment_draws(rng, b, h, w, cfg=jaug.RandAugmentConfig(), re_prob=0.25, hflip=0.5):
    """AugmentDraws replaying JAX's augment_batch(rng, ...) on b images of
    h x w: its key layout split(rng, 3b) -> keys[0] flip, keys[1, 0]
    RandAugment (fold_in(layer), split 4), keys[2] erasing (split 6), and
    the erasing noise of the images that erase (augment.py:412-418,
    444-458)."""
    keys = jax.random.split(rng, 3 * b).reshape(3, b, -1)
    flip = [bool(jax.random.bernoulli(keys[0, i], hflip)) for i in range(b)]
    layers = []
    for layer in range(cfg.num_layers):
        k_op, k_apply, k_lvl, k_sign = jax.random.split(jax.random.fold_in(keys[1, 0], layer), 4)
        layers.append((
            jax.random.randint(k_op, (b,), 0, jaug.N_OPS),
            jnp.clip(cfg.magnitude + cfg.mstd * jax.random.normal(k_lvl, (b,)), 0.0, 10.0),
            jnp.where(jax.random.bernoulli(k_sign, shape=(b,)), 1.0, -1.0),
            jax.random.bernoulli(k_apply, cfg.prob, (b,))))
    erase, target, log_r, top, left, noise = [], [], [], [], [], []
    for i in range(b):
        ks = jax.random.split(keys[2, i], 6)
        t = h * w * jax.random.uniform(ks[1], minval=0.02, maxval=1.0 / 3.0)
        lr = jax.random.uniform(ks[2], minval=jnp.log(0.3), maxval=jnp.log(1.0 / 0.3))
        eh = jnp.clip(jnp.round(jnp.sqrt(t * jnp.exp(lr))), 1, h).astype(jnp.int32)
        ew = jnp.clip(jnp.round(jnp.sqrt(t / jnp.exp(lr))), 1, w).astype(jnp.int32)
        erase.append(bool(jax.random.bernoulli(ks[0], re_prob)))
        target.append(float(t))
        log_r.append(float(lr))
        top.append(int(jax.random.randint(ks[3], (), 0, jnp.maximum(h - eh, 1))))
        left.append(int(jax.random.randint(ks[4], (), 0, jnp.maximum(w - ew, 1))))
        if erase[-1]:
            noise.append(np.asarray(jax.random.normal(ks[5], (h, w, 3), jnp.float32)))
    T = lambda v, dt: torch.from_numpy(np.array(v, dt))  # noqa: E731
    per_layer = [np.stack([np.asarray(lay[j]) for lay in layers]) for j in range(4)]
    return AugmentDraws(T(flip, bool), T(per_layer[0], np.int64), T(per_layer[1], np.float32),
                        T(per_layer[2], np.float32), T(per_layer[3], bool), T(erase, bool),
                        T(target, np.float32), T(log_r, np.float32), T(top, np.int64),
                        T(left, np.int64), T(np.stack(noise), np.float32) if noise else None)


def jax_attack_draws(seed):
    """attack_draws(step, shape) replaying the JAX FGSM step's uniform start
    draw, jax.random.uniform(k_attack, shape)."""
    def draws(step, shape):
        return torch.from_numpy(np.array(jax.random.uniform(jax_step_key(seed, step, 1), shape,
                                                            jnp.float32)))
    return draws


def step_mismatches(state, step, trajectory, x, y):
    """Run the port's steps on (x, y) beside a JAX trajectory of (metrics,
    params, EMA) per step; list what disagrees: loss and grad_norm beyond
    1e-4 relative, accuracies unequal, a parameter or EMA element beyond
    1e-4."""
    bad = []
    for i, (ref, ref_params, ref_ema) in enumerate(trajectory):
        metrics = step(state, torch.from_numpy(x), torch.from_numpy(y))
        got = {k: float(v) for k, v in metrics.items()}
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


# --------------------------------------------- the dwconv route (ConvNeXt)

MICRO = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), num_classes=NCLS)
STEP_LR = dict(lr=2e-3, schedule_type="cosine", lr_peak_epoch=1, epochs=3)
STEP_WD, STEP_EMA = 0.5, 0.5


def micro_dwconv_models(use_pallas=True):
    """convnext_micro + ConvStem1(8) in fp32 with use_pallas_dwconv, built
    directly (no factory or config flag sets it): the JAX module in
    interpret mode and the port's module (weights not loaded)."""
    jm = JaxConvNeXt(**MICRO, stem_factory=functools.partial(JaxConvStem1, siz=8),
                     dtype=jnp.float32, use_pallas=use_pallas, use_pallas_dwconv=True,
                     pallas_interpret=True)
    tm = ConvNeXt(**MICRO, stem_factory=functools.partial(ConvStem1, siz=8), dtype=torch.float32,
                  use_pallas=use_pallas, use_pallas_dwconv=True)
    return jm, tm


def dwconv_step_batch():
    """4 images labelled with the model's clean predictions on them, so that
    scores against the labels and against the mixup targets can differ (a
    random model is right about no random label)."""
    return images(n=4, seed=3), np.array([2, 2, 2, 4], np.int32)


def jax_dwconv_trajectory(adv, steps):
    """`steps` JAX steps (AdvConfig `adv`) on micro_dwconv_models' JAX
    module with the fused tail, mixup, AdamW and EMA, on dwconv_step_batch:
    (params, [(metrics, params, EMA) per step]) with params and EMA as port
    state_dicts."""
    jm, _ = micro_dwconv_models()
    params = jax_params("convnext_micro", True, 32, 0)
    tx = jopt.make_optimizer(optimizer="adamw", weight_decay=STEP_WD, family="convnext",
                             learning_rate=jsched.make_lr_schedule(jsched.LRConfig(**STEP_LR),
                                                                   2),
                             params=params)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                     ema_params=jema.ema_init(params))
    step = jax_make_train_step(jm, tx, adv=adv, mixup=jmix.MixupConfig(num_classes=NCLS),
                               ema_decay=STEP_EMA, seed=0, donate=False)
    x, y = dwconv_step_batch()
    out = []
    for _ in range(steps):
        state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
        out.append(({k: float(v) for k, v in metrics.items()},
                    jax_params_to_state_dict(jax.tree.map(np.asarray, state.params),
                                             "convnext_micro"),
                    jax_params_to_state_dict(jax.tree.map(np.asarray, state.ema_params),
                                             "convnext_micro")))
    return params, out


def port_dwconv_step(params, adv):
    """The port's state and step matching jax_dwconv_trajectory, with JAX's
    mixup and attack draws injected."""
    _, model = micro_dwconv_models()
    load_state_dict(model, jax_params_to_state_dict(params, "convnext_micro"))
    opt = make_optimizer(model, weight_decay=STEP_WD, family="convnext",
                         learning_rate=make_lr_schedule(LRConfig(**STEP_LR), 2))
    cfg = MixupConfig(num_classes=NCLS)
    step = make_train_step(model, adv=adv, mixup=cfg, ema_decay=STEP_EMA, seed=0,
                           mixup_draws=jax_mixup_draws(0, cfg), attack_draws=jax_attack_draws(0))
    return TrainState(model, opt, ema_init(model)), step
