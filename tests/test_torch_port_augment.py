"""Port parity of the on-device augmentation (revisiting_at_tpu_torch/data/
augment.py) against the JAX package on the CPU: numpy inputs from a seed at
8 x 24 x 40 x 3 (non-square), JAX's draws replayed from its keys and
injected.

Tolerances:
  * equalize, posterize, invert, solarize: exact (integer LUTs and
    thresholds; the port multiplies by the f32 1/c where XLA compiles
    JAX's division by a constant c);
  * the other photometric ops: 1e-6 (f32 reductions and the sharpness
    stencil summed in another order; solarize_add's constant factors
    folded in another order);
  * the geometric ops through the per-image bilinear sample: 1e-5 (f32
    cos and sin, the coordinate arithmetic);
  * the two-pass warp, rand_augment_batch and augment_batch: at least 99%
    of the elements within 1e-5, all within 2^-7. Both sides round x and
    the tap weights fr, 1 - fr to bf16; a source coordinate one f32 ulp
    apart (XLA fuses the coordinate arithmetic, cos and sin differ in the
    last bit) can flip the bf16 rounding of fr, or of the first pass's
    output that the second pass reads, which moves a pixel by one bf16 ulp
    of a value below 1, at most 2^-8, once per pass;
  * flip and erasing (with JAX's noise injected): exact.

CPU time: about 25 s on one core, most of it JAX's compiles.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import jax_augment_draws
from revisiting_at_tpu.data import augment as JA
from revisiting_at_tpu_torch.data import augment as TA
from revisiting_at_tpu_torch.data import AugmentDraws, RandAugmentConfig, draw_augment

torch.set_num_threads(1)
T = torch.from_numpy
B, H, W = 8, 24, 40
EXACT = {1: "equalize", 2: "invert", 4: "posterize", 5: "solarize"}
WARP_TOL = 2.0 ** -7


def _images(seed=0, b=B):
    return np.random.RandomState(seed).uniform(0, 1, (b, H, W, 3)).astype(np.float32)


def _levels_and_signs(seed=1):
    rng = np.random.RandomState(seed)
    lvl = rng.uniform(0, 10, B).astype(np.float32)
    lvl[0], lvl[1] = 0.0, 10.0  # both ends of the range
    return lvl, np.where(rng.rand(B) < 0.5, 1.0, -1.0).astype(np.float32)


def _warp_close(got, ref):
    d = np.abs(np.asarray(got) - np.asarray(ref))
    assert (d <= 1e-5).mean() >= 0.99, (d > 1e-5).mean()
    assert d.max() <= WARP_TOL, d.max()


@pytest.fixture(scope="module")
def jax_ops():
    """JAX's _apply_op for every op on every image: [N_OPS, B, H, W, 3], one
    jitted vmap over the 15 x 8 pairs."""
    x = _images()
    lvl, sign = _levels_and_signs()
    f = jax.jit(jax.vmap(JA._apply_op))
    op = np.repeat(np.arange(JA.N_OPS), B)
    out = f(jnp.asarray(np.tile(x, (JA.N_OPS, 1, 1, 1))), jnp.asarray(op),
            jnp.asarray(np.tile(lvl, JA.N_OPS)), jnp.asarray(np.tile(sign, JA.N_OPS)))
    return np.asarray(out).reshape(JA.N_OPS, B, H, W, 3)


@pytest.mark.parametrize("op", range(TA.N_OPS))
def test_op_matches_jax(jax_ops, op):
    """Each op on one image at a time (the reference path); the photometric
    ops also batched, to the bit of the per-image result."""
    x = _images()
    lvl, sign = _levels_and_signs()
    got = np.stack([TA._apply_op(T(x[i]), op, torch.tensor(lvl[i]), torch.tensor(sign[i]))
                    .numpy() for i in range(B)])
    ref = jax_ops[op]
    if op in EXACT:
        np.testing.assert_array_equal(got, ref)
    else:
        tol = 1e-5 if op in TA.GEO_OPS else 1e-6
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    if op not in TA.GEO_OPS:
        batched = TA.PHOTOMETRIC[op](T(x), T(lvl), T(sign)).numpy()
        np.testing.assert_array_equal(batched, got)


@pytest.mark.parametrize("ops", [(3,), (11,), (13,), (3, 12)],
                         ids=["rotate", "shear_x", "translate_x", "rotate_then_shear_y"])
def test_warp_matches_jax(ops):
    """warp_affine_batch on bf16-exact images and the same f32 matrices
    (per image: the ops composed in order at its level and sign)."""
    x = np.array(jnp.asarray(_images(2)).astype(jnp.bfloat16).astype(jnp.float32))
    lvl, sign = _levels_and_signs(3)
    total, bottom = torch.eye(3).expand(B, 3, 3), torch.tensor([[[0.0, 0.0, 1.0]]])
    for op in ops:
        m = TA.geo_mats(torch.full((B,), op), T(lvl), T(sign), H, W)
        total = TA._matmul3(total, torch.cat([m, bottom.expand(B, 1, 3)], 1))
    mats = total[:, :2].contiguous()
    ref = jax.jit(JA.warp_affine_batch)(jnp.asarray(x), jnp.asarray(mats.numpy()))
    got = TA.warp_affine_batch(T(x), mats)
    assert not np.allclose(got.numpy(), x, atol=1e-3)  # the warp moves pixels
    _warp_close(got.numpy(), ref)


def test_identity_warp_rounds_to_bf16():
    """The warp of the identity is the bf16 rounding of the image, as JAX's."""
    x = _images(4)
    eye = torch.eye(3)[:2].expand(B, 2, 3)
    got = TA.warp_affine_batch(T(x), eye).numpy()
    np.testing.assert_array_equal(got, T(x).bfloat16().float().numpy())
    ref = jax.jit(JA.warp_affine_batch)(jnp.asarray(x), jnp.asarray(eye.numpy()))
    np.testing.assert_array_equal(got, np.asarray(ref))


KEY = jax.random.PRNGKey(11)
NB = 16  # rand_augment_batch / augment_batch batch: both layers draw most ops


@pytest.fixture(scope="module")
def draws():
    """JAX's draws of augment_batch(KEY, ...) on NB images."""
    return jax_augment_draws(KEY, NB, H, W)


def test_rand_augment_batch_matches_jax(draws):
    x = _images(5, NB)
    applied = set(draws.op_idx[draws.apply].tolist())
    assert applied & set(TA.GEO_OPS) and applied & set(TA.PHOTOMETRIC), applied
    k_ra = jax.random.split(KEY, 3 * NB).reshape(3, NB, -1)[1, 0]
    ref = jax.jit(lambda k, xx: JA.rand_augment_batch(k, xx, JA.RandAugmentConfig()))(
        k_ra, jnp.asarray(x))
    _warp_close(TA.rand_augment_batch(T(x), draws).numpy(), ref)


def test_erasing_and_flip_match_jax(draws):
    x = _images(6, NB)
    assert 0 < int(draws.erase.sum()) < NB and 0 < int(draws.flip.sum()) < NB
    keys = jax.random.split(KEY, 3 * NB).reshape(3, NB, -1)
    ref_flip = jax.vmap(JA.hflip_single)(keys[0], jnp.asarray(x))
    np.testing.assert_array_equal(TA.hflip(T(x), draws.flip).numpy(), np.asarray(ref_flip))
    ref_erase = jax.vmap(JA.random_erasing_single)(keys[2], jnp.asarray(x))
    got = TA.random_erasing(T(x), draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_erase))
    assert not torch.equal(got, T(x))


def test_augment_batch_uint8_matches_jax(draws):
    """The whole augmentation on a uint8 batch: /255, flip, RandAugment,
    erasing, with JAX's draws and noise."""
    x = np.random.RandomState(7).randint(0, 256, (NB, H, W, 3)).astype(np.uint8)
    ref = JA.augment_batch(KEY, jnp.asarray(x))
    got = TA.augment_batch(T(x), draws).numpy()
    _warp_close(got, ref)
    assert got.dtype == np.float32 and got.shape == x.shape


def test_rand_augment_single_matches_jax():
    """The per-image reference path: JAX's rand_augment_single draws its
    scalars from fold_in(rng, layer); replayed per image and injected."""
    x = _images(8, 4)
    cfg = JA.RandAugmentConfig()
    rngs = jax.random.split(jax.random.PRNGKey(21), 4)
    ref = jax.jit(jax.vmap(lambda k, im: JA.rand_augment_single(k, im, cfg)))(rngs, jnp.asarray(x))
    op, lvl, sign, apply = (np.zeros((2, 4), dt) for dt in (np.int64, np.float32, np.float32,
                                                               bool))
    for i, k in enumerate(rngs):
        for layer in range(2):
            k_op, k_apply, k_lvl, k_sign = jax.random.split(jax.random.fold_in(k, layer), 4)
            op[layer, i] = int(jax.random.randint(k_op, (), 0, JA.N_OPS))
            lvl[layer, i] = float(jnp.clip(9.0 + 0.5 * jax.random.normal(k_lvl), 0.0, 10.0))
            sign[layer, i] = 1.0 if bool(jax.random.bernoulli(k_sign)) else -1.0
            apply[layer, i] = bool(jax.random.bernoulli(k_apply, 0.5))
    z = torch.zeros(4)
    draws = AugmentDraws(z.bool(), T(op), T(lvl), T(sign), T(apply), z.bool(), z, z, z.long(),
                         z.long())
    got = np.stack([TA.rand_augment_single(T(x[i]), draws, i).numpy() for i in range(4)])
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)


def test_draw_augment_distributions():
    """The port's own draws: JAX's probabilities and ranges, and boxes inside
    the image."""
    b = 4000
    d = draw_augment(torch.Generator().manual_seed(0), b, H, W, RandAugmentConfig())
    assert abs(d.flip.float().mean() - 0.5) < 0.03 and abs(d.erase.float().mean() - 0.25) < 0.03
    assert abs(d.apply.float().mean() - 0.5) < 0.03
    assert abs((d.sign > 0).float().mean() - 0.5) < 0.03
    assert set(d.op_idx.unique().tolist()) == set(range(TA.N_OPS))
    assert d.lvl.min() >= 0 and d.lvl.max() <= 10 and abs(float(d.lvl.mean()) - 9.0) < 0.05
    eh, ew = TA.erase_box(d.target, d.log_r, H, W)
    assert (d.top >= 0).all() and (d.top + eh <= H).all() and (d.left + ew <= W).all()
    assert ((d.target >= 0.02 * H * W) & (d.target <= H * W / 3.0)).all()
