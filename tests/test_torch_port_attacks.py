"""Port parity: APGD of revisiting_at_tpu_torch against the JAX package on
convnext_micro (fp32, plain tail), same weights, inputs and start noise.

Labels are the model's own clean predictions, so every point is correct at
the start and the attack has work to do. Tolerance: the iterates agree to
1e-4 (f32 gradients through the network differ by ~1e-6 relative; a sign
step only moves when a gradient component is that close to zero); the
correctness masks agree exactly; best losses to 1e-4 relative.

CPU time: 32 s of wall time and 60 s of CPU in one pytest process on 8
cores with an empty JAX compile cache.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import images, model_pair
from revisiting_at_tpu.attacks import apgd_attack as jax_apgd
from revisiting_at_tpu_torch.attacks import apgd_attack

torch.set_num_threads(1)

EPS = {"Linf": 8.0 / 255.0, "L2": 0.5}


@pytest.fixture(scope="module")
def problem():
    jm, v, tm = model_pair(not_original=True)
    fwd = jax.jit(lambda xx: jm.apply(v, xx, train=False))
    x = images(n=4)
    y = np.asarray(fwd(jnp.asarray(x))).argmax(-1)
    return fwd, tm, x, y


@pytest.mark.parametrize("norm", ["Linf", "L2"])
@pytest.mark.parametrize("flavour", ["train", "eval"])
def test_apgd_matches_jax(problem, norm, flavour):
    fwd, tm, x, y = problem
    n_iter, eps = 5, EPS[norm]
    key = jax.random.PRNGKey(7)
    noise = None
    if flavour == "eval":
        draw = jax.random.uniform(key, x.shape, jnp.float32, -1.0, 1.0) if norm == "Linf" \
            else jax.random.normal(key, x.shape, jnp.float32)
        noise = torch.from_numpy(np.array(draw))
    kw = dict(norm=norm, eps=eps, n_iter=n_iter, loss="ce", is_train=flavour == "train")

    @jax.jit
    def run_jax(xx, yy):
        r = jax_apgd(fwd, xx, yy, rng=key, random_start=flavour == "eval", **kw)
        return r.x_best, r.acc, r.loss_best, r.x_best_adv

    ref = [np.asarray(a) for a in run_jax(jnp.asarray(x), jnp.asarray(y))]
    got = apgd_attack(tm, torch.from_numpy(x), torch.from_numpy(y),
                      random_start=flavour == "eval", noise=noise, **kw)
    np.testing.assert_allclose(got.x_best.numpy(), ref[0], atol=1e-4)
    np.testing.assert_array_equal(got.acc.numpy(), ref[1])
    np.testing.assert_allclose(got.loss_best.numpy(), ref[2], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.x_best_adv.numpy(), ref[3], atol=1e-4)
    delta = got.x_best_adv.numpy() - x
    bound = np.abs(delta).max() if norm == "Linf" else np.sqrt((delta ** 2).reshape(4, -1).sum(1)).max()
    assert bound <= eps * (1 + 1e-5)


def test_apgd_l1_stays_in_ball(problem):
    """L1 (sparse top-k step + exact projection) keeps the ball and the box."""
    _, tm, x, y = problem
    gen = torch.Generator().manual_seed(0)
    res = apgd_attack(tm, torch.from_numpy(x), torch.from_numpy(y), norm="L1", eps=5.0,
                      n_iter=4, is_train=False, random_start=True, generator=gen)
    d = (res.x_best_adv.numpy() - x).reshape(len(x), -1)
    assert np.abs(d).sum(1).max() <= 5.0 * (1 + 1e-4)
    assert res.x_best_adv.min() >= 0 and res.x_best_adv.max() <= 1
    with pytest.raises(ValueError):
        apgd_attack(tm, torch.from_numpy(x), torch.from_numpy(y), norm="L3")
