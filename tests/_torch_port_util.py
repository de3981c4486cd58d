"""Shared helpers of the tests/test_torch_port_*.py parity tests: build a
JAX model and the port's counterpart with the same weights."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from revisiting_at_tpu.models import get_model as jax_get_model
from revisiting_at_tpu_torch.ckpt.convert import jax_params_to_state_dict, load_state_dict
from revisiting_at_tpu_torch.models import get_model as torch_get_model

torch.set_num_threads(1)
NCLS = 10


def perturbed_params(params, seed=0):
    """Init params with LayerScale gamma drawn from U(0.1, 1) and non-zero
    biases: the 1e-6 init would hide every block tail from the comparison."""
    rng = np.random.RandomState(seed)

    def leaf(path, v):
        v = np.asarray(v, np.float32)
        name = str(path[-1].key)
        if name == "gamma":
            return rng.uniform(0.1, 1.0, v.shape).astype(np.float32)
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


def model_pair(arch="convnext_micro", *, not_original=False, use_pallas=False, img=32,
               seed=0, dtype_torch=torch.float32):
    """(jax_model, jax_variables, torch_model) with the same weights, fp32."""
    jm, _ = jax_get_model(arch, not_original=not_original, num_classes=NCLS, dtype=jnp.float32,
                          use_pallas=use_pallas, pallas_interpret=use_pallas)
    params = jax_params(arch, not_original, img, seed)
    tm, _ = torch_get_model(arch, not_original=not_original, num_classes=NCLS,
                            dtype=dtype_torch, use_pallas=use_pallas)
    load_state_dict(tm, jax_params_to_state_dict(params, arch))
    return jm, {"params": params}, tm.eval()


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
