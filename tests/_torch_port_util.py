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
