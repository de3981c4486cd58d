"""Port parity: ConvNeXt models and checkpoints of revisiting_at_tpu_torch
against the JAX package, with the same weights (ckpt/convert.py) and inputs.

Tolerances, relative to the largest reference value, in fp32:
  * plain tail (erf GELU, f32 matmuls): 1e-4, f32 rounding of differently
    ordered sums through the network;
  * fused tail (JAX in Pallas interpret mode, the port in its plain kernel
    math): 2e-3, since a one-ulp LayerNorm difference can flip a bf16
    rounding of a matmul operand.

CPU time: 41 s of wall time and 63 s of CPU in one pytest process on 8
cores with an empty JAX compile cache; each comparison's logits and input
gradient come from one JAX program.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import NCLS, images, model_pair
from revisiting_at_tpu.ckpt.torch_export import export_torch_state_dict
from revisiting_at_tpu.models import get_model as jax_get_model
from revisiting_at_tpu.ops.losses import ce_indiv as jax_ce
from revisiting_at_tpu.train.train_step import input_grad_view as jax_input_view
from revisiting_at_tpu_torch.ckpt import convert
from revisiting_at_tpu_torch.models import NormalizedModel, get_model
from revisiting_at_tpu_torch.ops.losses import ce_indiv
from revisiting_at_tpu_torch.train.train_step import input_grad_view

torch.set_num_threads(1)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@pytest.mark.parametrize("use_pallas,tol", [(False, 1e-4), (True, 2e-3)])
@pytest.mark.parametrize("cvst", [False, True])
def test_convnext_micro_logits_and_input_grads(cvst, use_pallas, tol):
    jm, v, tm = model_pair(not_original=cvst, use_pallas=use_pallas)
    if use_pallas:
        jm = jax_input_view(jm)
        input_grad_view(tm)
    x = images()
    y = np.arange(len(x)) % NCLS

    def loss(xx):  # logits and input gradient from one JAX program
        logits = jm.apply(v, xx, train=False)
        return jnp.sum(jax_ce(logits, jnp.asarray(y))), logits

    (_, lj), gj = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    lt = tm(xt)
    ce_indiv(lt, torch.from_numpy(y)).sum().backward()
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (len(x), NCLS)
    assert _rel(lt.detach(), lj) < tol
    assert _rel(xt.grad, gj) < tol


def _random_params(arch, not_original, img=32):
    """A JAX param tree of the arch's shapes, filled from numpy (no init compile)."""
    jm, _ = jax_get_model(arch, not_original=not_original, num_classes=NCLS,
                          dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)),
                            train=False)["params"]
    rng = np.random.RandomState(0)
    return jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("arch,cvst", [("convnext_micro", False), ("convnext_micro", True),
                                       ("convnext_tiny", True)])
def test_convert_matches_jax_export(arch, cvst):
    params = _random_params(arch, cvst)
    ref = export_torch_state_dict(params, arch)
    got = convert.jax_params_to_state_dict(params, arch)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    model, _ = get_model(arch, not_original=cvst, num_classes=NCLS, dtype=torch.float32)
    convert.load_state_dict(model, got)  # strict


def test_convert_rejects_foreign_leaves():
    params = _random_params("convnext_micro", False)
    params["stage0_block0"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        convert.jax_params_to_state_dict(params, "convnext_micro")


def test_pt_roundtrip_and_prefix_cascade(tmp_path):
    """save -> load is exact; a normalizer-wrapped, DDP-prefixed reference
    state_dict strict-loads into a NormalizedModel."""
    src, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS,
                       dtype=torch.float32, add_normalization=True)
    assert isinstance(src, NormalizedModel)
    convert.save_torch_checkpoint(src, tmp_path / "w.pt")
    dst, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS,
                       dtype=torch.float32, add_normalization=True)
    convert.load_torch_checkpoint(tmp_path / "w.pt", dst)
    for (k, a), b in zip(src.state_dict().items(), dst.state_dict().values()):
        assert torch.equal(a, b), k
    wrapped = {f"module.model.{k}": v for k, v in src.model.state_dict().items()}
    wrapped["module.normalize.mean"] = torch.zeros(3)
    torch.save({"model_state_dict": wrapped}, tmp_path / "full.pt")
    convert.load_torch_checkpoint(tmp_path / "full.pt", dst)


def test_factory_names_and_views():
    m, meta = get_model("convnext_micro", dtype=torch.float32, add_normalization=True)
    assert meta.family == "convnext" and m.model.grad_mode == "full"
    assert input_grad_view(m) is m and m.model.grad_mode == "input"
    with torch.device("meta"):  # structure only: no 198M-parameter init
        large, _ = get_model("convnext_large", not_original=True)
    assert large.stages[2].blocks[0].wide_tail and large.stem.out_dim == 192
    vit, vit_meta = get_model("vit_micro", dtype=torch.float32, add_normalization=True)
    assert vit_meta.family == "vit" and vit.model.grad_mode == "full"
    assert input_grad_view(vit) is vit and vit.model.grad_mode == "input"
    with torch.device("meta"):  # the rest of the zoo builds: structure only
        iso, iso_meta = get_model("convnext_iso", not_original=True, updated=True)
        r50, r50_meta = get_model("resnet50", add_normalization=True)
    assert iso_meta.family == "convnext" and iso.grad_mode == "full" and iso.stem.out_dim == 432
    assert r50_meta.family == "resnet" and r50_meta.has_batch_stats
    assert input_grad_view(r50) is r50  # no tail: the view changes nothing
    with pytest.raises(ValueError, match="unknown model"):
        get_model("resnet18")
