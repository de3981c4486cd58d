"""Port parity of the 7x7 depthwise conv (revisiting_at_tpu_torch/ops/dwconv.py)
and of ConvNeXt with `use_pallas_dwconv` against the JAX package on the CPU,
where the port runs the kernels' plain versions and JAX its Pallas kernels
in interpret mode. Inputs come from numpy with a seed; about 60 s of CPU
time on one core, most of it JAX's interpret-mode compiles.

Tolerances, relative to max |ref|:
  * f32 maps: 1e-5. Both sides read x, dy and the weights as f32 and add
    the 49 taps in the same order from the same start; they differ in
    whether a multiply and an add are rounded apart, and in the order of
    dw's and db's sums over (b, h, w). Readings are up to 8e-7.
  * bf16 maps: y and dx 1e-2, since both round an f32 sum to bf16 and a
    last-ulp difference in that sum can flip the rounding, one bf16 ulp
    (2^-8 of the element); dw and db 1e-5 (f32 sums of the same inputs).
  * ConvNeXt: as tests/test_torch_port_models.py, 1e-4 with the plain tail
    and 2e-3 with the fused tail (a one-ulp LayerNorm difference can flip
    a bf16 rounding of a matmul operand).
The negative controls (weights fed transposed, dx with the unflipped
taps, the weights and bias rounded to bf16 as the library route does)
miss these tolerances by orders of magnitude.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from _torch_port_util import NCLS, images, jax_params, micro_dwconv_models, rel_err
from revisiting_at_tpu.ckpt.torch_export import export_torch_state_dict
from revisiting_at_tpu.ops import dwconv as jdw
from revisiting_at_tpu.ops.losses import ce_indiv as jax_ce
from revisiting_at_tpu.train.train_step import input_grad_view as jax_input_view
from revisiting_at_tpu_torch.ckpt.convert import load_state_dict
from revisiting_at_tpu_torch.models import ConvNeXtBlock
from revisiting_at_tpu_torch.ops import dwconv as tdw
from revisiting_at_tpu_torch.ops.losses import ce_indiv
from revisiting_at_tpu_torch.train.train_step import input_grad_view

torch.set_num_threads(1)
T = torch.from_numpy
TOL = {("f32", "y"): 1e-5, ("f32", "dx"): 1e-5, ("f32", "dw"): 1e-5, ("f32", "db"): 1e-5,
       ("bf16", "y"): 1e-2, ("bf16", "dx"): 1e-2, ("bf16", "dw"): 1e-5, ("bf16", "db"): 1e-5}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed=0):
    """x, w [7, 7, 1, C] (random, not symmetric), b and a cotangent dy."""
    rng = np.random.RandomState(seed)
    C = shape[-1]
    return (rng.randn(*shape).astype(np.float32),
            (rng.randn(7, 7, 1, C) * 0.2).astype(np.float32),
            (rng.randn(C) * 0.1).astype(np.float32), rng.randn(*shape).astype(np.float32))


def _jax_dwconv(fn, x, w, b, dy, dtype):
    """y and (dx, dw, db) of the JAX kernel in interpret mode, as f32 numpy."""
    jd = DTYPES[dtype][0]
    y, vjp = jax.vjp(lambda xx, ww, bb: fn(xx, ww, bb, True), jnp.asarray(x, jd),
                     jnp.asarray(w), jnp.asarray(b))
    assert y.dtype == jd
    cts = vjp(jnp.asarray(dy, jd))
    return [np.asarray(v, np.float32) for v in (y, *cts)]


def _port_dwconv(fn, x, w, b, dy, dtype):
    """y, dx, dw, db of the port's dwconv through autograd, as f32 numpy."""
    td = DTYPES[dtype][1]
    xt = T(x).to(td).requires_grad_(True)
    wt, bt = T(w).requires_grad_(True), T(b).requires_grad_(True)
    y = fn(xt, wt, bt)
    assert y.dtype == td and y.is_contiguous()
    y.backward(T(dy).to(td))
    assert xt.grad.dtype == td and wt.grad.dtype == bt.grad.dtype == torch.float32
    return [t.detach().float().numpy() for t in (y, xt.grad, wt.grad, bt.grad)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 12, 16, 8), (1, 7, 9, 16)])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_dwconv_matches_jax(version, shape, dtype):
    """y, dx, dw and db of the port's dwconv7x7 (v2 is the same function)
    against JAX's dwconv7x7 or dwconv7x7_v2 with a numpy cotangent."""
    jfn, tfn = {"v1": (jdw.dwconv7x7, tdw.dwconv7x7),
                "v2": (jdw.dwconv7x7_v2, tdw.dwconv7x7_v2)}[version]
    x, w, b, dy = _inputs(shape)
    refs = _jax_dwconv(jfn, x, w, b, dy, dtype)
    got = _port_dwconv(tfn, x, w, b, dy, dtype)
    for name, g, r in zip(("y", "dx", "dw", "db"), got, refs):
        assert g.shape == r.shape, name
        assert rel_err(g, r) < TOL[dtype, name], (name, rel_err(g, r))


def test_dwconv_accepts_flat_weight_and_matches_library_conv():
    """w [7, 7, C] is the same weight as [7, 7, 1, C]; in f32 the kernel
    route computes what F.conv2d(groups=C) computes on timm's [C, 1, 7, 7]."""
    x, w, b, _ = _inputs((2, 9, 11, 8), seed=3)
    y4 = tdw.dwconv7x7(T(x), T(w), T(b))
    y3 = tdw.dwconv7x7(T(x), T(w[:, :, 0]), T(b))
    assert torch.equal(y3, y4)
    lib = F.conv2d(T(x).permute(0, 3, 1, 2), T(w).permute(3, 2, 0, 1), T(b), padding=3,
                   groups=8).permute(0, 2, 3, 1)
    assert rel_err(y4, lib) < 1e-5
    with pytest.raises(ValueError):
        tdw.dwconv7x7(T(x), T(w[:5]), T(b))


def test_input_only_path_runs_no_weight_pass(monkeypatch):
    """With w and b not requiring grad, the backward computes dx alone:
    dx is equal to the full path's, and no weight gradient is made."""
    x, w, b, dy = _inputs((2, 10, 13, 16), seed=4)
    calls = []
    real = tdw.dwconv_wgrad
    monkeypatch.setattr(tdw, "dwconv_wgrad", lambda *a: calls.append(1) or real(*a))
    grads = []
    for needs_w in (True, False):
        xt = T(x).bfloat16().requires_grad_(True)
        wt, bt = T(w).requires_grad_(needs_w), T(b).requires_grad_(needs_w)
        tdw.dwconv7x7(xt, wt, bt).backward(T(dy).bfloat16())
        grads.append(xt.grad)
        assert (wt.grad is None and bt.grad is None) != needs_w
    assert torch.equal(grads[0], grads[1])
    assert calls == [1]


@pytest.mark.parametrize("fault", ["weight_transposed", "dx_unflipped", "bf16_weights"])
def test_negative_controls_fail(fault):
    """Faults the comparison above must catch, each against JAX's f32
    kernel: the weight fed with taps i and j swapped (random weights, so
    not symmetric), dx run with the unflipped taps, and the library
    route's cast points (weights and bias rounded to bf16)."""
    x, w, b, dy = _inputs((2, 12, 16, 8), seed=5)
    y_ref, dx_ref, _, _ = _jax_dwconv(jdw.dwconv7x7, x, w, b, dy, "f32")
    w49 = tdw.tap_major(T(w))
    if fault == "weight_transposed":
        got, ref = tdw.fwd_plain(T(x), tdw.tap_major(T(w).transpose(0, 1)), T(b)), y_ref
    elif fault == "dx_unflipped":
        got, ref = tdw.dx_plain(T(dy), w49.flip(0), torch.float32), dx_ref
    else:
        got = tdw.fwd_plain(T(x), w49.bfloat16().float(), T(b).bfloat16().float())
        ref = y_ref
    assert rel_err(tdw.fwd_plain(T(x), w49, T(b)), y_ref) < TOL["f32", "y"]
    assert rel_err(tdw.dx_plain(T(dy), w49, torch.float32), dx_ref) < TOL["f32", "dx"]
    assert rel_err(got, ref) > 10 * TOL["f32", "y"], rel_err(got, ref)


@pytest.mark.parametrize("use_pallas,tol", [(False, 1e-4), (True, 2e-3)])
def test_convnext_dwconv_route_matches_jax(use_pallas, tol):
    """Micro ConvNeXt + ConvStem1(8) with use_pallas_dwconv (every block,
    C <= 128): logits and input gradients against JAX's
    ConvNeXt(use_pallas_dwconv=True, pallas_interpret=True) on the same
    weights, exported by the JAX package's export_torch_state_dict."""
    jm, tm = micro_dwconv_models(use_pallas)
    params = jax_params("convnext_micro", True, 32, 0)
    load_state_dict(tm, {k: T(np.array(v)) for k, v in
                         export_torch_state_dict(params, "convnext_micro").items()})
    tm.eval()
    if use_pallas:
        jm = jax_input_view(jm)
        input_grad_view(tm)
    x = images()
    y = np.arange(len(x)) % NCLS
    fwd = jax.jit(lambda xx: jm.apply({"params": params}, xx, train=False))
    lj = fwd(jnp.asarray(x))
    gj = jax.jit(jax.grad(lambda xx: jnp.sum(jax_ce(fwd(xx), jnp.asarray(y)))))(jnp.asarray(x))
    xt = T(x).requires_grad_(True)
    lt = tm(xt)
    ce_indiv(lt, T(y)).sum().backward()
    assert rel_err(lt.detach(), lj) < tol
    assert rel_err(xt.grad, gj) < tol


@pytest.mark.parametrize("dim,routed", [(384, True), (768, False)])
def test_block_gate_is_c_at_most_384(monkeypatch, dim, routed):
    """A block takes the kernel route only with use_pallas_dwconv and
    C <= 384, as the JAX gate; wider blocks keep the library conv."""
    calls = []
    real = tdw.dwconv7x7
    monkeypatch.setattr("revisiting_at_tpu_torch.models.convnext.dwconv7x7",
                        lambda *a: calls.append(1) or real(*a))
    x = T(images(n=1, img=7)[..., :1].repeat(dim, -1))
    for flag in (False, True):
        ConvNeXtBlock(dim, use_pallas_dwconv=flag).eval()(x)
    assert calls == ([1] if routed else [])
