"""Port parity of the 7x7 depthwise conv (revisiting_at_tpu_torch/ops/dwconv.py)
and of ConvNeXt with `use_pallas_dwconv` against the JAX package on the CPU,
where the port runs the kernels' plain versions and JAX its Pallas kernels
in interpret mode. Inputs come from numpy with a seed. CPU time: 89 s of
wall time and 154 s of CPU in one pytest process on 8 cores with an empty
JAX compile cache, most of it JAX's interpret-mode compiles (the ConvNeXt
route's logits and input gradient come from one JAX program).

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

    def loss(xx):  # logits and input gradient from one JAX program
        logits = jm.apply({"params": params}, xx, train=False)
        return jnp.sum(jax_ce(logits, jnp.asarray(y))), logits

    (_, lj), gj = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(x))
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


# ------------------------------------------------------------ dwconv_plan
# The CUDA kernels' plan, checked on the CPU (the kernels run on the card).
# ConvNeXt-T's gated stages (C <= 384) at 224 and 320 px, batch 80 and 32;
# a ragged map (an odd number of bands, one column tile, a channel group cut
# short); a map in f32. SMs: the H100 SXM's 132.
SMS = 132
PLAN_SHAPES = ([(B, side * px // 224, side * px // 224, C, torch.bfloat16)
                for px in (224, 320) for B in (80, 32) for side, C in ((56, 96), (28, 192),
                                                                        (14, 384))]
               + [(3, 37, 13, 40, torch.bfloat16), (4, 28, 28, 192, torch.float32)])


def _plan_id(shape):
    B, H, W, C, dtype = shape
    return f"B{B}-{H}x{W}-C{C}-{str(dtype).split('.')[-1]}"


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=_plan_id)
def test_dwconv_plan_at_the_gated_shapes(shape):
    """The plan's tiling: 14 x 14-pixel tiles of 32 channels, which divide
    the gated stages' 56, 28 and 14 at 224 px; every tile a block at most,
    and no more blocks than fit on the card at once (the persistent walk);
    every weight-pass chunk holds items. Well under a second of CPU."""
    B, H, W, C, dtype = shape
    p = tdw.dwconv_plan(B, H, W, C, dtype, SMS)
    assert (p.tile, p.group, p.threads, p.stages) == (14, 32, 160, 2)
    if H in (56, 28, 14):
        assert H % p.tile == 0 and W % p.tile == 0
    assert (p.bands, p.ctiles, p.groups) == (-(-H // 14), -(-W // 14), -(-C // 32))
    items = B * p.bands * p.ctiles
    assert p.tiles == p.groups * items
    assert 1 <= p.fwd_grid == min(p.tiles, SMS * p.fwd_blocks_per_sm)
    assert p.part_rows * p.per_chunk >= items > (p.part_rows - 1) * p.per_chunk
    assert p.wgrad_grid == p.groups * p.part_rows <= max(p.groups, SMS * p.wgrad_blocks_per_sm)


def _stencil_runs(p, B):
    """The (group, image, band, column tile) tiles of each block, as
    dwconv_fwd_kernel splits them: block i takes [tiles * i / G, tiles *
    (i + 1) / G) with the column tile fastest and the group slowest."""
    for i in range(p.fwd_grid):
        t0, t1 = p.tiles * i // p.fwd_grid, p.tiles * (i + 1) // p.fwd_grid
        assert t1 > t0, "a block without tiles"
        for t in range(t0, t1):
            ct, t = t % p.ctiles, t // p.ctiles
            band, t = t % p.bands, t // p.bands
            yield i, t // B, t % B, band, ct


def _wgrad_runs(p):
    """The (group, image, band, column tile) items of each weight-pass
    block, as dwconv_wgrad_kernel takes them: block chunk * groups + g."""
    per_image = p.bands * p.ctiles
    items = p.tiles // p.groups
    for blk in range(p.wgrad_grid):
        g, chunk = blk % p.groups, blk // p.groups
        i0, i1 = chunk * p.per_chunk, min(items, (chunk + 1) * p.per_chunk)
        assert i1 > i0, "a weight-pass block without items"
        for it in range(i0, i1):
            b, r = divmod(it, per_image)
            yield chunk, g, b, *divmod(r, p.ctiles)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=_plan_id)
def test_dwconv_plan_tiles_cover_every_output_once(shape):
    """Every (image, row, column, channel) of the map lies in exactly one
    tile of the stencil's walk and in exactly one item of the weight
    pass's (one block per channel group and chunk), counted on a map of
    counters; a block's run of stencil tiles spans no more channel groups
    than its length forces (it reloads its weights once per group). Up to
    0.4 s of CPU (B = 80 at 320 px)."""
    B, H, W, C, dtype = shape
    p = tdw.dwconv_plan(B, H, W, C, dtype, SMS)
    T_, G = p.tile, p.group
    for runs in ("stencil", "wgrad"):
        seen = np.zeros((B, H, W, C), np.uint8)
        walk = (((g, b, band, ct) for _, g, b, band, ct in _stencil_runs(p, B))
                if runs == "stencil" else
                ((g, b, band, ct) for _, g, b, band, ct in _wgrad_runs(p)))
        for g, b, band, ct in walk:
            seen[b, band * T_:(band + 1) * T_, ct * T_:(ct + 1) * T_, g * G:(g + 1) * G] += 1
        assert seen.min() == 1 and seen.max() == 1, runs
    groups_per_block = {}
    for i, g, *_ in _stencil_runs(p, B):
        groups_per_block.setdefault(i, set()).add(g)
    run, per_group = -(-p.tiles // p.fwd_grid), p.tiles // p.groups  # longest run, a group
    assert all(len(gs) <= 1 + -(-run // per_group) for gs in groups_per_block.values())


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=_plan_id)
def test_dwconv_plan_shared_memory_fits(shape):
    """Each kernel's shared memory fits a block's 227 KB, and the blocks
    per SM the plan counts on fit an SM's 228 KB with the 1 KB a resident
    block reserves; the weight pass's end (four warps' 50 x 32 f32 sums)
    fits its ring, and the stencil's ring its output tile. Well under a
    second of CPU."""
    B, H, W, C, dtype = shape
    p = tdw.dwconv_plan(B, H, W, C, dtype, SMS)
    es = 2 if dtype == torch.bfloat16 else 4
    ring_fwd, ring_wgrad = 2 * 20 * 20 * 32 * es, 2 * (20 * 20 + 14 * 14) * 32 * es
    out_tile = 14 * 14 * 32 * es  # the stencil's staged outputs
    assert p.fwd_smem >= 128 + ring_fwd + out_tile and p.wgrad_smem >= 128 + ring_wgrad
    for smem, bps in ((p.fwd_smem, p.fwd_blocks_per_sm), (p.wgrad_smem, p.wgrad_blocks_per_sm)):
        assert smem <= 227 * 1024
        assert bps * (smem + 1024) <= 228 * 1024
    assert 4 * 50 * 32 * 4 <= ring_wgrad


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=_plan_id)
def test_dwconv_wrappers_launch_the_plan(monkeypatch, shape):
    """The wrappers hand the C entry points the plan, and the weight pass's
    partials have the plan's part_rows rows of 50 * C, which the reduction
    then sums: the entry points are replaced by recorders and the SM count
    by 132, so this runs on the CPU. Well under a second of CPU."""
    B, H, W, C, dtype = shape
    p = tdw.dwconv_plan(B, H, W, C, dtype, SMS)
    calls = {}
    lib = type("Lib", (), {
        "dwconv_supports": staticmethod(lambda c: c % 8 == 0 and c <= 384),
        "dwconv_fwd": staticmethod(lambda *a: calls.setdefault("fwd", a) and 0),
        "dwconv_wgrad": staticmethod(lambda *a: calls.setdefault("wgrad", a) and 0)})
    monkeypatch.setattr(tdw, "_lib", lambda: lib)
    monkeypatch.setattr(tdw, "sm_count", lambda t: SMS)
    monkeypatch.setattr(tdw.cuda_build, "launch", lambda t, fn, *a: fn(*a, None))
    x = torch.zeros(B, H, W, C, dtype=dtype)
    tdw.fwd_cuda(x, torch.zeros(49, C), torch.zeros(C))
    part = tdw.wgrad_partials_cuda(x, x)
    assert calls["fwd"][6:13] == (B, H, W, C, p.fwd_grid, p.stages, p.fwd_smem)
    assert calls["wgrad"][3:12] == (B, H, W, C, p.wgrad_grid, p.stages, p.wgrad_smem,
                                    p.per_chunk, p.part_rows)
    assert part.shape == (p.part_rows, tdw.PARTS * C) and part.dtype == torch.float32


def test_dwconv_plan_depends_on_shapes_and_sms_alone():
    """The plan is a pure function of (B, H, W, C, dtype, SMs): the same
    arguments give the same plan, recomputed without the cache; a card
    with fewer SMs gets fewer blocks over the same tiles; shapes outside
    the gate are refused. Well under a second of CPU."""
    fresh = tdw.dwconv_plan.__wrapped__
    for B, H, W, C, dtype in PLAN_SHAPES:
        assert fresh(B, H, W, C, dtype, SMS) == tdw.dwconv_plan(B, H, W, C, dtype, SMS)
    a, b = fresh(80, 56, 56, 96, torch.bfloat16, 132), fresh(80, 56, 56, 96, torch.bfloat16, 114)
    assert a.tiles == b.tiles and b.fwd_grid < a.fwd_grid and b.wgrad_grid <= a.wgrad_grid
    for bad in ((80, 56, 56, 100), (80, 56, 56, 392), (0, 56, 56, 96)):
        with pytest.raises(ValueError):
            fresh(*bad, torch.bfloat16, SMS)
    with pytest.raises(ValueError):
        fresh(80, 56, 56, 96, torch.float16, SMS)
