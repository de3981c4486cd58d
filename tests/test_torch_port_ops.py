"""Port parity: threat-model math, losses and the fused block tail of
revisiting_at_tpu_torch against the JAX package, on shared numpy inputs.

Tolerances: the norms, projections and losses are the same f32 formulas in
both frameworks, so they agree to f32 rounding of differently ordered sums
(rtol 1e-5). The block tail casts matmul operands to bf16 in both; a
one-ulp difference in an f32 LayerNorm statistic can flip one bf16
rounding, so it is held to 2e-3 of the largest output.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from revisiting_at_tpu.ops import block_mlp as jbm
from revisiting_at_tpu.ops import losses as jl
from revisiting_at_tpu.ops import norms as jn
from revisiting_at_tpu_torch.ops import block_mlp as tbm
from revisiting_at_tpu_torch.ops import losses as tl
from revisiting_at_tpu_torch.ops import norms as tn

from _torch_port_util import TAIL_ARGS, jax_tail_cotangents, rel_err, tail_inputs

torch.set_num_threads(1)
T = torch.from_numpy


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol)


# ------------------------------------------------------------------ norms

@pytest.fixture
def xy():
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, (5, 4, 4, 3)).astype(np.float32)
    y = (rng.randn(5, 4, 4, 3) * 0.5).astype(np.float32)
    y[1] = 0.0
    return x, y


@pytest.mark.parametrize("fn", ["l1_norm", "l2_norm", "l0_norm"])
def test_norms(xy, fn):
    _, y = xy
    _close(getattr(tn, fn)(T(y)), getattr(jn, fn)(jnp.asarray(y)))


def test_norm_keepdims(xy):
    _, y = xy
    assert tuple(tn.l2_norm(T(y), keepdims=True).shape) == (5, 1, 1, 1)
    _close(tn.l1_norm(T(y), keepdims=True), jn.l1_norm(jnp.asarray(y), keepdims=True))


@pytest.mark.parametrize("which,eps", [("linf", 0.1), ("l2", 0.7)])
def test_projections(xy, which, eps):
    x, y = xy
    adv = x + y
    if which == "linf":
        got, ref = tn.linf_project(T(adv), T(x), eps), jn.linf_project(adv, x, eps)
    else:
        got, ref = tn.l2_project(T(adv), T(x), eps), jn.l2_project(adv, x, eps)
    _close(got, ref)


@pytest.mark.parametrize("eps", [0.5, 3.0, 100.0])
def test_l1_projection_exact(xy, eps):
    """Rows outside the ball (eps 0.5), on both sides (3.0), all inside (100)."""
    x, y = xy
    got = tn.l1_projection(T(x), T(y), eps).numpy()
    _close(got, jn.l1_projection(jnp.asarray(x), jnp.asarray(y), eps), rtol=1e-4, atol=1e-5)
    z = x + y + got
    assert z.min() >= -1e-6 and z.max() <= 1 + 1e-6
    assert (np.abs((y + got).reshape(5, -1)).sum(1) <= eps * (1 + 1e-5) + 1e-5).all()


@pytest.mark.parametrize("norm", ["Linf", "L2", "L1"])
def test_check_imgs(xy, norm):
    x, y = xy
    adv = np.clip(x + 0.1 * y, 0, 1)
    _close(tn.check_imgs(T(adv), T(x), norm), jn.check_imgs(jnp.asarray(adv), jnp.asarray(x), norm))


def test_check_imgs_rejects_unknown_norm(xy):
    x, _ = xy
    with pytest.raises(ValueError):
        tn.check_imgs(T(x), T(x), "L3")


# ----------------------------------------------------------------- losses

@pytest.fixture
def logits():
    rng = np.random.RandomState(1)
    z = (rng.randn(6, 10) * 3).astype(np.float32)
    y = rng.randint(0, 10, 6).astype(np.int64)
    yt = (y + 1 + rng.randint(0, 9, 6)) % 10
    return z, y, yt


@pytest.mark.parametrize("name", ["ce", "dlr"])
def test_per_sample_losses(logits, name):
    z, y, _ = logits
    _close(tl.make_criterion(name)(T(z), T(y)),
           jl.make_criterion(name)(jnp.asarray(z), jnp.asarray(y)))


def test_dlr_targeted(logits):
    z, y, yt = logits
    _close(tl.dlr_loss_targeted(T(z), T(y), T(yt)),
           jl.dlr_loss_targeted(jnp.asarray(z), jnp.asarray(y), jnp.asarray(yt)))


def test_soft_and_smoothed_ce(logits):
    z, y, _ = logits
    soft = np.eye(10, dtype=np.float32)[y] * 0.8 + 0.02
    _close(tl.ce_indiv(T(z), T(soft)), jl.ce_indiv(jnp.asarray(z), jnp.asarray(soft)))
    _close(tl.soft_ce_mean(T(z), T(soft)), jl.soft_ce_mean(jnp.asarray(z), jnp.asarray(soft)))
    _close(tl.smoothed_ce(T(z), T(y), 0.1, 10), jl.smoothed_ce(jnp.asarray(z), jnp.asarray(y), 0.1, 10))
    np.testing.assert_array_equal(tl.is_correct(T(z), T(soft)).numpy(),
                                  np.asarray(jl.is_correct(jnp.asarray(z), jnp.asarray(soft))))


def test_bf16_logits_use_f32_math(logits):
    z, y, _ = logits
    zb = T(z).bfloat16()
    assert tl.ce_indiv(zb, T(y)).dtype == torch.float32
    with pytest.raises(ValueError):
        tl.make_criterion("hinge")


# ------------------------------------------------------------- block tail

def jax_tail(d, B, keep):
    """JAX block_mlp in interpret mode, grad_mode='input': (y, ds, dr)."""
    M, C = d["s"].shape
    Mb = M // B
    w = [jnp.asarray(d[k]) for k in ("ln_g", "ln_b")] + [
        jnp.asarray(d["w1"]).astype(jnp.bfloat16), jnp.asarray(d["b1"]),
        jnp.asarray(d["w2"]).astype(jnp.bfloat16), jnp.asarray(d["b2"]), jnp.asarray(d["gamma"])]
    m_tile = jbm.pick_m_tile(Mb, C, 4 * C, heavy=False)
    kp = jnp.ones((1,), jnp.float32) if keep is None else jnp.asarray(keep)

    def f(s, r):
        return jbm.block_mlp(s, r, kp, *w, m_tile, True, "input", m_tile)

    sh = (B, Mb, C)
    y, vjp = jax.vjp(f, jnp.asarray(d["s"]).reshape(sh), jnp.asarray(d["r"]).reshape(sh))
    ds, dr = vjp(jnp.asarray(d["dy"]).reshape(sh))
    return [np.asarray(a).reshape(M, C) for a in (y, ds, dr)]


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@pytest.mark.parametrize("M,C,B,keep", [
    (40, 16, 1, None),           # M not a multiple of any power-of-two tile
    (147, 768, 1, None),         # one ConvNeXt-T stage-3 block at 3 x 7x7
    (2 * 24, 16, 2, [1.0, 0.5]),  # per-sample DropPath scale
    (2 * 12, 432, 2, [1.0, 0.5]),  # convnext_iso's width (updated=1): C % 32 != 0
])
def test_block_tail_plain_matches_jax_interpret(M, C, B, keep):
    d = tail_inputs(M, C)
    y_ref, ds_ref, dr_ref = jax_tail(d, B, None if keep is None else np.asarray(keep, np.float32))
    t = {k: T(v).requires_grad_(k in ("s", "r")) for k, v in d.items() if k != "dy"}
    kp = None if keep is None else torch.tensor(keep)
    y = tbm.block_mlp(t["s"], t["r"], kp, M // B, t["ln_g"], t["ln_b"], t["w1"], t["b1"],
                      t["w2"], t["b2"], t["gamma"], grad_mode="input")
    y.backward(T(d["dy"]))
    assert _rel(y.detach(), y_ref) < 2e-3
    assert _rel(t["s"].grad, ds_ref) < 2e-3
    _close(t["r"].grad, dr_ref)
    assert t["w1"].grad is None and t["gamma"].grad is None


def test_convnext_block_tail_nhwc_and_full_mode_cpu():
    """NHWC wrapper with a per-sample keep over H*W rows; on the CPU 'full'
    runs the plain full backward, whose nine cotangents match JAX's
    _bwd_kernel (interpret mode) through the same wrapper shape."""
    B, H, W, C = 2, 3, 3, 16
    d = tail_inputs(B * H * W, C, seed=2)
    keep = np.asarray([1.25, 0.0], np.float32)
    refs = jax_tail_cotangents(d, B, keep, "full")
    t = {k: T(v).requires_grad_(True) for k, v in d.items() if k != "dy"}
    s4, r4 = t["s"].reshape(B, H, W, C), t["r"].reshape(B, H, W, C)
    y = tbm.convnext_block_tail(s4, r4, T(keep), t["ln_g"], t["ln_b"], t["w1"], t["b1"],
                                t["w2"], t["b2"], t["gamma"], grad_mode="full")
    flat = tbm.fwd_plain(t["s"], t["r"], T(keep), H * W, t["ln_g"], t["ln_b"], t["w1"],
                         t["b1"], t["w2"], t["b2"], t["gamma"])
    _close(y.reshape(B * H * W, C).detach(), flat.detach())
    y.backward(T(d["dy"]).reshape(B, H, W, C))
    for k, ref in zip(TAIL_ARGS, refs):
        assert rel_err(t[k].grad, ref) < 2e-3, k


def test_block_tail_dispatch_never_falls_back():
    """A CPU tensor takes the plain version without launching a kernel; a
    tensor on a device with no kernel raises instead of falling back."""
    d = tail_inputs(8, 32)
    before = dict(tbm.LAUNCHES)
    t = {k: T(v) for k, v in d.items()}
    tbm.block_mlp_fwd(t["s"], t["r"], None, 8, t["ln_g"], t["ln_b"], t["w1"], t["b1"],
                      t["w2"], t["b2"], t["gamma"])
    assert tbm.LAUNCHES == before
    m = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(NotImplementedError):
        tbm.block_mlp_fwd(m["s"], m["r"], None, 8, m["ln_g"], m["ln_b"], m["w1"], m["b1"],
                          m["w2"], m["b2"], m["gamma"])
    with pytest.raises(ValueError):
        tbm.block_mlp(t["s"], t["r"], None, 8, t["ln_g"], t["ln_b"], t["w1"], t["b1"],
                      t["w2"], t["b2"], t["gamma"], grad_mode="weights")


def test_full_backward_never_falls_back():
    """'full' on a tensor with no kernel (meta: no CUDA here) raises in the
    forward and in the backward instead of taking the plain version."""
    d = tail_inputs(8, 32)
    m = {k: T(v).to("meta").requires_grad_(k != "dy") for k, v in d.items()}
    before = dict(tbm.LAUNCHES)
    with pytest.raises(NotImplementedError):
        tbm.block_mlp(m["s"], m["r"], None, 8, m["ln_g"], m["ln_b"], m["w1"], m["b1"],
                      m["w2"], m["b2"], m["gamma"], grad_mode="full")
    with pytest.raises(NotImplementedError):
        tbm.block_mlp_bwd_full(m["s"], None, 8, m["ln_g"], m["ln_b"], m["w1"], m["b1"],
                               m["w2"], m["b2"], m["gamma"], m["dy"])
    assert tbm.LAUNCHES == before


def _built_widths():
    """The widths the tail kernels are built for (BLOCK_MLP_WIDTHS in csrc)."""
    import re
    from pathlib import Path

    src = (Path(tbm.__file__).resolve().parents[1] / "csrc" / "block_mlp_common.cuh").read_text()
    line = next(ln for ln in src.splitlines() if ln.startswith("#define BLOCK_MLP_WIDTHS"))
    return [int(w) for w in re.findall(r"X\((\d+)\)", line)]


def _row_pad(M):
    """M rounded up as the row pass pads its side buffers (a multiple of the
    weight pass's 64-row stages too)."""
    return -(-M // tbm.ROW_PAD) * tbm.ROW_PAD


# the main path's full-backward shapes (M rows, C): ConvNeXt-T stages 0-2 at
# batch 80 and 200, ViT-S at batch 80 (197 tokens), convnext_iso's C = 432 at
# batch 80, and tiny M
WGRAD_PLAN_SHAPES = ([(rows * b, C) for b in (80, 200) for rows, C in ((3136, 96), (784, 192),
                                                                       (196, 384))]
                     + [(197 * 80, 384), (196 * 80, 432), (1, 96), (64, 384), (65, 432)])


@pytest.mark.parametrize("M,C", WGRAD_PLAN_SHAPES + [(196 * 2 + 8, None)])
def test_wgrad_plan_covers_m_in_whole_stages(M, C):
    """The weight pass's slices of M: they cover [0, Mpad) exactly, each a
    whole number of 64-row ring stages and none empty, at most 64 of them
    (the plan's cap), as many as reach the width's block target (at
    most the 132 SMs, one wave) with one block per output tile and slice;
    the same for both products (dW1 [C, 4C] and A [4C, C]) and from the
    shapes alone. C None: every built width."""
    assert 432 in _built_widths()
    for c in ([C] if C else _built_widths()):
        m_pad = _row_pad(M)
        plans = {tbm.wgrad_plan(m_pad, c, 4 * c), tbm.wgrad_plan(m_pad, 4 * c, c),
                 tbm.wgrad_plan(m_pad, c, 4 * c)}
        assert len(plans) == 1, (M, c, plans)
        rows, n_split = plans.pop()
        assert rows % tbm.WGRAD_DEPTH == 0 and rows > 0
        assert 1 <= n_split <= 64
        assert (n_split - 1) * rows < m_pad <= n_split * rows  # every slice holds rows
        tiles, blocks = tbm._wgrad_tiles(c), tbm._wgrad_blocks(c)
        assert 84 <= blocks <= 132, (c, blocks)
        assert n_split * tiles <= blocks or n_split == 1, (c, n_split, tiles)
        if m_pad >= 64 * 64:  # enough rows: the target is reached
            assert (n_split + 1) * tiles > blocks or n_split == 64, (c, n_split, tiles)


def test_wgrad_plan_main_path_values():
    """The slices the H100 runs at ConvNeXt-T's stages 0-2 and ViT-S,
    batch 80 (3, 6, 24 and 24 tiles of 128 x 128 or 192 columns): 28 and
    14 (84 blocks, enough for HBM where the tensor cores idle), 5 and 5
    (one full wave, which the tensor work needs at C = 384), so one
    reduction launch each; convnext_iso's C = 432, 4."""
    assert [tbm._wgrad_tiles(c) for c in (96, 192, 384, 432)] == [3, 6, 24, 28]
    assert [tbm._wgrad_blocks(c) for c in (96, 192, 384, 432)] == [84, 84, 132, 132]
    assert tbm.wgrad_plan(250880, 96, 384) == (8960, 28)
    assert tbm.wgrad_plan(62720, 192, 768) == (4480, 14)
    assert tbm.wgrad_plan(_row_pad(15680), 1536, 384) == (3200, 5)
    assert tbm.wgrad_plan(_row_pad(15760), 384, 1536) == (3200, 5)
    assert tbm.wgrad_plan(_row_pad(15680), 432, 1728) == (3968, 4)
    with pytest.raises(ValueError):
        tbm.wgrad_plan(100, 96, 384)  # not a multiple of 64
    with pytest.raises(ValueError):
        tbm.wgrad_plan(128, 96, 96)  # not [C] x [4C]


# the column reduction's shapes on the main path: the row pass's column sums
# ([Mpad / part_rows, 4C] and [Mpad / part_rows, C], a row per 64-row tile)
# and the weight pass's slices ([slices, 4C * C]) at ConvNeXt-T's stages 0-2
# and ViT-S, batch 80; then short and ragged ones
REDUCE_MAIN_SHAPES = sorted({
    shape for M, C in [(3136 * 80, 96), (784 * 80, 192), (196 * 80, 384), (197 * 80, 384)]
    for parts in [_row_pad(M) // tbm.tail_plan(C, "bwd_full_rows").part_rows]
    for shape in ((parts, 4 * C), (parts, C),
                  (tbm.wgrad_plan(_row_pad(M), C, 4 * C)[1], 4 * C * C))})
REDUCE_SHAPES = REDUCE_MAIN_SHAPES + [(R, N) for R in (1, 63, 64, 65) for N in (8, 96, 1001)]


def _thread_rows(R, N):
    """The rows each thread of the reduction kernel reads under
    reduce_plan(R, N), in the order it adds them: {(split, row lane): rows}."""
    lanes, splits, rows = tbm.reduce_plan(R, N)
    row_lanes = tbm._REDUCE_THREADS // lanes
    return {(k, rl): list(range(k * rows + rl, min(R, (k + 1) * rows), row_lanes))
            for k in range(splits) for rl in range(row_lanes)}


@pytest.mark.parametrize("R,N", REDUCE_SHAPES)
def test_reduce_plan_covers_every_row_once(R, N):
    """The reduction's plan for part [R, N]: the splits (one block each of a
    cluster of at most 8) cut [0, R) into consecutive ranges in ascending
    order, none empty; each thread adds its rows in ascending order, and
    over the splits' row lanes every row is read exactly once. One launch
    at every R: the plan takes any row count."""
    lanes, splits, rows = tbm.reduce_plan(R, N)
    assert lanes in tbm._REDUCE_LANES and 1 <= splits <= tbm._REDUCE_MAX_SPLITS
    ranges = [range(k * rows, min(R, (k + 1) * rows)) for k in range(splits)]
    assert [r for rng in ranges for r in rng] == list(range(R))
    assert all(len(rng) > 0 for rng in ranges)
    per_thread = _thread_rows(R, N)
    assert all(rs == sorted(rs) for rs in per_thread.values())
    assert sorted(r for rs in per_thread.values() for r in rs) == list(range(R))


def test_reduce_plan_main_path_values():
    """The plans the H100 runs on the main path: the tall, narrow column
    sums split their rows over clusters of up to 8 blocks of 2-column-lane
    strips; the short, wide slice sums take no split, 64 or 256 column
    lanes; every thread takes at most 8 rows of the main path's sums (one
    batch of loads in flight)."""
    assert tbm.reduce_plan(3920, 96) == (2, 8, 490)
    assert tbm.reduce_plan(3920, 384) == (2, 4, 980)
    assert tbm.reduce_plan(246, 1536) == (2, 1, 246)
    assert tbm.reduce_plan(28, 36864) == (64, 1, 28)
    assert tbm.reduce_plan(5, 589824) == (256, 1, 5)
    for R, N in REDUCE_MAIN_SHAPES:
        lanes, splits, rows = tbm.reduce_plan(R, N)
        assert -(-rows // (tbm._REDUCE_THREADS // lanes)) <= tbm._REDUCE_BATCH, (R, N)


@pytest.mark.parametrize("R,N", [(3920, 96), (28, 36864), (65, 1001)])
def test_reduce_plan_same_for_equal_shapes(R, N):
    """The plan, and with it the order of the sum, is a function of the
    shape alone: the same from fresh ints, numpy ints and an emptied cache."""
    first = tbm.reduce_plan(R, N)
    tbm.reduce_plan.cache_clear()
    assert tbm.reduce_plan(int(str(R)), int(str(N))) == first
    assert tbm.reduce_plan(int(np.int64(R)), int(np.int64(N))) == first
    with pytest.raises(ValueError):
        tbm.reduce_plan(0, N)


@pytest.mark.parametrize("mode", ["input", "full"])
@pytest.mark.parametrize("wide", [False, True])
def test_tail_fusable_matches_jax(mode, wide):
    for C in (96, 192, 384, 512, 768, 1024, 1536):
        assert tbm.tail_fusable(C, mode, wide) == jbm.tail_fusable(C, mode, wide), C


# every width the tail kernels are built for (BLOCK_MLP_WIDTHS in csrc)
BUILT_WIDTHS = (16, 32, 64, 96, 128, 192, 256, 384, 432, 512, 768, 1024)


def _header():
    from pathlib import Path

    return (Path(tbm.__file__).resolve().parents[1] / "csrc" / "block_mlp_common.cuh").read_text()


def test_tail_plan_mirrors_the_source():
    """tail_plan's constants are the header's: the widths built, those that
    take the wgmma design (kWgmma), the row padding (kRowPad) and the
    producer warpgroup's registers (kProducerRegs)."""
    import re

    src = _header()
    assert _built_widths() == list(BUILT_WIDTHS)
    line = next(ln for ln in src.splitlines() if "constexpr bool kWgmma = " in ln)
    assert tuple(int(w) for w in re.findall(r"C == (\d+)", line)) == tbm.WGMMA_WIDTHS
    assert re.search(r"constexpr int kRowPad = (\d+);", src)[1] == str(tbm.ROW_PAD)
    assert re.search(r"kProducerRegs = (\d+)", src)[1] == str(tbm._PRODUCER_REGS)


@pytest.mark.parametrize("mode", ["fwd", "bwd_input", "bwd_full_rows"])
@pytest.mark.parametrize("C", BUILT_WIDTHS)
def test_tail_plan_fits_the_card(C, mode):
    """Each built width's tiling fits an H100 block: shared memory within
    232,448 bytes; the chunk a multiple of 16 that divides 4C; the f32
    accumulators of a consumer thread within its registers, with room for
    addresses; the row pass's rows per block and per column-sum row
    dividing the row padding (itself whole 64-row stages of the weight
    pass). The main
    path's widths (96, 192, 384) take the TMA + wgmma design in every mode."""
    p = tbm.tail_plan(C, mode)
    assert p.design == ("wgmma" if C in tbm.WGMMA_WIDTHS else "wmma")
    assert 0 < p.smem <= 232448
    assert p.chunk % 16 == 0 and (4 * C) % p.chunk == 0
    assert p.acc_regs + 32 <= p.regs <= 255
    if mode == "bwd_full_rows":  # its side buffers' rows are padded to ROW_PAD
        assert tbm.ROW_PAD % p.rows == 0 and tbm.ROW_PAD % p.part_rows == 0
    assert tbm.ROW_PAD % tbm.WGRAD_DEPTH == 0 and p.rows % 16 == 0
    if p.design == "wgmma":
        row_tiles = p.rows // 64
        assert p.threads == 128 * (row_tiles * p.split + 1)  # and the producer warpgroup
        # setmaxnreg moves registers within the block's launch allocation
        pool = p.threads * (65536 // p.threads // 8 * 8)
        assert p.regs * 128 * (p.threads // 128 - 1) + tbm._PRODUCER_REGS * 128 <= pool
        assert 2 <= p.stages <= 8 and C % 32 == 0 and (C // p.split) % 32 == 0
        assert p.part_rows == 64
    else:
        assert p.stages == 0 and p.part_rows == p.rows and p.threads <= 1024
    if C in (96, 192, 384):
        assert p.design == "wgmma"


def test_tail_plan_main_path_values():
    """The plans the H100 runs at ConvNeXt-T's stages 0-2 and ViT-S: four,
    three and two 64-row tiles a block at C = 96 (forward, input backward,
    row pass), two at C = 192, one tile split over two warpgroups at C =
    384; the ring as deep as shared memory allows; the row pass's
    column sums a row per 64-row tile, so 3920, 980 and 246 rows at batch 80
    (ViT-S: 248)."""
    assert tbm.tail_plan(96, "fwd")[:7] == ("wgmma", 256, 64, 640, 1, 6, 230656)
    assert tbm.tail_plan(96, "bwd_input")[:7] == ("wgmma", 192, 64, 512, 1, 5, 232192)
    assert tbm.tail_plan(96, "bwd_full_rows")[:7] == ("wgmma", 128, 64, 384, 1, 7, 225536)
    assert tbm.tail_plan(192, "bwd_input")[:7] == ("wgmma", 128, 64, 384, 1, 4, 231680)
    assert tbm.tail_plan(192, "bwd_full_rows")[:7] == ("wgmma", 128, 64, 384, 1, 3, 223488)
    assert tbm.tail_plan(384, "fwd")[:7] == ("wgmma", 64, 64, 384, 2, 3, 214272)
    assert tbm.tail_plan(384, "bwd_full_rows")[:7] == ("wgmma", 64, 64, 384, 2, 2, 230144)
    assert tbm.tail_plan(768, "fwd").design == "wmma"
    parts = [_row_pad(M) // tbm.tail_plan(C, "bwd_full_rows").part_rows
             for M, C in [(3136 * 80, 96), (784 * 80, 192), (196 * 80, 384), (197 * 80, 384)]]
    assert parts == [3920, 980, 246, 248]
    with pytest.raises(ValueError):
        tbm.tail_plan(96, "bwd")
    with pytest.raises(ValueError):
        tbm.tail_plan(100, "fwd")
