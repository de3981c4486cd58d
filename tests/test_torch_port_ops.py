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

def tail_inputs(M, C, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(s=f(M, C), r=f(M, C), ln_g=rng.uniform(0.5, 1.5, C).astype(np.float32),
                ln_b=f(C) * 0.1, w1=f(C, 4 * C) * 0.1, b1=f(4 * C) * 0.1,
                w2=f(4 * C, C) * 0.1, b2=f(C) * 0.1,
                gamma=rng.uniform(0.1, 1.0, C).astype(np.float32), dy=f(M, C))


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
    """NHWC wrapper flattens B*H*W; on the CPU 'full' differentiates the
    weights through the plain version's autograd."""
    d = tail_inputs(2 * 9, 16, seed=2)
    t = {k: T(v).requires_grad_(True) for k, v in d.items()}
    s4, r4 = t["s"].reshape(2, 3, 3, 16), t["r"].reshape(2, 3, 3, 16)
    y = tbm.convnext_block_tail(s4, r4, None, t["ln_g"], t["ln_b"], t["w1"], t["b1"],
                                t["w2"], t["b2"], t["gamma"], grad_mode="full")
    flat = tbm.fwd_plain(t["s"], t["r"], None, 18, t["ln_g"], t["ln_b"], t["w1"], t["b1"],
                         t["w2"], t["b2"], t["gamma"])
    _close(y.reshape(18, 16).detach(), flat.detach())
    y.sum().backward()
    assert t["w1"].grad is not None and t["gamma"].grad is not None


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


@pytest.mark.parametrize("mode", ["input", "full"])
@pytest.mark.parametrize("wide", [False, True])
def test_tail_fusable_matches_jax(mode, wide):
    for C in (96, 192, 384, 512, 768, 1024, 1536):
        assert tbm.tail_fusable(C, mode, wide) == jbm.tail_fusable(C, mode, wide), C
