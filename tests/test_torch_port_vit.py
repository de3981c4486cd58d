"""Port parity of the ViT slice: the fused qkv attention, the ViT MLP tail,
vit_micro, the converter, pos-embed interpolation, the weight-decay mask,
a training step and the CLIs of revisiting_at_tpu_torch against the JAX
package on the CPU (Pallas kernels in interpret mode).

Tolerances, relative to max |ref|:
  * attention in f32: 1e-5, f32 rounding of differently ordered sums (the
    readings are below 1e-6);
  * attention in bf16 inputs: 1e-2 for o and 2e-2 for dqkv. Both sides
    round p to bf16 before PV and ds16 = bf16(dS * scale) before dq and dk,
    and o and dqkv are bf16: an f32 score one ulp apart can flip one such
    rounding, which moves an output by one bf16 ulp (2^-8 of it). The
    largest readings over three seeds are 1.1e-3 (o) and 4.4e-3 (dqkv);
  * ViT MLP tail: 2e-3, the block tail's (test_torch_port_train.py);
  * vit_micro: 1e-4 on the plain path, 2e-3 with use_pallas, the ConvNeXt
    tests' bounds (test_torch_port_models.py);
  * pos-embed interpolation: 1e-6, f32 sums in another order (readings
    below 9e-7);
  * weight gradients through the fused full backward and the attention
    backward: 2e-3 of each gradient's max |ref|, the block tail's bound.

Budget: one core, about 60 s with a cold JAX compile cache. The weights
are drawn with numpy (`shaped_params`), as a JAX init compile of
vit_micro costs 8-18 s. A parity test of whole training steps (2-step
APGD, AdamW, EMA) took 36 s cold and does not fit: the step's machinery is
held to JAX on convnext_micro by test_torch_port_train.py, and what it
adds for a ViT here, by the weight-decay mask and the weight gradients.
"""

import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import NCLS, images, model_pair, perturbed_params, rel_err, shaped_params
from revisiting_at_tpu.ckpt.torch_export import export_torch_state_dict
from revisiting_at_tpu.models import get_model as jax_get_model
from revisiting_at_tpu.models.pos_embed import interpolate_pos_encoding as jax_interp
from revisiting_at_tpu.ops import attention as jatt
from revisiting_at_tpu.ops import block_mlp as jbm
from revisiting_at_tpu.ops.losses import ce_indiv as jax_ce
from revisiting_at_tpu.train import optimizer as jopt
from revisiting_at_tpu.train.train_step import input_grad_view as jax_input_view
from revisiting_at_tpu_torch.ckpt import convert
from revisiting_at_tpu_torch.cli import eval as eval_cli
from revisiting_at_tpu_torch.cli import train as train_cli
from revisiting_at_tpu_torch.models import get_model, interpolate_pos_encoding
from revisiting_at_tpu_torch.ops import attention as tatt
from revisiting_at_tpu_torch.ops import block_mlp as tbm
from revisiting_at_tpu_torch.ops.losses import ce_indiv
from revisiting_at_tpu_torch.train import wd_mask
from revisiting_at_tpu_torch.train.train_step import input_grad_view

torch.set_num_threads(1)
T = torch.from_numpy
TOL_ATT = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 2e-2)}  # (o, dqkv)


# -------------------------------------------------------------- attention

def _qkv(B, N, H, hd, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, N, 3 * H * hd) * 0.5).astype(np.float32), \
        rng.randn(B, N, H * hd).astype(np.float32)


# (B, N, H, hd) per case; the first two keep their ids from before the
# kernels took any head width and token count; N64, N65 and N129: a last
# key tile of 64 keys or of one (the forward kernel forms a tile of at most
# 8 keys apart)
ATT_QKV_CASES = {16: (2, 16, 2, 16), 197: (2, 197, 2, 16), "hd32": (2, 70, 2, 32),
                 "hd64": (2, 70, 1, 64), "N450": (1, 450, 1, 64),
                 "N64": (2, 64, 2, 16), "N65": (2, 65, 2, 16), "N129": (1, 129, 2, 16)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(ATT_QKV_CASES))
def test_attention_qkv_matches_jax(case, dtype):
    """The port's plain forward and dqkv (through the autograd Function)
    against JAX's `_fwd_qkv_kernel` / `_bwd_qkv_kernel` in interpret mode,
    on the same f32 or bf16 inputs: head widths 16 (vit_micro), 32 and 64
    (ViT-S/M/B), and 450 tokens, past the 448 the kernels once took."""
    B, N, H, hd = ATT_QKV_CASES[case]
    x, do = _qkv(B, N, H, hd)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    o_ref, (d_ref,) = jax.jit(lambda t, c: (lambda o, f: (o, f(c)))(
        *jax.vjp(lambda u: jatt.fused_attention_qkv(u, H, interpret=True), t)))(
        jnp.asarray(x, jdt), jnp.asarray(do, jdt))
    xt = T(x).to(dtype).requires_grad_(True)
    o = tatt.fused_attention_qkv(xt, H)
    o.backward(T(do).to(dtype))
    assert o.dtype == dtype and xt.grad.dtype == dtype
    tol_o, tol_d = TOL_ATT[dtype]
    assert rel_err(o.detach().float(), np.asarray(o_ref, np.float32)) < tol_o
    assert rel_err(xt.grad.float(), np.asarray(d_ref, np.float32)) < tol_d


def test_attention_bhnd_wrapper_matches_jax():
    """fused_attention on [B, N, H, hd] (the 'bhnd' layout) through the qkv
    kernels' plain version against JAX's `_fwd_kernel`/`_bwd_kernel`."""
    rng = np.random.RandomState(3)
    q, k, v, do = (rng.randn(2, 21, 2, 16).astype(np.float32) * 0.5 for _ in range(4))
    o_ref, refs = jax.jit(lambda c, *a: (lambda o, f: (o, f(c)))(
        *jax.vjp(lambda *b: jatt.fused_attention(*b, interpret=True), *a)))(
        *map(jnp.asarray, (do, q, k, v)))
    ts = [T(a).requires_grad_(True) for a in (q, k, v)]
    o = tatt.fused_attention(*ts)
    o.backward(T(do))
    assert tuple(o.shape) == q.shape
    assert rel_err(o.detach(), o_ref) < 1e-5
    for t, ref in zip(ts, refs):
        assert rel_err(t.grad, ref) < 1e-5


def test_attention_kernel_refuses_what_it_cannot_take():
    """The CUDA wrappers check before launching: contiguous bf16 with a head
    width that is a multiple of 16 up to 128 and any token count; a head
    width of 24 or 144, f32 and a non-contiguous tensor raise, and so does
    any device but CUDA (a CPU tensor given to the kernel, the meta device),
    instead of falling back. Head width 16 and 449 tokens pass the check. A
    CPU tensor through the dispatch launches nothing."""
    bf16 = torch.bfloat16
    before = dict(tatt.LAUNCHES)
    for qkv, H in ((torch.zeros(2, 10, 3 * 2 * 24, dtype=bf16), 2),
                   (torch.zeros(1, 4, 3 * 144, dtype=bf16), 1),
                   (torch.zeros(2, 10, 3 * 64), 1),
                   (torch.zeros(2, 3 * 64, 10, dtype=bf16).transpose(1, 2), 1)):
        with pytest.raises(NotImplementedError):
            tatt._check_qkv(qkv, H)
        with pytest.raises(NotImplementedError):
            tatt.attention_fwd_cuda(qkv, H)
    with pytest.raises(NotImplementedError):
        tatt.fused_attention_qkv(torch.zeros(1, 4, 3 * 64, device="meta"), 1)
    for shape, H, dims in (((2, 10, 3 * 2 * 16), 2, (2, 10, 2, 16)),
                           ((1, 449, 3 * 64), 1, (1, 449, 1, 64))):
        qkv = torch.zeros(shape, dtype=bf16)
        assert tatt._check_qkv(qkv, H) == dims
        with pytest.raises(NotImplementedError):  # the kernel takes CUDA tensors only
            tatt.attention_fwd_cuda(qkv, H)
    tatt.fused_attention_qkv(torch.zeros(1, 4, 3 * 64), 1)
    assert tatt.LAUNCHES == before


# ------------------------------------------------------------ ViT MLP tail

@pytest.mark.parametrize("keep", [None, [1.0, 0.0, 2.0]])
@pytest.mark.parametrize("mode", ["input", "full"])
def test_vit_mlp_tail_matches_jax(mode, keep):
    """vit_mlp_tail (s = r = x on B*N rows, one keep per image) against the
    JAX wrapper in interpret mode, N = 5 (ragged), C = 32: y and the
    cotangents of x and, in 'full' mode, of every weight."""
    B, N, C = 3, 5, 32
    rng = np.random.RandomState(4)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    d = dict(x=f(B, N, C), ln_g=rng.uniform(0.5, 1.5, C).astype(np.float32), ln_b=f(C) * 0.1,
             w1=f(C, 4 * C) * 0.2, b1=f(4 * C) * 0.1, w2=f(4 * C, C) * 0.2, b2=f(C) * 0.1,
             gamma=rng.uniform(0.1, 1.0, C).astype(np.float32))
    dy = f(B, N, C)
    names = list(d) if mode == "full" else ["x"]
    kp = None if keep is None else np.asarray(keep, np.float32)

    def jfun(*args):
        a = dict(d, **dict(zip(names, args)))
        return jbm.vit_mlp_tail(a["x"], None if kp is None else jnp.asarray(kp), a["ln_g"],
                                a["ln_b"], a["w1"], a["b1"], a["w2"], a["b2"], a["gamma"],
                                interpret=True, grad_mode=mode)

    y_ref, vjp = jax.vjp(jfun, *(jnp.asarray(d[k]) for k in names))
    refs = vjp(jnp.asarray(dy))
    t = {k: T(v).requires_grad_(k in names) for k, v in d.items()}
    y = tbm.vit_mlp_tail(t["x"], None if kp is None else T(kp), t["ln_g"], t["ln_b"], t["w1"],
                         t["b1"], t["w2"], t["b2"], t["gamma"], grad_mode=mode)
    y.backward(T(dy))
    assert rel_err(y.detach(), y_ref) < 2e-3
    for k, ref in zip(names, refs):
        assert rel_err(t[k].grad, ref) < 2e-3, (k, rel_err(t[k].grad, ref))


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("use_pallas,tol", [(False, 1e-4), (True, 2e-3)])
@pytest.mark.parametrize("cvst", [False, True])
def test_vit_micro_logits_and_input_grads(cvst, use_pallas, tol):
    """vit_micro at 32 px (5 tokens), converted JAX weights: logits and the
    input gradient of the summed CE. With use_pallas both frameworks run
    the fused attention and the fused tail's input-only backward."""
    jm, v, tm = model_pair("vit_micro", not_original=cvst, use_pallas=use_pallas,
                           params=shaped_params("vit_micro", cvst))
    if use_pallas:
        jm = jax_input_view(jm)
        input_grad_view(tm)
    x = images(n=2)
    y = np.arange(len(x)) % NCLS

    def loss(xx):
        logits = jm.apply(v, xx, train=False)
        return jnp.sum(jax_ce(logits, jnp.asarray(y))), logits

    (_, lj), gj = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(x))
    xt = T(x).requires_grad_(True)
    lt = tm(xt)
    ce_indiv(lt, T(y)).sum().backward()
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (len(x), NCLS)
    assert rel_err(lt.detach(), lj) < tol
    assert rel_err(xt.grad, gj) < tol


def test_bhnd_model_matches_qkv_model():
    """attn_impl='bhnd' runs the same function as 'qkv': the same weights
    give the same logits and input gradients to the last bits of f32
    summation order."""
    out = []
    for impl in ("qkv", "bhnd"):
        torch.manual_seed(0)
        m, _ = get_model("vit_micro", num_classes=NCLS, dtype=torch.float32, use_pallas=True,
                         attn_impl=impl, img_size=32)
        x = T(images(n=2)).requires_grad_(True)
        logits = m(x)
        logits.sum().backward()
        out.append((logits.detach(), x.grad))
    for a, b in zip(*out):
        assert rel_err(a, b) < 1e-6


@pytest.mark.parametrize("name", ["vit_s", "deit_s", "vit_s_21k", "vit_m", "vit_b",
                                  "vit_micro"])
def test_factory_builds_every_vit(name):
    """Each ViT name with and without ConvStem and with both attention
    layouts: family 'vit', patch 16, the reference's widths, and the stems'
    keys under patch_embed.proj."""
    dims = {"vit_m": 512, "vit_b": 768, "vit_micro": 32}
    for cvst in (False, True):
        for impl in ("qkv", "bhnd"):
            with torch.device("meta"):  # structure only
                m, meta = get_model(name, not_original=cvst, attn_impl=impl)
            assert meta.family == "vit" and meta.patch_size == 16
            assert m.blocks[0].attn.attn_impl == impl
            assert m.pos_embed.shape[-1] == dims.get(name, 384)
            keys = m.state_dict().keys()
            assert ("patch_embed.proj.stem.12.weight" in keys) == cvst
            assert ("blocks.0.ls1.gamma" in keys) == (name == "vit_m")
    with pytest.raises(ValueError):
        get_model("vit_micro", attn_impl="flash")


# -------------------------------------------------------------- converter

def _random_tree(arch, cvst, img):
    jm, _ = jax_get_model(arch, not_original=cvst, num_classes=NCLS, dtype=jnp.float32)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, img, img, 3)))["params"]
    rng = np.random.RandomState(0)
    return jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("arch,cvst,img", [("vit_micro", False, 32), ("vit_micro", True, 32),
                                           ("vit_m", True, 224)])
def test_vit_convert_matches_jax_export(arch, cvst, img):
    """jax_params_to_state_dict equals export_torch_state_dict key for key
    and value for value, and strict-loads: the ConvStem under
    patch_embed.proj.stem (proj at 12), and vit_m's no_embed_class
    pos_embed and ls1/ls2."""
    params = _random_tree(arch, cvst, img)
    ref = export_torch_state_dict(params, arch)
    got = convert.jax_params_to_state_dict(params, arch)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    with torch.device("meta"):
        model, _ = get_model(arch, not_original=cvst, num_classes=NCLS, dtype=torch.float32,
                             img_size=img)
    model.load_state_dict(got, strict=True, assign=True)
    if arch == "vit_m":
        assert tuple(got["pos_embed"].shape) == (1, 196, 512) and "blocks.11.ls2.gamma" in got
    params["block0"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        convert.jax_params_to_state_dict(params, arch)


# ------------------------------------------------------------- pos embed

@pytest.mark.parametrize("prefix", [1, 0])
@pytest.mark.parametrize("gs_new", [20, 24, 10])
def test_interpolate_pos_encoding_matches_jax(gs_new, prefix):
    """Grid 14 -> 20 (320 px), 24 and 10 (shrinking: the antialiased
    kernel), with and without the class-token position."""
    pe = np.random.RandomState(gs_new).randn(1, 196 + prefix, 24).astype(np.float32)
    ref = np.asarray(jax_interp(jnp.asarray(pe), gs_new * 16, num_prefix_tokens=prefix))
    got = interpolate_pos_encoding(T(pe), gs_new * 16, num_prefix_tokens=prefix)
    assert tuple(got.shape) == ref.shape == (1, gs_new ** 2 + prefix, 24)
    assert rel_err(got, ref) < 1e-6
    same = T(pe)
    assert interpolate_pos_encoding(same, 224, num_prefix_tokens=prefix) is same


# ------------------------------------------------------ wd mask, gradients

def test_vit_wd_mask_matches_jax():
    """The ndim rule for ViTs: cls_token and pos_embed decay, LN scales,
    biases and LayerScale do not; the factory names the family."""
    params = shaped_params("vit_micro", True)
    model, meta = get_model("vit_micro", not_original=True, num_classes=NCLS, img_size=32)
    assert meta.family == "vit"
    full = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                        jopt.wd_mask(params, "vit"), params)
    ref = {k for k, v in convert.jax_params_to_state_dict(full, "vit_micro").items() if v.all()}
    mine = {k for k, v in wd_mask(model, meta.family).items() if v}
    assert mine == ref
    assert {"cls_token", "pos_embed"} <= mine and "blocks.0.norm1.weight" not in mine


def test_vit_weight_grads_match_jax():
    """Every parameter's gradient of vit_micro + ConvStem, use_pallas=1 in
    full mode (the fused tail's full backward and the attention backward),
    against jax.grad of the JAX model in interpret mode."""
    params = shaped_params("vit_micro", True)
    jm, v, tm = model_pair("vit_micro", not_original=True, use_pallas=True, params=params)
    x = images(n=2)
    y = np.arange(len(x)) % NCLS
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jax_ce(jm.apply({"params": p}, jnp.asarray(x),
                                                                   train=False),
                                                          jnp.asarray(y)))))(v["params"])
    ref = convert.jax_params_to_state_dict(jax.tree.map(np.asarray, grads), "vit_micro")
    ce_indiv(tm(T(x)), T(y)).sum().backward()
    for name, prm in tm.named_parameters():
        assert rel_err(prm.grad, ref[name]) < 2e-3, (name, rel_err(prm.grad, ref[name]))


# ------------------------------------------------------------------ CLIs

def test_vit_train_cli_and_eval_at_another_size(tmp_path):
    """cli.train on vit_micro + ConvStem at 32 px (bf16, fused kernels'
    plain versions, DropPath on), then cli.eval of its EMA weights at 48 px:
    the checkpoint's 2x2 pos_embed grid is resized to 3x3 before the strict
    load. A validation size other than the training size is refused."""
    base = ["--model.arch", "vit_micro", "--model.not_original", "1",
            "--model.add_normalization", "0", "--model.model_ema", "1", "--adv.attack", "apgd",
            "--adv.n_iter", "2", "--data.dataset", "synthetic", "--data.num_classes", str(NCLS),
            "--training.batch_size", "2", "--training.epochs", "1", "--training.use_pallas", "1",
            "--model.drop_path_rate", "0.1", "--resolution.min_res", "32",
            "--resolution.max_res", "32", "--validation.batch_size", "2",
            "--validation.max_batches", "1", "--logging.folder", str(tmp_path), "--device", "cpu",
            "--synthetic_batches", "1"]
    trainer = train_cli.main(base + ["--validation.resolution", "32"])
    run = trainer.logger.dir
    records = [json.loads(line) for line in (run / "log").read_text().splitlines()]
    assert np.isfinite([r["train_loss"] for r in records if "train_loss" in r]).all()
    assert records[-1]["event"] == "final_val"
    sd = torch.load(run / "ckpt" / "weights_ema_0.pt")
    assert tuple(sd["pos_embed"].shape) == (1, 5, 32)
    res = eval_cli.main(["--run_dir", str(run), "--torch_ckpt",
                         str(run / "ckpt" / "weights_ema_0.pt"), "--device", "cpu", "--synthetic",
                         "--n_ex", "2", "--batch_size", "2", "--n_iter", "2", "--img_size", "48",
                         "--use_pallas", "1"])
    assert 0.0 <= res["Linf"]["robust"] <= 1.0 and res["Linf"]["n"] == 2
    with pytest.raises(ValueError, match="pos_embed"):
        train_cli.main(base + ["--validation.resolution", "48"])


def test_perturbed_params_reach_cls_token_and_layer_scale():
    """The parity helper perturbs the class token (zero at init) and vit_m's
    ls1/ls2 (1e-6 at init), so the comparisons above can see them."""
    tree = {"cls_token": np.zeros((1, 1, 4), np.float32),
            "block0": {"ls1": np.full(4, 1e-6, np.float32), "ls2": np.full(4, 1e-6, np.float32)}}
    out = perturbed_params(tree)
    assert np.abs(out["cls_token"]).min() > 0
    assert out["block0"]["ls1"].min() >= 0.1 and out["block0"]["ls2"].min() >= 0.1
