"""Port parity of the distributed step (revisiting_at_tpu_torch/parallel/,
train/train_step.py on a mesh) against the JAX package's shard_map step, on
the CPU: two gloo ranks of the port (tests/_torch_dist_worker.py, torch
and the port only) against JAX's step on two of conftest.py's virtual CPU
devices, same weights (the converter), same numpy batch (the port's rank r
takes the r-th half, as JAX's shard r), JAX's mixup draws replayed (one
stream shared by the shards: fold_in(fold_in(PRNGKey(seed), step), 1)).

  * DDP (data = 2), convnext_micro + ConvStem, fp32, mixup, 2-step APGD,
    AdamW with the convnext decay rule, EMA 0.5, 2 steps: use_pallas=1 (JAX
    in interpret mode), and use_pallas=0 with grad_accum 2 (one update on
    the mean of two averaged micro-gradients);
  * ROADMAP C25: at use_pallas=0 the port keeps the shard-local step, which
    equals JAX's make_train_step(..., mesh=<2 devices>) and not the
    global-batch step JAX's trainer would auto-partition (its mixup partner
    crosses the shards);
  * the per-shard streams that no JAX draw replaces (augmentation,
    erasing, FGSM's start, DropPath): rank r's are a single process's
    seeded with shard_seed(0, r), mixup's seed 0's on every rank;
  * the BatchNorm statistics average: tests/test_torch_port_bn.py's small
    ResNet, one SGD step with the statistics and their EMA, JAX in f64 (see
    that file for why);
  * FSDP (fsdp = 2): JAX's manual ZeRO-3 shard_map step with its
    _fsdp_spec state specs, the sharded-leaf count equal to JAX's;
  * TP (model = 2): convnext_micro and vit_micro logits under JAX's
    tp_tree_shardings (vit_micro with tp_attn, its 2 heads split), one
    use_pallas=0 step of each against JAX's auto-partitioned tp step; the
    sharded-leaf counts equal JAX's (12 on convnext_micro, as
    tests/test_tp.py:193), the indivisible fallback, JAX's refusal of
    use_pallas=1 and the "no param matched" assert.

Tolerances (f32): losses and grad_norm within 1e-4 relative, accuracies
equal, every parameter, running statistic and EMA element within 1e-4
absolute, logits within 1e-5 of the largest. The steps' bound is
tests/test_torch_port_train.py's, for its reason: AdamW's first updates
move each weight by about +-LR (up to 2e-3 here), and the gradients of the
two frameworks differ by bf16 rounding flips in the fused tails and by
summation order (two shards summed here, XLA's tree there), which moves a
few elements by up to 5e-5; the BN step's is test_torch_port_bn.py's.

The FSDP, TP and BatchNorm steps run without the attack (their JAX
programs compile in half the time; the attack on gathered or split weights
runs on the card, chip_smoke.py phase 20, against one process); the DDP
and C25 steps run 2-step APGD.

CPU time: about 100 s in one process here (8 cores, JAX's compile cache
warm), most of it JAX compiling six programs (interpret mode for the
kernel path); each case's two ranks run while JAX builds its reference.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import NCLS, images, jax_mixup_draws, jax_mixup_draws_of_key, jax_params
from revisiting_at_tpu.data import mixup as jmix
from revisiting_at_tpu.models import get_model as jax_get_model
from revisiting_at_tpu.models.resnet import ResNet as JaxResNet
from revisiting_at_tpu.parallel import MeshConfig as JaxMeshConfig
from revisiting_at_tpu.parallel import make_mesh as jax_make_mesh
from revisiting_at_tpu.parallel import param_shardings, replicated, tree_shardings
from revisiting_at_tpu.parallel import tp_sharded_leaf_count as jax_tp_count
from revisiting_at_tpu.parallel import tp_tree_shardings
from revisiting_at_tpu.train import ema as jema
from revisiting_at_tpu.train import optimizer as jopt
from revisiting_at_tpu.train import schedule as jsched
from revisiting_at_tpu.train.state import TrainState as JaxState
from revisiting_at_tpu.train.train_step import AdvConfig as JaxAdv
from revisiting_at_tpu.train.train_step import make_train_step as jax_make_train_step
from revisiting_at_tpu_torch.ckpt.convert import (jax_params_to_state_dict, load_state_dict,
                                                  param_layout)
from revisiting_at_tpu_torch.config import config_from_args
from revisiting_at_tpu_torch.data import MixupConfig
from revisiting_at_tpu_torch.models import get_model
from revisiting_at_tpu_torch.parallel.launch import run_ranks
from revisiting_at_tpu_torch.parallel.mesh import _fsdp_spec, fsdp_dim, make_mesh
from revisiting_at_tpu_torch.parallel.tp import tp_dims
from revisiting_at_tpu_torch.train import (AdvConfig, LRConfig, TrainState, ema_init,
                                           make_lr_schedule, make_optimizer, make_train_step)
from revisiting_at_tpu_torch.train.trainer import Trainer

from test_torch_port_bn import bn_variables

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
_RANKS = ThreadPoolExecutor(1)
LR = dict(lr=2e-3, schedule_type="cosine", lr_peak_epoch=1, epochs=3)  # 2e-7, 1e-3, 2e-3
WD, EMA = 0.5, 0.5
# AdamW's update is about LR * sign(m / sqrt(v)): an averaged-gradient
# element within rounding of zero can take opposite signs in the two
# frameworks and land up to 2 LR apart (measured: 1 element of 234,442,
# 6.6e-4 apart, in the data = 2 kernel step)
ADAM_FLIPS, ADAM_FLIP_TOL = 4, 2 * 2e-3


def run_workers(tmp_path, case, spec, timeout=240):
    """Two ranks of the worker on `spec`; what rank 0 wrote (step) or each
    rank's output files (the CLI cases)."""
    spec_path, out = tmp_path / f"{case}_spec.pt", tmp_path / f"{case}_out.pt"
    torch.save(spec, spec_path)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    run_ranks([sys.executable, WORKER, case, str(spec_path), str(out)], 2, timeout, env=env,
              cwd=REPO)
    if case == "step":
        return torch.load(out, weights_only=False)
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]


def start_workers(tmp_path, case, spec, timeout=240):
    """run_workers in a thread: the two ranks run while this process builds
    the reference; .result() waits for them (and raises their failure)."""
    return _RANKS.submit(run_workers, tmp_path, case, spec, timeout)


def _batch(n=8, img=32):
    return images(n=n, img=img, seed=3), np.random.RandomState(4).randint(0, NCLS, n).astype(
        np.int32)


def _sd(tree, arch="convnext_micro", stats=None):
    return jax_params_to_state_dict(jax.tree.map(np.asarray, tree), arch,
                                    None if stats is None else jax.tree.map(np.asarray, stats))


def _shard_mixup_draws(steps, h=32, w=32):
    """The draws of the shard_map step's shared mixup key at each step."""
    cfg = jmix.MixupConfig(num_classes=NCLS)
    return [jax_mixup_draws_of_key(
        jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), s), 1), cfg, h, w)
        for s in range(steps)]


def _jax_convnext_run(mesh, params, *, use_pallas, steps, accum=1, arch="convnext_micro",
                      state_specs=False, tp=False, attack="apgd"):
    """JAX's step on `mesh` from `params` (shard_map unless tp: then
    auto-partitioned over tp_tree_shardings, as its trainer runs dist.tp):
    per step the metrics, then the params and EMA as port state_dicts."""
    jm, _ = jax_get_model(arch, not_original=True, num_classes=NCLS, dtype=jnp.float32,
                          use_pallas=use_pallas, pallas_interpret=use_pallas,
                          tp_attn=2 if tp else 0)
    family = "vit" if arch.startswith("vit") else "convnext"
    tx = jopt.make_optimizer(optimizer="adamw", weight_decay=WD, family=family,
                             learning_rate=jsched.make_lr_schedule(jsched.LRConfig(**LR), 2),
                             params=params, grad_accum=accum)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                     ema_params=jema.ema_init(params))
    kw = dict(adv=JaxAdv(attack=attack, n_iter=2), mixup=jmix.MixupConfig(num_classes=NCLS),
              ema_decay=EMA, seed=0, donate=False)
    specs = None
    if state_specs or tp:
        rule = tp_tree_shardings if tp else (lambda m, t: param_shardings(m, t))
        shardings = JaxState(step=replicated(mesh), params=rule(mesh, params),
                             opt_state=(tp_tree_shardings if tp else tree_shardings)(
                                 mesh, state.opt_state),
                             ema_params=rule(mesh, params))
        state = jax.device_put(state, shardings)
        specs = jax.tree.map(lambda ns: ns.spec, shardings, is_leaf=lambda x: hasattr(x, "spec"))
    step = jax_make_train_step(jm, tx, mesh=None if tp else mesh,
                               state_specs=specs if state_specs else None, **kw)
    x, y = _batch(4 if tp else 8)
    out = []
    for _ in range(steps):
        state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
        out.append({k: float(v) for k, v in metrics.items()})
    return (out, _sd(state.params, arch), _sd(state.ema_params, arch),
            specs.params if specs is not None else None)


def _mismatches(got, ref_metrics, ref_params, ref_ema, tol=1e-4, flips=0, flip_tol=0.0):
    """What disagrees between a worker's output and JAX's run. flips: how
    many parameter elements may lie beyond tol, each within flip_tol (and
    their EMA elements within half of it, the EMA's decay being 0.5)."""
    bad = []
    for i, (g, r) in enumerate(zip(got["metrics"], ref_metrics)):
        bad += [(i, k, g[k], r[k]) for k in ("loss", "grad_norm")
                if abs(g[k] - r[k]) > tol * abs(r[k])]
        bad += [(i, k, g[k], r[k]) for k in ("adv_acc", "train_acc") if g[k] != r[k]]
    for what, mine, theirs, worst in (("param", got["params"], ref_params, flip_tol),
                                      ("ema", got["ema"], ref_ema, flip_tol / 2)):
        beyond = 0
        for k, v in theirs.items():
            d = (mine[k].float() - v).abs()
            beyond += int((d > tol).sum())
            if float(d.max()) > max(tol, worst):
                bad.append((what, k, float(d.max())))
        if beyond > flips:
            bad.append((what, "elements beyond tol", beyond))
    return bad


def _step_spec(params, *, use_pallas, steps, draws, arch="convnext_micro", **kw):
    x, y = _batch(4 if kw.get("tp") else 8)
    return dict(arch=arch, not_original=True, num_classes=NCLS, use_pallas=use_pallas,
                sd=jax_params_to_state_dict(params, arch), optimizer="adamw", wd=WD, lr=LR,
                ema=EMA, steps=steps, images=x, labels=y, mixup_draws=draws, **kw)


# ------------------------------------------------------------------ DDP

def test_ddp_step_matches_jax_shard_map(tmp_path):
    """data = 2 on the kernel path (use_pallas=1; JAX interpreted), 2 steps."""
    mesh = jax_make_mesh(JaxMeshConfig(data=2), devices=jax.devices()[:2])
    params = jax_params("convnext_micro", True, 32, 0)
    ranks = start_workers(tmp_path, "step", _step_spec(params, use_pallas=True, steps=2,
                                                       draws=_shard_mixup_draws(2)))
    metrics, ref_p, ref_e, _ = _jax_convnext_run(mesh, params, use_pallas=True, steps=2)
    got = ranks.result()
    assert got["fsdp_leaves"] == 0 and got["tp_leaves"] == 0
    assert _mismatches(got, metrics, ref_p, ref_e, flips=ADAM_FLIPS,
                       flip_tol=ADAM_FLIP_TOL) == []
    w = "stages.2.blocks.0.mlp.fc1.weight"  # the weights moved
    assert float((got["params"][w] - jax_params_to_state_dict(params, "convnext_micro")[w])
                 .abs().max()) > 1e-4


def test_c25_use_pallas0_step_is_shard_local_with_grad_accum(tmp_path):
    """ROADMAP C25. Under use_pallas=0 JAX's trainer would auto-partition a
    global-batch step (mixup's flip partner across the whole batch); the
    port's world-2 step stays shard-local: JAX's make_train_step with
    mesh=<2 devices>, here with grad_accum 2 (one update on the mean of two
    averaged micro-gradients, at the second step). The global-batch step
    (the port's single-process step, which tests/test_torch_port_train.py
    holds to JAX's mesh=None step) gives another loss."""
    mesh = jax_make_mesh(JaxMeshConfig(data=2), devices=jax.devices()[:2])
    params = jax_params("convnext_micro", True, 32, 0)
    draws = _shard_mixup_draws(2)
    ranks = start_workers(tmp_path, "step", _step_spec(params, use_pallas=False, steps=2,
                                                       draws=draws, grad_accum=2))
    metrics, ref_p, ref_e, _ = _jax_convnext_run(mesh, params, use_pallas=False, steps=2,
                                                 accum=2)
    got = ranks.result()
    assert _mismatches(got, metrics, ref_p, ref_e, flips=ADAM_FLIPS,
                       flip_tol=ADAM_FLIP_TOL) == []
    model, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS,
                         dtype=torch.float32)
    load_state_dict(model, jax_params_to_state_dict(params, "convnext_micro"))
    opt = make_optimizer(model, weight_decay=WD, learning_rate=make_lr_schedule(LRConfig(**LR),
                                                                                2))
    step = make_train_step(model, adv=AdvConfig(attack="apgd", n_iter=2),
                           mixup=MixupConfig(num_classes=NCLS), ema_decay=EMA, seed=0,
                           mixup_draws=lambda s, h, w: draws[s])
    x, y = _batch()
    whole = step(TrainState(model, opt, ema_init(model)), torch.from_numpy(x),
                 torch.from_numpy(y))
    assert abs(float(whole["loss"]) - got["metrics"][0]["loss"]) > 1e-3


# ------------------------------------------------- per-shard streams

def test_shard_streams_are_single_process_streams_of_the_shard_seed(tmp_path):
    """The streams of a world-2 step that no JAX draw replaces: RandAugment
    and erasing, FGSM's random start and DropPath (rate 0.3), drawn by each
    rank from shard_seed(seed, rank), and mixup from the seed's own stream,
    shared. Rank r's shard goes through what a single process seeded with
    shard_seed(0, r) does on it (its mixup draws seed 0's): one SGD step
    (no weight decay, first step: p - LR g) gives the mean of the two
    single-process losses and accuracies and the mean of their parameters,
    within f32 rounding (1e-6). Shard 1 under seed 0's streams, what a rank
    that drew the single process's streams would do, gives another loss."""
    from revisiting_at_tpu_torch.data import RandAugmentConfig, draw_mixup
    from revisiting_at_tpu_torch.ckpt.convert import load_state_dict as load_sd
    from revisiting_at_tpu_torch.train.train_step import shard_seed, step_seed

    def build():
        torch.manual_seed(0)
        model, _ = get_model("convnext_micro", not_original=True, num_classes=NCLS,
                             dtype=torch.float32, use_pallas=True, img_size=32,
                             drop_path_rate=0.3)
        for blk in (b for st in model.stages for b in st.blocks):
            torch.nn.init.uniform_(blk.gamma, 0.1, 1.0)  # the block MLPs' gradients not ~0
        return model

    sd = {k: v.clone() for k, v in build().state_dict().items()}
    x, y = _batch()
    spec = dict(arch="convnext_micro", not_original=True, num_classes=NCLS, use_pallas=True,
                sd=sd, optimizer="sgd", wd=0.0, lr=0.1, ema=0.0, steps=1, images=x, labels=y,
                mixup_draws=None, mixup=True, attack="fgsm", drop_path=0.3, augment=True)
    ranks = start_workers(tmp_path, "step", spec)
    cfg = MixupConfig(num_classes=NCLS)

    def single(r, seed):
        model = build()
        load_sd(model, sd)
        opt = make_optimizer(model, optimizer="sgd", weight_decay=0.0, momentum=0.9,
                             learning_rate=0.1)
        step = make_train_step(
            model, adv=AdvConfig(attack="fgsm", n_iter=2), mixup=cfg,
            randaug=RandAugmentConfig(), seed=seed,
            mixup_draws=lambda s, h, w: draw_mixup(
                torch.Generator().manual_seed(step_seed(0, s, 1)), h, w, cfg))
        m = step(TrainState(model, opt, None), torch.from_numpy(x[r * 4:(r + 1) * 4]),
                 torch.from_numpy(y[r * 4:(r + 1) * 4]))
        return {k: float(v) for k, v in m.items()}, model.state_dict()

    runs = [single(r, shard_seed(0, r)) for r in range(2)]
    shared, _ = single(1, 0)
    got = ranks.result()
    assert shard_seed(0, 0) == 0 and shard_seed(0, 1) != 0
    for k in ("loss", "train_acc", "adv_acc"):
        mean = (runs[0][0][k] + runs[1][0][k]) / 2
        assert abs(got["metrics"][0][k] - mean) <= 1e-6 * max(abs(mean), 1.0), k
    for k, v in got["params"].items():
        ref = (runs[0][1][k] + runs[1][1][k]) / 2
        assert float((v - ref).abs().max()) <= 1e-6, k
    w = "stages.2.blocks.0.mlp.fc1.weight"  # the weights moved
    assert float((got["params"][w] - sd[w]).abs().max()) > 1e-4
    assert abs(shared["loss"] - runs[1][0]["loss"]) > 1e-3


# ------------------------------------------------------ BatchNorm stats

def test_bn_statistics_average_matches_jax(tmp_path):
    """One SGD step of the small ResNet at world 2: each shard normalises
    over its own batch, the new running statistics are averaged over the
    shards before the EMA takes them (JAX's pmean, train_step.py:250-251).
    Without the attack: JAX's f64 APGD and the port's f32 one take sign
    steps that differ on the pixels whose gradient is within f32 rounding
    of zero (on this batch's second shard they put the early layers'
    updates 2-17% apart), which is the attack's precision, not the
    statistics' (the attack with frozen statistics is
    test_torch_port_bn.py's)."""
    params, stats = bn_variables("resnet", seed=1)
    x, y = _batch(8, 64)
    y = np.array([2, 2, 2, 4, 1, 2, 3, 4], np.int32)
    ranks = start_workers(tmp_path, "step", dict(
        arch="resnet_small", num_classes=NCLS, sd=_sd(params, "resnet50", stats),
        optimizer="sgd", wd=0.5, lr=0.1, ema=0.5, steps=1, images=x, labels=y,
        mixup_draws=None, attack="none"))
    with jax.enable_x64(True):
        jm = JaxResNet(stage_sizes=(1, 1, 1, 1), num_classes=NCLS, dtype=jnp.float64)
        p64, s64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), (params, stats))
        tx = jopt.make_optimizer(optimizer="sgd", weight_decay=0.5, momentum=0.9,
                                 family="resnet", learning_rate=0.1, params=p64)
        state = JaxState(step=jnp.zeros((), jnp.int32), params=p64, opt_state=tx.init(p64),
                         ema_params=jema.ema_init(p64), batch_stats=s64,
                         ema_batch_stats=jema.ema_init(s64))
        mesh = jax_make_mesh(JaxMeshConfig(data=2), devices=jax.devices()[:2])
        step = jax_make_train_step(jm, tx, adv=JaxAdv(attack="none"), mixup=None,
                                   ema_decay=0.5, seed=0, has_batch_stats=True, donate=False,
                                   mesh=mesh)
        state, metrics = step(state, jnp.asarray(x, jnp.float64), jnp.asarray(y))
        ref = ([{k: float(v) for k, v in metrics.items()}],
               _sd(state.params, "resnet50", state.batch_stats),
               _sd(state.ema_params, "resnet50", state.ema_batch_stats))
    got = ranks.result()
    ref_p = {k: v for k, v in ref[1].items() if not k.endswith("num_batches_tracked")}
    ref_e = {k: v for k, v in ref[2].items() if not k.endswith("num_batches_tracked")}
    assert _mismatches(got, ref[0], ref_p, ref_e) == []
    # the statistics moved, and each shard's alone would not give the average
    k = "layer4.0.bn3.running_var"
    assert float((got["params"][k] - _sd(params, "resnet50", stats)[k]).abs().max()) > 1e-3


# ------------------------------------------------------------------ FSDP

def test_fsdp_step_matches_jax_shard_map(tmp_path):
    """fsdp = 2: JAX's manual ZeRO-3 shard_map step (state specs by the
    _fsdp_spec rule, params all-gathered inside the loss, psum_scatter'd
    gradients, sharded AdamW moments and EMA) against the port's slices."""
    mesh = jax_make_mesh(JaxMeshConfig(data=1, fsdp=2), devices=jax.devices()[:2])
    params = jax_params("convnext_micro", True, 32, 0)
    ranks = start_workers(tmp_path, "step", _step_spec(params, use_pallas=False, steps=2,
                                                       draws=_shard_mixup_draws(2), fsdp=2,
                                                       attack="none"))
    metrics, ref_p, ref_e, specs = _jax_convnext_run(mesh, params, use_pallas=False, steps=2,
                                                     state_specs=True, attack="none")
    n_jax = sum(s != jax.sharding.PartitionSpec() for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    got = ranks.result()
    assert got["fsdp_leaves"] == n_jax > 0
    assert _mismatches(got, metrics, ref_p, ref_e, flips=ADAM_FLIPS,
                       flip_tol=ADAM_FLIP_TOL) == []


def test_fsdp_rule_matches_jax():
    """The port's axis per leaf is JAX's _fsdp_spec axis on the JAX layout,
    leaf by leaf, for convnext_micro and vit_micro."""
    from revisiting_at_tpu.parallel.mesh import _fsdp_spec as jax_fsdp_spec

    for arch in ("convnext_micro", "vit_micro"):
        params = jax_params(arch, True, 32, 0)
        sd = _sd(params, arch)
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        for size in (2, 4):
            ref = sum(jax_fsdp_spec(np.shape(v), size, 2 ** 14) != jax.sharding.PartitionSpec()
                      for _, v in flat)
            mine = sum(fsdp_dim(tuple(v.shape), size) is not None for v in sd.values())
            assert mine == ref, (arch, size)
        w = sd["stages.3.blocks.0.mlp.fc1.weight"] if arch.startswith("conv") else None
        if w is not None:  # [out 4C, in C]: JAX shards the kernel's out axis, 4C
            assert fsdp_dim(tuple(w.shape), 2) == 0
    assert _fsdp_spec((3, 5), 2, 1) is None and _fsdp_spec((2 ** 14,), 2, 2 ** 14) == 0


# -------------------------------------------------------------------- TP

@pytest.mark.parametrize("arch", ["convnext_micro", "vit_micro"])
def test_tp_logits_and_step_match_jax(tmp_path, arch):
    mesh = jax_make_mesh(JaxMeshConfig(model=2), devices=jax.devices()[:2])
    params = jax_params(arch, True, 32, 0)
    jm, _ = jax_get_model(arch, not_original=True, num_classes=NCLS, dtype=jnp.float32,
                          tp_attn=2)
    x, _ = _batch(4)
    ranks = start_workers(tmp_path, "step", _step_spec(
        params, use_pallas=False, steps=1, arch=arch,
        draws=[jax_mixup_draws(0, MixupConfig(num_classes=NCLS))(0, 32, 32)], tp=2,
        logits=True, refuse_no_rule=arch == "convnext_micro", folder=str(tmp_path / "runs"),
        attack="none"))
    with jax.set_mesh(mesh):
        sharded = jax.device_put(params, tp_tree_shardings(mesh, params))
        logits = np.asarray(jm.apply({"params": sharded}, jnp.asarray(x), train=False))
        metrics, ref_p, ref_e, _ = _jax_convnext_run(mesh, params, use_pallas=False, steps=1,
                                                     arch=arch, tp=True, attack="none")
    n_jax = jax_tp_count(tp_tree_shardings(mesh, params))
    got = ranks.result()
    assert got["tp_leaves"] == n_jax == (12 if arch == "convnext_micro" else 6)
    assert np.abs(got["logits"] - logits).max() <= 1e-5 * np.abs(logits).max()
    assert _mismatches(got, metrics, ref_p, ref_e, flips=ADAM_FLIPS,
                       flip_tol=ADAM_FLIP_TOL) == []
    if arch == "convnext_micro":
        assert "no param matched the TP rules" in got["refused"]


def test_tp_rules_match_jax_and_fall_back():
    """The sharded-leaf counts equal JAX's at tp 2, 3 (nothing divides:
    everything replicated) and 128 (stage 0's 4C = 64 does not divide: its
    blocks replicate, the others shard); the leaves are the block MLPs'."""
    for arch in ("convnext_micro", "vit_micro"):
        params = jax_params(arch, True, 32, 0)
        model, _ = get_model(arch, not_original=True, num_classes=NCLS)
        for tp in (2, 3, 128):
            mesh = jax.sharding.AbstractMesh((1, 1, tp), ("data", "fsdp", "model"))
            dims = tp_dims(model, param_layout(arch), tp)
            assert len(dims) == jax_tp_count(tp_tree_shardings(mesh, params)), (arch, tp)
            if tp == 128 and arch == "convnext_micro":
                assert 0 < len(dims) < 12
                assert "stages.0.blocks.0.mlp.fc1.weight" not in dims
        assert all(".mlp.fc" in k for k in tp_dims(model, param_layout(arch), 2))


def test_tp_refuses_the_kernels_as_jax_does(tmp_path):
    cfg = config_from_args(["--model.arch", "convnext_micro", "--dist.tp", "2",
                            "--training.use_pallas", "1", "--logging.folder", str(tmp_path)])
    with pytest.raises(ValueError, match="requires training.use_pallas=0"):
        Trainer(cfg, device="cpu")


def test_failed_init_releases_the_process_group(tmp_path, monkeypatch):
    """A trainer that started the process group (dist.multihost at world 1)
    and fails in its construction leaves no group behind, as JAX's leaves
    no context mesh (tests/test_tp.py test_failed_init_releases_context_mesh);
    one that succeeds releases it in `release`."""
    import torch.distributed as dist

    from revisiting_at_tpu_torch.parallel.launch import free_port

    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    base = ["--model.arch", "convnext_micro", "--dist.multihost", "1", "--data.num_classes",
            str(NCLS), "--resolution.max_res", "32", "--resolution.min_res", "32",
            "--validation.resolution", "32", "--logging.folder", str(tmp_path)]
    with pytest.raises(ValueError, match="pretrained_path"):
        Trainer(config_from_args(base + ["--model.pretrained", "1"]), device="cpu")
    assert not dist.is_initialized()
    tr = Trainer(config_from_args(base), device="cpu", synthetic_batches=1)
    assert dist.is_initialized() and tr.dist_info.started and tr.mesh.size == 1
    tr.release()
    tr.release()  # idempotent
    assert not dist.is_initialized()
    assert make_mesh().size == 1
