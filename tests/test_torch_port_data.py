"""Port parity of the image-folder pipeline (revisiting_at_tpu_torch/data/
folder.py) against the JAX package's tf.data pipeline, on folders built in
tmp_path (nothing is downloaded); the trainer's resolution ramp; the train
and eval CLIs on folders, on the CPU.

Tolerances: the eval loader's pixels within 1 uint8 level of tf.data's for
at least 99% of them, on PNG files (TF decodes JPEG with its fast integer
IDCT, PIL with the accurate one); the resize is TF's bicubic arithmetic,
so on equal decoded pixels the crops are equal. The crop distribution: the
mean area fraction and aspect within 0.02 and 0.03 of TF's over 2,000 draws
each, the whole-image fallback rate within 0.05.

CPU time: 39 s of wall time and 44 s of CPU in one pytest process on 8
cores with an empty JAX compile cache, TensorFlow's import included. The
tests that call TensorFlow import it themselves: at the module's top it
would be imported by every pytest process that collects the suite, each
xdist worker and each one that replaces a lost worker, before its first
test.
"""

import argparse
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from revisiting_at_tpu.data import folder as jfolder
from revisiting_at_tpu.train.schedule import get_resolution as jax_get_resolution
from revisiting_at_tpu_torch.cli import eval as eval_cli
from revisiting_at_tpu_torch.cli import train as train_cli
from revisiting_at_tpu_torch.config import config_from_args
from revisiting_at_tpu_torch.data import FolderConfig, SyntheticData, list_image_folder
from revisiting_at_tpu_torch.data import folder as tfolder
from revisiting_at_tpu_torch.train.trainer import Trainer

if importlib.util.find_spec("tensorflow") is None:  # the JAX pipeline's reference
    pytest.skip("tensorflow is not installed", allow_module_level=True)
torch.set_num_threads(1)

SIZES = [(50, 40), (40, 50), (37, 61), (64, 64)]


def _image(rng, h, w):
    """A gradient with noise: smooth enough to resize, busy enough to test."""
    g = np.linspace(0, 255, h * w).reshape(h, w, 1)
    return np.clip(g + rng.normal(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)


def make_folder(root: Path, n_classes=3, per_class=3, ext="png", seed=0, sizes=SIZES):
    """ImageFolder tree with ILSVRC-style basenames spread over the classes
    (basename order interleaves them); returns the root."""
    rng = np.random.RandomState(seed)
    k = 0
    for i in range(per_class):
        for c in range(n_classes):
            d = root / f"n0{c}"
            d.mkdir(parents=True, exist_ok=True)
            name = d / f"ILSVRC2012_val_{(k * 7) % (n_classes * per_class):08d}.{ext}"
            Image.fromarray(_image(rng, *sizes[k % len(sizes)])).save(name)
            k += 1
    return root


def _batches(it):
    xs, ys = zip(*((np.asarray(x), np.asarray(y)) for x, y in it))
    return np.concatenate(xs), np.concatenate(ys)


def _close_uint8(got, ref):
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert got.shape == ref.shape and d.max() <= 255
    assert (d <= 1).mean() >= 0.99, (d > 1).mean()


def test_list_image_folder_matches_jax(tmp_path):
    make_folder(tmp_path, ext="JPEG")
    (tmp_path / "n00" / "notes.txt").write_text("not an image")
    assert list_image_folder(tmp_path) == jfolder.list_image_folder(tmp_path)


@pytest.mark.parametrize("res", [32, 384])
def test_eval_loader_matches_tf_data(tmp_path, res):
    """The robustbench subset (basename order, subset_size) through the eval
    transform (centre crop at 32 px, warp resize at 384): the same order,
    labels and pixels as JAX's make_folder_dataset."""
    make_folder(tmp_path)
    kw = dict(root=str(tmp_path), resolution=res, batch_size=4, is_train=False,
              drop_remainder=False, sort_by_basename=True, subset_size=7)
    it_fn, _ = jfolder.make_folder_dataset(jfolder.FolderConfig(**kw))
    x_ref, y_ref = _batches(it_fn())
    loader, n = tfolder.make_folder_dataset(FolderConfig(**kw, num_parallel=0))
    x, y = _batches(loader())
    assert n == 2 and x.dtype == np.uint8 and x.shape == (7, res, res, 3)
    np.testing.assert_array_equal(y, y_ref)
    assert len(set(y.tolist())) == 3  # the subset spans the classes
    _close_uint8(x, x_ref)


def test_train_crop_and_resize_match_tf():
    """For a given box, the crop and the bicubic resize are TF's."""
    import tensorflow as tf

    img = _image(np.random.RandomState(1), 75, 100)
    for top, left, h, w in [(0, 0, 75, 100), (10, 20, 40, 37), (5, 61, 70, 39)]:
        ref = tf.image.resize(tf.slice(img, [top, left, 0], [h, w, 3]), (32, 32), "bicubic")
        ref = tf.cast(tf.clip_by_value(ref, 0, 255), tf.uint8).numpy()
        got = tfolder.resize_bicubic(img[top:top + h, left:left + w], 32, 32)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw", [(375, 500), (500, 42)], ids=["imagenet", "elongated"])
def test_crop_distribution_matches_tf(hw):
    """sample_crop against tf.image.sample_distorted_bounding_box (the JAX
    loader's arguments): area fraction, aspect and the whole-image fallback,
    which an elongated image forces often."""
    import tensorflow as tf

    h, w = hw
    n = 2000

    def stats(boxes):
        b = np.array(boxes, np.float64)
        whole = (b[:, 2] == h) & (b[:, 3] == w)
        return (b[:, 2] * b[:, 3] / (h * w)).mean(), (b[:, 3] / b[:, 2]).mean(), whole.mean()

    ref = []
    for i in range(n):
        begin, size, _ = tf.image.stateless_sample_distorted_bounding_box(
            [h, w, 3], tf.zeros([1, 0, 4]), seed=[i, 7], area_range=(0.08, 1.0),
            aspect_ratio_range=(3.0 / 4.0, 4.0 / 3.0), max_attempts=10,
            use_image_if_no_bounding_boxes=True)
        ref.append((int(begin[0]), int(begin[1]), int(size[0]), int(size[1])))
    rng = np.random.default_rng(0)
    got = [tfolder.sample_crop(rng, h, w, (0.08, 1.0), (3.0 / 4.0, 4.0 / 3.0)) for _ in range(n)]
    for top, left, ch, cw in got:
        assert 0 <= top and top + ch <= h and 0 <= left and left + cw <= w
    (a, r, f), (a_ref, r_ref, f_ref) = stats(got), stats(ref)
    assert abs(a - a_ref) < 0.02 and abs(r - r_ref) < 0.03 and abs(f - f_ref) < 0.05, (
        (a, r, f), (a_ref, r_ref, f_ref))
    if hw == (500, 42):
        assert 0.2 < f_ref < 0.8  # a crop fits only at the narrowest aspects


def test_cache_budgets_the_sources_it_holds(tmp_path):
    """C6, first repair: a train cache holds the full decoded sources, and
    the budget counts them (JAX counts res^2 * 3 per image)."""
    make_folder(tmp_path, sizes=[(200, 150)])
    sources = 9 * 200 * 150 * 3
    assert 9 * 16 * 16 * 3 < 20_000 < sources  # JAX's estimate fits, the sources do not
    kw = dict(root=str(tmp_path), resolution=16, batch_size=4, num_parallel=0,
              cache_decoded=True)
    small = tfolder.FolderLoader(FolderConfig(**kw, cache_budget_bytes=20_000))
    assert small.cache_bytes == sources and not small.cached
    assert tfolder.FolderLoader(FolderConfig(**kw, cache_budget_bytes=sources)).cached


def test_same_formats_and_batches_with_and_without_cache(tmp_path):
    """C6, second repair: the uncached train path decodes PNG as the cached
    one does (JAX's uncached path reads JPEG shapes only); and both give the
    same batches, epoch after epoch."""
    import tensorflow as tf

    make_folder(tmp_path)
    kw = dict(root=str(tmp_path), resolution=24, batch_size=4, seed=3)
    it_fn, _ = jfolder.make_folder_dataset(jfolder.FolderConfig(**kw))
    with pytest.raises(tf.errors.InvalidArgumentError):
        next(iter(it_fn()))
    plain = tfolder.FolderLoader(FolderConfig(**kw, num_parallel=0))
    cached = tfolder.FolderLoader(FolderConfig(**kw, num_parallel=0, cache_decoded=True))
    assert cached.cached and not plain.cached and len(plain) == 2
    epochs = [[_batches([b]) for b in loader] for loader in (plain, plain, cached, cached)]
    for (x0, y0), (x1, y1) in zip(epochs[0], epochs[2]):  # epoch 0, uncached / cached
        np.testing.assert_array_equal(x0, x1)
        np.testing.assert_array_equal(y0, y1)
    for (x0, _), (x1, _) in zip(epochs[1], epochs[3]):  # epoch 1
        np.testing.assert_array_equal(x0, x1)
    assert not np.array_equal(epochs[0][0][0], epochs[1][0][0])  # reshuffled, recropped


def test_same_batches_with_worker_processes(tmp_path):
    """Two worker processes (forked from the fork server) give the batches
    of the in-process loader: the crops hang on (seed, epoch, index), not on
    the worker."""
    make_folder(tmp_path)
    kw = dict(root=str(tmp_path), resolution=16, batch_size=4, seed=5)
    inline = tfolder.FolderLoader(FolderConfig(**kw, num_parallel=0))
    forked = tfolder.FolderLoader(FolderConfig(**kw, num_parallel=2))
    assert forked.num_workers == 2
    for _ in range(2):  # two epochs, the workers kept between them
        for (x0, y0), (x1, y1) in zip(inline, forked):
            np.testing.assert_array_equal(x0.numpy(), x1.numpy())
            np.testing.assert_array_equal(y0.numpy(), y1.numpy())


def _alive(pid: int) -> bool:
    try:
        return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def test_stop_fork_server_leaves_no_process(tmp_path):
    """stop_fork_server ends the server and the workers of dropped loaders
    before it returns; a loader made afterwards starts a new server."""
    import multiprocessing
    from multiprocessing import forkserver
    from multiprocessing.context import ForkServerProcess

    make_folder(tmp_path)
    kw = dict(root=str(tmp_path), resolution=16, batch_size=4, seed=5)
    for _ in range(2):  # the second round runs on a restarted server
        loader = tfolder.FolderLoader(FolderConfig(**kw, num_parallel=2))
        n = sum(1 for _ in loader)
        assert n == len(loader)
        workers = [p.pid for p in multiprocessing.active_children()
                   if isinstance(p, ForkServerProcess)]
        server = forkserver._forkserver._forkserver_pid
        assert len(workers) >= 2 and server is not None
        del loader
        tfolder.stop_fork_server()
        assert not [p for p in workers + [server] if _alive(p)]
        assert forkserver._forkserver._forkserver_pid is None


def test_shuffle_buffer_other_than_jax_default_is_refused(tmp_path):
    """The port shuffles the whole shard: a buffer size would be ignored, so
    any but JAX's default raises."""
    assert FolderConfig(root=str(tmp_path)).shuffle_buffer == jfolder.FolderConfig(
        root=str(tmp_path)).shuffle_buffer
    with pytest.raises(ValueError, match="shuffle_buffer"):
        FolderConfig(root=str(tmp_path), shuffle_buffer=1024)


def test_train_loader_follows_set_resolution(tmp_path):
    """The ramp changes a train loader's resolution from the next epoch on;
    an eval loader refuses."""
    make_folder(tmp_path)
    loader = tfolder.FolderLoader(FolderConfig(root=str(tmp_path), resolution=24,
                                               batch_size=4, num_parallel=0))
    assert next(iter(loader))[0].shape == (4, 24, 24, 3)
    assert next(iter(loader.set_resolution(16)))[0].shape == (4, 16, 16, 3)
    with pytest.raises(ValueError):
        tfolder.FolderLoader(FolderConfig(root=str(tmp_path), is_train=False,
                                          num_parallel=0)).set_resolution(16)


def test_two_shards_partition_the_set(tmp_path):
    make_folder(tmp_path)
    kw = dict(root=str(tmp_path), resolution=16, batch_size=2, is_train=False,
              drop_remainder=False, num_parallel=0)
    full_x, full_y = _batches(tfolder.FolderLoader(FolderConfig(**kw)))
    shards = [_batches(tfolder.FolderLoader(FolderConfig(**kw), i, 2)) for i in range(2)]
    assert [len(s[1]) for s in shards] == [5, 4]
    for i, (x, y) in enumerate(shards):  # ds.shard: every second image from i
        np.testing.assert_array_equal(x, full_x[i::2])
        np.testing.assert_array_equal(y, full_y[i::2])


BASE = ["--model.arch", "convnext_micro", "--model.not_original", "1",
        "--model.add_normalization", "0", "--data.num_classes", "3",
        "--training.batch_size", "4", "--training.precision", "fp32",
        "--validation.batch_size", "4", "--validation.resolution", "32",
        "--validation.max_batches", "1"]


@pytest.mark.parametrize("arch", ["convnext_micro", "vit_micro"])
def test_resolution_ramp_follows_get_resolution(tmp_path, arch):
    """The trainer rebuilds the train data at each resolution of the ramp,
    logging resolution_change where the JAX trainer does (JAX's
    get_resolution, starting from max_res); a ViT refuses the ramp."""
    r = dict(min_res=32, max_res=96, start_ramp=1, end_ramp=3)
    cfg = config_from_args(BASE + ["--model.arch", arch, "--training.epochs", "5",
                                   "--logging.folder", str(tmp_path),
                                   "--validation.resolution", "96"]
                           + [a for k, v in r.items() for a in (f"--resolution.{k}", str(v))])
    built = []

    def factory(res):
        built.append(res)
        return SyntheticData(2, res, 3, n_batches=1)

    trainer = Trainer(cfg, device="cpu", train_data=factory(32), train_data_factory=factory)
    if arch == "vit_micro":
        with pytest.raises(ValueError, match="pos_embed"):
            trainer.train()
        return
    trainer.train()
    expect, res = [], r["max_res"]
    for epoch in range(5):
        now = jax_get_resolution(epoch, **r)
        if now != res:
            expect.append(now)
            res = now
    records = [json.loads(line) for line in (trainer.logger.dir / "log").read_text().splitlines()]
    assert [e["res"] for e in records if e.get("event") == "resolution_change"] == expect
    assert expect == [32, 64, 96] and built == [32] + expect
    assert [e["res"] for e in records if "train_loss" in e] == [32, 32, 64, 96, 96]


def test_train_cli_on_a_folder_with_augmentations(tmp_path):
    """One epoch of the full recipe's data path on the CPU: JPEG folders,
    RandAugment, erasing, flip and mixup, 2-step APGD, the resolution of
    the ramp's start; then the eval CLI on its EMA weights and the val
    folder."""
    train = make_folder(tmp_path / "train", per_class=4, ext="JPEG", seed=1)
    val = make_folder(tmp_path / "val", ext="JPEG", seed=2)
    trainer = train_cli.main(BASE + [
        "--data.dataset", "folder", "--data.augmentations", "1", "--data.train_dataset",
        str(train), "--data.val_dataset", str(val), "--data.num_workers", "0",
        "--model.model_ema", "1", "--adv.attack", "apgd", "--adv.n_iter", "2",
        "--training.epochs", "1", "--training.use_pallas", "1", "--resolution.min_res", "32",
        "--resolution.max_res", "32", "--logging.folder", str(tmp_path / "runs"),
        "--device", "cpu"])
    run = trainer.logger.dir
    records = [json.loads(line) for line in (run / "log").read_text().splitlines()]
    epoch = [r for r in records if "train_loss" in r]
    assert trainer.iters_per_epoch == 3 and len(epoch) == 1
    assert np.isfinite(epoch[0]["train_loss"]) and epoch[0]["data_wait"] >= 0
    assert records[-1]["event"] == "final_val" and records[-1]["points"] == 4
    assert (run / "ckpt" / "weights_0.pt").exists()
    res = eval_cli.main(["--run_dir", str(run), "--torch_ckpt",
                         str(run / "ckpt" / "weights_ema_0.pt"), "--device", "cpu",
                         "--data_dir", str(val), "--n_ex", "5", "--batch_size", "4",
                         "--n_iter", "2", "--img_size", "32"])
    assert res["Linf"]["n"] == 5 and 0.0 <= res["Linf"]["robust"] <= 1.0


def test_eval_cli_data_dir_matches_jax_load_eval_set(tmp_path, monkeypatch):
    """cli.eval.main --data_dir evaluates the images and labels that the JAX
    evaluator's load_eval_set reads (uint8, basename order, n_ex)."""
    from revisiting_at_tpu.cli import eval as jax_eval_cli
    from revisiting_at_tpu_torch.ckpt.convert import save_torch_checkpoint
    from revisiting_at_tpu_torch.models import get_model

    val = make_folder(tmp_path / "val")
    run = tmp_path / "run"
    run.mkdir()
    (run / "params.json").write_text(json.dumps({
        "model.arch": "convnext_micro", "model.not_original": 1, "data.num_classes": 3}))
    torch.manual_seed(0)
    save_torch_checkpoint(get_model("convnext_micro", not_original=True, num_classes=3)[0],
                          run / "w.pt")
    seen = {}
    real = eval_cli.load_eval_set

    def spy(args, num_classes):
        seen["x"], seen["y"] = real(args, num_classes)
        return seen["x"], seen["y"]

    monkeypatch.setattr(eval_cli, "load_eval_set", spy)
    res = eval_cli.main(["--run_dir", str(run), "--torch_ckpt", str(run / "w.pt"), "--device",
                         "cpu", "--data_dir", str(val), "--n_ex", "8", "--batch_size", "3",
                         "--n_iter", "2", "--img_size", "32",
                         "--only_clean"])
    assert res["Linf"]["n"] == 8
    x_ref, y_ref = jax_eval_cli.load_eval_set(argparse.Namespace(
        data_dir=str(val), img_size=32, batch_size=3, n_ex=8, synthetic=False), 3)
    assert seen["x"].dtype == np.uint8 and seen["y"].dtype == np.int64
    np.testing.assert_array_equal(seen["y"], y_ref)
    _close_uint8(seen["x"], x_ref)
