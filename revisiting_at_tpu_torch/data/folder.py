"""Host-side ImageFolder pipeline on torch.utils.data with PIL decoding,
port of revisiting_at_tpu/data/folder.py (tf.data there).

The loader decodes, crops to the resolution and batches uint8 NHWC images
with int64 labels (pinned when asked); the photometric augmentation runs on
the device inside the train step (data/augment.py, data/mixup.py), which
also does the /255.

  * train: TF's `sample_distorted_bounding_box` crop (area in `scale`,
    aspect in `ratio`, 10 attempts, else the whole image), drawn from a
    generator seeded by (seed, epoch, index), so an epoch is the same
    whatever the number of workers; then the resize to the loader's
    resolution, which `set_resolution` changes for the ramp without new
    workers;
  * eval: the short side to floor(res / crop_pct), centre crop
    (folder.py:126-147); at res >= 384 a warp resize without a crop;
  * the resize is tf.image.resize(method="bicubic") as TF computes it
    (Keys cubic a = -0.5 from its 1024-entry table, half-pixel centres, no
    antialias, out-of-image taps dropped and the weights renormalised),
    written in torch on the CPU: F.interpolate's bicubic is a = -0.75. The
    cast to uint8 truncates after the clip, as tf.cast does;
  * shuffled each epoch from `seed`, sharded by (process_index,
    process_count) as ds.shard, the remainder dropped when asked; eval
    keeps `sort_by_basename` and `subset_size` (the robustbench subset).

The decoded cache (`cache_decoded`) holds the full-resolution sources on
train and the final tensors on eval. Unlike the JAX version (ROADMAP C6) it
budgets the bytes it actually holds (the sources' sizes come from their
headers), decodes the same formats with and without the cache, and is
filled once in the parent process by a pool of threads; a cached loader
runs without workers. The workers of an uncached loader persist across
epochs. They are forked from a fork server that has imported this module
(and so torch) once, not spawned, each importing torch anew, nor forked
from the caller, whose threads (CUDA's, JAX's) a fork would cut off. The port shuffles the whole shard each epoch; a shuffle_buffer other
than JAX's default is refused rather than ignored.

Expected layout: root/<class_dir>/<image files> (ImageFolder).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FolderConfig:
    root: str
    resolution: int = 224
    batch_size: int = 80
    is_train: bool = True
    crop_pct: float = 0.875  # eval: resize /crop_pct + center crop (AA_eval.py:104-115)
    scale: tuple[float, float] = (0.08, 1.0)  # RRC area range (parserr.py:39)
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    num_parallel: int = 8  # loader worker processes (0: load in the caller)
    seed: int = 0
    shuffle_buffer: int = 8192  # JAX's tf.data buffer; the port shuffles the whole shard
    drop_remainder: bool = True
    subset_size: int = 0
    # the first subset_size images by BASENAME across classes: the
    # reference's robustbench subset (JAX FolderConfig.sort_by_basename)
    sort_by_basename: bool = False
    # keep decoded images in host RAM across epochs (--data.in_memory):
    # train caches the full decoded sources, eval the final tensors; skipped
    # when those bytes exceed cache_budget_bytes
    cache_decoded: bool = False
    cache_budget_bytes: int = 4 << 30
    pin_memory: bool = False

    def __post_init__(self):
        if self.shuffle_buffer != 8192:
            raise ValueError(f"shuffle_buffer={self.shuffle_buffer}: the port shuffles the "
                             "whole shard each epoch and has no shuffle buffer to size")


def list_image_folder(root: str | Path) -> tuple[list[str], list[int], list[str]]:
    """(file paths, int labels, class names) — torchvision ImageFolder semantics
    (classes sorted lexicographically)."""
    root = Path(root)
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    class_to_idx = {c: i for i, c in enumerate(classes)}
    files, labels = [], []
    exts = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".JPEG", ".JPG", ".PNG"}
    for c in classes:
        for f in sorted((root / c).rglob("*")):
            if f.suffix in exts:
                files.append(str(f))
                labels.append(class_to_idx[c])
    return files, labels, classes


# ------------------------------------------------------------------ resize

_TABLE = 1024


def _keys_table(a: float = -0.5) -> np.ndarray:
    """TF's bicubic coefficient table (resize_bicubic_op.cc InitCoeffsTable):
    [kTableSize + 1, 2] f32, each entry computed in double from an f32 x."""
    out = np.zeros((_TABLE + 1, 2), np.float32)
    for i in range(_TABLE + 1):
        x = float(np.float32(i * 1.0 / _TABLE))
        out[i, 0] = ((a + 2) * x - (a + 3)) * x * x + 1
        x = float(np.float32(x + 1.0))
        out[i, 1] = ((a * x - 5 * a) * x + 8 * a) * x - 4 * a
    return out


_COEFFS = _keys_table()


def _axis_taps(in_size: int, out_size: int, start: int, count: int):
    """Input indices [count, 4] (int64) and f32 weights [count, 4] of output
    positions start .. start + count - 1 along one axis (TF's
    GetWeightsAndIndices with half-pixel centres and Keys cubic)."""
    f32 = np.float32
    scale = f32(in_size) / f32(out_size)
    in_loc_f = (np.arange(start, start + count).astype(f32) + f32(0.5)) * scale - f32(0.5)
    in_loc = np.floor(in_loc_f).astype(np.int64)
    offset = np.rint((in_loc_f - in_loc.astype(f32)) * f32(_TABLE)).astype(np.int64)
    taps = in_loc[:, None] + np.arange(-1, 3)
    idx = np.clip(taps, 0, in_size - 1)
    coef = np.stack([_COEFFS[offset, 1], _COEFFS[offset, 0], _COEFFS[_TABLE - offset, 0],
                     _COEFFS[_TABLE - offset, 1]], 1)
    w = np.where(idx == taps, coef, f32(0.0))
    total = ((w[:, 0] + w[:, 1]) + w[:, 2]) + w[:, 3]
    w = w * (f32(1.0) / total)[:, None]
    return torch.from_numpy(idx), torch.from_numpy(w.astype(f32))


def _interp(v: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, dim: int) -> torch.Tensor:
    """sum_k v[idx[:, k]] * w[:, k] along dim, the four products summed in
    order in f32 (TF's Interpolate1D)."""
    shape = [1] * v.dim()
    shape[dim] = -1
    out = None
    for k in range(4):
        term = v.index_select(dim, idx[:, k]) * w[:, k].reshape(shape)
        out = term if out is None else out + term
    return out


def resize_bicubic(img: np.ndarray, out_h: int, out_w: int, top: int = 0, left: int = 0,
                   rows: int | None = None, cols: int | None = None) -> np.ndarray:
    """tf.image.resize(img, (out_h, out_w), "bicubic") of an HWC image,
    optionally only its window [top, top + rows) x [left, left + cols),
    clipped to [0, 255] and truncated to uint8. TF interpolates along H,
    then along W."""
    rows = out_h if rows is None else rows
    cols = out_w if cols is None else cols
    src = torch.from_numpy(img.astype(np.float32))
    yi, yw = _axis_taps(img.shape[0], out_h, top, rows)
    xi, xw = _axis_taps(img.shape[1], out_w, left, cols)
    out = _interp(_interp(src, yi, yw, 0), xi, xw, 1)
    return out.clamp_(0.0, 255.0).to(torch.uint8).numpy()


def eval_transform(img: np.ndarray, res: int, crop_pct: float) -> np.ndarray:
    """The eval image: short side to floor(res / crop_pct) and the centre
    res x res crop, or at res >= 384 a warp resize to res x res
    (folder.py:126-147)."""
    if res >= 384:
        return resize_bicubic(img, res, res)
    h, w = img.shape[:2]
    scale_size = int(np.floor(np.float32(res / crop_pct)))
    ratio = np.float32(scale_size) / np.float32(min(h, w))
    nh, nw = int(np.rint(np.float32(h) * ratio)), int(np.rint(np.float32(w) * ratio))
    return resize_bicubic(img, nh, nw, (nh - res) // 2, (nw - res) // 2, res, res)


# -------------------------------------------------------------------- crop

def _generate_crop(rng: np.random.Generator, width: int, height: int, min_rel: np.float32,
                   max_rel: np.float32, aspect: np.float32):
    """TF's GenerateRandomCrop (sample_distorted_bounding_box_op.cc): a
    (top, left, h, w) box whose height is uniform between the heights of the
    smallest and largest admitted areas at this aspect, or None."""
    f32 = np.float32
    min_area = min_rel * f32(width) * f32(height)
    max_area = max_rel * f32(width) * f32(height)
    ch = int(np.rint(np.sqrt(min_area / aspect)))
    max_h = int(np.rint(np.sqrt(max_area / aspect)))
    if np.rint(f32(max_h) * aspect) > width:
        max_h = int((width + 0.5 - float(f32(1e-7))) / float(aspect))
        if np.rint(f32(max_h) * aspect) > width:
            max_h -= 1
    max_h = min(max_h, height)
    ch = min(ch, max_h)
    if ch < max_h:
        ch += int(rng.integers(0, max_h - ch + 1))
    cw = int(np.rint(f32(ch) * aspect))
    area = f32(cw * ch)
    if area < min_area:
        ch += 1
        cw = int(np.rint(f32(ch) * aspect))
        area = f32(cw * ch)
    if area > max_area:
        ch -= 1
        cw = int(np.rint(f32(ch) * aspect))
        area = f32(cw * ch)
    if (area < min_area or area > max_area or cw > width or ch > height or cw <= 0
            or ch <= 0):
        return None
    top = int(rng.integers(0, height - ch)) if ch < height else 0
    left = int(rng.integers(0, width - cw)) if cw < width else 0
    return top, left, ch, cw


def sample_crop(rng: np.random.Generator, height: int, width: int,
                scale: tuple[float, float], ratio: tuple[float, float],
                max_attempts: int = 10, min_object_covered: float = 0.1):
    """tf.image.sample_distorted_bounding_box with no boxes and
    use_image_if_no_bounding_boxes (the whole image is the object): up to
    max_attempts aspects uniform in `ratio`, a crop of area fraction in
    `scale` that covers at least min_object_covered of the image, else the
    whole image. Returns (top, left, h, w)."""
    f32 = np.float32
    lo, hi = f32(ratio[0]), f32(ratio[1])
    for _ in range(max_attempts):
        aspect = f32(rng.random(dtype=np.float32)) * (hi - lo) + lo
        box = _generate_crop(rng, width, height, f32(scale[0]), f32(scale[1]), aspect)
        if box is not None and box[2] * box[3] >= 1 and (
                f32(box[2] * box[3]) / f32(width * height) >= f32(min_object_covered)):
            return box
    return 0, 0, height, width


# ------------------------------------------------------------------ loader

def decode(path: str) -> np.ndarray:
    """An image file as HWC uint8 RGB (any format PIL reads)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _collate(batch):
    images, labels = zip(*batch)
    return torch.from_numpy(np.stack(images)), torch.tensor(labels, dtype=torch.int64)


class _Source(torch.utils.data.Dataset):
    """Item (epoch, i, res) -> (image i at res x res, uint8 HWC; its label)."""

    def __init__(self, files, labels, cfg: FolderConfig, cache):
        self.files, self.labels, self.cfg, self.cache = files, labels, cfg, cache

    def __len__(self):
        return len(self.files)

    def __getitem__(self, key):
        epoch, i, res = key
        cfg = self.cfg
        if not cfg.is_train:
            img = self.cache[i] if self.cache is not None else eval_transform(
                decode(self.files[i]), cfg.resolution, cfg.crop_pct)
            return img, self.labels[i]
        img = self.cache[i] if self.cache is not None else decode(self.files[i])
        rng = np.random.default_rng([cfg.seed % 2 ** 32, epoch, i])
        top, left, h, w = sample_crop(rng, img.shape[0], img.shape[1], cfg.scale, cfg.ratio)
        return resize_bicubic(img[top:top + h, left:left + w], res, res), self.labels[i]


class _EpochBatches:
    """Batches of (epoch, index, resolution) keys; each pass is the next
    epoch, shuffled from (seed, epoch) on train. With drop_remainder a pass
    is `full` batches: every process of a sharded folder takes the same
    count, the JAX one, len(all files) // (batch_size * process_count), so
    their steps and LR schedules agree where the shards' sizes differ."""

    def __init__(self, n: int, cfg: FolderConfig, full: int):
        self.n, self.cfg, self.full = n, cfg, full
        self.epoch, self.resolution = 0, cfg.resolution

    def __len__(self):
        return self.full if self.cfg.drop_remainder else -(-self.n // self.cfg.batch_size)

    def __iter__(self):
        epoch, b = self.epoch, self.cfg.batch_size
        self.epoch += 1
        order = (np.random.default_rng([self.cfg.seed % 2 ** 32, epoch]).permutation(self.n)
                 if self.cfg.is_train else np.arange(self.n))
        for s in range(0, len(self) * b, b):
            yield [(epoch, int(i), self.resolution) for i in order[s:s + b]]


def fork_server():
    """The forkserver context, its server started: it imports this module
    (and so torch) once, in the background, and forks every worker from
    there. A caller may start it early, to overlap that import with other
    work."""
    import multiprocessing
    from multiprocessing import forkserver

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    forkserver.ensure_running()
    return ctx


def stop_fork_server() -> None:
    """Stop what fork_server started, each process waited for: the workers
    of loaders no longer referenced (their finalizers join them; any worker
    left is terminated), the server, and the resource tracker it started.
    Left alone, they outlive the caller by a few seconds. A loader made
    afterwards starts a new server."""
    import gc
    import multiprocessing
    from multiprocessing import forkserver, resource_tracker
    from multiprocessing.context import ForkServerProcess

    gc.collect()
    for p in multiprocessing.active_children():
        if isinstance(p, ForkServerProcess):
            p.terminate()
            p.join()
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


class FolderLoader:
    """One process's shard of an ImageFolder as batches of (uint8 images
    [B, R, R, 3], int64 labels [B]). Iterating it runs the next epoch."""

    def __init__(self, cfg: FolderConfig, process_index: int = 0, process_count: int = 1):
        root = Path(cfg.root)
        if not root.is_dir():
            raise FileNotFoundError(f"image folder {root}: no such directory")
        files, labels, _ = list_image_folder(root)
        if cfg.sort_by_basename:
            order = sorted(range(len(files)), key=lambda i: Path(files[i]).name)
            files, labels = [files[i] for i in order], [labels[i] for i in order]
        if cfg.subset_size > 0:
            files, labels = files[: cfg.subset_size], labels[: cfg.subset_size]
        full = len(files) // (cfg.batch_size * process_count)
        files = files[process_index::process_count]
        labels = labels[process_index::process_count]
        if not files:
            raise ValueError(f"image folder {root}: no images in shard {process_index} of "
                             f"{process_count}")
        self.cfg = cfg
        self.cache_bytes = self._cache_bytes(files)
        self.cached = cfg.cache_decoded and self.cache_bytes <= cfg.cache_budget_bytes
        cache = None
        if self.cached:
            fill = (decode if cfg.is_train else
                    lambda f: eval_transform(decode(f), cfg.resolution, cfg.crop_pct))
            with ThreadPoolExecutor(max(cfg.num_parallel, 1)) as ex:
                cache = list(ex.map(fill, files))
        self.batches = _EpochBatches(len(files), cfg, full)
        workers = 0 if self.cached else cfg.num_parallel
        self.num_workers = workers
        self._loader = torch.utils.data.DataLoader(
            _Source(files, labels, cfg, cache), batch_sampler=self.batches,
            num_workers=workers, collate_fn=_collate, pin_memory=cfg.pin_memory,
            multiprocessing_context=fork_server() if workers else None,
            persistent_workers=workers > 0)

    def _cache_bytes(self, files) -> int:
        """The bytes the cache would hold: every source at its full size on
        train (read from the headers), the final tensors on eval."""
        if not self.cfg.cache_decoded:
            return 0
        if not self.cfg.is_train:
            return len(files) * self.cfg.resolution ** 2 * 3
        from PIL import Image

        total = 0
        for f in files:
            with Image.open(f) as im:
                total += im.size[0] * im.size[1] * 3
        return total

    def set_epoch(self, epoch: int) -> "FolderLoader":
        """The next pass is epoch `epoch` (its shuffle and crops): a resumed
        run goes on with the epoch it resumes at, not with the first."""
        self.batches.epoch = epoch
        return self

    def set_resolution(self, res: int) -> "FolderLoader":
        """Train images at res x res from the next epoch on (the ramp)."""
        if not self.cfg.is_train:
            raise ValueError("set_resolution: an eval loader keeps its resolution")
        self.batches.resolution = res
        return self

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self._loader)


def make_folder_dataset(cfg: FolderConfig, process_index: int = 0, process_count: int = 1):
    """(it_fn, batches per epoch), as the JAX version returns them: it_fn()
    gives the next epoch's iterator."""
    loader = FolderLoader(cfg, process_index, process_count)
    return loader.__iter__, len(loader)

