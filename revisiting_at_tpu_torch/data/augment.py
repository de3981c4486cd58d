"""On-device RandAugment, RandomErasing and horizontal flip on NHWC batches,
port of revisiting_at_tpu/data/augment.py.

The reference recipe's timm stack ('rand-m9-mstd0.5-inc1', RandomErasing
p=0.25 'pixel' mode, flip 0.5) runs on the batch's device inside the train
step, after uint8 -> [0, 1] and before mixup (JAX augment.py:467-491).
Every function takes NHWC f32 images in [0, 1].

Semantics are JAX's, with its two documented deviations from timm
(augment.py:402-413): per layer, the photometric op an image drew is applied
first (JAX selects it from all 15 over `apply`; here each op runs on the
images that drew it, the same result), and the geometric ops compose into
one inverse matrix per image (`total = total @ hom` in application order),
warped once at the end. The warp runs on every image, identity included
(augment.py:435), so every augmented pixel passes through its bf16 casts.

Randomness is drawn on the host, as in data/mixup.py: `draw_augment` makes
an `AugmentDraws` from a CPU torch.Generator (or a test hands in JAX's
draws), so the card and the CPU see the same draws. Only the erasing's N(0,
1) fill is drawn on the batch's device, for the images that erase, unless
`AugmentDraws.noise` carries it.

The warp keeps JAX's Catmull-Smith factorisation into two 1-D passes
(augment.py:279-297) and its cast points: x and the weights (1-fr, fr) in
bf16, the two products summed in f32, the coverage added in f32
(augment.py:254-270). The one-hot banded matmul that JAX runs on the TPU's
MXU (O(B*H*W^2) operand) becomes a two-tap gather. Equalize is PIL's
integer LUT (augment.py:54-89) from a scatter-add histogram over B*3 offset
channels and a gather, not JAX's one-hot matmuls. Per-image scalars
(matrices, erasing boxes, the images each op runs on) are computed on the
host and reach the device in one pinned, non-blocking copy per dtype: a
pageable copy would wait for the stream, and so for the previous step.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_F32 = torch.float32
_BF16 = torch.bfloat16
# XLA compiles JAX's division by a constant c into a product with the f32
# 1/c; these are those factors (and CUDA's division by a scalar is the same
# product, the CPU's a true division)
_INV10 = 1.0 / 10.0
_INV255 = 1.0 / 255.0


@dataclasses.dataclass(frozen=True)
class RandAugmentConfig:
    magnitude: float = 9.0
    mstd: float = 0.5
    num_layers: int = 2
    prob: float = 0.5


N_OPS = 15  # timm _RAND_INCREASING_TRANSFORMS
GEO_OPS = (3, 11, 12, 13, 14)  # rotate, shear x/y, translate x/y


@dataclasses.dataclass(frozen=True)
class AugmentDraws:
    """One batch's draws (host tensors, b images, L layers).

    flip: bool [b]; op_idx: int64 [L, b] in [0, N_OPS); lvl: f32 [L, b],
    N(magnitude, mstd) clipped to [0, 10]; sign: f32 [L, b], +-1; apply:
    bool [L, b]; erase: bool [b]; target: f32 [b], the erasing box's area in
    pixels; log_r: f32 [b], its log aspect; top, left: int64 [b], its corner.
    noise: the erasing fill [number of erasing images, h, w, 3] on the
    batch's device, or None to draw it there."""
    flip: torch.Tensor
    op_idx: torch.Tensor
    lvl: torch.Tensor
    sign: torch.Tensor
    apply: torch.Tensor
    erase: torch.Tensor
    target: torch.Tensor
    log_r: torch.Tensor
    top: torch.Tensor
    left: torch.Tensor
    noise: torch.Tensor | None = None


def erase_box(target: torch.Tensor, log_r: torch.Tensor, h: int, w: int):
    """The erasing box's height and width (int64) from its area and log
    aspect, as JAX rounds them (augment.py:449-450)."""
    aspect = torch.exp(log_r)
    eh = torch.clamp(torch.round(torch.sqrt(target * aspect)), 1, h).long()
    ew = torch.clamp(torch.round(torch.sqrt(target / aspect)), 1, w).long()
    return eh, ew


def draw_augment(gen: torch.Generator, b: int, h: int, w: int,
                 cfg: RandAugmentConfig = RandAugmentConfig(), re_prob: float = 0.25,
                 hflip: float = 0.5, min_area: float = 0.02, max_area: float = 1.0 / 3.0,
                 min_aspect: float = 0.3) -> AugmentDraws:
    """The draws of one batch of b images of h x w from a CPU generator,
    with JAX's distributions (augment.py:414-418, 447-456, 466)."""
    u = lambda *s: torch.rand(*s, generator=gen)  # noqa: E731
    L = cfg.num_layers
    flip = u(b) < hflip
    op_idx = torch.randint(0, N_OPS, (L, b), generator=gen)
    lvl = torch.clamp(cfg.magnitude + cfg.mstd * torch.randn(L, b, generator=gen), 0.0, 10.0)
    sign = torch.where(u(L, b) < 0.5, 1.0, -1.0)
    apply = u(L, b) < cfg.prob
    erase = u(b) < re_prob
    target = (h * w) * (min_area + (max_area - min_area) * u(b))
    lo, hi = math.log(min_aspect), math.log(1.0 / min_aspect)
    log_r = lo + (hi - lo) * u(b)
    eh, ew = erase_box(target, log_r, h, w)
    top = torch.floor(u(b) * torch.clamp(h - eh, min=1)).long()
    left = torch.floor(u(b) * torch.clamp(w - ew, min=1)).long()
    return AugmentDraws(flip, op_idx, lvl, sign, apply, erase, target, log_r, top, left)


# ---------------------------------------------------------------- pixel ops
# x: [n, H, W, 3] f32; lvl, sign: [n] f32 on x's device.

def _col(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


def _to_device(tensors: list[torch.Tensor], device: torch.device) -> list[torch.Tensor]:
    """Host tensors on `device`: on CUDA one pinned, non-blocking copy per
    dtype, so that the host does not wait for the stream."""
    if device.type != "cuda":
        return tensors
    out = list(tensors)
    for dtype in {t.dtype for t in tensors}:
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx]).pin_memory()
        flat = flat.to(device, non_blocking=True)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def _blend(a, b, factor):
    return b + factor * (a - b)


def _gray(x: torch.Tensor) -> torch.Tensor:
    w = torch.tensor([0.299, 0.587, 0.114], dtype=_F32, device=x.device)
    p = x * w
    return (p[..., 0:1] + p[..., 1:2]) + p[..., 2:3]


def _enh_factor(lvl, sign):
    return _col(1.0 + sign * lvl * _INV10 * 0.9)


def invert(x, lvl=None, sign=None):
    return 1.0 - x


def autocontrast(x, lvl=None, sign=None):
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo + 1e-12), 1.0)
    return torch.clamp((x - lo) * scale, 0.0, 1.0)


def _levels(x):
    """PIL's uint8 levels of [0, 1] pixels: clip(floor(x * 255), 0, 255)."""
    return torch.clamp(torch.floor(x * 255.0), 0, 255).long()


def equalize(x, lvl=None, sign=None):
    """PIL ImageOps.equalize, bit-exact: per image and channel the integer LUT
    lut[i] = (step//2 + sum(h[:i])) // step, step = (N - count of the last
    non-empty bin) // 255; identity where step == 0."""
    n, H, W, C = x.shape
    v = _levels(x).permute(0, 3, 1, 2).reshape(n * C, H * W)
    offset = torch.arange(n * C, device=x.device)[:, None] * 256
    hist = torch.zeros(n * C * 256, dtype=torch.long, device=x.device)
    hist = hist.scatter_add_(0, (v + offset).flatten(), torch.ones_like(v).flatten())
    hist = hist.view(n * C, 256)
    last_idx = 255 - torch.argmax((hist > 0).flip(1).to(torch.uint8), dim=1)
    last_count = hist.gather(1, last_idx[:, None])
    step = (H * W - last_count) // 255
    excl = torch.cumsum(hist, 1) - hist
    lut = torch.clamp((step // 2 + excl) // torch.clamp(step, min=1), 0, 255)
    out = torch.where(step > 0, lut.gather(1, v), v).to(_F32) * _INV255
    return out.view(n, C, H, W).permute(0, 2, 3, 1)


def posterize(x, lvl, sign=None):
    bits = torch.clamp(4 - torch.floor(lvl * _INV10 * 4.0).long(), min=1)
    keep = (255 << (8 - bits)) & 255
    return (_levels(x) & _col(keep)).to(_F32) * _INV255


def solarize(x, lvl, sign=None):
    thresh = _col((256.0 - lvl * _INV10 * 256.0) * _INV255)
    return torch.where(x >= thresh, 1.0 - x, x)


def solarize_add(x, lvl, sign=None):
    add = _col(lvl * _INV10 * 110.0 * _INV255)
    half = torch.tensor(128.0 * _INV255, dtype=_F32, device=x.device)
    return torch.where(x < half, torch.clamp(x + add, 0.0, 1.0), x)


def color(x, lvl, sign):
    return torch.clamp(_blend(x, _gray(x).expand_as(x), _enh_factor(lvl, sign)), 0.0, 1.0)


def contrast(x, lvl, sign):
    mean = _gray(x).mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp(_blend(x, mean.expand_as(x), _enh_factor(lvl, sign)), 0.0, 1.0)


def brightness(x, lvl, sign):
    return torch.clamp(_blend(x, torch.zeros_like(x), _enh_factor(lvl, sign)), 0.0, 1.0)


def sharpness(x, lvl, sign):
    """Blend with PIL's SMOOTH 3x3 kernel (edge-replicated), its nine taps
    summed in row-major order in f32 on either device."""
    H, W = x.shape[1], x.shape[2]
    xp = torch.cat([x[:, :1], x, x[:, -1:]], 1)
    xp = torch.cat([xp[:, :, :1], xp, xp[:, :, -1:]], 2)
    k = torch.tensor([1.0, 5.0], dtype=_F32) / 13.0
    sm = None
    for dy in range(3):
        for dx in range(3):
            wt = float(k[1] if (dy, dx) == (1, 1) else k[0])
            term = xp[:, dy:dy + H, dx:dx + W] * wt
            sm = term if sm is None else sm + term
    return torch.clamp(_blend(x, sm, _enh_factor(lvl, sign)), 0.0, 1.0)


# index -> photometric op; the geometric indices (GEO_OPS) are matrices
PHOTOMETRIC = {0: autocontrast, 1: equalize, 2: invert, 4: posterize, 5: solarize,
               6: solarize_add, 7: color, 8: contrast, 9: brightness, 10: sharpness}


# ------------------------------------------------------------ geometric ops

def geo_mats(op_idx: torch.Tensor, lvl: torch.Tensor, sign: torch.Tensor, h: int,
             w: int) -> torch.Tensor:
    """[n, 2, 3] f32 inverse (output -> input) maps of ops op_idx [n] at
    levels and signs [n] (host f32); the identity for photometric ops
    (augment.py:155-189, 300-321). Rotation turns counter-clockwise about
    the centre, as PIL's."""
    mag = sign * lvl * _INV10
    one, zero = torch.ones_like(mag), torch.zeros_like(mag)
    th = mag * 30.0 * math.pi * (1.0 / 180.0)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    c, s = torch.cos(th), torch.sin(th)
    rows = {
        3: (c, -s, cx - c * cx + s * cy, s, c, cy - s * cx - c * cy),
        11: (one, mag * 0.3, zero, zero, one, zero),
        12: (one, zero, zero, mag * 0.3, one, zero),
        13: (one, zero, mag * 0.45 * w, zero, one, zero),
        14: (one, zero, zero, zero, one, mag * 0.45 * h),
    }
    out = torch.stack((one, zero, zero, zero, one, zero), -1)
    for k, r in rows.items():
        out = torch.where((op_idx == k)[:, None], torch.stack(r, -1), out)
    return out.view(-1, 2, 3)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[n, 3, 3] @ [n, 3, 3] in f32, its three terms summed in order."""
    return (a[:, :, 0:1] * b[:, 0:1, :] + a[:, :, 1:2] * b[:, 1:2, :]) + a[:, :, 2:3] * b[:, 2:3, :]


def _affine_sample(x: torch.Tensor, mat: torch.Tensor, fill: float = 0.5) -> torch.Tensor:
    """Bilinear sample of one image x [H, W, C] at mat @ [xo, yo, 1], the
    per-image reference warp (augment.py:144-177)."""
    H, W, _ = x.shape
    mat = _to_device([mat], x.device)[0]
    yo = torch.arange(H, dtype=_F32, device=x.device)[:, None].expand(H, W)
    xo = torch.arange(W, dtype=_F32, device=x.device)[None, :].expand(H, W)
    xi = mat[0, 0] * xo + mat[0, 1] * yo + mat[0, 2]
    yi = mat[1, 0] * xo + mat[1, 1] * yo + mat[1, 2]
    x0, y0 = torch.floor(xi), torch.floor(yi)
    wx, wy = (xi - x0)[..., None], (yi - y0)[..., None]

    def gather(yy, xx):
        inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        vals = x[torch.clamp(yy, 0, H - 1).long(), torch.clamp(xx, 0, W - 1).long()]
        return torch.where(inb[..., None], vals, fill)

    return (gather(y0, x0) * (1 - wx) * (1 - wy) + gather(y0, x0 + 1) * wx * (1 - wy)
            + gather(y0 + 1, x0) * (1 - wx) * wy + gather(y0 + 1, x0 + 1) * wx * wy)


def _resample(x: torch.Tensor, tgt: torch.Tensor, dim: int, fill: float) -> torch.Tensor:
    """1-D linear resample of x [B, H, W, C] along dim (1: H, 2: W): output
    element i reads x at source coordinate tgt [B, H, W] along that axis,
    blended into fill where the two taps leave the image. x and the weights
    are rounded to bf16, the two products summed in f32 (augment.py:240-270)."""
    n = x.shape[dim]
    t0f = torch.floor(tgt)
    frf = tgt - t0f
    fr = frf.to(_BF16)
    in_lo = (t0f >= 0.0) & (t0f <= n - 1)
    in_hi = (t0f + 1.0 >= 0.0) & (t0f + 1.0 <= n - 1)
    x16 = x.to(_BF16)

    def tap(t, weight, inside):
        idx = torch.clamp(t, 0, n - 1).long()[..., None].expand(x.shape)
        v = torch.gather(x16, dim, idx).to(_F32)
        return torch.where(inside[..., None], weight.to(_F32)[..., None] * v, 0.0)

    out = tap(t0f, 1 - fr, in_lo) + tap(t0f + 1.0, fr, in_hi)
    cov = (1.0 - frf) * in_lo + frf * in_hi
    return out + (1.0 - cov)[..., None] * fill


def warp_affine_batch(x: torch.Tensor, mats: torch.Tensor, fill: float = 0.5) -> torch.Tensor:
    """Batched inverse-map affine warp of x [B, H, W, C] by mats [B, 2, 3]
    (rows a b c; d e f), as two 1-D passes (augment.py:279-297):
    along W, tmp[h, w] = x[h, g], g = (a - b d/e) w + (b/e) h + (c - b f/e);
    along H, out[h, w] = tmp[d w + e h + f, w]; e is kept off zero."""
    B, H, W, _ = x.shape
    m = mats.to(device=x.device, dtype=_F32)
    a, b, c = (m[:, 0, i, None, None] for i in range(3))
    d, e, f = (m[:, 1, i, None, None] for i in range(3))
    wo = torch.arange(W, dtype=_F32, device=x.device)[None, None, :]
    ho = torch.arange(H, dtype=_F32, device=x.device)[None, :, None]
    e_safe = torch.where(torch.abs(e) < 1e-6, 1e-6, e)
    g = (a - b * d / e_safe) * wo + (b / e_safe) * ho + (c - b * f / e_safe)
    tmp = _resample(x, g.expand(B, H, W), 2, fill)
    k = d * wo + e * ho + f
    return _resample(tmp, k.expand(B, H, W), 1, fill)


# ------------------------------------------------------------- rand augment

def _apply_op(x: torch.Tensor, op_idx: int, lvl: torch.Tensor, sign: torch.Tensor):
    """One op on one image x [H, W, 3] (lvl, sign 0-d f32): photometric ops
    directly, geometric ones through the bilinear _affine_sample."""
    h, w, _ = x.shape
    if op_idx in GEO_OPS:
        return _affine_sample(x, geo_mats(torch.tensor([op_idx]), lvl.reshape(1),
                                          sign.reshape(1), h, w)[0])
    lvl, sign = _to_device([lvl.reshape(1), sign.reshape(1)], x.device)
    return PHOTOMETRIC[op_idx](x[None], lvl, sign)[0]


def rand_augment_single(img: torch.Tensor, draws: AugmentDraws, i: int,
                        cfg: RandAugmentConfig = RandAugmentConfig()) -> torch.Tensor:
    """The per-image reference path (augment.py:383-399): image i of the
    draws, its ops applied one after another in layer order, each geometric
    op resampled on its own. rand_augment_batch is the production path."""
    x = img
    for layer in range(cfg.num_layers):
        if bool(draws.apply[layer, i]):
            x = _apply_op(x, int(draws.op_idx[layer, i]), draws.lvl[layer, i],
                          draws.sign[layer, i])
    return x


def rand_augment_batch(images: torch.Tensor, draws: AugmentDraws,
                       cfg: RandAugmentConfig = RandAugmentConfig()) -> torch.Tensor:
    """Batched RandAugment (augment.py:402-435): per layer each image's
    photometric op, if it applies; the geometric ops composed into one
    matrix per image; then one warp of every image."""
    return warp_affine_batch(*photometric_layers(images, draws, cfg))


def photometric_layers(images: torch.Tensor, draws: AugmentDraws,
                       cfg: RandAugmentConfig = RandAugmentConfig()):
    """rand_augment_batch up to its warp: (the images after each layer's
    photometric ops, the composed inverse maps [b, 2, 3] on their device)."""
    b, h, w, _ = images.shape
    total = torch.eye(3, dtype=_F32).expand(b, 3, 3)
    bottom = torch.tensor([[0.0, 0.0, 1.0]], dtype=_F32)
    groups, host = [], []  # per layer and op: the images that apply it, their lvl and sign
    for layer in range(cfg.num_layers):
        ops, apply = draws.op_idx[layer], draws.apply[layer]
        lvl, sign = draws.lvl[layer], draws.sign[layer]
        for k in PHOTOMETRIC:
            sel = torch.nonzero(apply & (ops == k)).flatten()
            if len(sel):
                groups.append(k)
                host += [sel, lvl[sel], sign[sel]]
        hom = torch.cat([geo_mats(ops, lvl, sign, h, w), bottom.expand(b, 1, 3)], 1)
        hom = torch.where(apply[:, None, None], hom, torch.eye(3, dtype=_F32))
        total = _matmul3(total, hom)  # inverse maps compose in application order
    *dev, mats = _to_device(host + [total[:, :2, :].contiguous()], images.device)
    x = images.clone()
    for g, k in enumerate(groups):  # in layer order
        idx, lvl, sign = dev[3 * g:3 * g + 3]
        x[idx] = PHOTOMETRIC[k](x[idx], lvl, sign)
    return x, mats


# ----------------------------------------------------- erasing, flip, batch

def random_erasing(images: torch.Tensor, draws: AugmentDraws,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """timm RandomErasing, mode 'pixel', count 1 (augment.py:438-464): the
    drawn box of each erasing image filled with unclamped N(0, 1) noise,
    draws.noise or drawn on the images' device for those images only."""
    sel = torch.nonzero(draws.erase).flatten()
    if not len(sel):
        return images
    _, h, w, c = images.shape
    dev = images.device
    eh, ew = erase_box(draws.target[sel], draws.log_r[sel], h, w)
    idx, top, left, eh, ew = _to_device(
        [sel, _col(draws.top[sel]), _col(draws.left[sel]), _col(eh), _col(ew)], dev)
    noise = draws.noise
    if noise is None:
        noise = torch.randn((len(sel), h, w, c), generator=generator, device=dev,
                            dtype=images.dtype)
    ys = torch.arange(h, device=dev)[None, :, None, None]
    xs = torch.arange(w, device=dev)[None, None, :, None]
    box = (ys >= top) & (ys < top + eh) & (xs >= left) & (xs < left + ew)
    out = images.clone()
    out[idx] = torch.where(box, noise.to(device=dev, dtype=images.dtype), images[idx])
    return out


def hflip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip along W the images whose flag is set (augment.py:467-468)."""
    return torch.where(_to_device([_col(flip)], images.device)[0], images.flip(2), images)


def augment_batch(images: torch.Tensor, draws: AugmentDraws,
                  cfg: RandAugmentConfig = RandAugmentConfig(), use_randaug: bool = True,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """The train-time augmentation of a uint8 or [0, 1] f32 NHWC batch on its
    device (augment.py:472-491): uint8 -> /255, flip, RandAugment, erasing.
    The flip and erasing probabilities are draw_augment's."""
    if images.dtype == torch.uint8:
        images = images.to(_F32) * _INV255
    x = hflip(images, draws.flip)
    if use_randaug:
        x = rand_augment_batch(x, draws, cfg)
    return random_erasing(x, draws, generator)
