"""7x7 depthwise convolution of NHWC maps, SAME padding, with bias, port of
revisiting_at_tpu/ops/dwconv.py:

    y[b, h, w, c] = b[c] + sum_{i,j} w[i, j, c] * xpad[b, h + i, w + j, c]

Hand-written Hopper kernels in csrc/dwconv.cu replace its TPU kernels:

  * the forward replaces `_fwd_kernel`;
  * dx, the same stencil run on dy with the flipped taps and no bias,
    replaces `_bwd_kernel`'s input cotangent (the forward kernel with a
    template flag);
  * dw and db replace the rest of `_bwd_kernel`: a weight pass writes
    per-block partials and a reduction sums them in a fixed order, in one
    launch whatever their number.

The forward (and dx) and the weight pass are persistent kernels fed by a
TMA ring: 14 x 14-pixel, 32-channel tiles whose halos arrive through a 4-D
tensor map (its zero fill is the SAME padding), a producer warp and four
consumer warps of 7 x 7 outputs each; the stencil's tiles leave by TMA
stores, which clip the map's edges. `dwconv_plan` gives their tiling and
grids from the shapes and the SM count alone; the C entry points check it.

The JAX package's `dwconv7x7_v2` runs other TPU kernels (`_fwd_kernel_v2`,
`_bwd_kernel_v2`) that differ from v1 only in how the TPU schedules its
sublane shifts (one misaligned copy per column offset); they compute the
same function, so one Hopper forward and one backward serve both names.

Numbers follow the JAX kernels: x and dy are read as f32; the weights and
the bias stay f32 (not rounded to the map's type); the forward starts its
f32 accumulator at the bias and adds the 49 taps in row-major order; dx
starts at zero; y and dx are rounded to x's dtype; dw and db are f32. The
model's library route (cuDNN on bf16 weights, bias added in bf16) rounds
elsewhere, so the two routes are not interchangeable bit for bit.

Layouts: x [B, H, W, C] NHWC; w [7, 7, 1, C] (flax's depthwise HWIO) or
[7, 7, C]; b [C]. The kernels take the tap-major weight [49, C] f32.

Beside each kernel is its plain PyTorch version with the same cast points,
49 shifted multiply-adds on the padded map. A tensor on the CPU takes the
plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import cuda_build

K = 7
P = K // 2
TAPS = K * K

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"fwd": 0, "dx": 0, "wgrad": 0, "reduce": 0}

# The kernels' tiling (csrc/dwconv.cu): output rows and columns of a tile,
# channels of a tile, threads of a block (four consumer warps and the
# producer), ring stages; a partial row of the weight pass holds 49 dw taps
# and db.
TILE = 14
GROUP = 32
THREADS = 160
STAGES = 2
PARTS = TAPS + 1
MAX_C = 384
_HALO = TILE + K - 1
# blocks per SM each kernel is planned for, by the map's element size
# (bf16: 128 registers a thread; f32: the shared memory)
_FWD_BLOCKS = {2: 3, 4: 1}
_WGRAD_BLOCKS = {2: 2, 4: 1}
_ELEM = {torch.bfloat16: 2, torch.float32: 4}


class DwconvPlan(NamedTuple):
    """The tiling and grids of the dwconv kernels at one shape."""
    tile: int           # output rows and columns of a tile
    group: int          # channels of a tile
    threads: int        # threads of a block
    stages: int         # TMA ring stages
    bands: int          # tiles down the map
    ctiles: int         # tiles across it
    groups: int         # channel groups
    tiles: int          # the stencil's tiles: groups * B * bands * ctiles
    fwd_blocks_per_sm: int
    fwd_grid: int       # persistent blocks of the forward and dx
    fwd_smem: int       # their dynamic shared memory, bytes
    wgrad_blocks_per_sm: int
    per_chunk: int      # the weight pass's (image, band, column tile) items a block
    part_rows: int      # its chunks, the partial rows the reduction sums
    wgrad_grid: int     # groups * part_rows
    wgrad_smem: int


@functools.lru_cache(maxsize=None)
def dwconv_plan(B: int, H: int, W: int, C: int, dtype: torch.dtype, sms: int) -> DwconvPlan:
    """The plan csrc/dwconv.cu builds for x [B, H, W, C] of `dtype` on a
    card with `sms` SMs; its C entry points recompute it and refuse (-1) a
    plan they would not build.

    Stencil: tiles of TILE x TILE pixels and GROUP channels, in (channel
    group, image, band, column tile) order, fewer than 2^31, split into
    fwd_grid contiguous runs, one per block: as many blocks as fit on the
    card at once (fwd_blocks_per_sm per SM), at most one per tile. Weight
    pass: the (image, band, column tile) items of each channel group cut
    into part_rows chunks of per_chunk items, so that the groups *
    part_rows blocks fit on the card at once; block chunk * groups + group
    writes row `chunk` of the partials. Each block's shared memory is its
    ring (a tile's halo, and the weight pass's dy tile, per stage) with 128
    bytes of alignment slack, the stencil's output tile, and the ring's
    mbarriers. Nothing but the shapes and the SM count enters, so the
    partials and their sum are the same bits on every launch."""
    if dtype not in _ELEM:
        raise ValueError(f"dwconv_plan: dtype must be float32 or bfloat16, got {dtype}")
    if min(B, H, W, C, sms) <= 0 or C % 8 or C > MAX_C:
        raise ValueError(f"dwconv_plan: expected B, H, W, SMs >= 1 and C a multiple of 8 up to "
                         f"{MAX_C}, got B={B}, H={H}, W={W}, C={C}, sms={sms}")
    es = _ELEM[dtype]
    bands, ctiles, groups = -(-H // TILE), -(-W // TILE), -(-C // GROUP)
    items = B * bands * ctiles
    tiles = groups * items
    if tiles >= 2 ** 31:
        raise ValueError(f"dwconv_plan: {tiles} tiles, the kernels take fewer than 2^31")
    halo, dy = _HALO * _HALO * GROUP * es, TILE * TILE * GROUP * es
    fwd_bps, wgrad_bps = _FWD_BLOCKS[es], _WGRAD_BLOCKS[es]
    want = min(items, max(1, sms * wgrad_bps // groups))
    per_chunk = -(-items // want)
    part_rows = -(-items // per_chunk)
    bars = 2 * STAGES * 8  # a full and an empty mbarrier per stage
    return DwconvPlan(TILE, GROUP, THREADS, STAGES, bands, ctiles, groups, tiles,
                      fwd_bps, min(tiles, sms * fwd_bps), 128 + STAGES * halo + dy + bars,
                      wgrad_bps, per_chunk, part_rows, groups * part_rows,
                      128 + STAGES * (halo + dy) + bars)


def tap_major(w: torch.Tensor) -> torch.Tensor:
    """[7, 7, 1, C] or [7, 7, C] -> the kernels' [49, C] f32, tap i*7 + j."""
    if w.shape[:2] != (K, K) or w.dim() not in (3, 4) or (w.dim() == 4 and w.shape[2] != 1):
        raise ValueError(f"dwconv7x7: weight must be [7, 7, 1, C] or [7, 7, C], "
                         f"got {tuple(w.shape)}")
    return w.reshape(TAPS, w.shape[-1]).to(torch.float32, memory_format=torch.contiguous_format)


# ----------------------------------------------------------- plain versions

def _stencil(x, w49, acc):
    """acc + sum_{i,j} w49[i*7 + j] * xpad[:, i:i+H, j:j+W], in f32, taps in
    row-major order; x is read as f32."""
    _, H, W, _ = x.shape
    xp = F.pad(x.float(), (0, 0, P, P, P, P))
    for i in range(K):
        for j in range(K):
            acc = acc + w49[i * K + j] * xp[:, i:i + H, j:j + W, :]
    return acc


def fwd_plain(x, w49, b):
    """Forward of the kernel in plain PyTorch. x [B, H, W, C]; w49 [49, C]
    and b [C] f32. y has x's dtype."""
    acc = b.float().expand(x.shape).clone()
    return _stencil(x, w49.float(), acc).to(x.dtype)


def dx_plain(dy, w49, dtype):
    """dx in plain PyTorch: the forward's stencil on dy with the flipped
    taps w49[48 - (i*7 + j)], from zero, rounded to `dtype` (x's)."""
    return _stencil(dy, w49.float().flip(0), torch.zeros(dy.shape, device=dy.device)).to(dtype)


def wgrad_plain(x, dy):
    """dw [49, C] and db [C] in plain PyTorch, f32:
    dw[i*7 + j, c] = sum_{b,h,w} xpad[b, h+i, w+j, c] * dy[b, h, w, c]."""
    _, H, W, _ = x.shape
    xp = F.pad(x.float(), (0, 0, P, P, P, P))
    d = dy.float()
    dw = torch.stack([(xp[:, i:i + H, j:j + W, :] * d).sum((0, 1, 2))
                      for i in range(K) for j in range(K)])
    return dw, d.sum((0, 1, 2))


def reduce_plain(part):
    """The fixed-order reduction in plain PyTorch: part [R, N] -> [N]."""
    return part.sum(0)


# ----------------------------------------------------------- CUDA kernels

_lib_handle = None


def _lib():
    """The kernels' C entry points, built at first use."""
    global _lib_handle
    if _lib_handle is None:
        Pt, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        _lib_handle = types.SimpleNamespace(**cuda_build.load("dwconv", {
            "dwconv_supports": [I],
            "dwconv_occupancy": [I, I],
            "dwconv_fwd": [I, I, Pt, Pt, Pt, Pt, I, I, I, I, I, I, I, Pt],
            "dwconv_wgrad": [I, Pt, Pt, I, I, I, I, I, I, I, L, I, Pt, Pt],
            "dwconv_reduce": [Pt, L, L, Pt, Pt],
        }))
    return _lib_handle


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t: torch.Tensor) -> int:
    """The SMs of the card t lies on (read once per card)."""
    return _sms(t.get_device())


def plan_for(x: torch.Tensor) -> DwconvPlan:
    """dwconv_plan for the NHWC map x on its card."""
    B, H, W, C = x.shape
    return dwconv_plan(B, H, W, C, x.dtype, sm_count(x))


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_map(name, t, shape=None, dtype=None):
    """A contiguous, 16-byte aligned NHWC map of a supported dtype and width."""
    if t.dim() != 4 or t.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: expected a [B, H, W, C] float32/bfloat16 map, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if (shape is not None and tuple(t.shape) != tuple(shape)) or (dtype and t.dtype != dtype):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned NHWC map")
    C = t.shape[-1]
    if not _lib().dwconv_supports(C):
        raise NotImplementedError(f"dwconv7x7 CUDA kernel: unsupported width C = {C} "
                                  f"(a multiple of 8, at most {MAX_C})")
    return t.shape


def _check_vec(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous float32 {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _raise_on(err, what):
    if err != 0:
        why = {-1: "unsupported shape or plan", -2: "no tensor map"}.get(err, f"cudaError {err}")
        raise RuntimeError(f"dwconv {what} kernel launch failed: {why}")


def _launch_stencil(src, w49, b, dx: bool):
    B, H, W, C = _check_map("dy" if dx else "x", src)
    _check_vec("w", w49, (TAPS, C), src.device)
    if not dx:
        _check_vec("b", b, (C,), src.device)
    plan = plan_for(src)
    out = torch.empty_like(src)
    err = cuda_build.launch(src, _lib().dwconv_fwd, _DTYPE_CODE[src.dtype], int(dx),
                            src.data_ptr(), w49.data_ptr(), None if dx else b.data_ptr(),
                            out.data_ptr(), B, H, W, C, plan.fwd_grid, plan.stages,
                            plan.fwd_smem)
    _raise_on(err, "dx" if dx else "forward")
    LAUNCHES["dx" if dx else "fwd"] += 1
    return out


def fwd_cuda(x, w49, b):
    """Launch the forward kernel. Types as fwd_plain; x contiguous NHWC."""
    return _launch_stencil(x, w49, b, dx=False)


def dx_cuda(dy, w49):
    """Launch the forward kernel as dx (flipped taps, no bias). dx has dy's
    dtype, which the caller makes x's."""
    return _launch_stencil(dy, w49, None, dx=True)


def wgrad_partials_cuda(x, dy):
    """Launch the weight pass: partials [R, 50 * C] f32, R = the plan's
    part_rows, row r holding the dw (taps 0-48, each C wide) and db (the
    last C) of chunk r's blocks, one per channel group. The chunks come
    from the shapes and the SM count alone, so the summed result is the
    same bits every run."""
    B, H, W, C = _check_map("x", x)
    _check_map("dy", dy, x.shape, x.dtype)
    plan = plan_for(x)
    part = torch.empty(plan.part_rows, PARTS * C, dtype=torch.float32, device=x.device)
    err = cuda_build.launch(x, _lib().dwconv_wgrad, _DTYPE_CODE[x.dtype], x.data_ptr(),
                            dy.data_ptr(), B, H, W, C, plan.wgrad_grid, plan.stages,
                            plan.wgrad_smem, plan.per_chunk, plan.part_rows, part.data_ptr())
    _raise_on(err, "weight-gradient")
    LAUNCHES["wgrad"] += 1
    return part


def reduce_cuda(part):
    """Sum part [R, N] f32 over R in a fixed order, in one launch: [N].
    The host work is one allocation and one call (the device context only
    when the tensor is not on the current device)."""
    if part.dtype != torch.float32 or part.dim() != 2 or not part.is_contiguous():
        raise ValueError(f"part: expected contiguous float32 [R, N], got {part.dtype} "
                         f"{tuple(part.shape)}")
    R, N = part.shape
    out = part.new_empty(N)
    # the kernel refuses an N that is not a multiple of 4 or a misaligned row
    err = cuda_build.launch(part, _lib().dwconv_reduce, part.data_ptr(), R, N, out.data_ptr())
    _raise_on(err, "reduction")
    LAUNCHES["reduce"] += 1
    return out


def wgrad_cuda(x, dy):
    """dw [49, C] and db [C] f32: the weight pass, then the fixed-order sum
    of its partials. Types as wgrad_plain."""
    C = x.shape[-1]
    total = reduce_cuda(wgrad_partials_cuda(x, dy))
    return total[:TAPS * C].view(TAPS, C), total[TAPS * C:]


# ----------------------------------------------------------- dispatch

def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise NotImplementedError(f"dwconv7x7: no kernel for device {t.device}")


def dwconv_fwd(x, w49, b):
    """Forward: plain version for CPU tensors, the kernel for CUDA tensors."""
    if _on_cpu(x):
        return fwd_plain(x, w49, b)
    return fwd_cuda(x.contiguous(), w49.contiguous(), b.float().contiguous())


def dwconv_dx(dy, w49, dtype):
    """dx in `dtype` (x's): plain version on the CPU, the kernel on CUDA."""
    if _on_cpu(dy):
        return dx_plain(dy, w49, dtype)
    return dx_cuda(dy.to(dtype).contiguous(), w49.contiguous())


def dwconv_wgrad(x, dy):
    """(dw [49, C], db [C]) f32: plain version on the CPU, the kernels on CUDA."""
    if _on_cpu(x):
        return wgrad_plain(x, dy)
    return wgrad_cuda(x.contiguous(), dy.to(x.dtype).contiguous())


class _DwConv7x7(torch.autograd.Function):
    """The depthwise conv with the kernels' backward. It saves x and w; dx
    is computed when x needs a gradient, and the weight pass and its
    reduction only when w or b does (inside the attacks the parameters have
    requires_grad off, so they run dx alone; JAX computes dw there and
    discards it, with the same dx)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return dwconv_fwd(x, tap_major(w), b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        w49 = tap_major(w)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = dwconv_dx(dy, w49, x.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw49, db = dwconv_wgrad(x, dy)
            dw = dw49.reshape(w.shape).to(w.dtype)
        return dx, dw, db


def dwconv7x7(x, w, b):
    """Depthwise 7x7 conv, SAME padding, of NHWC x [B, H, W, C] with
    w [7, 7, 1, C] or [7, 7, C] and b [C] (both read as f32). y has x's
    dtype. Differentiable in x, w and b."""
    return _DwConv7x7.apply(x, w, b)


def dwconv7x7_v2(x, w, b):
    """The JAX package's hoisted-shift variant: the same function, so the
    same kernels (see the module docstring)."""
    return dwconv7x7(x, w, b)
