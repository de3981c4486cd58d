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
import types

import torch
import torch.nn.functional as F

from . import cuda_build

K = 7
P = K // 2
TAPS = K * K

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"fwd": 0, "dx": 0, "wgrad": 0, "reduce": 0}

# blocks the weight pass aims for: the (image, band) tiles are cut into
# chunks, one per block and column tile, so that about this many fill the card
_WGRAD_BLOCKS = 1024


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
            "dwconv_tile_rows": [],
            "dwconv_tile_cols": [],
            "dwconv_parts": [],
            "dwconv_fwd": [I, I, Pt, Pt, Pt, Pt, I, I, I, I, Pt],
            "dwconv_wgrad": [I, Pt, Pt, I, I, I, I, L, I, Pt, Pt],
            "dwconv_reduce": [Pt, L, L, Pt, Pt],
        }))
    return _lib_handle


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
                                  "(a multiple of 8, at most 384)")
    return t.shape


def _check_vec(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous float32 {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"dwconv {what} kernel launch failed: "
                           f"{'unsupported shape' if err == -1 else f'cudaError {err}'}")


def _launch_stencil(src, w49, b, dx: bool):
    B, H, W, C = _check_map("dy" if dx else "x", src)
    _check_vec("w", w49, (TAPS, C), src.device)
    if not dx:
        _check_vec("b", b, (C,), src.device)
    out = torch.empty_like(src)
    err = cuda_build.launch(src, _lib().dwconv_fwd, _DTYPE_CODE[src.dtype], int(dx),
                            src.data_ptr(), w49.data_ptr(), None if dx else b.data_ptr(),
                            out.data_ptr(), B, H, W, C)
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
    """Launch the weight pass: partials [R, 50 * C] f32, row r holding one
    block's dw (taps 0-48, each C wide) and db (the last C). The (image,
    band) tiles are cut into chunks by the shapes alone, so the summed
    result is the same bits every run."""
    B, H, W, C = _check_map("x", x)
    _check_map("dy", dy, x.shape, x.dtype)
    lib = _lib()
    bands = -(-H // lib.dwconv_tile_rows())
    ctiles = -(-W // lib.dwconv_tile_cols())
    items = B * bands
    per_block_row = ctiles * -(-C // 32)
    per_chunk = -(-items // max(1, min(items, -(-_WGRAD_BLOCKS // per_block_row))))
    n_chunks = -(-items // per_chunk)
    part = torch.empty(n_chunks * ctiles, lib.dwconv_parts() * C, dtype=torch.float32,
                       device=x.device)
    err = cuda_build.launch(x, lib.dwconv_wgrad, _DTYPE_CODE[x.dtype], x.data_ptr(),
                            dy.data_ptr(), B, H, W, C, per_chunk, n_chunks, part.data_ptr())
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
