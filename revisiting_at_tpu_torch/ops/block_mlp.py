"""Fused ConvNeXt block tail: LN -> Dense(4C) -> GELU -> Dense(C) ->
LayerScale -> (DropPath) -> residual.

    y = r + keep * gamma * (gelu_tanh(LN(s) @ W1 + b1) @ W2 + b2)

Port of revisiting_at_tpu/ops/block_mlp.py. Hand-written Hopper kernels in
csrc/ replace its TPU kernels:

  * the forward replaces `_fwd_kernel` (csrc/block_mlp.cu);
  * the input-only backward (ds; dr = dy) replaces `_bwd_input_kernel`,
    with gamma folded into a bf16 W2 as the JAX wrapper does (same file);
  * the full backward replaces `_bwd_kernel` (csrc/block_mlp_bwd.cu): a row
    pass (ds, bf16 side outputs, column sums per 64-row tile), a weight pass
    (dW1 and A = g16^T @ kdy16 over slices of M from `wgrad_plan`, TMA and
    wgmma) and a fixed-order reduction. The JAX package's two-pass variant
    of that kernel (`_bwd_split`, its `split_bwd` knob) computes the same
    cotangents, so the port has no second variant.

The forward, the input backward and the row pass are TMA + wgmma kernels
at every width built (`WGMMA_WIDTHS`): at C = 432, 512 and 768 in clusters
of two blocks, at 1024 in clusters of four, each block holding its part of
C; 432 tiled as 512, 16 and 32 as 64, the pad columns zero. `tail_plan`
gives each width's tiling, which the C entry points check against the one
they were built with.

The kernels are bound to PyTorch with ctypes and built with nvcc at first
use into build/kernels/ (ops/cuda_build.py). The sources name what bounds
them on the H100 and how the design deals with it.

Beside each kernel is its plain PyTorch version with the same cast points:
bf16 matmul operands with f32 accumulation, emulated as
``a.bfloat16().float() @ b.bfloat16().float()`` so that the product is not
rounded to bf16 (JAX's preferred_element_type=f32). A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
import types
from typing import NamedTuple

import torch

from . import cuda_build

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"fwd": 0, "bwd_input": 0, "bwd_full_rows": 0, "wgrad": 0, "reduce": 0}

_K0 = math.sqrt(2.0 / math.pi)
_K1 = 0.044715
_EPS = 1e-6

# The column reduction's plan (csrc/block_mlp_bwd.cu reduce_kernel): blocks
# of 256 threads, column lanes of 4 columns each (16-byte loads) where N
# allows, split into row lanes that keep 8 loads in flight; the rows split
# over the blocks of a cluster of at most 8.
_REDUCE_THREADS = 256
_REDUCE_LANES = (256, 64, 16, 4, 2)  # column lanes per block, widest first
_REDUCE_BATCH = 8
_REDUCE_MAX_SPLITS = 8
_SMS = 132  # the H100 SXM's SMs: a reduction aims for a block on each

# The weight pass's tiling (csrc/block_mlp_bwd.cu): 64-row slices of M per
# ring stage; 128 columns of the wide operand (4C) per block, two consumer
# warpgroups of 64; the narrow operand (C columns) in chunks of at most 256,
# each a multiple of 64; blocks for the H100's 132 SMs, in one wave.
WGRAD_DEPTH = 64
# At most 64 slices of M: each adds a [P, Q] f32 partial to write and read
# again. (The cap once kept the reduction to one level of 64 rows; the
# reduction now takes any count in one launch.)
_WGRAD_MAX_SLICES = 64
# Blocks that keep HBM busy in the weight pass where the tensor cores have
# time to spare. On the H100, 84 blocks (28 and 14 slices at ConvNeXt-T's
# stages 0 and 1, batch 80) beat a full wave (44 and 22 slices) by 3-5% of
# device time, more than the spread over five rounds, and beat 48-66 blocks
# too (tools/wgrad_slices.py); more blocks only add partials.
_WGRAD_HBM_BLOCKS = 84
# the H100 SXM's HBM rate over its dense bf16 tensor-core rate: bytes per flop
_WGRAD_BYTES_PER_FLOP = 3.35e12 / 989e12


def _wgrad_chunks(C: int) -> tuple[int, int]:
    """(chunks, columns per chunk) of the narrow operand: at most 256
    columns each, padded to a multiple of 64."""
    n = -(-C // 256)
    per_chunk = -(-C // n)
    return n, -(-per_chunk // 64) * 64


def _wgrad_tiles(C: int) -> int:
    """Blocks per slice of M: output tiles of 128 x chunk."""
    return -(-4 * C // 128) * _wgrad_chunks(C)[0]


def _wgrad_blocks(C: int) -> int:
    """Blocks the weight pass aims to run at width C, in one wave: those
    that keep HBM busy, or as many as its tensor work needs where that is
    more. Per row of M it reads 10 * C bytes and issues 8 * C * (chunks *
    columns per chunk) flops; the ratio of their times at the peak rates is
    the share of the SMs that the tensor work needs."""
    chunks, width = _wgrad_chunks(C)
    ops_share = 0.8 * chunks * width * _WGRAD_BYTES_PER_FLOP
    return min(_SMS, max(_WGRAD_HBM_BLOCKS, math.ceil(ops_share * _SMS)))


def wgrad_plan(m_pad: int, P: int, Q: int) -> tuple[int, int]:
    """(rows per slice, slices) of the M axis for the weight pass on
    x [m_pad, P]^T @ y [m_pad, Q], one of P, Q four times the other.

    Chosen from the shapes alone, so the partials and their fixed-order sum
    are the same bits on every run: as many slices as let the blocks (one
    per output tile and slice) reach `_wgrad_blocks`, at most
    `_WGRAD_MAX_SLICES`, each a whole number of 64-row ring stages; every
    slice holds rows."""
    C = min(P, Q)
    if max(P, Q) != 4 * C or m_pad <= 0 or m_pad % WGRAD_DEPTH:
        raise ValueError(f"wgrad_plan: expected [m_pad, C] and [m_pad, 4C] with m_pad a "
                         f"multiple of {WGRAD_DEPTH}, got m_pad={m_pad}, P={P}, Q={Q}")
    n_split = max(1, min(_WGRAD_MAX_SLICES, _wgrad_blocks(C) // _wgrad_tiles(C),
                         m_pad // WGRAD_DEPTH))
    rows = -(-m_pad // n_split // WGRAD_DEPTH) * WGRAD_DEPTH
    return rows, -(-m_pad // rows)


@functools.lru_cache(maxsize=None)
def reduce_plan(R: int, N: int) -> tuple[int, int, int]:
    """(column lanes, splits, rows per split) of the column reduction of
    part [R, N] into [N]: a block of 256 threads sums a strip of `lanes`
    column lanes (4 columns each where N is a multiple of 4) over its
    split's rows, and a cluster of `splits` blocks, one per split in
    ascending order, adds up their strips. Split k takes rows [k * rows,
    min(R, (k + 1) * rows)); every split holds rows.

    Chosen from the shapes alone, so the sum's order, and its bits, are the
    same on every run: the fewest splits, then the widest strips, that give
    every thread at most `_REDUCE_BATCH` rows (one batch of loads in
    flight) and a block to each of the card's SMs; where no plan does both
    (too few columns), the one with the most blocks whose threads take one
    batch, then the fewest rows a thread; where none does that (too many
    rows), the fewest rows a thread."""
    if R <= 0 or N <= 0:
        raise ValueError(f"reduce_plan: expected R, N >= 1, got R={R}, N={N}")
    vec = 4 if N % 4 == 0 else 1
    best, best_key = None, None
    for splits in range(1, _REDUCE_MAX_SPLITS + 1):
        rows = -(-R // splits)
        if (splits - 1) * rows >= R:  # a split without rows
            continue
        for lanes in _REDUCE_LANES:
            per_thread = -(-rows // (_REDUCE_THREADS // lanes))
            blocks = -(-N // (lanes * vec)) * splits
            one_batch = per_thread <= _REDUCE_BATCH
            if one_batch and blocks >= _SMS:
                return lanes, splits, rows
            key = (one_batch, blocks if one_batch else 0, -per_thread, -splits, lanes)
            if best_key is None or key > best_key:
                best, best_key = (lanes, splits, rows), key
    return best


# Rows of the full backward's side buffers are padded to a multiple of this
# (csrc/block_mlp_common.cuh kRowPad): a multiple of every plan's rows per
# block and of the weight pass's 64-row stages.
ROW_PAD = 128
# The widths the forward, input backward and row pass are built for, all
# TMA + wgmma kernels (csrc/block_mlp_common.cuh kWgmma, BLOCK_MLP_WIDTHS).
WGMMA_WIDTHS = (16, 32, 64, 96, 128, 192, 256, 384, 432, 512, 768, 1024)
# Of those, the widths launched in thread-block clusters, with the blocks per
# cluster (kCluster): each block of a cluster holds padded / cluster of the
# columns of the same 64-row tile. At C = 768 one block has no room for a
# 64-row tile's u and kdy, two weight stages and the f32 accumulators; at
# 432 and 512 it has room for the forward's ring, not for the backward's;
# at 1024 half of C leaves the backward one ring stage, a quarter three.
TAIL_CLUSTER = {432: 2, 512: 2, 768: 2, 1024: 4}
TAIL_MODES = ("fwd", "bwd_input", "bwd_full_rows")
_SMEM_MAX = 232448  # dynamic shared memory an H100 block can use
_BOX = 8192         # a 64 x 64 bf16 TMA box
# registers the wgmma kernels' producer warpgroup keeps (setmaxnreg); the
# consumer warpgroups share the rest
_PRODUCER_REGS = 24


class TailPlan(NamedTuple):
    """The tiling of the tail kernels at one width and mode."""
    design: str     # "wgmma": TMA + wgmma, the one design at every width
    rows: int       # rows per block
    chunk: int      # columns of the 4C axis per chunk
    threads: int    # threads per block
    split: int      # output columns split over this many warpgroups
    stages: int     # weight chunks in flight (the TMA ring)
    smem: int       # dynamic shared memory, bytes
    acc_regs: int   # f32 accumulator registers per consumer thread (o or du, h, dg)
    regs: int       # registers a thread of the block may hold
    part_rows: int  # rows per row of the row pass's column sums
    cluster: int    # blocks per thread-block cluster, each with padded / cluster columns
    padded: int     # the width tiled: C, or (C below 64 or not a multiple of 32) C
                    # rounded up to 64-column boxes in every block of the cluster; zero pad


def _padded(C: int, cluster: int) -> int:
    """The width the kernels tile (csrc/block_mlp_common.cuh kPadded)."""
    step = 64 * cluster
    return -(-C // step) * step if C < 64 or C % 32 else C


@functools.lru_cache(maxsize=None)
def tail_plan(C: int, mode: str) -> TailPlan:
    """The tiling csrc/block_mlp_common.cuh builds at width C for `mode`
    ('fwd', 'bwd_input' or 'bwd_full_rows'), mirrored from its Plan; the C
    entry points take (rows, chunk, threads, split, smem, cluster, padded)
    and refuse a plan they were not built for.

    R row tiles of 64 rows (up to C = 192: 2, and at C = 96 4 in the
    forward, 3 in the input backward) by G warpgroups over their C output
    columns (2 from C = 256), and a producer warpgroup; chunks of 64 columns
    of 4C, as many ring stages as the shared memory holds (at most 8, and
    two chunks' worth) beside the u (and kdy) tiles, two g/dh tiles per row
    tile and the backward's row statistics and column-sum scratch. At C =
    432, 512 and 768 a cluster of two blocks takes each 64-row tile, at 1024
    a cluster of four, each block the tiling of its part of the padded
    width, plus the buffer that receives the peers' partial h (and dg), a
    slot per peer; its epilogue's row-sum parts and column-sum scratch reuse
    the u tile. A width below 64 or not a multiple of 32 is tiled as its
    padded width: C = 16 and 32 as 64 (4C is one and two chunks), 432 as
    512 (4C = 1728 is 27 whole chunks; the stages, shared memory and
    registers are 512's)."""
    if mode not in TAIL_MODES:
        raise ValueError(f"tail_plan: unknown mode {mode!r}")
    if C not in WGMMA_WIDTHS:
        raise ValueError(f"tail_plan: no kernel is built for C = {C}; the widths built are "
                         f"{WGMMA_WIDTHS}")
    bwd = mode != "fwd"
    cl = TAIL_CLUSTER.get(C, 1)
    cp = _padded(C, cl)
    cb = cp // cl  # columns of the padded width a block holds
    G = 1 if cb <= 192 else 2
    R = 1 if cb > 192 else 2 if C != 96 else {"fwd": 4, "bwd_input": 3}.get(mode, 2)
    nwg, bm, cw, n1 = R * G, 64 * R, cb // G, 64 // G
    threads = 128 * (nwg + 1)  # and the producer warpgroup
    # the block's registers, an even split's, which setmaxnreg moves from
    # the producer to the consumers
    pool = threads * (65536 // threads // 8 * 8)
    regs = min(240, (pool - 128 * _PRODUCER_REGS) // (128 * nwg) // 8 * 8)
    tile = _BOX * -(-cb // 64)
    scratch = (n1 + cw if cl == 1 else n1 // cl) * nwg * 32
    exchange = (2 if bwd else 1) * (cl - 1) * 128 * nwg * (n1 // 2 // cl) * 4
    fixed = (1024 + R * tile * (2 if bwd else 1) + R * 2 * _BOX
             + (2 * bm * 4 if bwd else 0)
             + (2 * G * bm * 4 if bwd and G > 1 and cl == 1 else 0)
             + (scratch if mode == "bwd_full_rows" else 0)
             + exchange + 256)
    stages = min(8, 2 * (4 * C // 64), (_SMEM_MAX - fixed) // tile)
    return TailPlan("wgmma", bm, 64, threads, G, stages, fixed + stages * tile,
                    cw // 2 + (n1 if bwd else n1 // 2), regs, 64, cl, cp)


def _plan_args(C: int, mode: str) -> tuple:
    p = tail_plan(C, mode)
    return p.rows, p.chunk, p.threads, p.split, p.smem, p.cluster, p.padded


def tail_fusable(C: int, grad_mode: str, wide: bool = False) -> bool:
    """Channel-width gate for the fused tail, identical to the JAX package's.

    It changes numerics (tanh GELU and bf16 cast points on the kernel path,
    erf GELU on the plain model path), so the port keeps its decisions:
    any C <= 384; input-only backward through C = 1024; full backward
    through C = 512, or C = 1024 with `wide`."""
    if C <= 384:
        return True
    if grad_mode == "input":
        return C <= 1024
    return C <= (1024 if wide else 512)


# ----------------------------------------------------------- plain versions

def _gelu_tanh(h):
    t = torch.tanh(_K0 * (h + _K1 * h * h * h))
    return 0.5 * h * (1.0 + t)


def _dgelu_tanh(h):
    t = torch.tanh(_K0 * (h + _K1 * h * h * h))
    dinner = _K0 * (1.0 + 3.0 * _K1 * h * h)
    return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * dinner


def _ln_f32(s, g, b):
    mu = s.mean(-1, keepdim=True)
    var = ((s - mu) ** 2).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + _EPS)
    xhat = (s - mu) * inv
    return xhat * g + b, xhat, inv


def _mm16(a, w):
    """bf16 operands, f32 accumulation: a [m, k] @ w [k, n] in f32."""
    return a.bfloat16().float() @ w.bfloat16().float()


def _keep_rows(keep, rows_per_keep):
    if keep is None:
        return 1.0
    return keep.float().repeat_interleave(rows_per_keep)[:, None]


def fwd_plain(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma):
    """Forward of the kernel in plain PyTorch. s, r: [M, C]; w1 [C, 4C];
    w2 [4C, C]; keep: [M // rows_per_keep] f32 or None. y has s's dtype."""
    u, _, _ = _ln_f32(s.float(), ln_g, ln_b)
    g = _gelu_tanh(_mm16(u, w1) + b1)
    o = _mm16(g, w2) + b2
    y = r.float() + _keep_rows(keep, rows_per_keep) * gamma * o
    return y.to(s.dtype)


def bwd_input_plain(s, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2g16, dy):
    """Input-only backward of the kernel in plain PyTorch: ds from dy, with
    w2g16 = bf16(W2 * gamma). ds has s's dtype."""
    u, xhat, inv = _ln_f32(s.float(), ln_g, ln_b)
    dgl = _dgelu_tanh(_mm16(u, w1) + b1)
    kdy = _keep_rows(keep, rows_per_keep) * dy.float()
    dg = _mm16(kdy, w2g16.t())
    dh16 = (dg * dgl).bfloat16()
    du = _mm16(dh16, w1.t())
    dxh = du * ln_g
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xhat).mean(-1, keepdim=True)
    return (inv * (dxh - m1 - xhat * m2)).to(s.dtype)


def bwd_full_rows_plain(s, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2g16, dy):
    """The full backward's row pass in plain PyTorch, with `_bwd_kernel`'s
    cast points: u16, g16, kdy16 and dh16 are bf16; dh, du and the column
    sums are f32. Returns (ds, dln_g, dln_b, db1, u16, kdy16, g16, dh16);
    ds has s's dtype."""
    u, xhat, inv = _ln_f32(s.float(), ln_g, ln_b)
    u16 = u.bfloat16()
    w1_16 = w1.bfloat16().float()
    h = u16.float() @ w1_16 + b1
    g16 = _gelu_tanh(h).bfloat16()
    kdy16 = (_keep_rows(keep, rows_per_keep) * dy.float()).bfloat16()
    dh = (kdy16.float() @ w2g16.float().t()) * _dgelu_tanh(h)
    dh16 = dh.bfloat16()
    du = dh16.float() @ w1_16.t()
    dxh = du * ln_g
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xhat).mean(-1, keepdim=True)
    ds = (inv * (dxh - m1 - xhat * m2)).to(s.dtype)
    return ds, (du * xhat).sum(0), du.sum(0), dh.sum(0), u16, kdy16, g16, dh16


def bwd_full_plain(s, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2g16, dy):
    """Full backward of the kernels in plain PyTorch: the row pass, then
    dW1 = u16^T @ dh16 and A = g16^T @ kdy16 in f32. Returns (ds, dln_g,
    dln_b, dw1, db1, A); ds has s's dtype, the rest are f32."""
    ds, dln_g, dln_b, db1, u16, kdy16, g16, dh16 = bwd_full_rows_plain(
        s, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2g16, dy)
    return ds, dln_g, dln_b, wgrad_plain(u16, dh16), db1, wgrad_plain(g16, kdy16)


def wgrad_plain(x16, y16):
    """The weight pass in plain PyTorch: x16^T @ y16 in f32 (bf16 inputs)."""
    return x16.float().t() @ y16.float()


def reduce_plain(part):
    """The fixed-order reduction in plain PyTorch: part [R, N] -> [N]."""
    return part.sum(0)


# ----------------------------------------------------------- CUDA kernels

_lib_handle = None


def _lib():
    """The kernels' C entry points (both libraries), built at first use."""
    global _lib_handle
    if _lib_handle is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        plan = [I] * 7  # rows, chunk, threads, split, smem, cluster, padded
        fns = cuda_build.load("block_mlp", {
            "block_mlp_supports": [I],
            "block_mlp_max_clusters": [I, I],
            "block_mlp_fwd": [I, I, P, P, P, I, P, P, P, P, P, P, P, P, L, *plan, P],
            "block_mlp_bwd_input": [I, I, P, P, I, P, P, P, P, P, P, P, L, *plan, P],
        })
        fns.update(cuda_build.load("block_mlp_bwd", {
            "block_mlp_bwd_full_rows": [I, I, P, P, I, P, P, P, P, P, P, P, L, L,
                                        P, P, P, P, P, P, P, *plan, P],
            "block_mlp_wgrad": [P, I, P, I, L, L, I, P, P, I, I, L, P],
            "block_mlp_reduce": [P, L, L, I, I, L, P, P],
            "block_mlp_rows_max_clusters": [I],
        }))
        _lib_handle = types.SimpleNamespace(**fns)
    return _lib_handle


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check_common(s, keep, rows_per_keep, ln_g, ln_b, w1, b1):
    if s.dim() != 2 or s.dtype not in _DTYPE_CODE:
        raise ValueError(f"s: expected [M, C] float32/bfloat16, got {s.dtype} {tuple(s.shape)}")
    M, C = s.shape
    if not _lib().block_mlp_supports(C):
        raise NotImplementedError(f"block_mlp CUDA kernel not built for C = {C}")
    dev, f32 = s.device, torch.float32
    _check("s", s, (M, C), s.dtype, dev)
    _check("ln_g", ln_g, (C,), f32, dev)
    _check("ln_b", ln_b, (C,), f32, dev)
    # W1 [C, 4C]: contiguous, or the transpose of a contiguous [4C, C]
    _check("w1", w1 if w1.is_contiguous() else w1.t(),
           (C, 4 * C) if w1.is_contiguous() else (4 * C, C), torch.bfloat16, dev)
    _check("b1", b1, (4 * C,), f32, dev)
    if keep is not None:
        if rows_per_keep <= 0 or M % rows_per_keep:
            raise ValueError(f"rows_per_keep {rows_per_keep} does not divide M = {M}")
        _check("keep", keep, (M // rows_per_keep,), f32, dev)
    return M, C


def _ptr(t):
    return None if t is None else t.data_ptr()


def _w1_layout(w1_16):
    """W1 [C, 4C] as the kernels take it: W1^T [4C, C], contiguous (a view
    when w1_16 is the transpose of a contiguous [4C, C])."""
    return w1_16.t().contiguous()


def _raise_on(err, what):
    if err != 0:
        cause = {-1: "unsupported width or plan", -2: "cuTensorMapEncodeTiled failed",
                 -3: "no thread-block cluster of the plan fits the card"}
        raise RuntimeError(f"block_mlp {what} kernel launch failed: "
                           f"{cause.get(err, f'cudaError {err}')}")


def tail_max_clusters(C: int, mode: str) -> int:
    """The thread-block clusters of the bf16 kernel of width C and `mode`
    that the card holds at a time (cudaOccupancyMaxActiveClusters): what a
    wave of the cluster kernels holds. Raises for a width without clusters
    and where the query fails."""
    if tail_plan(C, mode).cluster == 1:
        raise ValueError(f"tail_max_clusters: C = {C} runs no thread-block clusters")
    lib = _lib()
    n = (lib.block_mlp_rows_max_clusters(C) if mode == "bwd_full_rows"
         else lib.block_mlp_max_clusters(C, TAIL_MODES.index(mode)))
    if n < 0:
        raise RuntimeError(f"block_mlp: cudaOccupancyMaxActiveClusters failed at C = {C} "
                           f"({mode}): cudaError {-n}")
    return n


def fwd_cuda(s, r, keep, rows_per_keep, ln_g, ln_b, w1_16, b1, w2_16, b2, gamma):
    """Launch the forward kernel. Types as fwd_plain, with w1_16/w2_16 bf16
    (w1_16 [C, 4C] contiguous or the transpose of a contiguous [4C, C])."""
    M, C = _check_common(s, keep, rows_per_keep, ln_g, ln_b, w1_16, b1)
    _check("r", r, (M, C), s.dtype, s.device)
    _check("w2", w2_16, (4 * C, C), torch.bfloat16, s.device)
    _check("b2", b2, (C,), torch.float32, s.device)
    _check("gamma", gamma, (C,), torch.float32, s.device)
    y = torch.empty_like(s)
    if M == 0:
        return y
    w1k = _w1_layout(w1_16)
    err = cuda_build.launch(
        s, _lib().block_mlp_fwd, C, _DTYPE_CODE[s.dtype], _ptr(s), _ptr(r), _ptr(keep),
        rows_per_keep, _ptr(ln_g), _ptr(ln_b), _ptr(w1k), _ptr(b1), _ptr(w2_16), _ptr(b2),
        _ptr(gamma), _ptr(y), M, *_plan_args(C, "fwd"))
    _raise_on(err, "forward")
    LAUNCHES["fwd"] += 1
    return y


def bwd_input_cuda(s, keep, rows_per_keep, ln_g, ln_b, w1_16, b1, w2g16, dy):
    """Launch the input-only backward kernel. Types as bwd_input_plain."""
    M, C = _check_common(s, keep, rows_per_keep, ln_g, ln_b, w1_16, b1)
    _check("w2g", w2g16, (4 * C, C), torch.bfloat16, s.device)
    _check("dy", dy, (M, C), s.dtype, s.device)
    ds = torch.empty_like(s)
    if M == 0:
        return ds
    w1k = _w1_layout(w1_16)
    err = cuda_build.launch(
        s, _lib().block_mlp_bwd_input, C, _DTYPE_CODE[s.dtype], _ptr(s), _ptr(keep),
        rows_per_keep, _ptr(ln_g), _ptr(ln_b), _ptr(w1k), _ptr(b1), _ptr(w2g16), _ptr(dy),
        _ptr(ds), M, *_plan_args(C, "bwd_input"))
    _raise_on(err, "input-backward")
    LAUNCHES["bwd_input"] += 1
    return ds


def bwd_full_rows_cuda(s, keep, rows_per_keep, ln_g, ln_b, w1_16, b1, w2g16, dy):
    """Launch the full backward's row pass. Returns ds and the side outputs
    (u16, kdy16, g16, dh16 over Mpad rows, M rounded up to ROW_PAD, rows
    past M zero; db1_part, dlng_part, dlnb_part with a row of column sums
    per `tail_plan(C, "bwd_full_rows").part_rows` rows)."""
    M, C = _check_common(s, keep, rows_per_keep, ln_g, ln_b, w1_16, b1)
    _check("w2g", w2g16, (4 * C, C), torch.bfloat16, s.device)
    _check("dy", dy, (M, C), s.dtype, s.device)
    m_pad = max(-(-M // ROW_PAD), 1) * ROW_PAD
    parts = m_pad // tail_plan(C, "bwd_full_rows").part_rows
    bf, f32 = torch.bfloat16, torch.float32
    shapes = ((m_pad, C, bf), (m_pad, C, bf), (m_pad, 4 * C, bf), (m_pad, 4 * C, bf),
              (parts, 4 * C, f32), (parts, C, f32), (parts, C, f32))
    side = tuple(torch.empty(r, c, dtype=t, device=s.device) for r, c, t in shapes)
    ds = torch.empty_like(s)
    w1k = _w1_layout(w1_16)
    err = cuda_build.launch(
        s, _lib().block_mlp_bwd_full_rows, C, _DTYPE_CODE[s.dtype], _ptr(s), _ptr(keep),
        rows_per_keep, _ptr(ln_g), _ptr(ln_b), _ptr(w1k), _ptr(b1), _ptr(w2g16), _ptr(dy),
        _ptr(ds), M, m_pad, *(_ptr(t) for t in side), *_plan_args(C, "bwd_full_rows"))
    _raise_on(err, "full-backward row")
    LAUNCHES["bwd_full_rows"] += 1
    return (ds,) + side


def _wgrad_launch(x16, y16, summed: bool):
    m_pad, P = x16.shape
    Q = y16.shape[1]
    _check("x16", x16, (m_pad, P), torch.bfloat16, x16.device)
    _check("y16", y16, (m_pad, Q), torch.bfloat16, x16.device)
    rows, n_split = wgrad_plan(m_pad, P, Q)
    part = torch.empty(n_split, P, Q, dtype=torch.float32, device=x16.device)
    out = torch.empty(P, Q, dtype=torch.float32, device=x16.device) if summed else None
    err = cuda_build.launch(x16, _lib().block_mlp_wgrad, _ptr(x16), P, _ptr(y16), Q, m_pad, rows,
                            n_split, _ptr(part), _ptr(out), *reduce_plan(n_split, P * Q))
    _raise_on(err, "weight-gradient")
    LAUNCHES["wgrad"] += 1
    if summed:
        LAUNCHES["reduce"] += 1
    return out if summed else part


def wgrad_partials_cuda(x16, y16):
    """Launch the weight pass: per-slice partials [n_split, P, Q] (f32) of
    x16^T @ y16 from bf16 x16 [Mpad, P] and y16 [Mpad, Q], one of P, Q four
    times the other, Mpad a multiple of 64. The slices of M are
    `wgrad_plan`'s."""
    return _wgrad_launch(x16, y16, summed=False)


def wgrad_cuda(x16, y16):
    """x16^T @ y16 [P, Q] in f32: the weight pass, then the reduction kernel
    summing its partials in slice order, both launched by one call. Types as
    wgrad_plain."""
    return _wgrad_launch(x16, y16, summed=True)


def reduce_cuda(part):
    """Sum part [R, N] f32 over R in a fixed order: one launch of the
    reduction kernel with `reduce_plan`'s split of the rows."""
    if part.dtype != torch.float32 or part.dim() != 2 or not part.is_contiguous():
        raise ValueError(f"part: expected contiguous float32 [R, N], got {part.dtype} "
                         f"{tuple(part.shape)}")
    R, N = part.shape
    out = part.new_empty(N)
    err = cuda_build.launch(part, _lib().block_mlp_reduce, part.data_ptr(), R, N,
                            *reduce_plan(R, N), out.data_ptr())
    _raise_on(err, "reduction")
    LAUNCHES["reduce"] += 1
    return out


def bwd_full_cuda(s, keep, rows_per_keep, ln_g, ln_b, w1_16, b1, w2g16, dy):
    """The full backward on the card: row pass, weight pass, reductions.
    Types and results as bwd_full_plain."""
    ds, u16, kdy16, g16, dh16, db1_p, dlng_p, dlnb_p = bwd_full_rows_cuda(
        s, keep, rows_per_keep, ln_g, ln_b, w1_16, b1, w2g16, dy)
    dw1 = wgrad_cuda(u16, dh16)
    a = wgrad_cuda(g16, kdy16)
    return ds, reduce_cuda(dlng_p), reduce_cuda(dlnb_p), dw1, reduce_cuda(db1_p), a


# ----------------------------------------------------------- dispatch

def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise NotImplementedError(f"block_mlp: no kernel for device {t.device}")


def _bf16(w):
    return w.to(torch.bfloat16, memory_format=torch.contiguous_format)


def _f32(v):
    return v.to(torch.float32, memory_format=torch.contiguous_format)


def _bf16_t(w1):
    """W1 [C, 4C] in bf16 as the transpose of a contiguous [4C, C]: the
    layout the wgmma kernels read, and a cast alone when w1 is the
    transpose of nn.Linear's weight, as the models pass it."""
    return w1.t().to(torch.bfloat16, memory_format=torch.contiguous_format).t()


def block_mlp_fwd(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma):
    """Forward: plain version for CPU tensors, the kernel for CUDA tensors."""
    if _on_cpu(s):
        return fwd_plain(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma)
    return fwd_cuda(s.contiguous(), r.to(s.dtype).contiguous(), keep, rows_per_keep, _f32(ln_g),
                    _f32(ln_b), _bf16_t(w1), _f32(b1), _bf16(w2), _f32(b2), _f32(gamma))


def block_mlp_bwd_input(s, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, gamma, dy):
    """Input-only backward: ds from dy. Folds gamma into the bf16 W2 first,
    as the JAX wrapper does: bf16(f32(bf16(W2)) * gamma)."""
    w2g16 = (w2.bfloat16().float() * gamma.float()).bfloat16()
    if _on_cpu(s):
        return bwd_input_plain(s, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2g16, dy)
    return bwd_input_cuda(s.contiguous(), keep, rows_per_keep, _f32(ln_g), _f32(ln_b),
                          _bf16_t(w1), _f32(b1), w2g16.contiguous(), dy.contiguous())


class _BlockTailInput(torch.autograd.Function):
    """Fused tail whose backward computes the input cotangents only:
    ds by the input-backward kernel (or its plain version), dr = dy.
    Weight cotangents are None: for attack closures, never for training."""

    @staticmethod
    def forward(ctx, s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma):
        ctx.save_for_backward(s, keep, ln_g, ln_b, w1, b1, w2, gamma)
        ctx.rows_per_keep = rows_per_keep
        return block_mlp_fwd(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma)

    @staticmethod
    def backward(ctx, dy):
        s, keep, ln_g, ln_b, w1, b1, w2, gamma = ctx.saved_tensors
        ds = None
        if ctx.needs_input_grad[0]:
            ds = block_mlp_bwd_input(s, keep, ctx.rows_per_keep, ln_g, ln_b, w1, b1, w2,
                                     gamma, dy.to(s.dtype))
        dr = dy if ctx.needs_input_grad[1] else None
        return ds, dr, None, None, None, None, None, None, None, None, None


def block_mlp_bwd_full(s, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma, dy):
    """Full backward: (ds, dln_g, dln_b, dw1, db1, dw2, db2, dgamma) from dy.

    gamma is folded into the bf16 W2 as for the input backward; the kernel
    (or its plain version) returns A = g16^T @ kdy16, and the cotangents it
    entangles with gamma are recovered here as the JAX wrapper does:
    dw2 = A * gamma, db2 = gamma * sum(kdy), dgamma = sum_h bf16(W2) * A +
    b2 * sum(kdy). Weight cotangents are f32; ds has s's dtype."""
    w2g16 = (w2.bfloat16().float() * gamma.float()).bfloat16()
    if _on_cpu(s):
        ds, dln_g, dln_b, dw1, db1, a = bwd_full_plain(s, keep, rows_per_keep, ln_g, ln_b, w1,
                                                       b1, w2g16, dy)
    else:
        ds, dln_g, dln_b, dw1, db1, a = bwd_full_cuda(
            s.contiguous(), keep, rows_per_keep, _f32(ln_g), _f32(ln_b), _bf16_t(w1), _f32(b1),
            w2g16.contiguous(), dy.contiguous())
    return (ds, dln_g, dln_b, dw1, db1,
            *recover_gamma_cotangents(a, dy, keep, rows_per_keep, w2, b2, gamma))


def recover_gamma_cotangents(a, dy, keep, rows_per_keep, w2, b2, gamma):
    """(dw2, db2, dgamma) from A = g16^T @ kdy16, as the JAX wrapper recovers
    them outside its kernel (plain tensor code there and here)."""
    gamma_f = gamma.float()
    kdy_sum = (_keep_rows(keep, rows_per_keep) * dy.float()).sum(0)
    dgamma = (w2.bfloat16().float() * a).sum(0) + b2.float() * kdy_sum
    return a * gamma_f, gamma_f * kdy_sum, dgamma


class _BlockTailFull(torch.autograd.Function):
    """Fused tail with every cotangent: the full-backward kernels (or their
    plain version) for s and the weights, dr = dy, none for keep."""

    @staticmethod
    def forward(ctx, s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma):
        ctx.save_for_backward(s, keep, ln_g, ln_b, w1, b1, w2, b2, gamma)
        ctx.rows_per_keep = rows_per_keep
        return block_mlp_fwd(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma)

    @staticmethod
    def backward(ctx, dy):
        s, keep, ln_g, ln_b, w1, b1, w2, b2, gamma = ctx.saved_tensors
        ds, dln_g, dln_b, dw1, db1, dw2, db2, dgamma = block_mlp_bwd_full(
            s, keep, ctx.rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma, dy.to(s.dtype))
        return ds, dy, None, None, dln_g, dln_b, dw1, db1, dw2, db2, dgamma


def block_mlp(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma,
              grad_mode: str = "full"):
    """Fused tail on [M, C] rows. keep: [M // rows_per_keep] f32 or None.

    grad_mode 'input' differentiates w.r.t. s and r only (attack closures;
    weight cotangents are None). 'full' differentiates everything through
    the full backward."""
    if grad_mode == "input":
        return _BlockTailInput.apply(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2,
                                     gamma)
    if grad_mode != "full":
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    return _BlockTailFull.apply(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma)


def convnext_block_tail(s, r, keep, ln_g, ln_b, w1, b1, w2, b2, gamma, *,
                        grad_mode: str = "full"):
    """NHWC wrapper: s (dwconv output) and r (residual) are [B, H, W, C];
    keep is the per-sample DropPath scale [B] or None. W1 is [C, 4C] and
    W2 is [4C, C] (the JAX layout). keep=None flattens B*H*W into M rows."""
    B, Hs, Ws, C = s.shape
    M = Hs * Ws
    y = block_mlp(s.reshape(B * M, C), r.reshape(B * M, C),
                  None if keep is None else keep.float(), M,
                  ln_g, ln_b, w1, b1, w2, b2, gamma, grad_mode=grad_mode)
    return y.reshape(B, Hs, Ws, C)


def vit_mlp_tail(x, keep, ln_g, ln_b, w1, b1, w2, b2, gamma, *, grad_mode: str = "full"):
    """Token wrapper for the ViT MLP tail: norm2 -> fc1 -> GELU -> fc2 ->
    LayerScale -> (DropPath) -> residual on x [B, N, C]. The same kernels
    as the ConvNeXt tail with s = r = x on B*N rows and one keep per image
    (rows_per_keep = N); autograd adds the two cotangents of the shared
    input. W1 is [C, 4C] and W2 [4C, C] (the JAX layout); keep is [B] or
    None."""
    B, N, C = x.shape
    xr = x.reshape(B * N, C)
    y = block_mlp(xr, xr, None if keep is None else keep.float(), N,
                  ln_g, ln_b, w1, b1, w2, b2, gamma, grad_mode=grad_mode)
    return y.reshape(B, N, C)
