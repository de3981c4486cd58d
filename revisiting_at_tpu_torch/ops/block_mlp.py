"""Fused ConvNeXt block tail: LN -> Dense(4C) -> GELU -> Dense(C) ->
LayerScale -> (DropPath) -> residual.

    y = r + keep * gamma * (gelu_tanh(LN(s) @ W1 + b1) @ W2 + b2)

Port of revisiting_at_tpu/ops/block_mlp.py. Hand-written Hopper kernels in
csrc/ replace its TPU kernels:

  * the forward replaces `_fwd_kernel` (csrc/block_mlp.cu);
  * the input-only backward (ds; dr = dy) replaces `_bwd_input_kernel`,
    with gamma folded into a bf16 W2 as the JAX wrapper does (same file);
  * the full backward replaces `_bwd_kernel` (csrc/block_mlp_bwd.cu): a row
    pass (ds, bf16 side outputs, per-block column sums), a weight pass
    (dW1 and A = g16^T @ kdy16 over slices of M) and a fixed-order
    reduction. The JAX package's two-pass variant of that kernel
    (`_bwd_split`, its `split_bwd` knob) computes the same cotangents, so
    the port has no second variant.

The kernels are bound to PyTorch with ctypes and built with nvcc at first
use into build/kernels/ (see `build`). The sources name what bounds them on
the H100 and how the design deals with it.

Beside each kernel is its plain PyTorch version with the same cast points:
bf16 matmul operands with f32 accumulation, emulated as
``a.bfloat16().float() @ b.bfloat16().float()`` so that the product is not
rounded to bf16 (JAX's preferred_element_type=f32). A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import types
from pathlib import Path

import torch

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"fwd": 0, "bwd_input": 0, "bwd_full_rows": 0, "wgrad": 0, "reduce": 0}

_K0 = math.sqrt(2.0 / math.pi)
_K1 = 0.044715
_EPS = 1e-6

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_HEADER = _CSRC / "block_mlp_common.cuh"
# one shared library per source, built by concurrent nvcc processes
SOURCES = {"block_mlp": _CSRC / "block_mlp.cu", "block_mlp_bwd": _CSRC / "block_mlp_bwd.cu"}
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -Xptxas -v: registers, shared memory and spills per kernel, kept beside the library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# rows summed per thread in one level of the fixed-order reduction
_REDUCE_GROUP = 64


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
_lib_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + _HEADER.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"lib{name}_{digest}.so"


def build() -> dict[str, Path]:
    """Compile each csrc/ source for sm_90a into build/kernels/ (once per
    source version), one nvcc process per source, all started together.
    Returns {name: shared library}; ptxas's report is kept beside each
    library as <library>.ptxas.txt."""
    libs = {name: _library_path(name) for name in SOURCES}
    todo = [(name, out) for name, out in libs.items() if not out.exists()]
    if todo:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            procs.append((out, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for out, tmp, cmd, proc in procs:  # wait for every process before raising
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                              f"{stdout}\n{stderr}")
                continue
            Path(f"{out}.ptxas.txt").write_text(stdout + stderr)
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    return libs


def _lib():
    """The kernels' C entry points (both libraries), built at first use."""
    global _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            libs = {name: ctypes.CDLL(str(path)) for name, path in build().items()}
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            signatures = {
                "block_mlp": {
                    "block_mlp_supports": [I],
                    "block_mlp_fwd": [I, I, P, P, P, I, P, P, P, P, P, P, P, P, L, P],
                    "block_mlp_bwd_input": [I, I, P, P, I, P, P, P, P, P, P, P, L, P],
                },
                "block_mlp_bwd": {
                    "block_mlp_rows_per_block": [I],
                    "block_mlp_row_pad": [],
                    "block_mlp_bwd_full_rows": [I, I, P, P, I, P, P, P, P, P, P, P, L, L,
                                                P, P, P, P, P, P, P, P],
                    "block_mlp_wgrad": [P, I, P, I, L, L, I, P, P],
                    "block_mlp_reduce": [P, L, L, I, P, P],
                },
            }
            fns = {}
            for name, entries in signatures.items():
                for fn_name, argtypes in entries.items():
                    fn = getattr(libs[name], fn_name)
                    fn.argtypes, fn.restype = argtypes, I
                    fns[fn_name] = fn
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
    _check("w1", w1, (C, 4 * C), torch.bfloat16, dev)
    _check("b1", b1, (4 * C,), f32, dev)
    if keep is not None:
        if rows_per_keep <= 0 or M % rows_per_keep:
            raise ValueError(f"rows_per_keep {rows_per_keep} does not divide M = {M}")
        _check("keep", keep, (M // rows_per_keep,), f32, dev)
    return M, C


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"block_mlp {what} kernel launch failed: "
                           f"{'unsupported width' if err == -1 else f'cudaError {err}'}")


def fwd_cuda(s, r, keep, rows_per_keep, ln_g, ln_b, w1_16, b1, w2_16, b2, gamma):
    """Launch the forward kernel. Types as fwd_plain, with w1_16/w2_16 bf16."""
    M, C = _check_common(s, keep, rows_per_keep, ln_g, ln_b, w1_16, b1)
    _check("r", r, (M, C), s.dtype, s.device)
    _check("w2", w2_16, (4 * C, C), torch.bfloat16, s.device)
    _check("b2", b2, (C,), torch.float32, s.device)
    _check("gamma", gamma, (C,), torch.float32, s.device)
    y = torch.empty_like(s)
    if M == 0:
        return y
    with torch.cuda.device(s.device):
        err = _lib().block_mlp_fwd(
            C, _DTYPE_CODE[s.dtype], _ptr(s), _ptr(r), _ptr(keep), rows_per_keep,
            _ptr(ln_g), _ptr(ln_b), _ptr(w1_16), _ptr(b1), _ptr(w2_16), _ptr(b2),
            _ptr(gamma), _ptr(y), M, _stream(s))
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
    with torch.cuda.device(s.device):
        err = _lib().block_mlp_bwd_input(
            C, _DTYPE_CODE[s.dtype], _ptr(s), _ptr(keep), rows_per_keep, _ptr(ln_g),
            _ptr(ln_b), _ptr(w1_16), _ptr(b1), _ptr(w2g16), _ptr(dy), _ptr(ds), M, _stream(s))
    _raise_on(err, "input-backward")
    LAUNCHES["bwd_input"] += 1
    return ds


def bwd_full_rows_cuda(s, keep, rows_per_keep, ln_g, ln_b, w1_16, b1, w2g16, dy):
    """Launch the full backward's row pass. Returns ds and the side outputs
    (u16, kdy16, g16, dh16, db1_part, dlng_part, dlnb_part) over Mpad rows,
    M rounded up to the row padding; rows past M are zero."""
    M, C = _check_common(s, keep, rows_per_keep, ln_g, ln_b, w1_16, b1)
    _check("w2g", w2g16, (4 * C, C), torch.bfloat16, s.device)
    _check("dy", dy, (M, C), s.dtype, s.device)
    lib = _lib()
    pad, bm = lib.block_mlp_row_pad(), lib.block_mlp_rows_per_block(C)
    m_pad = max(-(-M // pad), 1) * pad
    bf, f32 = torch.bfloat16, torch.float32
    shapes = ((m_pad, C, bf), (m_pad, C, bf), (m_pad, 4 * C, bf), (m_pad, 4 * C, bf),
              (m_pad // bm, 4 * C, f32), (m_pad // bm, C, f32), (m_pad // bm, C, f32))
    side = tuple(torch.empty(r, c, dtype=t, device=s.device) for r, c, t in shapes)
    ds = torch.empty_like(s)
    with torch.cuda.device(s.device):
        err = lib.block_mlp_bwd_full_rows(
            C, _DTYPE_CODE[s.dtype], _ptr(s), _ptr(keep), rows_per_keep, _ptr(ln_g), _ptr(ln_b),
            _ptr(w1_16), _ptr(b1), _ptr(w2g16), _ptr(dy), _ptr(ds), M, m_pad,
            *(_ptr(t) for t in side), _stream(s))
    _raise_on(err, "full-backward row")
    LAUNCHES["bwd_full_rows"] += 1
    return (ds,) + side


def wgrad_partials_cuda(x16, y16):
    """Launch the weight pass: per-slice partials [n_split, P, Q] (f32) of
    x16^T @ y16 from bf16 x16 [Mpad, P] and y16 [Mpad, Q]. The M axis is cut
    into slices so that about 768 blocks fill the card; the cut depends on
    the shapes only, so the summed result is the same bits every run."""
    m_pad, P = x16.shape
    Q = y16.shape[1]
    _check("x16", x16, (m_pad, P), torch.bfloat16, x16.device)
    _check("y16", y16, (m_pad, Q), torch.bfloat16, x16.device)
    tiles = P * Q // 4096  # 32 x 128 output tiles
    n_split = max(1, min(-(-768 // tiles), m_pad // 256))
    rows = -(-m_pad // n_split // 32) * 32
    n_split = -(-m_pad // rows)
    part = torch.empty(n_split, P, Q, dtype=torch.float32, device=x16.device)
    with torch.cuda.device(x16.device):
        err = _lib().block_mlp_wgrad(_ptr(x16), P, _ptr(y16), Q, m_pad, rows, n_split,
                                     _ptr(part), _stream(x16))
    _raise_on(err, "weight-gradient")
    LAUNCHES["wgrad"] += 1
    return part


def wgrad_cuda(x16, y16):
    """x16^T @ y16 [P, Q] in f32: the weight pass, then the fixed-order sum
    of its partials. Types as wgrad_plain."""
    part = wgrad_partials_cuda(x16, y16)
    n_split, P, Q = part.shape
    return reduce_cuda(part.view(n_split, P * Q)).view(P, Q)


def reduce_cuda(part):
    """Sum part [R, N] f32 over R in a fixed order: levels of the reduction
    kernel, each summing groups of consecutive rows, until one row is left."""
    _check("part", part, tuple(part.shape), torch.float32, part.device)
    while part.shape[0] > 1:
        R, N = part.shape
        out = torch.empty(-(-R // _REDUCE_GROUP), N, dtype=torch.float32, device=part.device)
        with torch.cuda.device(part.device):
            err = _lib().block_mlp_reduce(_ptr(part), R, N, _REDUCE_GROUP, _ptr(out),
                                          _stream(part))
        _raise_on(err, "reduction")
        LAUNCHES["reduce"] += 1
        part = out
    return part[0]


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


def block_mlp_fwd(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma):
    """Forward: plain version for CPU tensors, the kernel for CUDA tensors."""
    if _on_cpu(s):
        return fwd_plain(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma)
    return fwd_cuda(s.contiguous(), r.to(s.dtype).contiguous(), keep, rows_per_keep, _f32(ln_g),
                    _f32(ln_b), _bf16(w1), _f32(b1), _bf16(w2), _f32(b2), _f32(gamma))


def block_mlp_bwd_input(s, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, gamma, dy):
    """Input-only backward: ds from dy. Folds gamma into the bf16 W2 first,
    as the JAX wrapper does: bf16(f32(bf16(W2)) * gamma)."""
    w2g16 = (w2.bfloat16().float() * gamma.float()).bfloat16()
    if _on_cpu(s):
        return bwd_input_plain(s, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2g16, dy)
    return bwd_input_cuda(s.contiguous(), keep, rows_per_keep, _f32(ln_g), _f32(ln_b),
                          _bf16(w1), _f32(b1), w2g16.contiguous(), dy.contiguous())


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
            s.contiguous(), keep, rows_per_keep, _f32(ln_g), _f32(ln_b), _bf16(w1), _f32(b1),
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
