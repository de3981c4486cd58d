"""Fused ConvNeXt block tail: LN -> Dense(4C) -> GELU -> Dense(C) ->
LayerScale -> (DropPath) -> residual.

    y = r + keep * gamma * (gelu_tanh(LN(s) @ W1 + b1) @ W2 + b2)

Port of revisiting_at_tpu/ops/block_mlp.py. Two hand-written Hopper kernels
in csrc/block_mlp.cu replace its TPU kernels:

  * the forward replaces `_fwd_kernel`;
  * the input-only backward (ds; dr = dy) replaces `_bwd_input_kernel`,
    with gamma folded into a bf16 W2 as the JAX wrapper does.

Both are bound to PyTorch with ctypes and built with nvcc at first use
into build/kernels/ (see `_lib`). The source names what bounds them on the
H100 and how the design deals with it.

Beside each kernel is its plain PyTorch version with the same cast points:
bf16 matmul operands with f32 accumulation, emulated as
``a.bfloat16().float() @ b.bfloat16().float()`` so that the product is not
rounded to bf16 (JAX's preferred_element_type=f32). A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises.
The full weight backward (`_bwd_kernel`, ROADMAP B1) is not ported yet: on
the CPU the plain version's autograd serves grad_mode="full", on a CUDA
tensor it raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"fwd": 0, "bwd_input": 0}

_K0 = math.sqrt(2.0 / math.pi)
_K1 = 0.044715
_EPS = 1e-6

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "block_mlp.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


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


def build() -> Path:
    """Compile csrc/block_mlp.cu for sm_90a into build/kernels/ (once per
    source version) and return the shared library's path."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = _BUILD_DIR / f"libblock_mlp_{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _lib():
    global _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            lib = ctypes.CDLL(str(build()))
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.block_mlp_supports.argtypes = [I]
            lib.block_mlp_supports.restype = I
            lib.block_mlp_fwd.argtypes = [I, I, P, P, P, I, P, P, P, P, P, P, P, P, L, P]
            lib.block_mlp_fwd.restype = I
            lib.block_mlp_bwd_input.argtypes = [I, I, P, P, I, P, P, P, P, P, P, P, L, P]
            lib.block_mlp_bwd_input.restype = I
            _lib_handle = lib
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
            _ptr(gamma), _ptr(y), M, torch.cuda.current_stream(s.device).cuda_stream)
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
            _ptr(ln_b), _ptr(w1_16), _ptr(b1), _ptr(w2g16), _ptr(dy), _ptr(ds), M,
            torch.cuda.current_stream(s.device).cuda_stream)
    _raise_on(err, "input-backward")
    LAUNCHES["bwd_input"] += 1
    return ds


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


def block_mlp(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma,
              grad_mode: str = "full"):
    """Fused tail on [M, C] rows. keep: [M // rows_per_keep] f32 or None.

    grad_mode 'input' differentiates w.r.t. s and r only. 'full'
    differentiates everything: on the CPU through the plain version's
    autograd; on a CUDA tensor that needs the full backward kernel, which
    is not ported yet."""
    if grad_mode == "input":
        return _BlockTailInput.apply(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2,
                                     gamma)
    if grad_mode != "full":
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    if _on_cpu(s):
        return fwd_plain(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (s, r, ln_g, ln_b, w1, b1, w2, b2, gamma)):
        raise NotImplementedError("full backward kernel: ROADMAP B1")
    return block_mlp_fwd(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma)


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
