"""Fused multi-head self-attention on the qkv Dense output, port of
revisiting_at_tpu/ops/attention.py.

    o = softmax(Q K^T * hd^-0.5) V   per head, concatenated over heads

Head g's q, k and v are the column slices [g*hd, (g+1)*hd), offset by 0,
D and 2D, of qkv [B, N, 3D]; o is [B, N, D]; the backward writes one dqkv
[B, N, 3D] at the same offsets. Hand-written Hopper kernels in
csrc/attention.cu (TMA loads, wgmma; persistent blocks that walk the
(head, image) pairs, each head's tiles loaded once for all its rows)
replace the TPU kernels:

  * the forward (`attn_fwd_kernel`) replaces `_fwd_qkv_kernel`;
  * the backward replaces `_bwd_qkv_kernel` with two kernels: a dq pass
    (`attn_bwd_rows_kernel`: dq, and per query row the softmax max,
    1 / sum and delta = rowsum(dp * p) into a small f32 side buffer) and a
    dk/dv pass (`attn_bwd_cols_kernel`: dk and dv per key tile, over the
    query tiles). No float atomics: the same bits every run.

`fused_attention(q, k, v)` on [B, N, H, hd] (the `attn_impl='bhnd'` path,
the JAX package's `fused_attention`, whose `_fwd_kernel`/`_bwd_kernel`
compute the same function) packs q, k, v into [B, N, 3D] and runs the
same kernels; autograd splits dqkv back into dq, dk and dv.

Cast points, as in the TPU kernels: s = (q . k^T accumulated in f32) *
scale; keys past N are masked to -1e30; p = e / sum(e), e = exp(s - max),
in f32; p is cast to the operand dtype before PV, which accumulates in
f32; o has the operand dtype. Backward: p16 = cast(p); dv = p16^T dO;
dp = dO v^T; dS = p * (dp - rowsum(dp * p)) with the f32 p; ds16 =
cast(dS * scale); dq = ds16 k; dk = ds16^T q; all accumulated in f32.
The casts go to the input dtype (bf16 in a bf16 model, none in f32).
The kernels form e and e / sum(e) by cheaper routes within a few f32 ulp
(e by ex2, p as e times the row's 1 / sum; csrc/attention.cu); the plain
versions use torch.exp and division.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel, which takes contiguous bf16 with any N >= 1 and a head width that
is a multiple of 16 up to 128, or raises.
"""

from __future__ import annotations

import ctypes
import types

import torch

from . import cuda_build

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"fwd": 0, "bwd_rows": 0, "bwd_cols": 0}

MAX_HEAD_DIM = 128  # the kernels take head widths 16, 32, ..., 128 and any N


# ----------------------------------------------------------- plain versions

def _heads(qkv, num_heads):
    """q, k, v as [B, H, N, hd] views of qkv [B, N, 3D]."""
    B, N, three_d = qkv.shape
    hd = three_d // 3 // num_heads
    t = qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    return t[0], t[1], t[2]


def _probs(q, k, scale):
    """The f32 softmax of the scaled f32 scores, [B, H, N, N]."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _merge(t):
    """[B, H, N, hd] -> [B, N, H * hd]."""
    B, H, N, hd = t.shape
    return t.permute(0, 2, 1, 3).reshape(B, N, H * hd)


def attention_qkv_fwd_plain(qkv, num_heads):
    """Forward in plain PyTorch: qkv [B, N, 3D] -> o [B, N, D], qkv's dtype."""
    dt = qkv.dtype
    q, k, v = _heads(qkv, num_heads)
    p = _probs(q, k, q.shape[-1] ** -0.5)
    o = p.to(dt).float() @ v.float()
    return _merge(o.to(dt))


def _bwd_terms(qkv, do, num_heads):
    """q, k, v, the f32 p, do (cast to qkv's dtype) as f32 [B, H, N, hd],
    ds16 = cast(dS * scale) as f32, and the dtype."""
    dt = qkv.dtype
    B, N, _ = qkv.shape
    q, k, v = _heads(qkv, num_heads)
    hd = q.shape[-1]
    scale = hd ** -0.5
    p = _probs(q, k, scale)
    do16 = do.to(dt).reshape(B, N, num_heads, hd).permute(0, 2, 1, 3).float()
    dp = do16 @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return q, k, p, do16, (ds * scale).to(dt).float(), dt


def attention_bwd_rows_plain(qkv, do, num_heads):
    """The row pass in plain PyTorch: dq [B, N, D] = ds16 k, qkv's dtype."""
    _, k, _, _, ds16, dt = _bwd_terms(qkv, do, num_heads)
    return _merge((ds16 @ k.float()).to(dt))


def attention_bwd_cols_plain(qkv, do, num_heads):
    """The column pass in plain PyTorch: [dk, dv] [B, N, 2D], dk = ds16^T q
    and dv = p16^T do, qkv's dtype."""
    q, _, p, do16, ds16, dt = _bwd_terms(qkv, do, num_heads)
    dk = ds16.transpose(-1, -2) @ q.float()
    dv = p.to(dt).float().transpose(-1, -2) @ do16
    return torch.cat([_merge(dk.to(dt)), _merge(dv.to(dt))], dim=-1)


def attention_qkv_bwd_plain(qkv, do, num_heads):
    """Backward in plain PyTorch: dqkv [B, N, 3D] from qkv and do [B, N, D],
    qkv's dtype."""
    q, k, p, do16, ds16, dt = _bwd_terms(qkv, do, num_heads)
    dq = ds16 @ k.float()
    dk = ds16.transpose(-1, -2) @ q.float()
    dv = p.to(dt).float().transpose(-1, -2) @ do16
    return torch.cat([_merge(t.to(dt)) for t in (dq, dk, dv)], dim=-1)


# ----------------------------------------------------------- CUDA kernels

_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _lib_handle = types.SimpleNamespace(**cuda_build.load("attention", {
            "attention_fwd": [P, P, I, I, I, I, F, P],
            "attention_bwd_rows": [P, P, P, P, I, I, I, I, F, P],
            "attention_bwd_cols": [P, P, P, P, I, I, I, I, F, P],
        }))
    return _lib_handle


def _check_qkv(qkv, num_heads):
    """(B, N, H, hd) of a qkv the kernels take; NotImplementedError for
    what they do not (a head width that is not a multiple of 16 or is over
    MAX_HEAD_DIM, a dtype other than bf16, a non-contiguous tensor)."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or qkv.shape[-1] // 3 % num_heads:
        raise ValueError(f"qkv: expected [B, N, 3 * H * hd], got {tuple(qkv.shape)} "
                         f"with H = {num_heads}")
    B, N, three_d = qkv.shape
    hd = three_d // 3 // num_heads
    if qkv.dtype != torch.bfloat16 or hd % 16 or not 0 < hd <= MAX_HEAD_DIM or N < 1 \
            or not qkv.is_contiguous():
        raise NotImplementedError(
            f"attention CUDA kernel: takes contiguous bf16 qkv with a head width that is a "
            f"multiple of 16 up to {MAX_HEAD_DIM}, got {qkv.dtype} {tuple(qkv.shape)} (head "
            f"width {hd}){'' if qkv.is_contiguous() else ', not contiguous'}")
    return B, N, num_heads, hd


def _check_cuda(qkv, num_heads):
    """_check_qkv, and the tensor must lie on a CUDA device."""
    dims = _check_qkv(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise NotImplementedError(f"attention CUDA kernel: no kernel for device {qkv.device}")
    return dims


def _check_like(name, t, shape, dtype, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _raise_on(err, what):
    if err != 0:
        cause = {-1: "unsupported shape", -2: "cuTensorMapEncodeTiled failed"}
        raise RuntimeError(f"attention {what} kernel launch failed: "
                           f"{cause.get(err, f'cudaError {err}')}")


def _scale(hd):
    """The f32 of hd^-0.5, the value JAX multiplies the scores by."""
    return ctypes.c_float(hd ** -0.5)


def stats_shape(B, N, H):
    """The dq pass's side buffer: per head and 64-row query tile, the
    (scaled) max, 1 / sum and delta of each row (f32)."""
    return (B, H, -(-N // 64), 3, 64)


def attention_fwd_cuda(qkv, num_heads):
    """Launch the forward kernel: o [B, N, D] bf16."""
    B, N, H, hd = _check_cuda(qkv, num_heads)
    o = torch.empty(B, N, qkv.shape[-1] // 3, dtype=qkv.dtype, device=qkv.device)
    err = cuda_build.launch(qkv, _lib().attention_fwd, qkv.data_ptr(), o.data_ptr(), B, N, H, hd,
                            _scale(hd))
    _raise_on(err, "forward")
    LAUNCHES["fwd"] += 1
    return o


def attention_bwd_rows_cuda(qkv, do, num_heads):
    """Launch the dq pass: returns dqkv [B, N, 3D] bf16 with its dq third
    written, and the f32 side buffer (`stats_shape`) of per-row max,
    1 / sum and delta that the dk/dv pass reads."""
    B, N, H, hd = _check_cuda(qkv, num_heads)
    _check_like("do", do, (B, N, qkv.shape[-1] // 3), qkv.dtype, qkv.device)
    stats = torch.empty(stats_shape(B, N, H), dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    err = cuda_build.launch(qkv, _lib().attention_bwd_rows, qkv.data_ptr(), do.data_ptr(),
                            stats.data_ptr(), dqkv.data_ptr(), B, N, H, hd, _scale(hd))
    _raise_on(err, "backward dq")
    LAUNCHES["bwd_rows"] += 1
    return dqkv, stats


def attention_bwd_cols_cuda(qkv, do, num_heads, stats, dqkv):
    """Launch the dk/dv pass: writes the dk and dv thirds of dqkv (from the
    dq pass, with its side buffer) and returns it."""
    B, N, H, hd = _check_cuda(qkv, num_heads)
    _check_like("do", do, (B, N, qkv.shape[-1] // 3), qkv.dtype, qkv.device)
    _check_like("stats", stats, stats_shape(B, N, H), torch.float32, qkv.device)
    _check_like("dqkv", dqkv, qkv.shape, qkv.dtype, qkv.device)
    err = cuda_build.launch(qkv, _lib().attention_bwd_cols, qkv.data_ptr(), do.data_ptr(),
                            stats.data_ptr(), dqkv.data_ptr(), B, N, H, hd, _scale(hd))
    _raise_on(err, "backward dk/dv")
    LAUNCHES["bwd_cols"] += 1
    return dqkv


def attention_bwd_cuda(qkv, do, num_heads):
    """The backward on the card: the dq pass, then the dk/dv pass.
    Returns dqkv [B, N, 3D] bf16."""
    dqkv, stats = attention_bwd_rows_cuda(qkv, do, num_heads)
    return attention_bwd_cols_cuda(qkv, do, num_heads, stats, dqkv)


# ----------------------------------------------------------- dispatch

def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise NotImplementedError(f"attention: no kernel for device {t.device}")


def attention_qkv_fwd(qkv, num_heads):
    """Forward: plain version for CPU tensors, the kernel for CUDA tensors."""
    if _on_cpu(qkv):
        return attention_qkv_fwd_plain(qkv, num_heads)
    return attention_fwd_cuda(qkv, num_heads)


def attention_qkv_bwd(qkv, do, num_heads):
    """Backward: dqkv from qkv and do, plain on the CPU, kernels on CUDA."""
    if _on_cpu(qkv):
        return attention_qkv_bwd_plain(qkv, do, num_heads)
    return attention_bwd_cuda(qkv, do.to(qkv.dtype).contiguous(), num_heads)


class _AttentionQKV(torch.autograd.Function):
    """Saves qkv only; the backward recomputes the softmax, as JAX does."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return attention_qkv_fwd(qkv, num_heads)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        return attention_qkv_bwd(qkv, do, ctx.num_heads), None


def fused_attention_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """qkv [B, N, 3D] (the qkv Dense output, head-major per third) ->
    [B, N, D] = softmax(Q K^T / sqrt(hd)) V concatenated over heads."""
    if not qkv.is_contiguous():
        qkv = qkv.contiguous()
    return _AttentionQKV.apply(qkv, num_heads)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, N, H, hd] -> [B, N, H, hd]: the same function through the
    qkv kernels (one [B, N, 3D] copy in, dq, dk, dv split out by autograd)."""
    B, N, H, hd = q.shape
    qkv = torch.cat([t.reshape(B, N, H * hd) for t in (q, k, v)], dim=-1)
    return fused_attention_qkv(qkv, H).reshape(B, N, H, hd)
