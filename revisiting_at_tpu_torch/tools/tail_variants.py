"""Time patched variants of the block tail's cluster kernels (C = 768, or
432, 512 and 1024 with --width) against the kernels as built, in turns, on
one GPU: what each part of a chunk of 4C costs.

    python3 -m revisiting_at_tpu_torch.tools.tail_variants [--width 768 | 512 | 432 | 1024]

Each variant is csrc/ copied to build/tail_variants/<name>/ with a few lines
replaced, and block_mlp.cu (the forward and the input backward) built from
it with ops/cuda_build.py's nvcc flags, all builds started together:

  * as built: no change;
  * no weight loads: the producer loads the ring's first S items only and
    marks every later item as landed, so the products reuse stale stages;
  * no tanh: gelu and gelu' take 0.5 h for tanh(...), the rest of their
    arithmetic kept;
  * no exchange: a block neither sends nor waits for its peers' partial h
    (dg), nor writes the peers' g (dh) tiles, and waits on a named barrier
    of its own warpgroups instead of the tile's mbarrier.

All but the first compute wrong results on purpose; each variant's error
against the plain version is printed beside its time. The forward and the
input backward are timed at ConvNeXt-T's stage 3 (49 rows an image) at
batch 200, 80 and 32 (--width 512 and 432: ConvNeXt-B's stage 2 and
convnext_iso, 196 rows an image at batch 80; --width 1024: ConvNeXt-B's
stage 3, 49 rows an image at batch 80), on the event clock over
ROUNDS rounds in turns (the order reversed every other round; medians).
Prints one line per measurement, with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
import types
from pathlib import Path

import torch

from revisiting_at_tpu_torch.ops import block_mlp as bm
from revisiting_at_tpu_torch.ops import cuda_build

ROUNDS = 5
# the cluster widths: (rows per image at 224 px, batches) of their main path
WIDTHS = {768: (49, (200, 80, 32)), 512: (196, (80,)), 432: (196, (80,)), 1024: (49, (80,))}
OUT = cuda_build.BUILD_DIR.parent / "tail_variants"

_LOAD = """    mbar_arrive_expect_tx(&sm.full[st], P::TILE);
#pragma unroll
    for (int b = 0; b < P::BOXES; ++b)
      tma_load_2d(dst + b * kBox, map, &sm.full[st], col0 + 64 * b, 64 * chunk);"""
_TILE = """      fence_proxy_async();
      arrive_tile<P>(&sm.gfull[j & 1]);
      mbar_wait_cluster(&sm.gfull[j & 1], (j >> 1) & 1);"""
VARIANTS = {
    "as built": [],
    "no weight loads": [(_LOAD, "    if (i >= P::S) {\n      mbar_arrive(&sm.full[st]);\n"
                                "      continue;\n    }\n" + _LOAD)],
    "no tanh": [("tanhf(kK0 * (h + kK1 * h * h * h))", "(0.5f * h)")],
    "no exchange": [("expect_peer(sm.xfull, P::XCH_BYTES);", ""),
                    ("mbar_wait_cluster(sm.xfull, j & 1);", ""),
                    ("xch_send(sm, h, 0, rank);", ""), ("xch_send(sm, dg, 1, rank);", ""),
                    ("xch_send(sm, hn, 0, rank);", ""), ("xch_send(sm, ha, 0, rank);", ""),
                    ("g_peers.send(off, gp);", ""), ("dh_peers.send(off, dhp);", ""),
                    (_TILE, "      fence_proxy_async();\n      named_bar_sync(bar, bar_n);")],
}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build() -> dict:
    """{variant: the forward and input backward's C entry points}."""
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        d = OUT / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC, d)
        for a, b in subs:
            hits = 0
            for f in ("block_mlp.cu", "block_mlp_common.cuh"):
                text = (d / f).read_text()
                hits += text.count(a)
                (d / f).write_text(text.replace(a, b))
            if not hits:
                raise RuntimeError(f"variant {name!r}: {a[:60]!r} is not in the source")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "block_mlp.cu")]
        procs[name] = (d / "lib.so", subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.PIPE, text=True))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    plan = [I] * 7  # rows, chunk, threads, split, smem, cluster, padded
    sigs = {"block_mlp_supports": [I],
            "block_mlp_fwd": [I, I, P, P, P, I, P, P, P, P, P, P, P, P, L, *plan, P],
            "block_mlp_bwd_input": [I, I, P, P, I, P, P, P, P, P, P, P, L, *plan, P]}
    libs = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r}: nvcc failed\n{out}\n{err}")
        lib = ctypes.CDLL(str(so))
        fns = {}
        for fn, args in sigs.items():
            fns[fn] = getattr(lib, fn)
            fns[fn].argtypes, fns[fn].restype = args, ctypes.c_int
        libs[name] = types.SimpleNamespace(**fns)
    return libs


def time_ms(fn, iters=20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, choices=sorted(WIDTHS), default=768)
    C = ap.parse_args(argv).width
    rows, batches = WIDTHS[C]
    if not torch.cuda.is_available():
        print("tail_variants: no GPU", file=sys.stderr)
        return 2
    label = f"[{card()}]"
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch in batches:
        M = rows * batch
        rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
        s, r, dy = (rnd(M, C).bfloat16() for _ in range(3))
        ln_g, ln_b, b1, b2 = 1.0 + 0.1 * rnd(C), 0.1 * rnd(C), 0.1 * rnd(4 * C), 0.1 * rnd(C)
        w1 = (rnd(4 * C, C) / C ** 0.5).bfloat16().t()  # nn.Linear's layout: a view of W1^T
        w2 = (rnd(4 * C, C) / (4 * C) ** 0.5).bfloat16()
        gamma = 0.1 + 0.9 * torch.rand(C, generator=gen, device="cuda")
        w2g = (w2.float() * gamma).bfloat16()
        calls = {"fwd": lambda: bm.fwd_cuda(s, r, None, M, ln_g, ln_b, w1, b1, w2, b2, gamma),
                 "bwd_input": lambda: bm.bwd_input_cuda(s, None, M, ln_g, ln_b, w1, b1, w2g, dy)}
        refs = {"fwd": bm.fwd_plain(s, r, None, M, ln_g, ln_b, w1, b1, w2, b2, gamma).float(),
                "bwd_input": bm.bwd_input_plain(s, None, M, ln_g, ln_b, w1, b1, w2g, dy).float()}
        for what, call in calls.items():
            runs = {name: [] for name in libs}
            errs = {}
            for k in range(ROUNDS):
                for name in (list(libs) if k % 2 == 0 else list(libs)[::-1]):
                    bm._lib_handle = libs[name]
                    if name not in errs:
                        ref = refs[what]
                        errs[name] = (call().float() - ref).abs().max().item() / ref.abs().max().item()
                    runs[name].append(time_ms(call))
            for name, v in runs.items():
                print(f"tail_variants {what} B={batch} M={M} C={C} {name}: event median "
                      f"{statistics.median(v):.4f} ms [{min(v):.4f}, {max(v):.4f}], error "
                      f"{errs[name]:.2e} of max|plain| {label}", flush=True)
    bm._lib_handle = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
