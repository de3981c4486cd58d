"""Time patched variants of the 7x7 depthwise conv's kernels against the
kernels as built, in turns, on one GPU: what each design choice of
csrc/dwconv.cu costs or gains.

    python3 -m revisiting_at_tpu_torch.tools.dwconv_variants

Each variant is csrc/ copied to build/dwconv_variants/<n>/ with a few lines
replaced, and dwconv.cu built from it with ops/cuda_build.py's nvcc flags,
all builds started together. A variant that changes the blocks per SM the
kernels are built for also changes the plan the wrapper hands them
(`_FWD_BLOCKS`, `_WGRAD_BLOCKS` of ops/dwconv.py). VARIANTS lists them.

ptxas's spills and each kernel's SASS instruction mix (cuobjdump) are
printed per variant. Every variant computes the same function; each one's y, dx, dw and db are
compared with the plain version (chip_smoke.py's tolerances) and, bit for
bit, with the kernels as built. The forward, dx and the weight pass with its
reduction are timed at ConvNeXt-T's gated stages 0-2 (batch 80, 224 px,
bf16) over ROUNDS rounds in turns (the order reversed every other round;
event medians), and by torch.profiler's device time; the sums over the
three stages close the report. Prints one line per measurement, with the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import types
from collections import Counter
from pathlib import Path

import torch

from revisiting_at_tpu_torch.ops import cuda_build
from revisiting_at_tpu_torch.ops import dwconv as dw
from revisiting_at_tpu_torch.tools import tree_compare

OUT = cuda_build.BUILD_DIR.parent / "dwconv_variants"

_FWD_BLOCKS = "__host__ __device__ constexpr int fwd_blocks() { return sizeof(T) == 2 ? 3 : 1; }"
_WGRAD_BLOCKS = ("__host__ __device__ constexpr int wgrad_blocks() "
                 "{ return sizeof(T) == 2 ? 2 : 1; }")

# The stencil's tile as built: output rows in pairs, then the last row.
# (start, end) marks the region that a variant replaces.
_FWD_TILE = ("    // the outputs are staged once the previous tile's store has read them\n",
             "      for (int q = 0; q < kQ; ++q) sts<T>(os + ((kQ - 1) * kTile + q) * kCG * "
             "sizeof(T), a[q]);\n    }\n    ring.release(s);\n")
# The whole tile unrolled: each halo row read once, the rows slide down
# through the 7 x 7 accumulators (58 KB of code a tile).
_FWD_UNROLLED = """    float acc[kQ][kQ];
#pragma unroll
    for (int p = 0; p < kQ; ++p)
#pragma unroll
      for (int q = 0; q < kQ; ++q) acc[p][q] = a0;
    // halo row r feeds output row p = r - i through tap row i
#pragma unroll
    for (int r = 0; r < kQH; ++r) {
      float in[kQH];
#pragma unroll
      for (int j = 0; j < kQH; ++j) in[j] = lds<T>(hs + (r * kHalo + j) * kCG * sizeof(T));
#pragma unroll
      for (int i = 0; i < kK; ++i) {
        const int p = r - i;
        if (p >= 0 && p < kQ) {
#pragma unroll
          for (int q = 0; q < kQ; ++q)
#pragma unroll
            for (int j = 0; j < kK; ++j) acc[p][q] = fmaf(w[i * kK + j], in[q + j], acc[p][q]);
        }
      }
    }
    ring.release(s);

    // stage the outputs once the previous tile's store has read them, then
    // one thread stores the tile
    if (threadIdx.x == 0) bulk_wait_read();
    named_bar_sync(1, 32 * kConsumers);
#pragma unroll
    for (int p = 0; p < kQ; ++p)
#pragma unroll
      for (int q = 0; q < kQ; ++q) sts<T>(os + (p * kTile + q) * kCG * sizeof(T), acc[p][q]);
"""
# One output row a loop iteration, its 7 halo rows read for it alone.
_FWD_ROWS = """    // stage the outputs once the previous tile's store has read them
    if (threadIdx.x == 0) bulk_wait_read();
    named_bar_sync(1, 32 * kConsumers);
    // output row p takes halo rows p..p+6 through tap rows 0..6
#pragma unroll 1
    for (int p = 0; p < kQ; ++p) {
      float acc[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) acc[q] = a0;
#pragma unroll
      for (int i = 0; i < kK; ++i) {
        float in[kQH];
#pragma unroll
        for (int j = 0; j < kQH; ++j)
          in[j] = lds<T>(hs + ((p + i) * kHalo + j) * kCG * sizeof(T));
#pragma unroll
        for (int q = 0; q < kQ; ++q)
#pragma unroll
          for (int j = 0; j < kK; ++j) acc[q] = fmaf(w[i * kK + j], in[q + j], acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) sts<T>(os + (p * kTile + q) * kCG * sizeof(T), acc[q]);
    }
    ring.release(s);
"""
# The pair loop run over rows 6 and 7 too (row 7's sums are not stored): no
# peeled row, an eighth more FMAs.
_NO_PEEL = [("for (int p = 0; p + 1 < kQ; p += 2)", "for (int p = 0; p < kQ; p += 2)"),
            ("        sts<T>(os + ((p + 1) * kTile",
             "        if (p + 1 < kQ) sts<T>(os + ((p + 1) * kTile"),
            (("    {  // the last row\n", "sizeof(T), a[q]);\n    }\n"), "")]

# The weight pass's tile as built, and as a loop over output rows, one or
# two a time (the same order of sums: dw and db keep their bits).
_WGRAD_TILE = ("    // the quadrant's dy (zero past the map and past C: the box's fill)\n",
               "              acc[i * kK + j] = fmaf(in[q + j], d[p][q], acc[i * kK + j]);\n"
               "        }\n      }\n    }\n")
_WGRAD_ROWS = """    // output row p: its dy row, and halo rows p..p+6 through tap rows 0..6
#pragma unroll 1
    for (int p = 0; p < kQ; ++p) {
      float d[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        d[q] = lds<T>(ds + (p * kTile + q) * kCG * sizeof(T));
        db += d[q];
      }
#pragma unroll
      for (int i = 0; i < kK; ++i) {
        float in[kQH];
#pragma unroll
        for (int j = 0; j < kQH; ++j)
          in[j] = lds<T>(hs + ((p + i) * kHalo + j) * kCG * sizeof(T));
#pragma unroll
        for (int q = 0; q < kQ; ++q)
#pragma unroll
          for (int j = 0; j < kK; ++j) acc[i * kK + j] = fmaf(in[q + j], d[q], acc[i * kK + j]);
      }
    }
"""
_WGRAD_PAIRS = """    // output rows p and p + 1: their dy rows, and halo rows p..p+7
#pragma unroll 1
    for (int p = 0; p + 1 < kQ; p += 2) {
      float da[kQ], dd[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        da[q] = lds<T>(ds + (p * kTile + q) * kCG * sizeof(T));
        db += da[q];
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        dd[q] = lds<T>(ds + ((p + 1) * kTile + q) * kCG * sizeof(T));
        db += dd[q];
      }
#pragma unroll
      for (int k = 0; k <= kK; ++k) {
        float in[kQH];
#pragma unroll
        for (int j = 0; j < kQH; ++j)
          in[j] = lds<T>(hs + ((p + k) * kHalo + j) * kCG * sizeof(T));
        if (k < kK) {
#pragma unroll
          for (int q = 0; q < kQ; ++q)
#pragma unroll
            for (int j = 0; j < kK; ++j)
              acc[k * kK + j] = fmaf(in[q + j], da[q], acc[k * kK + j]);
        }
        if (k > 0) {
#pragma unroll
          for (int q = 0; q < kQ; ++q)
#pragma unroll
            for (int j = 0; j < kK; ++j)
              acc[(k - 1) * kK + j] = fmaf(in[q + j], dd[q], acc[(k - 1) * kK + j]);
        }
      }
    }
    {  // the last row
      float d[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        d[q] = lds<T>(ds + ((kQ - 1) * kTile + q) * kCG * sizeof(T));
        db += d[q];
      }
#pragma unroll
      for (int i = 0; i < kK; ++i) {
        float in[kQH];
#pragma unroll
        for (int j = 0; j < kQH; ++j)
          in[j] = lds<T>(hs + ((kQ - 1 + i) * kHalo + j) * kCG * sizeof(T));
#pragma unroll
        for (int q = 0; q < kQ; ++q)
#pragma unroll
          for (int j = 0; j < kK; ++j) acc[i * kK + j] = fmaf(in[q + j], d[q], acc[i * kK + j]);
      }
    }
"""
_FWD2 = (_FWD_BLOCKS, _FWD_BLOCKS.replace("? 3 : 1", "? 2 : 1"))
_WGRAD3 = (_WGRAD_BLOCKS, _WGRAD_BLOCKS.replace("? 2 : 1", "? 3 : 1"))

# name: ([(old, new) of dwconv.cu: old a line or a (start, end) region],
#        {plan table: {element size: blocks per SM}})
VARIANTS = {
    "as built": ([], {}),
    "stencil 2 blocks per SM": ([_FWD2], {"_FWD_BLOCKS": {2: 2, 4: 1}}),
    "stencil tile unrolled": ([(_FWD_TILE, _FWD_UNROLLED)], {}),
    "stencil tile unrolled, 2 blocks per SM": ([(_FWD_TILE, _FWD_UNROLLED), _FWD2],
                                               {"_FWD_BLOCKS": {2: 2, 4: 1}}),
    "stencil row loop": ([(_FWD_TILE, _FWD_ROWS)], {}),
    "stencil row loop unrolled": (
        [(_FWD_TILE, _FWD_ROWS.replace("#pragma unroll 1\n", "#pragma unroll\n"))], {}),
    "stencil row pairs, no peeled row": (_NO_PEEL, {}),
    "weight pass 3 blocks per SM": ([_WGRAD3], {"_WGRAD_BLOCKS": {2: 3, 4: 1}}),
    "weight pass row loop, 3 blocks per SM": ([(_WGRAD_TILE, _WGRAD_ROWS), _WGRAD3],
                                              {"_WGRAD_BLOCKS": {2: 3, 4: 1}}),
    "weight pass row pairs, 3 blocks per SM": ([(_WGRAD_TILE, _WGRAD_PAIRS), _WGRAD3],
                                               {"_WGRAD_BLOCKS": {2: 3, 4: 1}}),
}
# every entry point of csrc/dwconv.cu, as ops/dwconv.py binds them
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {"dwconv_supports": [_I], "dwconv_occupancy": [_I, _I],
              "dwconv_fwd": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
              "dwconv_wgrad": [_I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _I, _P, _P],
              "dwconv_reduce": [_P, _L, _L, _P, _P]}


def patch(text: str, subs, name: str) -> str:
    """text with each (old, new) replaced, old a line or a (start, end)
    region, both ends included; raises if an old line is missing."""
    for old, new in subs:
        start, end = old if isinstance(old, tuple) else (old, "")
        if start not in text or end not in text.split(start, 1)[1]:
            raise RuntimeError(f"variant {name!r}: {start[:60]!r} is not in csrc/dwconv.cu")
        head, rest = text.split(start, 1)
        text = head + new + rest.split(end, 1)[1] if end else text.replace(start, new)
    return text


# the bf16 kernels' mangled names, shortened
_SHORT = {"fwd_kernelI13__nv_bfloat16Lb0": "forward bf16",
          "fwd_kernelI13__nv_bfloat16Lb1": "dx bf16",
          "wgrad_kernelI13__nv_bfloat16": "weight pass bf16"}


def sass_mix(so) -> dict:
    """{kernel: (instructions, FFMA, LDS, the five commonest other opcodes)}
    of a library's SASS (cuobjdump beside nvcc). The kernels' tile loops are
    unrolled, so the static counts are those of one tile."""
    cuobjdump = Path(cuda_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    mixes, ops = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            ops = mixes.setdefault(line.split("Function : ", 1)[1].strip(), Counter())
        elif ops is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                ops[m.group(1).split(".")[0]] += 1
    return {k: (sum(c.values()), c["FFMA"], c["LDS"],
                [(op, n) for op, n in c.most_common(8) if op not in ("FFMA", "LDS")][:5])
            for k, c in mixes.items()}


def build() -> dict:
    """{variant: its C entry points}, every nvcc started together."""
    procs = {}
    for i, (name, (subs, _)) in enumerate(VARIANTS.items()):
        d = OUT / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC, d)
        (d / "dwconv.cu").write_text(patch((d / "dwconv.cu").read_text(), subs, name))
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "dwconv.cu")]
        procs[name] = (d / "lib.so", subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r}: nvcc failed\n{out}\n{err}")
        spills = [ln.strip() for ln in (out + err).splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        print(f"dwconv_variants {name}: ptxas spills {spills or 'none'}", flush=True)
        for kern, (n, ffma, lds, rest) in sass_mix(so).items():
            short = next((v for k, v in _SHORT.items() if k in kern), None)
            if short:
                print(f"dwconv_variants {name}: SASS {short}: {n} instructions ({16 * n} bytes), "
                      f"FFMA {ffma} ({ffma / n:.0%}), LDS {lds}, then {rest}", flush=True)
        lib = ctypes.CDLL(str(so))
        fns = {}
        for fn, args in SIGNATURES.items():
            fns[fn] = getattr(lib, fn)
            fns[fn].argtypes, fns[fn].restype = args, ctypes.c_int
        libs[name] = types.SimpleNamespace(**fns)
    return libs


class Switch:
    """Points ops/dwconv.py at a variant's library and plan tables; a no-op
    when it already does, so a timed call costs the host no more than the
    kernels as built."""

    def __init__(self, libs: dict):
        self.libs, self.current = libs, None
        as_built = (dw._FWD_BLOCKS, dw._WGRAD_BLOCKS)
        self.plans = {name: (plan.get("_FWD_BLOCKS", as_built[0]),
                             plan.get("_WGRAD_BLOCKS", as_built[1]))
                      for name, (_, plan) in VARIANTS.items()}

    def __call__(self, name: str) -> None:
        if self.current == name:
            return
        self.current = name
        dw._lib_handle = self.libs[name]
        dw._FWD_BLOCKS, dw._WGRAD_BLOCKS = self.plans[name]
        dw.dwconv_plan.cache_clear()


def main() -> int:
    if not torch.cuda.is_available():
        print("dwconv_variants: no GPU", file=sys.stderr)
        return 2
    label = f"[{tree_compare.card()}]"
    libs = build()
    use = Switch(libs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    total = {}
    for B, H, W, C in tree_compare.DW_SHAPES:
        rnd = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")  # noqa: E731
        x, w49, b, dy = (rnd(B, H, W, C).bfloat16(), 0.2 * rnd(49, C), 0.1 * rnd(C),
                         rnd(B, H, W, C).bfloat16())
        ref = dict(zip(("y", "dx", "dw", "db"), (dw.fwd_plain(x, w49, b),
                                                 dw.dx_plain(dy, w49, x.dtype),
                                                 *dw.wgrad_plain(x, dy))))
        built = None
        for name in libs:
            use(name)
            got = dict(zip(("y", "dx", "dw", "db"),
                           (dw.fwd_cuda(x, w49, b), dw.dx_cuda(dy, w49), *dw.wgrad_cuda(x, dy))))
            built = built or got
            for k, g in got.items():
                e = (g.float() - ref[k].float()).abs().max().item()
                if not e <= tree_compare.DW_TOL[k] * ref[k].float().abs().max().item():
                    raise AssertionError(f"variant {name!r}: {k} B={B} {H}x{W} C={C}: error {e}")
            same = [k for k in got if torch.equal(got[k], built[k])]
            print(f"dwconv_variants {name} B={B} {H}x{W} C={C}: within tolerance; the same bits "
                  f"as built in {same}", flush=True)
        calls = tree_compare.dwconv_calls(dw, x, w49, b, dy)
        for kern, call in calls.items():
            def timed(name, call=call):
                def fn():
                    use(name)
                    return call()
                return fn
            res = tree_compare.in_turns({name: timed(name) for name in libs})
            tree_compare.report(f"dwconv_variants {kern} B={B} {H}x{W} C={C}:", res, label)
            for name, (med, _, _, dev, _) in res.items():
                t = total.setdefault((kern, name), [0.0, 0.0])
                t[0] += med
                t[1] = None if dev is None or t[1] is None else t[1] + dev
        del x, dy, ref, built
        torch.cuda.empty_cache()
    for (kern, name), (med, dev) in total.items():
        dev_s = "not measured" if dev is None else f"{dev:.4f} ms"
        print(f"dwconv_variants {kern} over stages 0-2, {name}: event medians {med:.4f} ms, "
              f"device {dev_s} {label}", flush=True)
    use("as built")
    dw._lib_handle = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
