"""Time the block tail's row kernels, the column reduction and the qkv
attention forward of several trees of the port in turns, on one GPU.

    python3 -m revisiting_at_tpu_torch.tools.tree_compare [--tail-only] TREE [TREE ...]

Each TREE is a checkout of the repository (for example the parent commit
unpacked by `git archive` into a directory under build/). Its package
revisiting_at_tpu_torch is loaded under a name of its own and builds its
kernels into the tree's own build/kernels/, all trees' nvcc processes
started together. This tree comes last. At the main path's shapes:

  * the block tail's forward and input backward (`fwd_cuda`,
    `bwd_input_cuda`) at ConvNeXt-T's four stages, batch 200, and its full
    backward's row pass (`bwd_full_rows_cuda`) at stages 0-2 and ViT-S,
    batch 80, each tree's output held to this tree's plain version within
    chip_smoke.py's TOL, with the ms beside the unfused model path's
    (use_pallas=0: cuBLAS matmuls, eager elementwise ops); with
    --tail-only nothing else is timed;
  * the column reduction (`reduce_cuda`) over the full backward's 15
    partials of ConvNeXt-T's stages 0-2 at batch 80 (the row pass's three
    column sums and the weight pass's two products per stage), and over
    ViT-S's 5 (197 tokens, batch 80), beside torch.sum on the same
    partials;
  * the attention forward (`attention_fwd_cuda`) at ViT-S (batch 80, 197
    tokens, 6 heads of 64), beside scaled_dot_product_attention;

each timed on the event clock over ROUNDS rounds in turns (the trees and
the library, the order reversed every other round; medians and [min,
max]) and by torch.profiler's device time (every launch of a call booked),
with the launches per call. Each tree's output is compared with this
tree's plain version and, bit for bit, with the other trees'. Prints one
line per measurement, with the card's name and power limit.
"""

from __future__ import annotations

import importlib
import importlib.util
import statistics
import subprocess
import sys
import threading
from pathlib import Path

import torch

ROUNDS = 5
BATCH = 80
# (rows per image, C) of ConvNeXt-T's stages 0-2 at 224 px, and ViT-S's tokens
STAGES = [(3136, 96), (784, 192), (196, 384)]
VIT = (197, 384)
# the tail's forward and input backward: ConvNeXt-T's four stages at this batch
TAIL_BATCH = 200
TAIL_STAGES = STAGES + [(49, 768)]
# max |kernel - plain| <= TOL * max |plain| (chip_smoke.py's TOL for y and ds)
TAIL_TOL = 2e-2
HERE = Path(__file__).resolve().parents[2]


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def load_tree(root: Path, tag: int):
    """The ops modules (block_mlp, attention, cuda_build) of the package in
    root, loaded under a name of its own."""
    if root.resolve() == HERE:
        name = "revisiting_at_tpu_torch"
    else:
        name = f"_tree{tag}_revisiting_at_tpu_torch"
        pkg = root / "revisiting_at_tpu_torch"
        spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                      submodule_search_locations=[str(pkg)])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return tuple(importlib.import_module(f"{name}.ops.{m}")
                 for m in ("block_mlp", "attention", "cuda_build"))


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


def device_ms(fn, n=10, tries=3):
    """(ms of device time per call, launches per call) from torch.profiler:
    per kernel name its mean duration times its launches per call (count
    over n, rounded); None for the time after `tries` traces without one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count]
        per_call = {e.key: max(1, round(e.count / n)) for e in events}
        us = sum(e.self_device_time_total / e.count * per_call[e.key] for e in events)
        if us > 0:
            return us / 1000, sum(per_call.values())
    return None, None


def in_turns(fns: dict) -> dict:
    """{name: (median ms, min, max, device ms, launches per call)}, the
    event-clock times over ROUNDS rounds in turns."""
    runs = {k: [] for k in fns}
    for r in range(ROUNDS):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            runs[k].append(time_ms(fns[k]))
    return {k: (statistics.median(v), min(v), max(v), *device_ms(fns[k]))
            for k, v in runs.items()}


def report(what: str, res: dict, label: str) -> None:
    for k, (med, lo, hi, dev, launches) in res.items():
        dev_s = "not measured" if dev is None else f"{dev:.4f} ms, {launches} launches a call"
        print(f"{what} {k}: event median {med:.4f} ms [{lo:.4f}, {hi:.4f}], device {dev_s} "
              f"{label}", flush=True)


def partials(bm, M: int, C: int, gen) -> list:
    """Random f32 partials of the full backward's five sums at [M, C]: the
    row pass's column sums (db1 [Mpad / part_rows, 4C], dln_g and dln_b [., C])
    and the weight pass's two products ([slices, 4C * C] each)."""
    pad, bm_rows = bm.ROW_PAD, bm.tail_plan(C, "bwd_full_rows").part_rows
    m_pad = -(-M // pad) * pad
    n_split = bm.wgrad_plan(m_pad, C, 4 * C)[1]
    shapes = [(m_pad // bm_rows, 4 * C), (m_pad // bm_rows, C), (m_pad // bm_rows, C),
              (n_split, 4 * C * C), (n_split, 4 * C * C)]
    return [torch.randn(*sh, generator=gen, device="cuda") for sh in shapes]


def tail_inputs(M: int, C: int, gen) -> dict:
    rnd = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")  # noqa: E731
    return dict(s=rnd(M, C).bfloat16(), r=rnd(M, C).bfloat16(), dy=rnd(M, C).bfloat16(),
                ln_g=1.0 + 0.1 * rnd(C), ln_b=0.1 * rnd(C), w1=rnd(C, 4 * C) / C ** 0.5,
                b1=0.1 * rnd(4 * C), w2=rnd(4 * C, C) / (4 * C) ** 0.5, b2=0.1 * rnd(C),
                gamma=0.1 + 0.9 * torch.rand(C, generator=gen, device="cuda"))


def tail_calls(bm, d: dict, M: int) -> dict:
    """{what: call} of one tree's tail kernels on d."""
    w1, w2 = d["w1"].bfloat16(), d["w2"].bfloat16()
    w2g = (w2.float() * d["gamma"]).bfloat16()
    bwd = (d["s"], None, M, d["ln_g"], d["ln_b"], w1, d["b1"], w2g, d["dy"])
    return {"fwd": lambda: bm.fwd_cuda(d["s"], d["r"], None, M, d["ln_g"], d["ln_b"], w1,
                                       d["b1"], w2, d["b2"], d["gamma"]),
            "bwd_input": lambda: bm.bwd_input_cuda(*bwd),
            "bwd_full_rows": lambda: bm.bwd_full_rows_cuda(*bwd)[0],
            "plain fwd": lambda: bm.fwd_plain(d["s"], d["r"], None, M, d["ln_g"], d["ln_b"], w1,
                                              d["b1"], w2, d["b2"], d["gamma"]),
            "plain bwd": lambda: bm.bwd_input_plain(*bwd)}


def model_path(d: dict) -> dict:
    """The unfused tail (use_pallas=0) on d: its forward, and its autograd
    backward with (bwd_input) and without (bwd_full_rows: every cotangent)
    the weights frozen."""
    from revisiting_at_tpu_torch.models.convnext import plain_tail

    args = (d["ln_g"], d["ln_b"], d["w1"].t(), d["b1"], d["w2"].t(), d["b2"], d["gamma"],
            torch.bfloat16)
    s_in, r_in = d["s"].clone().requires_grad_(True), d["r"].clone().requires_grad_(True)
    leaves = [t.detach().clone().requires_grad_(True) for t in
              (d["s"], d["r"], d["ln_g"], d["ln_b"], d["w1"].t().contiguous(), d["b1"],
               d["w2"].t().contiguous(), d["b2"], d["gamma"])]
    y_in = plain_tail(s_in, r_in, *args)
    y_all = plain_tail(*leaves, torch.bfloat16)
    return {"fwd": lambda: plain_tail(d["s"], d["r"], *args),
            "bwd_input": lambda: torch.autograd.grad(y_in, (s_in, r_in), d["dy"],
                                                     retain_graph=True),
            "bwd_full_rows": lambda: torch.autograd.grad(y_all, leaves, d["dy"],
                                                         retain_graph=True)}


def compare_tail(mods, names, gen, label) -> None:
    """Each tree's forward, input backward and row pass at the stage shapes,
    in turns with the other trees and the model path."""
    bm_here = mods[-1][0]
    shapes = ([("fwd", TAIL_BATCH, rc) for rc in TAIL_STAGES]
              + [("bwd_input", TAIL_BATCH, rc) for rc in TAIL_STAGES]
              + [("bwd_full_rows", BATCH, rc) for rc in STAGES + [VIT]])
    for what, batch, (rows, C) in shapes:
        M = rows * batch
        d = tail_inputs(M, C, gen)
        ref = tail_calls(bm_here, d, M)["plain fwd" if what == "fwd" else "plain bwd"]().float()
        scale = ref.abs().max().item()
        calls = [tail_calls(bm, d, M)[what] for bm, _, _ in mods]
        for n, call in zip(names, calls):
            err = (call().float() - ref).abs().max().item()
            if not err <= TAIL_TOL * scale:
                raise AssertionError(f"{n}: tail {what} M={M} C={C}: error {err} > "
                                     f"{TAIL_TOL} * {scale}")
        fns = dict(zip(names, calls))
        fns["model path"] = model_path(d)[what]
        flops = {"fwd": 16, "bwd_input": 24, "bwd_full_rows": 24}[what] * M * C * C
        res = in_turns(fns)
        report(f"tail {what} B={batch} M={M} C={C} ({flops / 1e9:.1f} GFLOP of the tail's own "
               f"products):", res, label)
        del d, ref, calls, fns
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    tail_only = "--tail-only" in args
    trees = [Path(a) for a in args if a != "--tail-only"] + [HERE]
    if not torch.cuda.is_available():
        print("tree_compare: no GPU", file=sys.stderr)
        return 2
    label = f"[{card()}]"
    mods = [load_tree(t, i) for i, t in enumerate(trees)]
    names = [str(t) for t in trees]
    threads = [threading.Thread(target=cb.build) for _, _, cb in mods]
    for b in threads:
        b.start()
    for b in threads:
        b.join()
    for bm, att, _ in mods:  # raises here if a build failed
        bm._lib()
        att._lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bm_here, att_here = mods[-1][0], mods[-1][1]
    compare_tail(mods, names, gen, label)
    if tail_only:
        return 0

    # the column reduction
    for what, shapes in (("ConvNeXt-T stages 0-2", STAGES), ("ViT-S", [VIT])):
        parts = [p for rows, C in shapes for p in partials(bm_here, rows * BATCH, C, gen)]
        for i, (bm, _, _) in enumerate(mods):
            for p in parts:
                got = bm.reduce_cuda(p)
                if not torch.equal(got, bm.reduce_cuda(p)):
                    raise AssertionError(f"{names[i]}: reduce {tuple(p.shape)} differs over two "
                                         "launches")
                err = (got - p.sum(0)).abs().max().item() / p.sum(0).abs().max().item()
                if err > 2e-6:
                    raise AssertionError(f"{names[i]}: reduce {tuple(p.shape)} error {err:.2e}")
        fns = {n: (lambda bm=bm: [bm.reduce_cuda(p) for p in parts])
               for n, (bm, _, _) in zip(names, mods)}
        fns["torch.sum"] = lambda: [torch.sum(p, 0) for p in parts]
        shapes_s = ", ".join(f"{p.shape[0]}x{p.shape[1]}" for p in parts)
        report(f"reduce {what}, B={BATCH}, {len(parts)} sums ({shapes_s}):", in_turns(fns), label)
        del parts

    # the attention forward
    B, N, H, hd = BATCH, VIT[0], 6, 64
    qkv = torch.randn(B, N, 3 * H * hd, generator=gen, device="cuda").bfloat16()
    ref = att_here.attention_qkv_fwd_plain(qkv, H).float()
    outs = [att.attention_fwd_cuda(qkv, H) for _, att, _ in mods]
    for n, o in zip(names, outs):
        err = (o.float() - ref).abs().max().item() / ref.abs().max().item()
        same = [m for m, o2 in zip(names, outs) if torch.equal(o, o2)]
        print(f"attention fwd {n}: error {err:.2e} of max|ref| against the plain version; "
              f"bitwise equal to {same}", flush=True)

    def sdpa():
        q, k, v = qkv.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        return torch.nn.functional.scaled_dot_product_attention(q, k, v)

    fns = {n: (lambda att=att: att.attention_fwd_cuda(qkv, H)) for n, (_, att, _) in
           zip(names, mods)}
    fns["sdpa"] = sdpa
    report(f"attention fwd B={B} N={N} H={H} hd={hd}:", in_turns(fns), label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
