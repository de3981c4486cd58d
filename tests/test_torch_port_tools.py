"""The port's measurement scripts (revisiting_at_tpu_torch/tools/), on the
CPU: the ptxas report parser and comparison, the slice counts the
weight-pass sweep tries, the source lines the tail's and the dwconv's
variant timings patch, and the tree comparison's modes and dwconv shapes. None needs a GPU
for what is checked here. CPU time: 9 s in one pytest process.
"""

from pathlib import Path

import pytest
import torch

import chip_smoke
from revisiting_at_tpu_torch.ops import block_mlp as tbm
from revisiting_at_tpu_torch.ops import dwconv as tdw
from revisiting_at_tpu_torch.tools import (dwconv_variants, ptxas_compare, tail_variants,
                                           tree_compare, wgrad_slices)

torch.set_num_threads(1)

# two entries as nvcc's ptxas prints them; the anonymous namespace carries
# a per-build hash (a9690f21 / 058fe1ae here)
_REPORT = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__{h1}_12_block_mlp_cu_{h2}10fwd_kernelILi96EfEEvPKT0_' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__{h1}_12_block_mlp_cu_{h2}10fwd_kernelILi96EfEEvPKT0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used {regs} registers, used 1 barriers, 33024 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__{h1}_12_block_mlp_cu_{h2}10bwd_kernelILi768EfEEvPKT0_' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__{h1}_12_block_mlp_cu_{h2}10bwd_kernelILi768EfEEvPKT0_
    48 bytes stack frame, 72 bytes spill stores, 84 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 33024 bytes smem, 400 bytes cmem[0]
"""


def _write(d, h1, h2, regs):
    d.mkdir()
    (d / "libblock_mlp_0123456789ab.so.ptxas.txt").write_text(
        _REPORT.format(h1=h1, h2=h2, regs=regs))
    return d


def test_ptxas_parse_drops_the_per_build_namespace_hash():
    a = ptxas_compare.parse(_REPORT.format(h1="a9690f21", h2="058fe1ae", regs=168))
    b = ptxas_compare.parse(_REPORT.format(h1="3a0876eb", h2="223ebf72", regs=168))
    assert a == b and len(a) == 2
    bwd = next(v for k, v in a.items() if "bwd_kernel" in k)
    assert bwd == {"stack": 48, "spill_stores": 72, "spill_loads": 84, "registers": 255}


@pytest.mark.parametrize("regs,rc", [(168, 0), (170, 1)])
def test_ptxas_compare_exits_1_only_when_a_kernel_differs(tmp_path, capsys, regs, rc):
    old = _write(tmp_path / "old", "a9690f21", "058fe1ae", 168)
    new = _write(tmp_path / "new", "3a0876eb", "223ebf72", regs)
    assert ptxas_compare.main([str(old), str(new)]) == rc
    assert f"2 kernels in both builds, {rc} differ" in capsys.readouterr().out


def test_ptxas_compare_rename_matches_a_kernel_kept_under_a_new_name(tmp_path, capsys):
    old = _write(tmp_path / "old", "a9690f21", "058fe1ae", 168)
    new = tmp_path / "new"
    new.mkdir()
    (new / "libblock_mlp_0123456789ab.so.ptxas.txt").write_text(
        _REPORT.format(h1="3a0876eb", h2="223ebf72", regs=168)
        .replace("10fwd_kernelI", "15fwd_kernel_wmmaI"))
    assert ptxas_compare.main([str(old), str(new)]) == 0
    assert "1 kernels in both builds, 0 differ; 1 only in the old" in capsys.readouterr().out
    assert ptxas_compare.main(["--rename", "fwd_kernel=fwd_kernel_wmma", str(old), str(new)]) == 0
    assert "2 kernels in both builds, 0 differ; 0 only in the old" in capsys.readouterr().out


@pytest.mark.parametrize("name,M,C", wgrad_slices.SHAPES)
def test_wgrad_slices_candidates_hold_the_plan(name, M, C):
    """The sweep tries the plan's count and counts cut as the plan cuts M:
    whole 64-row stages, every slice holding rows, at most 64 slices."""
    m_pad = -(-M // tbm.WGRAD_DEPTH) * tbm.WGRAD_DEPTH
    ns = wgrad_slices.candidates(m_pad, C)
    assert tbm.wgrad_plan(m_pad, C, 4 * C)[1] in ns, (name, ns)
    for n in ns:
        rows, n_cut = wgrad_slices._cut(m_pad, n)
        assert n_cut == n <= 64 and rows % tbm.WGRAD_DEPTH == 0
        assert (n - 1) * rows < m_pad <= n * rows


@pytest.mark.parametrize("name", list(tail_variants.VARIANTS))
def test_tail_variants_patch_lines_of_the_source(name):
    """Every line a variant replaces is in the sources it copies, so no
    variant silently times the kernels as built."""
    from revisiting_at_tpu_torch.ops import cuda_build

    src = "".join((cuda_build.CSRC / f).read_text() for f in ("block_mlp.cu",
                                                              "block_mlp_common.cuh"))
    for old, new in tail_variants.VARIANTS[name]:
        assert old in src and old != new, (name, old[:60])


@pytest.mark.parametrize("argv,mode", [(["build/parent"], "all"),
                                       (["--tail-only", "build/parent"], "tail"),
                                       (["--dwconv", "build/parent"], "dwconv"),
                                       (["build/parent", "--dwconv"], "dwconv"),
                                       (["--wide", "build/parent"], "wide")])
def test_tree_compare_modes(argv, mode):
    """A flag anywhere picks the mode; the trees keep their order and this
    tree comes last."""
    got, trees = tree_compare.parse_args(argv)
    assert got == mode and trees == [Path("build/parent"), tree_compare.HERE]


def test_tree_compare_wide_shapes_are_iso_and_convnext_b_stage_2():
    """--wide times convnext_iso's and ConvNeXt-B stage 2's shape, 196 rows
    an image (14 x 14 at 224 px) at C = 432 and 512, in clusters of two
    blocks, and ConvNeXt-B stage 3's, 49 rows an image at C = 1024, in
    clusters of four, at the training batch."""
    assert tree_compare.WIDE_SHAPES == [(chip_smoke.ISO_ROWS, chip_smoke.ISO_C), (196, 512),
                                        (49, 1024)]
    assert tree_compare.BATCH == chip_smoke.TRAIN_BATCH
    for _, C in tree_compare.WIDE_SHAPES:
        assert {tbm.tail_plan(C, m).cluster for m in tbm.TAIL_MODES} == {4 if C == 1024 else 2}


def test_tree_compare_refuses_two_modes():
    with pytest.raises(SystemExit):
        tree_compare.parse_args(["--dwconv", "--tail-only", "build/parent"])


def test_tree_compare_dwconv_shapes_are_the_gated_stages():
    """--dwconv times ConvNeXt-T's gated stages 0-2 at the training batch
    and 224 px, as chip_smoke.py's phase 15 does, whose tiles divide the
    maps (no padding tile), and holds the outputs to chip_smoke.py's
    tolerances."""
    assert tree_compare.DW_SHAPES == [(chip_smoke.TRAIN_BATCH, side, side, C)
                                      for side, C in chip_smoke.DW_STAGES]
    for B, H, W, C in tree_compare.DW_SHAPES:
        p = tdw.dwconv_plan(B, H, W, C, torch.bfloat16, 132)
        assert C <= tdw.MAX_C and H % p.tile == 0 and W % p.tile == 0
    assert tree_compare.DW_TOL == {k: chip_smoke.TOL[f"dw_{k}"] for k in ("y", "dx", "dw", "db")}


@pytest.mark.parametrize("name", list(dwconv_variants.VARIANTS))
def test_dwconv_variants_patch_lines_of_the_source(name):
    """Every line or region a dwconv variant replaces is in csrc/dwconv.cu
    (patch raises otherwise), every variant but the kernels as built
    changes it, and a variant that builds other blocks per SM hands the
    wrapper a plan for them."""
    from revisiting_at_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "dwconv.cu").read_text()
    subs, plan = dwconv_variants.VARIANTS[name]
    out = dwconv_variants.patch(src, subs, name)
    assert (out == src) == (name == "as built")
    builds_blocks = any(old in (dwconv_variants._FWD_BLOCKS, dwconv_variants._WGRAD_BLOCKS)
                        for old, _ in subs)
    assert builds_blocks == bool(plan)
