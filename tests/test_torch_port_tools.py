"""The port's measurement scripts (revisiting_at_tpu_torch/tools/), on the
CPU: the ptxas report parser and comparison, and the slice counts the
weight-pass sweep tries. Neither needs a GPU for what is checked here.
"""

import pytest

from revisiting_at_tpu_torch.ops import block_mlp as tbm
from revisiting_at_tpu_torch.tools import ptxas_compare, wgrad_slices

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
