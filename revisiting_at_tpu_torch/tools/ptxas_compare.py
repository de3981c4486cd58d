"""Compare the ptxas reports of two builds of the port's kernels.

    python3 -m revisiting_at_tpu_torch.tools.ptxas_compare [--rename OLD=NEW ...] OLD_DIR NEW_DIR

Each directory is a build/kernels/ that ops/cuda_build.py filled: beside each
library lib<name>_<hash>.so lies its ptxas report, <library>.ptxas.txt. For
every library in both, every kernel compiled in both is compared on its
registers, stack frame, spill stores and spill loads; the kernels found in
only one build are listed. --rename OLD=NEW matches the old build's kernel
OLD with the new build's NEW (a kernel kept under a new name). Exits 1 if a
kernel in both differs.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

_LIB = re.compile(r"lib(.+)_[0-9a-f]{12}\.so\.ptxas\.txt$")
_FUNC = re.compile(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
# nvcc names an anonymous namespace after the file and a hash that changes
# from build to build: _ZN45_GLOBAL__N__a9690f21_12_block_mlp_cu_058fe1ae10...
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def parse(report: str) -> dict[str, dict[str, int]]:
    """{kernel: {registers, stack, spill_stores, spill_loads}} from a report."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in report.splitlines():
        if m := _FUNC.search(line):
            name = _ANON.sub("12_GLOBAL__N_1", m.group(1))
            out.setdefault(name, {})
        elif name and (m := _STACK.search(line)):
            out[name].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        elif name and (m := _REGS.search(line)):
            out[name]["registers"] = int(m[1])
    return {k: v for k, v in out.items() if "registers" in v}


def reports(build_dir: Path, renames: dict[str, str] | None = None
            ) -> dict[str, dict[str, dict[str, int]]]:
    """{library: parse(report)}, each kernel named in `renames` (an
    identifier of its mangled name, as 10fwd_kernel) given the new name."""
    out = {}
    for path in sorted(build_dir.glob("*.ptxas.txt")):
        if m := _LIB.match(path.name):
            kernels = parse(path.read_text())
            for a, b in (renames or {}).items():
                kernels = {k.replace(f"{len(a)}{a}I", f"{len(b)}{b}I"): v
                           for k, v in kernels.items()}
            out[m[1]] = kernels
    return out


def demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt")
    if not tool or not names:
        return names
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    return res.stdout.splitlines() if res.returncode == 0 else names


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    renames = {}
    while len(argv) > 2 and argv[0] == "--rename" and "=" in argv[1]:
        a, b = argv[1].split("=", 1)
        renames[a] = b
        argv = argv[2:]
    if len(argv) != 2:
        raise SystemExit(__doc__.split("\n\n")[1].strip())
    old, new = reports(Path(argv[0]), renames), reports(Path(argv[1]))
    differ = 0
    for lib in sorted(set(old) | set(new)):
        a, b = old.get(lib, {}), new.get(lib, {})
        common = sorted(set(a) & set(b))
        changed = [k for k in common if a[k] != b[k]]
        differ += len(changed)
        print(f"lib{lib}: {len(common)} kernels in both builds, {len(changed)} differ; "
              f"{len(set(a) - set(b))} only in the old, {len(set(b) - set(a))} only in the new")
        for k, shown in zip(changed, demangle(changed)):
            print(f"  differs: {shown}: old {a[k]}, new {b[k]}")
        for tag, only in (("old", sorted(set(a) - set(b))), ("new", sorted(set(b) - set(a)))):
            for k, shown in zip(only, demangle(only)):
                print(f"  only in the {tag}: {shown}: {(a if tag == 'old' else b)[k]}")
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())
