"""Build and load the port's hand-written CUDA kernels (csrc/, sm_90a).

Each source in `SOURCES` is compiled by nvcc into a shared library with a
plain C interface, bound with ctypes by the module that launches it
(ops/block_mlp.py, ops/attention.py, ops/dwconv.py). `build()` compiles
every source at once, one nvcc process each, all started together, into
build/kernels/; a library is named by the hash of its source, the headers
and the flags, so it is built once per version. Nothing here runs at
import: the CPU tests import every module, and the CPU has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# one shared library per source
SOURCES = {"block_mlp": CSRC / "block_mlp.cu", "block_mlp_bwd": CSRC / "block_mlp_bwd.cu",
           "attention": CSRC / "attention.cu", "dwconv": CSRC / "dwconv.cu"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -Xptxas -v: registers, shared memory and spills per kernel, kept beside the library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


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


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build() -> dict[str, Path]:
    """Compile every source that has no library yet, all nvcc processes
    started together. Returns {name: shared library}; ptxas's report is
    kept beside each library as <library>.ptxas.txt."""
    libs = {name: library_path(name) for name in SOURCES}
    todo = [(name, out) for name, out in libs.items() if not out.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
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


def launch(t, fn, *args) -> int:
    """fn(*args, stream) for a kernel on t's device: stream is the raw handle
    of that device's current stream (no torch.cuda.Stream is built, which
    would cost more host time than the launch), and the device context is
    entered only when t's device is not the current one. The device is read
    as an index (`get_device`), not as a torch.device: on the H100's host
    the two device objects and `torch.cuda.current_device()` took more time
    than the ctypes call itself. Every ctypes launch of the port goes
    through here; returns fn's error code."""
    index = t.get_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


def load(name: str, signatures: dict[str, list]) -> dict[str, ctypes._CFuncPtr]:
    """The C entry points of library `name` (every library is built at the
    first load), with their argument types set and an int return."""
    with _lock:
        if not _loaded:
            _loaded.update({n: ctypes.CDLL(str(p)) for n, p in build().items()})
        fns = {}
        for fn_name, argtypes in signatures.items():
            fn = getattr(_loaded[name], fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[fn_name] = fn
        return fns
