"""Build the port's native sources and load them with ctypes.

Each source in `deepsee_torch/csrc/` is compiled on first use into its own
shared library with a plain C interface: the CUDA kernels (`*.cu`) with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC --split-compile=0 -o lib<name>.so <name>.cu

and the host image codec (`codec.cpp`, a copy of deepsee_tpu/native/codec.cpp)
with the flags of deepsee_tpu/native/Makefile:

    g++ -O3 -Wall -Wextra -fPIC -std=c++17 -ffp-contract=off -shared \
        -o libcodec.so codec.cpp -ljpeg -lpng -lz

into `deepsee_torch/_build/<hash>/`, where the hash covers every source and
the flags, so an edited source rebuilds and an unchanged one is reused.  The
sources asked for compile at once, one compiler process each, and each
`nvcc` optimizes its kernels on as many threads as the host has
(`--split-compile=0`).  Nothing here
runs at import time: the CPU tests import every module on machines without
nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--split-compile=0")
# -ffp-contract=off: the codec's float32 normalize rounds like numpy's (no FMA)
GXX_FLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared")
GXX_LIBS = ("-ljpeg", "-lpng", "-lz")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host codec builds only where a C++ compiler "
                           "is installed")
    return gxx


def _command(src: Path, out: Path) -> List[str]:
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [_gxx(), *GXX_FLAGS, "-o", str(out), str(src), *GXX_LIBS]


def sources() -> Dict[str, Path]:
    """{name: source} of every CUDA and C++ source in csrc/."""
    return {src.stem: src for src in sorted(CSRC.iterdir()) if src.suffix in (".cu", ".cpp")}


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + GXX_FLAGS + GXX_LIBS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile each named source that has no library yet, all at once;
    return {name: library}.  Raises with the compiler's output if one fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = sources()
    libs = {name: out_dir / f"lib{name}.so" for name in names}
    procs = []
    try:
        for name, lib in libs.items():
            if lib.exists():
                continue
            # one temporary per process and thread: a concurrent build
            # never writes into this one's file
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            procs.append((name, tmp, lib, subprocess.Popen(
                _command(srcs[name], tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, tmp, lib, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{Path(proc.args[0]).name} failed on {srcs[name].name}:\n{log}")
                continue
            os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs


def build_all() -> Dict[str, Path]:
    """Compile every CUDA kernel source without a library yet; return
    {name: library}."""
    return build(name for name, src in sources().items() if src.suffix == ".cu")


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu or .cpp, building it if needed."""
    return ctypes.CDLL(str(build([name])[name]))
