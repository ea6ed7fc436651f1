"""Build the CUDA kernels of `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/kernels/lib<name>_<hash>.so` at the
repository root, compiled for sm_90a as a shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC [per-kernel flags] -o lib<name>_<hash>.so <name>.cu

The hash covers the source and the flags, so an edited source is rebuilt
and an unchanged one is reused.  Nothing here runs at import time: the
first wrapper call on a CUDA tensor builds its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"

_BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# score.cu, warp.cu, sor.cu, match.cu: no FMA contraction, so every pixel's result is
# bit-identical to the plain PyTorch version's on the card (see the notes in
# the sources).
_EXTRA_FLAGS = {"score": ["-fmad=false"], "lm_iter": [],
                "warp": ["-fmad=false"], "sor": ["-fmad=false"],
                "median": [], "zbuffer": [], "match": ["-fmad=false"]}
SOURCES = tuple(f"{name}.cu" for name in _EXTRA_FLAGS)

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_path(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    flags = _BASE_FLAGS + _EXTRA_FLAGS[name]
    digest = hashlib.sha256(source_path(name).read_bytes()
                            + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu; None if the library is up to date."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc()] + _BASE_FLAGS + _EXTRA_FLAGS[name] + [
        "-o", tmp, str(source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    BUILD_LOG[name] = proc.communicate()[0]
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{BUILD_LOG[name]}")
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def build_all() -> float:
    """Build every kernel library (the nvcc runs in parallel) and load it;
    returns the seconds it took."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in _EXTRA_FLAGS}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
    for name in _EXTRA_FLAGS:
        load(name)
    return time.perf_counter() - t0


def check(err: int, what: str) -> None:
    """Raise if a C launcher returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
