"""Build and load the port's CUDA kernels.

Each source under ``ops/csrc/`` compiles with ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, into ``build/torch_kernels/`` at the root of the
checkout (git-ignored), and is cached by a hash of the source and the
flags: a changed source builds anew, an unchanged one loads the library
already there.  Only the repository's own sources are compiled.

Nothing here runs when the module is imported: the CPU tests import
every module of the port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# Kernel name -> source file under csrc/.
SOURCES = {
    "fused_popcount": "fused_popcount.cu",
    "delta_scatter": "delta_scatter.cu",
    "bsi_ripple": "bsi_ripple.cu",
    "score_planes": "score_planes.cu",
    "anchored_count": "anchored_count.cu",
    "expand_payload": "expand_payload.cu",
    "tree_eval": "tree_eval.cu",
    "interp": "interp.cu",
    "stream_sum": "stream_sum.cu",
    "mesh_topn": "mesh_topn.cu",
    "top_k": "top_k.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


class KernelBuildError(RuntimeError):
    pass


_mu = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelBuildError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start_build(name: str, nvcc: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _lib_path(name)
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile every named kernel (all by default) that has no library
    for its current source yet — one ``nvcc`` per source, all started
    together — and return ``{name: seconds}`` for the ones built."""
    names = list(SOURCES) if names is None else names
    with _mu:
        missing = [n for n in names if not _lib_path(n).exists()]
        if not missing:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        jobs = {n: _start_build(n, nvcc) for n in missing}
        took: dict[str, float] = {}
        errors = []
        for n, (proc, tmp, out) in jobs.items():
            log, _ = proc.communicate()
            took[n] = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, out)
        if errors:
            raise KernelBuildError("\n".join(errors))
        return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _mu:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
