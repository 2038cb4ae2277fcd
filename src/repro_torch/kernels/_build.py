"""Build the CUDA sources in ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into
``build/kernels/lib<name>.so`` at the repository root (listed in
``.gitignore``) and exposes a plain C interface, so no PyTorch header is
compiled: a build takes seconds.  Nothing is built at import; the first
launch of a kernel builds it, and ``build_all()`` builds every source at
once, one ``nvcc`` process per source, all started together.  Each
process builds into a file of its own and renames it into place, so the
ranks of a multi-process run, which build together, never load a
library another one is still writing.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
BUILD_LOG: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _start(name: str) -> subprocess.Popen:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(_own(name)),
                             str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(name: str, proc: subprocess.Popen, t0: float) -> None:
    log, _ = proc.communicate()
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    out = BUILD_DIR / f"lib{name}.so"
    os.replace(_own(name), out)
    _LIBS[name] = ctypes.CDLL(str(out))


def _own(name: str) -> pathlib.Path:
    """This process's build output, renamed to ``lib<name>.so`` once
    whole."""
    return BUILD_DIR / f"lib{name}.{os.getpid()}.so"


def build_all(names) -> None:
    """Compile every named source in parallel and load the libraries."""
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in names if n not in _LIBS}
    for n, p in procs.items():
        _finish(n, p, t0)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build_all([name])
    return _LIBS[name]
