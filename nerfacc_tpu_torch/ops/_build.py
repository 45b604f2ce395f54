"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` on its own into ``build/nerfacc_tpu_torch/<name>-<hash>.so``, where
the hash covers the source, the shared headers and the flags, so an edited
source is rebuilt and an unchanged one is not.  Several sources build in
parallel: one ``nvcc`` process each, all started together.

Nothing here runs at import: the build happens when a CUDA tensor first
reaches a kernel (or when :func:`build` is called), so importing the package
needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerfacc_tpu_torch"

# --fmad=false: no FMA contraction, so a kernel does the same float
# arithmetic, rounded at the same places, as its plain PyTorch version.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA toolkit is needed to build the port's kernels"
        )
    return path


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Optional[Iterable[str]] = None) -> None:
    """Compile the named kernel sources (default: all) that are not built."""
    names = kernel_names() if names is None else list(names)
    jobs = []
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, building it first
    if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        lib.nerfacc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.nerfacc_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C launch function returned a CUDA error code."""
    if rc != 0:
        msg = lib.nerfacc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
