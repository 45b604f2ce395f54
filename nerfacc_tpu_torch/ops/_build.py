"""Build the port's CUDA kernels and host libraries at first use and load
them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` on its own into ``build/nerfacc_tpu_torch/<name>-<hash>.so``, where
the hash covers the source, the shared headers and the flags, so an edited
source is rebuilt and an unchanged one is not.  Each ``csrc/<name>.cpp`` (the
host code of the data layer: the JPEG decoder and the ray sampler) is
compiled the same way by ``g++``.  Several sources build in parallel: one
compiler process each, all started together.  A failed build raises with
the compiler's output; nothing falls back to another path.

Nothing here runs at import: the build happens when a CUDA tensor first
reaches a kernel, or a loader first needs a host library (or when
:func:`build` is called), so importing the package needs neither ``nvcc``,
``g++`` nor a card.
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
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
)
NVCC_FLAGS = COMPILE_FLAGS + ("-shared", "-Xcompiler", "-fPIC")
# Host sources; -ffp-contract=off keeps GCC from fusing multiply-adds, so
# the float arithmetic is the one the source spells (as --fmad=false does
# for the kernels).
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")
HOST_EXTRA_FLAGS = {"rayforge": ("-fopenmp",)}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA toolkit is needed to build the port's kernels"
        )
    return path


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH; it builds the port's host libraries (csrc/*.cpp)")
    return path


def _source(name: str) -> Path:
    """``csrc/<name>.cu`` for a kernel, ``csrc/<name>.cpp`` for host code."""
    src = CSRC / f"{name}.cu"
    return src if src.exists() else CSRC / f"{name}.cpp"


def _flags(name: str) -> tuple:
    if _source(name).suffix == ".cu":
        return NVCC_FLAGS
    return HOST_FLAGS + HOST_EXTRA_FLAGS.get(name, ())


def _target(name: str) -> Path:
    src = _source(name)
    h = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def host_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cpp"))


def build(names: Optional[Iterable[str]] = None) -> None:
    """Compile the named sources (default: every kernel) that are not built."""
    names = kernel_names() if names is None else list(names)
    jobs = []
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        src = _source(name)
        compiler = _nvcc() if src.suffix == ".cu" else _cxx()
        cmd = [compiler, *_flags(name), "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((src.name, so, tmp, proc, Path(compiler).name))
    failed = []
    for src_name, so, tmp, proc, compiler in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{src_name} ({compiler} exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` says of each kernel in ``csrc/<name>.cu`` (registers,
    shared memory, spills), from a separate compile to a cubin with the
    library's flags."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = BUILD_DIR / f"{name}.{os.getpid()}.cubin"
    cmd = [_nvcc(), *COMPILE_FLAGS, "-cubin", "-Xptxas", "-v", "-o", str(cubin), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cubin.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}.cu (nvcc -Xptxas -v exit {proc.returncode}):\n{proc.stdout}")
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` or ``.cpp``,
    building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        if _source(name).suffix == ".cu":
            lib.nerfacc_cuda_error_string.argtypes = [ctypes.c_int]
            lib.nerfacc_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C launch function returned a CUDA error code."""
    if rc != 0:
        msg = lib.nerfacc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
