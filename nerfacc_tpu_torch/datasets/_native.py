"""ctypes bindings of the native ray sampler (``csrc/rayforge.cpp``).

Port of ``nerfacc_tpu/datasets/_native.py``.  The JAX package loads
``native/librayforge.so`` when someone has built it and takes its numpy path
otherwise; the port builds its copy with ``g++`` at first use into
``build/nerfacc_tpu_torch/`` (``ops/_build.py``) and has no other path for a
training batch over images: a failed build raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..ops import _build

_lib = None


def get_lib() -> ctypes.CDLL:
    """The sampler's library, built on the first call."""
    global _lib
    if _lib is None:
        lib = _build.load("rayforge")
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.rayforge_sample_rays.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            f32p, f32p, f32p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int,
            f32p, f32p, f32p,
        ]
        lib.rayforge_image_rays.argtypes = [
            ctypes.c_int64, ctypes.c_int64, f32p, f32p, ctypes.c_int, f32p, f32p,
        ]
        lib.rayforge_num_threads.restype = ctypes.c_int
        _lib = lib
    return _lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def sample_rays(
    images: np.ndarray,  # (n, h, w, c) uint8, c in {3, 4}
    c2w: np.ndarray,  # (n, 3 or 4, 4) float32
    K: np.ndarray,  # (3, 3) float32
    bkgd: np.ndarray,  # (3,) float32
    seed: int,
    n_rays: int,
    opengl: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A training batch of ``n_rays`` over the images: ``(origins,
    viewdirs, pixels)``, each float32 ``(n_rays, 3)``.  Ray ``i`` takes its
    image and pixel from splitmix64 draws of ``seed`` and ``i``, its pixel
    composited over ``bkgd`` where the images have alpha."""
    lib = get_lib()
    if images.dtype != np.uint8 or images.ndim != 4 or images.shape[-1] not in (3, 4):
        raise ValueError(f"sample_rays takes (n, h, w, 3|4) uint8 images, not {images.dtype} {images.shape}")
    if not images.flags.c_contiguous:
        # The loaders hold their images contiguous; a copy here would cost a
        # pass over the whole stack on every batch.
        raise ValueError("sample_rays takes C-contiguous images")
    c2w34 = np.ascontiguousarray(c2w[:, :3, :4], np.float32).reshape(-1, 12)
    Kf = np.ascontiguousarray(K, np.float32).reshape(9)
    bk = np.ascontiguousarray(bkgd, np.float32)
    n, h, w, c = images.shape
    out_o, out_d, out_p = (np.empty((n_rays, 3), np.float32) for _ in range(3))
    lib.rayforge_sample_rays(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w, c,
        _f32p(c2w34), _f32p(Kf), _f32p(bk), ctypes.c_uint64(seed & (2**64 - 1)), n_rays, int(opengl),
        _f32p(out_o), _f32p(out_d), _f32p(out_p),
    )
    return out_o, out_d, out_p


def image_rays(h: int, w: int, c2w: np.ndarray, K: np.ndarray, opengl: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Every pixel's ray of one ``(3 or 4, 4)`` pose, row-major: ``(origins,
    viewdirs)``, each float32 ``(h * w, 3)``."""
    lib = get_lib()
    m = np.ascontiguousarray(np.asarray(c2w)[:3, :4], np.float32).reshape(12)
    Kf = np.ascontiguousarray(K, np.float32).reshape(9)
    out_o, out_d = (np.empty((h * w, 3), np.float32) for _ in range(2))
    lib.rayforge_image_rays(h, w, _f32p(m), _f32p(Kf), int(opengl), _f32p(out_o), _f32p(out_d))
    return out_o, out_d


def num_threads() -> int:
    """OpenMP's thread count for the sampler."""
    return int(get_lib().rayforge_num_threads())


def image_ids(seed: int, n_rays: int, n_images: int) -> np.ndarray:
    """Each ray's image in :func:`sample_rays`'s batch for ``seed``: the
    splitmix64 draw of ``rayforge.cpp``, in numpy
    (``nerfacc_tpu/datasets/nerf_synthetic.py:117-126``)."""
    i = np.arange(n_rays, dtype=np.uint64)
    x = (np.uint64(seed) ^ (i * np.uint64(0x9E3779B97F4A7C15))) + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(n_images)).astype(np.int64)
