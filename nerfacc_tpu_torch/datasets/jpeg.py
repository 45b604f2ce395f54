"""A JPEG reader of the port's own, and :func:`read_image` for PNG or JPEG.

The JAX package reads the Mip-NeRF 360 captures with ``imageio``
(``nerfacc_tpu/datasets/nerf_360_v2.py:73,108``), which the port does not
need.  The decoder is host C++ (``csrc/jpeg_decode.cpp``), built by ``g++``
at first use into ``build/nerfacc_tpu_torch/`` and called through ctypes: a
capture holds hundreds of megapixels, too many for a decoder in Python.  It
takes baseline and extended sequential Huffman-coded JPEG with 8-bit
samples, one or three components, sampling factors up to 2x2 and restart
intervals, and gives the bytes that ``imageio.v2.imread`` gives (PIL on
libjpeg-turbo at its defaults: the accurate integer IDCT, fancy upsampling,
the fixed-point YCbCr tables).  Progressive, lossless, arithmetic-coded,
12-bit and CMYK files raise a ``ValueError`` naming the file.  If the
library cannot be built, the call raises with the compiler's output; there
is no other decoder to fall back to.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build
from .png import decode_png

_SIGNATURE_PNG = b"\x89PNG\r\n\x1a\n"
_SIGNATURE_JPEG = b"\xff\xd8\xff"
_ERR_LEN = 256
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("jpeg_decode")
        u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
        lib.jpeg_header.argtypes = [u8p, ctypes.c_int64, i32p, i32p, i32p, ctypes.c_char_p, ctypes.c_int]
        lib.jpeg_decode.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    return _lib


def decode_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """The image in ``data``: ``(H, W, 3)`` uint8 RGB, or ``(H, W)`` grey."""
    lib = _library()
    buf = np.frombuffer(data, np.uint8)
    src = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    err = ctypes.create_string_buffer(_ERR_LEN)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_header(src, buf.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c), err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, np.uint8)
    if lib.jpeg_decode(src, buf.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size, err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def read_image(path: str) -> np.ndarray:
    """A PNG or JPEG file as uint8 ``(H, W[, C])``, by its first bytes."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_SIGNATURE_PNG):
        return decode_png(data, path)
    if data.startswith(_SIGNATURE_JPEG):
        return decode_jpeg(data, path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")
