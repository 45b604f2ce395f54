"""A small PNG reader and writer on ``zlib``, for the dataset loader and the
render CLI.

The JAX package reads and writes PNGs with ``imageio``
(``nerfacc_tpu/datasets/nerf_synthetic.py:25-41``, ``examples/render.py``);
the port needs neither ``imageio`` nor ``PIL``.  :func:`read_png` takes
non-interlaced 8-bit grey, RGB and RGBA images with any of the five row
filters, and refuses anything else.  :func:`write_png` writes 8-bit grey,
RGB or RGBA with filter 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: grey, RGB, RGBA.
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length  # length, type, body, CRC


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, width: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-row filters (PNG spec section 9) on ``(height, 1 + width
    * bpp)`` bytes; returns ``(height, width, bpp)`` uint8.

    A pixel's prediction reads its left, upper and upper-left neighbours,
    all on earlier anti-diagonals, so the rows are rebuilt one anti-diagonal
    at a time, each with its own row's filter: ``height + width - 1`` vector
    steps instead of one step a pixel.
    """
    rows = raw.reshape(height, 1 + width * bpp)
    kinds = rows[:, 0].astype(np.int32)
    bad = np.flatnonzero(kinds > 4)
    if bad.size:
        raise ValueError(f"{path}: unknown PNG row filter {kinds[bad[0]]} in row {bad[0]}")
    if not kinds.any():  # every row unfiltered, as write_png writes them
        return rows[:, 1:].reshape(height, width, bpp).copy()
    lines = rows[:, 1:].reshape(height, width, bpp).astype(np.int32)
    # A zero row above and a zero column to the left, as the filters assume.
    buf = np.zeros((height + 1, width + 1, bpp), np.int32)
    for k in range(height + width - 1):
        r = np.arange(max(0, k - width + 1), min(height - 1, k) + 1)
        c = k - r
        left, up, up_left = buf[r + 1, c], buf[r, c + 1], buf[r, c]
        kind = kinds[r][:, None]
        pred = np.select(
            [kind == 1, kind == 2, kind == 3, kind == 4],
            [left, up, (left + up) >> 1, _paeth(left, up, up_left)],
            0,
        )
        buf[r + 1, c + 1] = (lines[r, c] + pred) & 0xFF
    return buf[1:, 1:].astype(np.uint8)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Decode PNG bytes into ``(H, W)`` (grey) or ``(H, W, C)`` uint8, as
    ``imageio`` returns them."""
    if data[: len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise ValueError(
            f"{path}: only 8-bit grey, RGB and RGBA PNGs are read "
            f"(bit depth {depth}, colour type {color})"
        )
    if compression != 0 or filtering != 0 or interlace != 0:
        raise ValueError(f"{path}: only non-interlaced PNGs with the standard filters are read")
    channels = _CHANNELS[color]
    stride = width * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + stride):
        raise ValueError(f"{path}: PNG image data of {raw.size} bytes, expected {height * (1 + stride)}")
    img = _unfilter(raw, height, width, channels, path)
    return img[..., 0] if channels == 1 else img


def read_png(path: str) -> np.ndarray:
    """Read a PNG file (see :func:`decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 ``(H, W)``, ``(H, W, 1)``, ``(H, W, 3)`` or
    ``(H, W, 4)`` image, every row with filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1|3|4) images, not {img.shape}")
    height, width, channels = img.shape
    rows = np.concatenate(
        [np.zeros((height, 1), np.uint8), np.ascontiguousarray(img).reshape(height, -1)], axis=1
    )
    header = struct.pack(">IIBBBBB", width, height, 8, _COLOR_TYPE[channels], 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 image as a PNG file (see :func:`encode_png`)."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
