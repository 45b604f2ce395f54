"""The port's JPEG decoder (``csrc/jpeg_decode.cpp`` through
``datasets/jpeg.py``) against ``imageio.v2.imread``.

imageio decodes with PIL on libjpeg-turbo at its defaults, which the
decoder reproduces (the accurate integer IDCT, fancy upsampling, the
fixed-point YCbCr tables), so every case is held bit for bit: PIL encodes at
qualities 50, 75 and 95, in 4:4:4, 4:2:2, 4:2:0, grey and RGB (Adobe
transform 0), with and without optimised Huffman tables and restart
intervals, at sizes that are not multiples of 16 (1x1 and 3x5 included,
where the upsampling replicates instead of interpolating).  The committed
fixtures under ``tests/fixtures/jpeg/`` (written by ``make_fixtures.py``
there) must decode to their committed arrays; what the decoder refuses
raises a ``ValueError`` naming the file.
"""

import glob
import io
import os

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from nerfacc_tpu_torch.datasets import jpeg, png

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "fixtures", "jpeg", "*.jpg")))
SIZES = [(37, 29), (17, 131), (48, 64), (100, 77), (3, 5), (1, 1), (2, 9)]


def _pattern(h, w, c, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.sin(xx / 7.0) * 80 + np.cos(yy / 5.0) * 40 + 100 + rng.integers(0, 60, (h, w))
    img = ((base[..., None] + 53 * np.arange(c)) % 256).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _encode(img, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, "L" if img.ndim == 2 else "RGB").save(buf, format="JPEG", **opts)
    return buf.getvalue()


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("kind", ["444", "422", "420", "grey", "rgb"])
def test_decode_matches_imageio(kind, quality):
    opts = dict(quality=quality)
    if kind == "rgb":
        opts.update(subsampling=0, keep_rgb=True)  # Adobe transform 0: no colour conversion
    elif kind != "grey":
        opts.update(subsampling={"444": 0, "422": 1, "420": 2}[kind])
    n = 0
    for i, (h, w) in enumerate(SIZES):
        img = _pattern(h, w, 1 if kind == "grey" else 3, seed=i + quality)
        for extra in ({}, {"optimize": True}, {"restart_marker_blocks": 3}, {"restart_marker_rows": 1}):
            data = _encode(img, **opts, **extra)
            if "restart_marker_blocks" in extra and h * w > 64:
                assert b"\xff\xdd" in data and b"\xff\xd0" in data
            want = imageio.imread(data)
            got = jpeg.decode_jpeg(data)
            assert got.dtype == np.uint8 and got.shape == want.shape, (h, w, extra)
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} q{quality} {h}x{w} {extra}")
            n += 1
    assert n == 4 * len(SIZES)


def test_decode_of_a_capture_sized_view_matches_imageio():
    # A Mip-NeRF 360 view at factor 4 is about 1297 x 840.
    img = _pattern(840, 1297, 3, seed=7)
    data = _encode(img, quality=95, subsampling=2)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), imageio.imread(data))


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_committed_fixtures_decode_to_their_arrays(path):
    want = np.load(path[: -len(".jpg")] + ".npy")
    np.testing.assert_array_equal(jpeg.read_jpeg(path), want)
    np.testing.assert_array_equal(jpeg.read_image(path), want)
    np.testing.assert_array_equal(imageio.imread(path), want)


def test_fixtures_cover_each_sampling_and_a_restart_interval():
    names = [os.path.basename(p) for p in FIXTURES]
    assert len(names) == 5
    for word in ("yuv444", "yuv422", "yuv420", "grey", "rst"):
        assert any(word in n for n in names), word
    for p in FIXTURES:
        h, w = np.load(p[: -len(".jpg")] + ".npy").shape[:2]
        assert h % 16 and w % 16


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` after ``marker`` set to ``value``."""
    out = bytearray(data)
    out[data.index(marker) + offset] = value
    return bytes(out)


def test_refuses_what_it_does_not_decode(tmp_path):
    img = _pattern(24, 40, 3, seed=1)
    cases = {
        "progressive": _encode(img, progressive=True),
        "arithmetic-coded": _patched(_encode(img), b"\xff\xc0", 1, 0xC9),  # SOF9
        "lossless": _patched(_encode(img), b"\xff\xc0", 1, 0xC3),
        "12-bit": _patched(_encode(img), b"\xff\xc0", 4, 12),  # the precision byte
    }
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, format="JPEG")
    cases["four-component"] = buf.getvalue()
    for word, data in cases.items():
        path = tmp_path / f"{word}.jpg"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=word) as info:
            jpeg.read_jpeg(str(path))
        assert str(path) in str(info.value)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x00" * 16, "x.jpg")
    data = _encode(img)
    for cut in (200, len(data) - 40):  # in a table, in the scan
        with pytest.raises(ValueError, match="end of file"):
            jpeg.decode_jpeg(data[:cut], "cut.jpg")


def test_read_image_dispatches_on_the_magic_bytes(tmp_path):
    img = _pattern(13, 21, 3, seed=2)
    png.write_png(str(tmp_path / "a.jpg"), img)  # a PNG whatever its name
    (tmp_path / "b.png").write_bytes(_encode(img, quality=90))  # a JPEG
    (tmp_path / "c.png").write_bytes(b"GIF89a" + bytes(20))
    np.testing.assert_array_equal(jpeg.read_image(str(tmp_path / "a.jpg")), img)
    np.testing.assert_array_equal(jpeg.read_image(str(tmp_path / "b.png")), imageio.imread(tmp_path / "b.png"))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        jpeg.read_image(str(tmp_path / "c.png"))
