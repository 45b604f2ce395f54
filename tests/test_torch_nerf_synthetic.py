"""The NeRF-Synthetic loader and the PNG reader and writer of the port.

``SubjectLoader`` against ``nerfacc_tpu.datasets.nerf_synthetic`` on the
same images and seed, both loaders pinned to their numpy path (the native
sampler's batches are held in ``tests/test_torch_native.py``): the batches
must be the same numbers.  The PNG reader is held against
``imageio`` on the committed fixture, on images that ``imageio`` writes
(its encoder picks a filter per row) and on rows encoded here with each of
the five filters.
"""

import io
import os
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

import nerfacc_tpu.datasets._native as jnative
from nerfacc_tpu.datasets.nerf_synthetic import SubjectLoader as JLoader
from nerfacc_tpu_torch.datasets import png
from nerfacc_tpu_torch.datasets.nerf_synthetic import SubjectLoader as TLoader

ROOT = os.path.join(os.path.dirname(__file__), "fixtures", "nerf_synthetic_tiny")
FIXTURE_PNGS = [os.path.join(ROOT, "lego", p) for p in ("train/r_0.png", "train/r_1.png", "test/r_0.png")]


@pytest.fixture
def numpy_path(monkeypatch):
    """Both loaders' numpy path: the JAX loader's wherever its native
    library is built, the port's instead of its native sampler."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(TLoader, "NATIVE_SAMPLER", False)


def _arrays(seed=0, n=3, h=12, w=10):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, h, w, 4), dtype=np.uint8)
    c2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    c2w[:, :3, 3] = rng.normal(size=(n, 3)).astype(np.float32) * 3
    return dict(images=images, camtoworlds=c2w, focal=11.5)


def _same_batch(t, j):
    np.testing.assert_array_equal(t["rays"].origins.numpy(), np.asarray(j["rays"].origins))
    np.testing.assert_array_equal(t["rays"].viewdirs.numpy(), np.asarray(j["rays"].viewdirs))
    np.testing.assert_array_equal(t["pixels"].numpy(), np.asarray(j["pixels"]))
    np.testing.assert_array_equal(t["color_bkgd"].numpy(), np.asarray(j["color_bkgd"]))


@pytest.mark.parametrize("aug", ["white", "black", "random"])
def test_train_batches_match_jax(numpy_path, aug):
    kw = dict(split="train", num_rays=64, color_bkgd_aug=aug, near=1.3, far=3.7, seed=3, **_arrays())
    jl, tl = JLoader(**kw), TLoader(**kw, device="cpu")
    assert len(tl) == len(jl) == 3
    for step in range(4):
        _same_batch(tl[step % 3], jl[step % 3])
    tl.update_num_rays(32)
    jl.update_num_rays(32)
    t, j = tl[0], jl[0]
    assert t["pixels"].shape == (32, 3)
    _same_batch(t, j)


def test_train_batches_of_one_image_match_jax(numpy_path):
    kw = dict(split="trainval", num_rays=40, batch_over_images=False, **_arrays(1))
    jl, tl = JLoader(**kw), TLoader(**kw, device="cpu")
    _same_batch(tl[2], jl[2])


@pytest.mark.parametrize("aug", ["white", "random"])
def test_eval_batches_match_jax(numpy_path, aug):
    kw = dict(split="test", color_bkgd_aug=aug, **_arrays(2))
    jl, tl = JLoader(**kw), TLoader(**kw, device="cpu")
    t, j = tl[1], jl[1]
    assert t["rays"].origins.shape == (12, 10, 3) and t["pixels"].shape == (12, 10, 3)
    _same_batch(t, j)


def test_subject_loader_disk_fixture(numpy_path):
    # tests/test_datasets.py:121 on the port, and against the JAX loader.
    train = TLoader(subject_id="lego", root_fp=ROOT, split="train", num_rays=64, color_bkgd_aug="random",
                    device="cpu")
    assert len(train) == 2 and train.WIDTH == 16 and train.HEIGHT == 16
    batch = train[0]
    assert batch["rays"].origins.shape == (64, 3)
    assert batch["pixels"].shape == (64, 3)
    d = batch["rays"].viewdirs.numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    o = batch["rays"].origins.numpy()
    cams = train.camtoworlds[:, :3, 3]
    dist = np.linalg.norm(o[:, None] - cams[None], axis=-1).min(axis=1)
    np.testing.assert_allclose(dist, 0.0, atol=1e-5)
    jtrain = JLoader(subject_id="lego", root_fp=ROOT, split="train", num_rays=64, color_bkgd_aug="random")
    np.testing.assert_array_equal(train.images, jtrain.images)
    assert train.focal == jtrain.focal
    _same_batch(batch, jtrain[0])

    test = TLoader(subject_id="lego", root_fp=ROOT, split="test", device="cpu")
    assert test[0]["pixels"].shape == (16, 16, 3)
    _same_batch(test[0], JLoader(subject_id="lego", root_fp=ROOT, split="test")[0])


def test_loader_refuses_unknown_split_and_background():
    with pytest.raises(ValueError, match="split"):
        TLoader(split="holdout", device="cpu", **_arrays())
    with pytest.raises(ValueError, match="color_bkgd_aug"):
        TLoader(split="train", color_bkgd_aug="grey", device="cpu", **_arrays())


@pytest.mark.parametrize("path", FIXTURE_PNGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_read_png_matches_imageio_on_the_fixture(path):
    np.testing.assert_array_equal(png.read_png(path), imageio.imread(path))


def _smooth_image(rng, h, w, c):
    # Gradients with noise, so that imageio's encoder picks several filters.
    yy, xx = np.mgrid[:h, :w]
    base = np.sin(xx / 5.0) * 90 + yy * 2 + rng.integers(0, 25, (h, w))
    img = (base[..., None] + 37 * np.arange(c)) % 256
    return img.astype(np.uint8)


@pytest.mark.parametrize("shape", [(23, 17, 3), (19, 31, 4), (64, 48, 4), (9, 13, 1)],
                         ids=["rgb", "rgba", "rgba-64x48", "grey"])
def test_read_png_matches_imageio_on_what_imageio_writes(shape):
    rng = np.random.default_rng(sum(shape))
    img = _smooth_image(rng, *shape)
    if shape[-1] == 1:
        img = img[..., 0]
    buf = io.BytesIO()
    imageio.imwrite(buf, img, format="png")
    data = buf.getvalue()
    np.testing.assert_array_equal(png.decode_png(data), img)
    np.testing.assert_array_equal(png.decode_png(data), imageio.imread(data))


def _filter_row(kind, cur, prev, bpp):
    """The PNG encoder's filter ``kind`` of one row (PNG spec section 9)."""
    cur, prev = cur.astype(np.int32), prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(cur)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (left + prev) // 2
    else:
        p = left + prev - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
    return ((cur - pred) % 256).astype(np.uint8)


def _png_bytes(img, kinds):
    h, w, c = img.shape
    rows, prev = [], np.zeros(w * c, np.uint8)
    for r in range(h):
        cur = img[r].reshape(-1)
        rows.append(bytes([kinds[r]]) + _filter_row(kinds[r], cur, prev, c).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_undoes_each_filter(kind, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (11, 9, channels), dtype=np.uint8)
    kinds = [r % 5 for r in range(11)] if kind == "mixed" else [kind] * 11
    data = _png_bytes(img, kinds)
    want = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(imageio.imread(data), want)
    np.testing.assert_array_equal(png.decode_png(data), want)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_png_round_trips(tmp_path, channels):
    rng = np.random.default_rng(10 + channels)
    img = rng.integers(0, 256, (7, 5, channels), dtype=np.uint8)
    want = img[..., 0] if channels == 1 else img
    path = str(tmp_path / "img.png")
    png.write_png(path, want)
    np.testing.assert_array_equal(png.read_png(path), want)
    np.testing.assert_array_equal(imageio.imread(path), want)


def test_png_refuses_what_it_does_not_read():
    header = bytearray(_png_bytes(np.zeros((2, 2, 3), np.uint8), [0, 0]))
    header[24] = 16  # bit depth
    with pytest.raises(ValueError, match="8-bit"):
        png.decode_png(bytes(header))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(20))
    bad = bytearray(_png_bytes(np.zeros((2, 2, 3), np.uint8), [0, 0]))
    raw = bytes([7]) + bytes(6) + bytes([0]) + bytes(6)  # row filter 7
    body = zlib.compress(raw)
    idat = struct.pack(">I", len(body)) + b"IDAT" + body + struct.pack(">I", zlib.crc32(b"IDAT" + body))
    end = struct.pack(">I", 0) + b"IEND" + struct.pack(">I", zlib.crc32(b"IEND"))
    with pytest.raises(ValueError, match="filter 7"):
        png.decode_png(bytes(bad[:33]) + idat + end)
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(np.zeros((2, 2, 3), np.float32))
