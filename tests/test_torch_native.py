"""The port's native ray sampler (``csrc/rayforge.cpp`` through
``datasets/_native.py``) against the JAX package's (``native/rayforge.cpp``
through ``nerfacc_tpu.datasets._native``).

The JAX library is built here from ``native/rayforge.cpp`` with its
Makefile's flags into a temporary directory, and ``_native``'s lookup is
pointed there, so nothing is written into the repository; both samplers
must give the same bits.  Then ``tests/test_native.py``'s geometry checks on
the port, and the NeRF-Synthetic and D-NeRF loaders' training batches
through both native paths, timestamps included.  A build that fails raises
with the compiler's output.
"""

import ctypes
import shlex
import subprocess
from pathlib import Path

import numpy as np
import pytest

import nerfacc_tpu.datasets._native as jnative
from nerfacc_tpu.datasets.dnerf_synthetic import SubjectLoader as JDynLoader
from nerfacc_tpu.datasets.nerf_synthetic import SubjectLoader as JLoader
from nerfacc_tpu_torch.datasets import _native as tnative
from nerfacc_tpu_torch.datasets.dnerf_synthetic import SubjectLoader as TDynLoader
from nerfacc_tpu_torch.datasets.nerf_synthetic import SubjectLoader as TLoader
from nerfacc_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]


def _makefile_flags() -> list:
    for line in (REPO / "native" / "Makefile").read_text().splitlines():
        if line.startswith("CXXFLAGS"):
            return shlex.split(line.split("=", 1)[1])
    raise AssertionError("native/Makefile has no CXXFLAGS")


def _build_jax_library(out_dir: Path, extra=()) -> Path:
    so = out_dir / "librayforge.so"
    cmd = ["g++", *_makefile_flags(), *extra, "-o", str(so), str(REPO / "native" / "rayforge.cpp")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return so


def _pointed_at(mp, so):
    mp.setattr(jnative, "_find_lib", lambda: str(so))
    mp.setattr(jnative, "_LIB", None)
    mp.setattr(jnative, "_TRIED", False)
    assert jnative.available()
    return jnative


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's ``_native`` on a library built from
    ``native/rayforge.cpp`` outside the repository, with the Makefile's
    flags and ``-ffp-contract=off``, as the port builds its copy: the
    Makefile's ``-march=native`` lets GCC fuse multiply-adds where the
    machine has FMA, which moves the rays by an ulp (see
    :func:`test_the_makefiles_own_build_differs_only_by_fused_multiply_adds`)."""
    so = _build_jax_library(tmp_path_factory.mktemp("rayforge"), ["-ffp-contract=off"])
    with pytest.MonkeyPatch.context() as mp:
        yield _pointed_at(mp, so)


def _scene(rng, n=4, h=12, w=20, c=4):
    images = rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)
    c2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        c2w[i, :3, :3] = q.astype(np.float32)
    c2w[:, :3, 3] = rng.normal(size=(n, 3)).astype(np.float32) * 3
    K = np.array([[17.5, 0, w / 2], [0, 16.25, h / 2], [0, 0, 1]], np.float32)
    return images, c2w, K


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("opengl", [True, False])
def test_sample_rays_matches_the_jax_library_bit_for_bit(jax_native, channels, opengl):
    rng = np.random.default_rng(channels + 2 * opengl)
    images, c2w, K = _scene(rng, c=channels)
    bkgd = rng.random(3).astype(np.float32)
    for seed in (0, 42, 2**63 - 5):
        got = tnative.sample_rays(images, c2w, K, bkgd, seed, 1000, opengl)
        want = jax_native.sample_rays(images, c2w, K, bkgd, seed, 1000, opengl)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == (1000, 3)
            np.testing.assert_array_equal(g, w)


def test_image_rays_and_threads_match_the_jax_library(jax_native):
    rng = np.random.default_rng(5)
    _, c2w, K = _scene(rng, n=1)
    lib = jax_native.get_lib()
    f32p = ctypes.POINTER(ctypes.c_float)
    m = np.ascontiguousarray(c2w[0, :3, :4]).reshape(12)
    for opengl in (True, False):
        o, d = tnative.image_rays(12, 20, c2w[0], K, opengl)
        wo, wd = np.empty((240, 3), np.float32), np.empty((240, 3), np.float32)
        lib.rayforge_image_rays(12, 20, m.ctypes.data_as(f32p), K.reshape(9).ctypes.data_as(f32p), int(opengl),
                                wo.ctypes.data_as(f32p), wd.ctypes.data_as(f32p))
        np.testing.assert_array_equal(o, wo)
        np.testing.assert_array_equal(d, wd)
    assert tnative.num_threads() == jax_native.get_lib().rayforge_num_threads() >= 1


def test_the_makefiles_own_build_differs_only_by_fused_multiply_adds(tmp_path):
    # native/Makefile builds with -march=native, under which GCC contracts
    # the direction's dot products and the pixel's compositing into FMAs on
    # a machine that has them: the same rays and pixels within about an ulp
    # (1.79e-07 of a unit direction, 5.96e-08 of a pixel, measured on an
    # x86 host with FMA), the origins and image ids exact.
    with pytest.MonkeyPatch.context() as mp:
        j = _pointed_at(mp, _build_jax_library(tmp_path))
        rng = np.random.default_rng(11)
        images, c2w, K = _scene(rng, n=6, h=40, w=60)
        bkgd = rng.random(3).astype(np.float32)
        for opengl in (True, False):
            (o, d, p), (wo, wd, wp) = (f.sample_rays(images, c2w, K, bkgd, 9, 20000, opengl) for f in (tnative, j))
            np.testing.assert_array_equal(o, wo)
            np.testing.assert_allclose(d, wd, rtol=0, atol=2.4e-7)
            np.testing.assert_allclose(p, wp, rtol=0, atol=6e-8)


def test_native_rays_geometry():
    # tests/test_native.py:17 on the port.
    rng = np.random.default_rng(0)
    n_imgs, h, w = 3, 16, 16
    images = rng.integers(0, 255, (n_imgs, h, w, 4), dtype=np.uint8)
    c2w = np.zeros((n_imgs, 3, 4), np.float32)
    c2w[:, :3, :3] = np.eye(3)
    c2w[:, :3, 3] = rng.random((n_imgs, 3))
    K = np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)
    bkgd = np.ones(3, np.float32)
    o, d, pix = tnative.sample_rays(images, c2w, K, bkgd, 42, 256, True)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    assert all(np.isclose(o[i], c2w[:, :3, 3], atol=1e-6).all(axis=-1).any() for i in range(16))
    assert pix.min() >= 0.0 and pix.max() <= 1.0
    o2, d2, pix2 = tnative.sample_rays(images, c2w, K, bkgd, 42, 256, True)
    np.testing.assert_array_equal(pix, pix2)
    np.testing.assert_array_equal(o, o2)
    # Each ray's pixel is its image's, at the ray's own direction: rebuild
    # the pixel from the direction (identity rotation, OpenGL camera).
    ids = tnative.image_ids(42, 256, n_imgs)
    px = np.rint(d[:, 0] / -d[:, 2] * 20.0 + 8 - 0.5).astype(int)
    py = np.rint(-d[:, 1] / -d[:, 2] * 20.0 + 8 - 0.5).astype(int)
    rgba = images[ids, py, px].astype(np.float32) / 255.0
    want = rgba[:, :3] * rgba[:, 3:] + bkgd * (1 - rgba[:, 3:])
    np.testing.assert_allclose(pix, want, atol=1e-6)


def test_native_image_id_reconstruction():
    # tests/test_native.py:46 on the port's loader.
    n_imgs, h, w = 4, 8, 8
    images = np.stack([np.full((h, w, 4), 60 * i + 40, np.uint8) for i in range(n_imgs)])
    images[..., 3] = 255
    c2w = np.zeros((n_imgs, 3, 4), np.float32)
    c2w[:, :3, :3] = np.eye(3)
    loader = TLoader(split="train", num_rays=128, images=images, camtoworlds=c2w, focal=10.0,
                     color_bkgd_aug="black", device="cpu")
    batch = loader.fetch_data(0)
    expect = (60 * np.asarray(loader._last_image_id) + 40) / 255.0
    np.testing.assert_allclose(batch["pixels"].numpy()[:, 0], expect, atol=1e-6)


def _same_batch(t, j):
    np.testing.assert_array_equal(t["rays"].origins.numpy(), np.asarray(j["rays"].origins))
    np.testing.assert_array_equal(t["rays"].viewdirs.numpy(), np.asarray(j["rays"].viewdirs))
    np.testing.assert_array_equal(t["pixels"].numpy(), np.asarray(j["pixels"]))
    np.testing.assert_array_equal(t["color_bkgd"].numpy(), np.asarray(j["color_bkgd"]))


@pytest.mark.parametrize("aug", ["white", "black", "random"])
def test_nerf_synthetic_batches_through_both_native_paths(jax_native, aug):
    rng = np.random.default_rng(7)
    images, c2w, _ = _scene(rng, n=5, h=14, w=11)
    kw = dict(split="train", num_rays=96, color_bkgd_aug=aug, images=images, camtoworlds=c2w, focal=9.5, seed=4)
    jl, tl = JLoader(**kw), TLoader(**kw, device="cpu")
    for step in range(3):
        _same_batch(tl[step], jl[step])
        np.testing.assert_array_equal(tl._last_image_id, jl._last_image_id)


def test_dnerf_batches_and_timestamps_through_both_native_paths(jax_native):
    rng = np.random.default_rng(8)
    images, c2w, _ = _scene(rng, n=6, h=10, w=13)
    ts = np.linspace(0.0, 1.0, 6).astype(np.float32)
    kw = dict(split="train", num_rays=64, color_bkgd_aug="random", images=images, camtoworlds=c2w, focal=8.0,
              timestamps=ts, seed=2)
    jl, tl = JDynLoader(**kw), TDynLoader(**kw, device="cpu")
    for step in range(3):
        t, j = tl[step], jl[step]
        _same_batch(t, j)
        assert t["timestamps"].shape == (64, 1)
        np.testing.assert_array_equal(t["timestamps"].numpy(), np.asarray(j["timestamps"]))
    # Eval views take the numpy path on both sides.
    kw.update(split="test", num_rays=None)
    t, j = TDynLoader(**kw, device="cpu")[1], JDynLoader(**kw)[1]
    _same_batch(t, j)
    np.testing.assert_array_equal(t["timestamps"].numpy(), np.asarray(j["timestamps"]))


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    (tmp_path / "rayforge.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match=r"rayforge\.cpp \(g\+\+ exit [1-9]") as info:
        tnative.sample_rays(*_scene(np.random.default_rng(0)), np.ones(3, np.float32), 0, 8, True)
    assert "error" in str(info.value)
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.load("rayforge")
