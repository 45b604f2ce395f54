"""The port's COLMAP reader and ``similarity_from_cameras`` against the JAX
package's.

The sparse models are written by this file's own writers (the layout of
``tests/test_datasets.py:13-38``, extended to every camera model and to the
``.txt`` files), read by both packages, and must agree exactly; the
similarity transform, float64 on both sides, is held at rtol 1e-12.
"""

import struct

import numpy as np
import pytest

from nerfacc_tpu.datasets import colmap as jcolmap
from nerfacc_tpu.datasets.nerf_360_v2 import similarity_from_cameras as j_similarity
from nerfacc_tpu_torch.datasets import colmap as tcolmap
from nerfacc_tpu_torch.datasets.nerf_360_v2 import similarity_from_cameras as t_similarity

MODEL_IDS = {name: i for i, (name, _) in tcolmap.CAMERA_MODELS.items()}


def write_cameras_bin(path, cams):
    """``cams``: {id: (model, width, height, params)}."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam_id, (model, w, h, params) in cams.items():
            f.write(struct.pack("<iiQQ", cam_id, MODEL_IDS[model], w, h))
            f.write(struct.pack(f"<{len(params)}d", *params))


def write_images_bin(path, images):
    """``images``: {id: (name, camera id, qvec, tvec)}; each with two 2D
    points, which the readers skip."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for img_id, (name, cam_id, qvec, tvec) in images.items():
            f.write(struct.pack("<I", img_id))
            f.write(struct.pack("<4d", *qvec))
            f.write(struct.pack("<3d", *tvec))
            f.write(struct.pack("<I", cam_id))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ddq", 1.5, 2.5, -1) * 2)


def write_cameras_txt(path, cams):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        for cam_id, (model, w, h, params) in cams.items():
            f.write(f"{cam_id} {model} {w} {h} " + " ".join(repr(float(p)) for p in params) + "\n")


def write_images_txt(path, images):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n#\n")
        for img_id, (name, cam_id, qvec, tvec) in images.items():
            vals = " ".join(repr(float(v)) for v in (*qvec, *tvec))
            f.write(f"{img_id} {vals} {cam_id} {name}\n")
            f.write("1.5 2.5 -1 10.0 20.0 3\n")


def _cameras(rng):
    """One camera of each of the 11 models, random parameters."""
    return {
        i + 1: (name, int(rng.integers(100, 2000)), int(rng.integers(100, 2000)), rng.normal(size=n) * 100)
        for i, (name, n) in sorted(tcolmap.CAMERA_MODELS.items())
    }


def _images(rng, n=5, n_cams=11):
    out = {}
    for i in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        out[10 + i] = (f"img_{i:03d}.jpg", int(rng.integers(1, n_cams + 1)), q, rng.normal(size=3))
    return out


def _same_model(t, j):
    tc, ti = t
    jc, ji = j
    assert tc.keys() == jc.keys() and ti.keys() == ji.keys()
    for k in tc:
        assert (tc[k].model, tc[k].width, tc[k].height) == (jc[k].model, jc[k].width, jc[k].height)
        np.testing.assert_array_equal(tc[k].params, jc[k].params)
    for k in ti:
        assert (ti[k].name, ti[k].camera_id) == (ji[k].name, ji[k].camera_id)
        np.testing.assert_array_equal(ti[k].qvec, ji[k].qvec)
        np.testing.assert_array_equal(ti[k].tvec, ji[k].tvec)


def test_bin_round_trip(tmp_path):
    # tests/test_datasets.py:40's checks on the port, then every model.
    cams = {1: ("PINHOLE", 800, 600, np.array([500.0, 510.0, 400.0, 300.0]))}
    imgs = {
        1: ("a.png", 1, np.array([1.0, 0, 0, 0]), np.array([0.0, 0, 1])),
        2: ("b.png", 1, np.array([0.9238795, 0, 0.3826834, 0]), np.array([1.0, 2, 3])),
    }
    write_cameras_bin(tmp_path / "cameras.bin", cams)
    write_images_bin(tmp_path / "images.bin", imgs)
    rcams, rimgs = tcolmap.load_sparse(str(tmp_path))
    assert rcams[1].model == "PINHOLE"
    np.testing.assert_allclose(rcams[1].K[0, 0], 500.0)
    np.testing.assert_allclose(rcams[1].K[1, 2], 300.0)
    assert rimgs[1].name == "a.png"
    np.testing.assert_allclose(rimgs[2].tvec, [1, 2, 3])
    np.testing.assert_allclose(rimgs[1].R(), np.eye(3), atol=1e-12)
    R = rimgs[2].R()
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-7)

    rng = np.random.default_rng(0)
    cams, imgs = _cameras(rng), _images(rng)
    write_cameras_bin(tmp_path / "cameras.bin", cams)
    write_images_bin(tmp_path / "images.bin", imgs)
    t = tcolmap.load_sparse(str(tmp_path))
    _same_model(t, jcolmap.load_sparse(str(tmp_path)))
    for k, (model, w, h, params) in cams.items():
        assert (t[0][k].model, t[0][k].width, t[0][k].height) == (model, w, h)
        np.testing.assert_array_equal(t[0][k].params, params)
    assert [t[1][k].name for k in sorted(t[1])] == [imgs[k][0] for k in sorted(imgs)]


def test_txt_readers(tmp_path):
    rng = np.random.default_rng(1)
    cams, imgs = _cameras(rng), _images(rng, n=4)
    write_cameras_txt(tmp_path / "cameras.txt", cams)
    write_images_txt(tmp_path / "images.txt", imgs)
    t = tcolmap.load_sparse(str(tmp_path))  # no .bin: the .txt files
    _same_model(t, jcolmap.load_sparse(str(tmp_path)))
    for k, (name, cam_id, q, tv) in imgs.items():
        assert (t[1][k].name, t[1][k].camera_id) == (name, cam_id)
        np.testing.assert_array_equal(t[1][k].qvec, q)
        np.testing.assert_array_equal(t[1][k].tvec, tv)
    # The .bin files win where both are present, as in JAX.
    write_cameras_bin(tmp_path / "cameras.bin", {1: cams[2]})
    write_images_bin(tmp_path / "images.bin", {7: imgs[10]})
    t = tcolmap.load_sparse(str(tmp_path))
    assert list(t[0]) == [1] and list(t[1]) == [7]


@pytest.mark.parametrize("model", [name for _, (name, _) in sorted(tcolmap.CAMERA_MODELS.items())])
def test_intrinsics_and_distortion_of_each_model_match_jax(model):
    n = dict(tcolmap.CAMERA_MODELS.values())[model]
    params = np.random.default_rng(len(model)).normal(size=n) * 300
    t = tcolmap.Camera(model, 640, 480, params)
    j = jcolmap.Camera(model, 640, 480, params)
    np.testing.assert_array_equal(t.K, j.K)
    np.testing.assert_array_equal(t.distortion, j.distortion)
    assert t.K.dtype == np.float64 and t.K[2, 2] == 1.0


def test_rotation_and_world_to_camera_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(16):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        tv = rng.normal(size=3)
        t = tcolmap.Image("x", 1, q, tv)
        j = jcolmap.Image("x", 1, q, tv)
        np.testing.assert_array_equal(t.R(), j.R())
        np.testing.assert_array_equal(t.w2c(), j.w2c())
        np.testing.assert_allclose(t.R() @ t.R().T, np.eye(3), atol=1e-12)


def _rig(rng, n, flipped=False):
    """``n`` random camera-to-world matrices; with ``flipped`` every
    camera's y axis is world -y, so their mean up direction (-y) is world
    +y, opposite camera space's up, and ``c`` is -1: the transform's other
    branch."""
    c2w = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        if flipped:
            a = rng.uniform(0, 2 * np.pi)
            # y axis (0, -1, 0), x and z in the horizontal plane.
            c2w[i, :3, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, -1.0, 0], [np.sin(a), 0, -np.cos(a)]])
        else:
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            c2w[i, :3, :3] = jcolmap.Image("x", 1, q, np.zeros(3)).R()
        c2w[i, :3, 3] = rng.normal(size=3) * 3 + 1.0
    return c2w


@pytest.mark.parametrize("strict", [False, True], ids=["median", "max"])
@pytest.mark.parametrize("flipped", [False, True], ids=["c>-1", "c=-1"])
def test_similarity_from_cameras_matches_jax(strict, flipped):
    rng = np.random.default_rng(3 + 2 * strict + flipped)
    for n in (3, 8, 25):
        c2w = _rig(rng, n, flipped)
        Tt, st = t_similarity(c2w, strict_scaling=strict)
        Tj, sj = j_similarity(c2w, strict_scaling=strict)
        np.testing.assert_allclose(Tt, Tj, rtol=1e-12, atol=0)
        np.testing.assert_allclose(st, sj, rtol=1e-12)
        if flipped:
            np.testing.assert_array_equal(Tt[:3, :3], np.diag([-1.0, 1.0, 1.0]))
        out = np.einsum("nij, ki -> nkj", c2w, Tt)
        out[:, :3, 3] *= st
        dist = np.linalg.norm(out[:, :3, 3], axis=-1)
        # The median (or max) camera distance is 1 after the transform.
        assert (dist.max() if strict else np.median(dist)) == pytest.approx(1.0, rel=1e-12)
