"""The port's Mip-NeRF 360 loader against the JAX package's, and the port's
CLIs on a COLMAP capture.

A tiny capture is written here: a ring of inward-facing OpenCV cameras
(PINHOLE, ``sparse/0/cameras.bin`` and ``images.bin``), PIL-encoded JPEGs in
``images/``, ``images_2/`` and ``images_4/``.  The JAX loader (``imageio``)
and the port's (its own JPEG decoder) must agree on ``K``, the cameras
(atol 1e-6), the every-8th split, the images, and the batches under each
background mode.  The port's two CLIs build ``nerf_360_v2.SubjectLoader``
for a 360 scene; the JAX CLIs open the same folder with the NeRF-Synthetic
loader and fail (``ROADMAP.md``, Queue 3).
"""

import importlib.util
import io
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from nerfacc_tpu.datasets.nerf_360_v2 import SubjectLoader as JLoader
from nerfacc_tpu_torch.datasets import nerf_360_v2
from nerfacc_tpu_torch.datasets.nerf_360_v2 import SubjectLoader as TLoader
from nerfacc_tpu_torch.examples import train_ngp_nerf_occ as occ_cli
from nerfacc_tpu_torch.examples import train_ngp_nerf_prop as prop_cli

REPO = Path(__file__).resolve().parents[1]
SCENE = "garden"
N_VIEWS, WIDTH, HEIGHT = 10, 64, 48  # two test views (0 and 8)


def qvec_from_rotation(R):
    """COLMAP's (w, x, y, z) of a rotation matrix."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = np.copysign(np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2, R[2, 1] - R[1, 2])
    y = np.copysign(np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2, R[0, 2] - R[2, 0])
    z = np.copysign(np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2, R[1, 0] - R[0, 1])
    return np.array([w, x, y, z])


def ring_c2w(n, radius=3.0, seed=0):
    """``n`` OpenCV cameras (x right, y down, z forward) on a ring about the
    origin, world up +z, each looking at the origin."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        pos = np.array([radius * np.cos(a), radius * np.sin(a), rng.uniform(0.3, 1.2)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        m = np.eye(4)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, down, fwd, pos
        out.append(m)
    return np.stack(out)


def write_capture(root: Path, seed=0) -> np.ndarray:
    """The capture under ``root / SCENE``; returns the cameras (c2w)."""
    scene = root / SCENE
    (scene / "sparse" / "0").mkdir(parents=True)
    c2w = ring_c2w(N_VIEWS, seed=seed)
    focal = 0.8 * WIDTH
    with open(scene / "sparse" / "0" / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, WIDTH, HEIGHT))  # PINHOLE
        f.write(struct.pack("<4d", focal, focal * 1.01, WIDTH / 2, HEIGHT / 2))
    # COLMAP's images in another order than their names.
    order = np.random.default_rng(seed + 1).permutation(N_VIEWS)
    with open(scene / "sparse" / "0" / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", N_VIEWS))
        for img_id, i in enumerate(order, start=1):
            R = c2w[i, :3, :3].T
            f.write(struct.pack("<I", img_id))
            f.write(struct.pack("<4d", *qvec_from_rotation(R)))
            f.write(struct.pack("<3d", *(-R @ c2w[i, :3, 3])))
            f.write(struct.pack("<I", 1))
            f.write(f"IMG_{i:04d}.JPG".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    rng = np.random.default_rng(seed + 2)
    for factor in (1, 2, 4):
        d = scene / ("images" if factor == 1 else f"images_{factor}")
        d.mkdir()
        h, w = HEIGHT // factor, WIDTH // factor
        for i in range(N_VIEWS):
            yy, xx = np.mgrid[:h, :w]
            img = (np.sin(xx / 3.0 + i)[..., None] * 90 + yy[..., None] * 3 + rng.integers(0, 40, (h, w, 3)) + 60)
            buf = io.BytesIO()
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, format="JPEG", quality=90)
            # The downsampled folders may name their files otherwise.
            (d / (f"IMG_{i:04d}.JPG" if factor == 1 else f"img_{i:04d}.jpg")).write_bytes(buf.getvalue())
    return c2w


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("360_v2")
    return root, write_capture(root)


def test_the_writer_round_trips_the_cameras(capture):
    root, c2w = capture
    from nerfacc_tpu_torch.datasets.colmap import load_sparse

    _, images = load_sparse(str(root / SCENE / "sparse" / "0"))
    for im in images.values():
        i = int(im.name[4:8])
        np.testing.assert_allclose(np.linalg.inv(im.w2c()), c2w[i], atol=1e-12)


@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("split", ["train", "test"])
def test_loader_matches_jax(capture, split, factor):
    root, _ = capture
    kw = dict(subject_id=SCENE, root_fp=str(root), split=split, factor=factor)
    t, j = TLoader(**kw, device="cpu"), JLoader(**kw)
    np.testing.assert_array_equal(t.K, j.K)
    assert t.K.dtype == np.float32 and t.K[0, 0] == np.float32(0.8 * WIDTH / factor)
    np.testing.assert_allclose(t.camtoworlds, j.camtoworlds, rtol=0, atol=1e-6)
    assert t.camtoworlds.dtype == np.float32 and t.camtoworlds.shape == (len(j), 4, 4)
    assert len(t) == len(j) == {"train": 8, "test": 2}[split]
    assert t.images.dtype == np.uint8 and t.images.shape == (len(j), HEIGHT // factor, WIDTH // factor, 3)
    np.testing.assert_array_equal(t.images, j.images)
    assert (t.WIDTH, t.HEIGHT) == (j.WIDTH, j.HEIGHT)
    # The normalisation: the median camera distance of the whole capture is 1.
    all_c2w = np.concatenate([TLoader(**dict(kw, split=s), device="cpu").camtoworlds for s in ("train", "test")])
    assert np.median(np.linalg.norm(all_c2w[:, :3, 3], axis=-1)) == pytest.approx(1.0, abs=1e-6)


def _same_batch(t, j):
    np.testing.assert_array_equal(t["rays"].origins.numpy(), np.asarray(j["rays"].origins))
    np.testing.assert_array_equal(t["rays"].viewdirs.numpy(), np.asarray(j["rays"].viewdirs))
    np.testing.assert_array_equal(t["pixels"].numpy(), np.asarray(j["pixels"]))
    np.testing.assert_array_equal(t["color_bkgd"].numpy(), np.asarray(j["color_bkgd"]))


@pytest.mark.parametrize("aug", ["white", "black", "random"])
def test_batches_match_jax(capture, aug):
    root, _ = capture
    kw = dict(subject_id=SCENE, root_fp=str(root), color_bkgd_aug=aug, factor=4, seed=5)
    t = TLoader(split="train", num_rays=77, **kw, device="cpu")
    j = JLoader(split="train", num_rays=77, **kw)
    for step in range(3):
        bt, bj = t[step], j[step]
        assert bt["rays"].origins.shape == (77, 3) and bt["pixels"].shape == (77, 3)
        _same_batch(bt, bj)
    one = dict(kw, batch_over_images=False)
    _same_batch(TLoader(split="train", num_rays=20, **one, device="cpu")[3], JLoader(split="train", num_rays=20, **one)[3])
    t, j = TLoader(split="test", **kw, device="cpu"), JLoader(split="test", **kw)
    bt = t[1]
    assert bt["rays"].origins.shape == (HEIGHT // 4, WIDTH // 4, 3) and bt["pixels"].shape == (HEIGHT // 4, WIDTH // 4, 3)
    _same_batch(bt, j[1])


def test_loader_refuses_other_cameras_factors_and_a_missing_card(tmp_path, monkeypatch):
    write_capture(tmp_path)
    with pytest.raises(ValueError, match="factor"):
        TLoader(SCENE, str(tmp_path), "train", factor=3, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLoader(SCENE, str(tmp_path), "train")  # the default device is the card
    cams = tmp_path / SCENE / "sparse" / "0" / "cameras.bin"
    data = bytearray(cams.read_bytes())
    data[12:16] = struct.pack("<i", 4)  # OPENCV: 8 parameters
    cams.write_bytes(bytes(data[:32]) + struct.pack("<8d", *range(8)))
    with pytest.raises(ValueError, match="pinhole"):
        TLoader(SCENE, str(tmp_path), "train", device="cpu")


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("cli", ["train_ngp_nerf_occ", "train_ngp_nerf_prop"])
def test_the_clis_load_a_360_scene_and_the_jax_clis_fail_on_it(capture, cli, monkeypatch):
    root, _ = capture
    argv = ["--scene", SCENE, "--data_root", str(root)]
    port = {"train_ngp_nerf_occ": occ_cli, "train_ngp_nerf_prop": prop_cli}[cli]
    if port is occ_cli:
        # Shrink the grid and the field: the loaders do not depend on them.
        monkeypatch.setattr(occ_cli, "build_config", lambda scene, real=occ_cli.build_config: dict(
            real(scene), grid_resolution=16))
        argv_port = argv + ["--levels", "2", "--log2t", "12"]
    else:
        argv_port = argv
    out = port.setup(port.parse_args(argv_port + ["--device", "cpu"]))
    train_ds, test_ds = out[1], out[2]
    assert isinstance(train_ds, nerf_360_v2.SubjectLoader) and isinstance(test_ds, nerf_360_v2.SubjectLoader)
    # Upstream nerfacc's arguments: factor 4 for both splits, a random
    # background for training.
    assert (train_ds.WIDTH, train_ds.HEIGHT, test_ds.WIDTH) == (WIDTH // 4, HEIGHT // 4, WIDTH // 4)
    assert train_ds.color_bkgd_aug == "random" and train_ds.training and not test_ds.training
    assert (len(train_ds), len(test_ds)) == (8, 2)
    # The JAX example opens the same folder with the NeRF-Synthetic loader.
    monkeypatch.syspath_prepend(str(REPO / "examples"))
    monkeypatch.setattr(sys, "argv", [cli] + argv + ["--cpu"])
    with pytest.raises(FileNotFoundError, match="transforms_train.json"):
        _jax_example(cli).main()


def test_two_cpu_steps_of_the_occupancy_cli_on_the_capture(capture, monkeypatch):
    root, _ = capture
    # The CLI's unbounded block (4 levels, near 0.2, step 1e-3, cone 0.004,
    # alpha_thre 1e-2, the dynamic ray count) with a res-16 grid, 2 hash
    # levels, at most 512 rays and 8 x 16384 traversal slots.
    monkeypatch.setattr(occ_cli, "build_config", lambda scene, real=occ_cli.build_config: dict(
        real(scene), grid_resolution=16, target_sample_batch_size=256 * 64, traversal_capacity=8 * 256 * 64))
    args = occ_cli.parse_args(["--scene", SCENE, "--data_root", str(root), "--device", "cpu", "--num_rays", "512",
                               "--levels", "2", "--log2t", "12", "--max_steps", "2"])
    run, train_ds, test_ds, chunk = occ_cli.setup(args)
    cfg = run.cfg
    assert (cfg["grid_nlvl"], cfg["near_plane"], cfg["alpha_thre"], cfg["cone_angle"], cfg["unbounded"]) == (
        4, 0.2, 1e-2, 0.004, True)
    assert cfg["dynamic_rays"] and cfg["num_rays"] == 512 and train_ds.num_rays == 512  # min(512, 1024)
    losses, n_samples = occ_cli.train(run, train_ds, 2)
    assert run.step == 2 and len(losses) == 2
    assert all(np.isfinite(float(v)) for v in losses) and all(0 < int(n) <= 256 * 64 for n in n_samples)
    traversed, visible, unslotted = (int(v) for v in run.sample_counts)
    assert visible <= traversed and unslotted == 0
    # A chunk whose traversal finds more than its 64 slots a ray renders
    # again with room for all: the same image as one chunk with room for all.
    rays = test_ds[0]["rays"]
    small, large = occ_cli.render_image(run, rays, 16), occ_cli.render_image(run, rays, 256)
    assert small.shape == (HEIGHT // 4, WIDTH // 4, 3) and bool(torch.isfinite(small).all())
    np.testing.assert_allclose(small.numpy(), large.numpy(), rtol=0, atol=1e-5)
    # Past the traversal's most slots a chunk renders in parts.
    monkeypatch.setitem(run.cfg, "traversal_capacity", 2048)
    parts = occ_cli.render_image(run, rays, 16)
    np.testing.assert_allclose(parts.numpy(), large.numpy(), rtol=0, atol=1e-5)
    monkeypatch.setitem(run.cfg, "dynamic_rays", False)  # the fixed 16 x 64 slots leave rays empty
    assert float((occ_cli.render_image(run, rays, 16) - large).abs().max()) > 1e-2


class _Loader:
    def __init__(self, n):
        self.num_rays = n

    def update_num_rays(self, n):
        self.num_rays = n


@pytest.mark.parametrize("traversed, visible, n, rays, slots", [
    (4000, 2000, 1024, 409, 2048),  # the survivors bind: 0.8 * 1000 / 2000 * 1024 rays
    (16000, 100, 1024, 819, 16000),  # the traversal's most slots bind: 0.8 * 16000 / (16000 / 1024)
    (400, 100, 1024, 8192, 4096),  # room for more: num_rays, and slots for them
    (10**9, 10**9, 1024, occ_cli.MIN_RAYS, 16000),  # at least MIN_RAYS
])
def test_the_dynamic_ray_count_follows_the_survivors_within_the_traversal(traversed, visible, n, rays, slots):
    cfg = dict(target_sample_batch_size=1000, traversal_capacity=16000, num_rays=8192)
    run = occ_cli.Run(cfg=cfg, field=None, estimator=None, occ_state=None, opt=None, schedule=None, generator=None,
                      sample_counts=torch.tensor([traversed, visible, 0]))
    loader = _Loader(n)
    occ_cli.fit_num_rays(run, loader)
    assert (loader.num_rays, run.traversal_slots) == (rays, slots)
