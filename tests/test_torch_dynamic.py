"""The dynamic procedural scene and the D-NeRF loader: the port's
``datasets/procedural.py`` (``scene_rgb_density_t``, ``make_dynamic_loaders``)
and ``datasets/dnerf_synthetic.py`` against ``nerfacc_tpu.datasets``.

As for the static scene (``tests/test_torch_procedural.py``), the poses are
bit-equal and the renders may put a uint8 value one step apart where it
sits on a rounding edge.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.datasets import procedural as jproc
import nerfacc_tpu.datasets._native as jnative
from nerfacc_tpu.datasets.dnerf_synthetic import SubjectLoader as JLoader
from nerfacc_tpu_torch.datasets import procedural as tproc
from nerfacc_tpu_torch.datasets.dnerf_synthetic import SubjectLoader as TLoader
from nerfacc_tpu_torch.datasets.png import write_png


@pytest.mark.parametrize("t", [0.0, 0.3, 0.75, 1.0])
def test_scene_rgb_density_t_matches_jax(t):
    x = np.random.default_rng(0).uniform(-1.0, 1.0, (4096, 3)).astype(np.float32)
    rgb_j, sigma_j = (np.asarray(a) for a in jproc.scene_rgb_density_t(jnp.asarray(x), jnp.float32(t)))
    rgb_t, sigma_t = tproc.scene_rgb_density_t(torch.from_numpy(x), t)
    assert (sigma_j > 0).mean() > 0.05
    # atol 1e-5 and rtol 1e-5: the same float32 terms (colours in [0, 1],
    # densities up to 60) about centres that the two packages' cos and sin
    # may turn an ulp apart (1e-6 relative measured).
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sigma_t.numpy(), sigma_j, rtol=1e-5, atol=1e-5)
    # A time a point, as the T-NeRF occupancy probe would ask: the same as
    # one call at that time.
    ts = torch.full((4096,), t)
    per_point = tproc.scene_rgb_density_t(torch.from_numpy(x), ts)
    torch.testing.assert_close(per_point[1], sigma_t, rtol=0, atol=0)


def test_the_scene_moves_with_time():
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1.0, 1.0, (2048, 3)).astype(np.float32))
    s0, s1 = tproc.scene_rgb_density_t(x, 0.0)[1], tproc.scene_rgb_density_t(x, 0.25)[1]
    assert float((s0 - s1).abs().max()) > 1.0


def test_make_dynamic_loaders_match_jax():
    # tests/test_datasets.py:107's settings.
    kw = dict(num_rays=32, width=24, height=24, n_train=3, n_test=1)
    j_train, j_test = jproc.make_dynamic_loaders(**kw)
    t_train, t_test = tproc.make_dynamic_loaders(**kw, device="cpu")
    for a, b in ((t_train, j_train), (t_test, j_test)):
        np.testing.assert_array_equal(a.camtoworlds, b.camtoworlds)
        np.testing.assert_array_equal(a.timestamps, b.timestamps)
        assert a.images.dtype == np.uint8 and a.images.shape == b.images.shape
        assert (a.near, a.far, a.focal) == (b.near, b.far, b.focal)
        diff = np.abs(a.images.astype(np.int32) - b.images.astype(np.int32))
        print(f"{100 * (diff > 0).mean():.3f}% of uint8 values differ, by at most {diff.max()}")
        assert diff.max() <= 1
    np.testing.assert_array_equal(t_train.timestamps, [0.0, 0.5, 1.0])
    assert t_train.images[..., 3].max() == 255 and t_train.images[..., 3].min() == 0
    # The JAX test's shapes and ranges on the port.
    b = t_train[0]
    assert b["timestamps"].shape == (32, 1)
    assert 0.0 <= float(b["timestamps"].min()) and float(b["timestamps"].max()) <= 1.0
    bt = t_test[0]
    assert bt["timestamps"].shape == (24, 24, 1) and bt["rays"].origins.shape == (24, 24, 3)


def _write_scene(root, rng):
    """A tiny D-NeRF scene on disk: train, val and test splits of 16x16
    RGBA frames, some frames without a ``time`` (their time is i / (n - 1))."""
    scene = root / "tiny"
    scene.mkdir()
    for split, n in (("train", 3), ("val", 2), ("test", 2)):
        frames = []
        for i in range(n):
            path = f"./{split}/r_{i}"
            (scene / split).mkdir(exist_ok=True)
            write_png(str(scene / f"{path}.png"), rng.integers(0, 256, (16, 16, 4), dtype=np.uint8))
            c2w = np.eye(4)
            c2w[:3, 3] = rng.uniform(-3, 3, 3)
            frame = {"file_path": path, "transform_matrix": c2w.tolist()}
            if not (split == "train" and i == 1):
                frame["time"] = float(rng.random())
            frames.append(frame)
        (scene / f"transforms_{split}.json").write_text(json.dumps({"camera_angle_x": 0.69, "frames": frames}))


@pytest.mark.parametrize("split", ["train", "trainval", "test"])
def test_dnerf_loader_matches_jax_on_a_scene_on_disk(tmp_path, split, monkeypatch):
    # Both loaders on their numpy path (tests/test_torch_native.py holds the
    # native sampler's batches).
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(TLoader, "NATIVE_SAMPLER", False)
    _write_scene(tmp_path, np.random.default_rng(5))
    num_rays = None if split == "test" else 40
    kw = dict(subject_id="tiny", root_fp=str(tmp_path), split=split, num_rays=num_rays)
    j, t = JLoader(**kw), TLoader(**kw, device="cpu")
    np.testing.assert_array_equal(t.timestamps, j.timestamps)
    assert len(t.timestamps) == {"train": 3, "trainval": 5, "test": 2}[split]
    np.testing.assert_array_equal(t.images, j.images)
    for index in (0, 1):
        bj, bt = j[index], t[index]
        np.testing.assert_array_equal(bt["timestamps"].numpy(), np.asarray(bj["timestamps"]))
        for key in ("pixels", "color_bkgd"):
            np.testing.assert_allclose(bt[key].numpy(), np.asarray(bj[key]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(bt["rays"].viewdirs.numpy(), np.asarray(bj["rays"].viewdirs), rtol=0, atol=1e-6)
    if split == "test":
        assert bt["timestamps"].shape == (16, 16, 1)
    else:
        assert bt["timestamps"].shape == (40, 1)
        # The frame written without a time has time 1 / (3 - 1).
        assert t.timestamps[1] == 0.5


def test_dnerf_loader_needs_timestamps():
    images = np.zeros((1, 8, 8, 4), np.uint8)
    with pytest.raises(ValueError, match="timestamps"):
        TLoader(images=images, camtoworlds=np.eye(4, dtype=np.float32)[None], focal=7.2, device="cpu")


def test_dynamic_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tproc.make_dynamic_loaders(width=8, height=8, n_train=1, n_test=1)
    images = np.zeros((1, 8, 8, 4), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLoader(images=images, camtoworlds=np.eye(4, dtype=np.float32)[None], focal=7.2, timestamps=[0.0])
