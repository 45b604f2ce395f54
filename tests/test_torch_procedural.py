"""The procedural scene: the port's ``datasets/procedural.py`` against
``nerfacc_tpu.datasets.procedural`` on the same inputs.

Both packages make poses and rays in numpy from the same seed, so poses are
bit-equal.  The renders march the same 512 midpoints, but XLA and PyTorch
round the transcendentals and the transmittance's cumsum differently in the
last bits, so a uint8 pixel may land one step apart where its value sits on
a rounding edge; the share that differs is printed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.datasets import procedural as jproc
from nerfacc_tpu_torch.datasets import procedural as tproc


def _points(seed=0, n=4096):
    # Inside and around the blobs (radius 0.2 to 0.45 about +-0.5).
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 3)).astype(np.float32)


def test_scene_density_matches_jax():
    x = _points()
    want = np.asarray(jproc.scene_density(jnp.asarray(x)))
    got = tproc.scene_density(torch.from_numpy(x)).numpy()
    assert (want > 0).mean() > 0.05
    # atol 1e-5: float32 sums of the same five terms.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("detail", [0.0, 1.0])
def test_scene_rgb_density_matches_jax(detail):
    x = _points(1)
    rgb_j, sigma_j = (np.asarray(a) for a in jproc.scene_rgb_density(jnp.asarray(x), detail))
    rgb_t, sigma_t = tproc.scene_rgb_density(torch.from_numpy(x), detail)
    assert rgb_t.shape == rgb_j.shape and sigma_t.shape == sigma_j.shape
    # atol 1e-5 (colours in [0, 1], densities up to 60 with ripples of 35%).
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sigma_t.numpy(), sigma_j, rtol=0, atol=1e-5)


def test_generate_dataset_matches_jax():
    kw = dict(width=32, height=32, n_train=2, n_test=1, detail=1.0)
    want = jproc.generate_dataset(**kw)
    got = tproc.generate_dataset(**kw, device="cpu")
    tr_j, c2w_j, te_j, tc2w_j, focal_j = want
    tr_t, c2w_t, te_t, tc2w_t, focal_t = got
    assert focal_t == focal_j
    np.testing.assert_array_equal(c2w_t, c2w_j)
    np.testing.assert_array_equal(tc2w_t, tc2w_j)
    for name, a, b in (("train", tr_t, tr_j), ("test", te_t, te_j)):
        assert a.dtype == np.uint8 and a.shape == b.shape
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        print(f"{name}: {100 * (diff > 0).mean():.3f}% of uint8 values differ, by at most {diff.max()}")
        # At most one uint8 step (see the module docstring).
        assert diff.max() <= 1
    # The scene is in view: opaque and transparent pixels both.
    assert tr_t[..., 3].max() == 255 and tr_t[..., 3].min() == 0


def test_render_pixels_is_the_views_render():
    # The crop that chip_smoke.py renders on the CPU to hold a card view:
    # rendering some pixels alone gives those pixels of the whole view.
    kw = dict(width=24, height=20, n_train=1, n_test=1)
    tr, c2w, _, _, _ = tproc.generate_dataset(**kw, device="cpu")
    K = tproc.intrinsics(24, 20)
    yy, xx = np.mgrid[5:9, 10:17]
    crop = tproc.render_pixels(c2w[0], K, xx.reshape(-1), yy.reshape(-1), device="cpu")
    np.testing.assert_array_equal(crop.reshape(4, 7, 4), tr[0, 5:9, 10:17])


def test_make_loaders_shapes():
    # tests/test_datasets.py:95 on the port.
    train, test = tproc.make_loaders(num_rays=64, width=32, height=32, n_train=2, n_test=1, device="cpu")
    b = train[0]
    assert b["rays"].origins.shape == (64, 3)
    assert b["pixels"].shape == (64, 3)
    bt = test[0]
    assert bt["rays"].origins.shape == (32, 32, 3)
    assert bt["pixels"].shape == (32, 32, 3)
    assert (train.near, train.far) == (1.3, 3.7) and (test.near, test.far) == (1.3, 3.7)


def test_dataset_entry_points_default_to_the_card(monkeypatch):
    from nerfacc_tpu_torch.datasets.nerf_synthetic import SubjectLoader

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    K = tproc.intrinsics(8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tproc.generate_dataset(width=8, height=8, n_train=1, n_test=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tproc.make_loaders(width=8, height=8, n_train=1, n_test=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tproc.render_pixels(np.eye(4, dtype=np.float32), K, np.arange(4), np.arange(4))
    images = np.zeros((1, 8, 8, 4), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SubjectLoader(images=images, camtoworlds=np.eye(4, dtype=np.float32)[None], focal=7.2)
