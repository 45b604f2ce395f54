"""The OpenCV lens undistortion of the port (``nerfacc_tpu_torch/cameras.py``):
the round trips of ``tests/test_camera.py`` on the port, and the port
against ``nerfacc_tpu.cameras`` on the same inputs.

Both sides run the same float32 Newton steps elementwise; XLA and PyTorch
may round a division or ``tan`` an ulp apart, and ten steps carry that
along, so the port is held to JAX within 1e-6 (the points lie in [0, 1)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu import cameras as jcam
from nerfacc_tpu_torch import cameras as tcam


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_opencv_lens_undistortion_roundtrip():
    # tests/test_camera.py:15 on the port.
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.random((3, 1000, 2), dtype=np.float32))
    params = torch.from_numpy(rng.random(8, dtype=np.float32) * 0.01)
    x_undistort = tcam.opencv_lens_undistortion(x, params, 1e-5, 10)
    x_distort = tcam._opencv_lens_distortion(x_undistort, params.expand(x.shape[:-1] + (8,)))
    np.testing.assert_allclose(x.numpy(), x_distort.numpy(), atol=1e-5)


def test_opencv_lens_undistortion_partial_params():
    # tests/test_camera.py:27 on the port.
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((100, 2), dtype=np.float32))
    for n in (0, 1, 2, 4):
        params = torch.from_numpy(rng.random(n, dtype=np.float32) * 0.01)
        out = tcam.opencv_lens_undistortion(x, params, 1e-5, 10)
        assert out.shape == x.shape
        full = torch.zeros(8)
        full[:n] = params
        x_distort = tcam._opencv_lens_distortion(out, full.expand(x.shape[:-1] + (8,)))
        np.testing.assert_allclose(x.numpy(), x_distort.numpy(), atol=1e-5)


def test_opencv_lens_undistortion_fisheye_roundtrip():
    # tests/test_camera.py:41 on the port.
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.random((3, 1000, 2), dtype=np.float32))
    params = torch.from_numpy(rng.random(4, dtype=np.float32) * 0.01)
    x_undistort = tcam.opencv_lens_undistortion_fisheye(x, params, 1e-5, 10)
    x_distort = tcam._opencv_lens_distortion_fisheye(x_undistort, params.expand(x.shape[:-1] + (4,)))
    np.testing.assert_allclose(x.numpy(), x_distort.numpy(), atol=1e-5)


@pytest.mark.parametrize("n_params", [0, 1, 2, 4, 8])
def test_undistortion_matches_jax(n_params):
    rng = np.random.default_rng(n_params)
    uv = rng.uniform(-1, 1, (500, 2)).astype(np.float32)
    # Per-point parameters, strong enough that Newton takes several steps.
    params = (rng.uniform(-0.2, 0.2, (500, n_params))).astype(np.float32)
    want = np.asarray(jcam.opencv_lens_undistortion(jnp.asarray(uv), jnp.asarray(params), 1e-6, 10))
    got = tcam.opencv_lens_undistortion(_t(uv), _t(params), 1e-6, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    full = np.pad(params, ((0, 0), (0, 8 - n_params)))
    for a in (jcam._opencv_lens_distortion(jnp.asarray(uv), jnp.asarray(full)),):
        np.testing.assert_allclose(tcam._opencv_lens_distortion(_t(uv), _t(full)).numpy(), np.asarray(a),
                                   rtol=0, atol=1e-6)


def test_fisheye_undistortion_matches_jax():
    rng = np.random.default_rng(9)
    uv = rng.uniform(-1, 1, (500, 2)).astype(np.float32)
    uv[:3] = [[0.0, 0.0], [1e-7, 0.0], [0.9, -0.9]]  # the centre, and near it
    params = rng.uniform(-0.05, 0.05, 4).astype(np.float32)
    want = np.asarray(jcam.opencv_lens_undistortion_fisheye(jnp.asarray(uv), jnp.asarray(params), 1e-6, 10))
    got = tcam.opencv_lens_undistortion_fisheye(_t(uv), _t(params), 1e-6, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    fwd = np.asarray(jcam._opencv_lens_distortion_fisheye(jnp.asarray(uv), jnp.broadcast_to(params, (500, 4))))
    np.testing.assert_allclose(tcam._opencv_lens_distortion_fisheye(_t(uv), _t(params).expand(500, 4)).numpy(), fwd,
                               rtol=1e-6, atol=1e-6)


def test_undistortion_refuses_what_jax_asserts():
    with pytest.raises(ValueError, match="uv"):
        tcam.opencv_lens_undistortion(torch.zeros(4, 3), torch.zeros(8))
    with pytest.raises(ValueError, match="0, 1, 2, 4 or 8"):
        tcam.opencv_lens_undistortion(torch.zeros(4, 2), torch.zeros(3))
    with pytest.raises(ValueError, match="4 entries"):
        tcam.opencv_lens_undistortion_fisheye(torch.zeros(4, 2), torch.zeros(8))
