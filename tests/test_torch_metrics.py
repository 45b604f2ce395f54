"""Image metrics: the port's ``utils/metrics.py`` and ``utils/lpips.py``
against ``nerfacc_tpu.utils`` on the same images.

PSNR, SSIM and MS-SSIM agree within 1e-5 (float32 filters summed in
another order by XLA's and PyTorch's convolutions).  LPIPS with the
fixed-seed backbone agrees within rtol 1e-4: both packages draw the same
weights with numpy, and the thirteen convolutions round differently.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.utils import metrics as jm
from nerfacc_tpu_torch.utils import metrics as tm

jl = importlib.import_module("nerfacc_tpu.utils.lpips")
tl = importlib.import_module("nerfacc_tpu_torch.utils.lpips")


def _pair(shape, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return a, b


# (H, W) of 176 and more takes all five MS-SSIM scales; 64 takes three.
SHAPES = {"one-64x48": (64, 48, 3), "batched-2x40x40": (2, 40, 40, 3), "five-scales-176": (176, 180, 3)}


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_psnr_ssim_ms_ssim_match_jax(shape):
    a, b = _pair(shape)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("psnr", "ssim", "ms_ssim"):
        want = np.asarray(getattr(jm, name)(ja, jb))
        got = getattr(tm, name)(ta, tb).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    s_j, cs_j = jm.ssim(ja, jb, return_cs=True)
    s_t, cs_t = tm.ssim(ta, tb, return_cs=True)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(cs_t.numpy(), np.asarray(cs_j), rtol=0, atol=1e-5)


def test_ms_ssim_takes_fewer_scales_on_small_images():
    a, b = _pair((24, 30, 3), seed=3)  # two scales fit
    want = float(jm.ms_ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(tm.ms_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert got == pytest.approx(want, abs=1e-5)
    # Two scales: cs at full size, then SSIM at half size, weights 0.0448 and 0.2856.
    _, cs = tm.ssim(torch.from_numpy(a), torch.from_numpy(b), return_cs=True)
    s = tm.ssim(tm._downsample2x(torch.from_numpy(a)), tm._downsample2x(torch.from_numpy(b)))
    w = np.array([0.0448, 0.2856]) / (0.0448 + 0.2856)
    assert got == pytest.approx(float(cs) ** w[0] * float(s) ** w[1], abs=1e-6)


def test_ssim_gaussian_window_oracle():
    # tests/test_metrics.py:49 on the port.
    rng = np.random.default_rng(2)
    a = rng.random((32, 32, 1)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)

    size, sigma = 11, 1.5
    x = np.arange(size) - 5
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    win = np.outer(g, g)

    def filt(im):
        h, w = im.shape
        out = np.zeros((h - 10, w - 10))
        for i in range(h - 10):
            for j in range(w - 10):
                out[i, j] = (im[i : i + 11, j : j + 11] * win).sum()
        return out

    ia, ib = a[..., 0].astype(np.float64), b[..., 0].astype(np.float64)
    mu_a, mu_b = filt(ia), filt(ib)
    va = filt(ia * ia) - mu_a**2
    vb = filt(ib * ib) - mu_b**2
    cov = filt(ia * ib) - mu_a * mu_b
    c1, c2 = 0.01**2, 0.03**2
    want = (((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (va + vb + c2))).mean()
    got = float(tm.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_lpips_rnd_backbone_matches_jax():
    a, b = _pair((2, 40, 36, 3), seed=4, noise=0.2)
    want, src_j = jl.lpips(a, b)
    got, src_t = tl.lpips(torch.from_numpy(a), torch.from_numpy(b))
    assert src_t == src_j == "rnd"
    assert got == pytest.approx(want, rel=1e-4)
    one_j, _ = jl.lpips(a[1], b[1])
    one_t, _ = tl.lpips(a[1], b[1])  # numpy input runs on the CPU
    assert one_t == pytest.approx(one_j, rel=1e-4)
    # The two packages draw the same weights.
    convs, lins, _ = tl._load_params()
    jconvs, jlins, _ = jl._load_params()
    for (w, bias), (jw, jbias) in zip(convs, jconvs):
        np.testing.assert_array_equal(w, np.transpose(jw, (3, 2, 0, 1)))
        np.testing.assert_array_equal(bias, jbias)
    for lin, jlin in zip(lins, jlins):
        np.testing.assert_array_equal(lin, jlin)


def test_lpips_unconditional():
    # tests/test_utils.py:139 on the port: zero on identical images and
    # monotone in the strength of the noise.
    rng = np.random.RandomState(0)
    a = rng.rand(48, 48, 3).astype(np.float32)
    noise = rng.randn(48, 48, 3).astype(np.float32)
    ta = torch.from_numpy(a)
    same, src = tl.lpips(ta, ta)
    assert src in ("rnd", "vgg")
    small, _ = tl.lpips(ta, torch.from_numpy(np.clip(a + 0.05 * noise, 0, 1)))
    big, _ = tl.lpips(ta, torch.from_numpy(np.clip(a + 0.3 * noise, 0, 1)))
    assert same < 1e-6
    assert same < small < big


def test_lpips_or_none_is_none_without_vgg_weights(monkeypatch):
    monkeypatch.delenv("NERFACC_LPIPS_WEIGHTS", raising=False)
    tl._load_params.cache_clear()
    try:
        a, b = _pair((24, 24, 3))
        assert tm.lpips_or_none(torch.from_numpy(a), torch.from_numpy(b)) is None
    finally:
        tl._load_params.cache_clear()
