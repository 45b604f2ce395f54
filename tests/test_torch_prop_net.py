"""The proposal-network path's modules against the JAX package:
``estimators/prop_net.py`` (``_transform_stot``, ``_pdf_loss`` and its
oracle, the cadence), ``NGPDensityField`` and the contractions of
``models/ngp.py`` (weights carried by ``convert.field_from_jax``), and
``propnet_render_rays``.  One whole train step is in
``tests/test_torch_prop_train.py``.  Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.estimators import prop_net as jprop
from nerfacc_tpu.models.ngp import NGPDensityField as JDensity
from nerfacc_tpu.models.ngp import contract_tanh as j_tanh
from nerfacc_tpu.models.ngp import contract_to_unisphere as j_unisphere
from nerfacc_tpu.rendering import propnet_render_rays as j_render
from nerfacc_tpu_torch.convert import field_from_jax
from nerfacc_tpu_torch.data_specs import RayIntervals
from nerfacc_tpu_torch.estimators import prop_net as tprop
from nerfacc_tpu_torch.models.ngp import NGPDensityField as TDensity
from nerfacc_tpu_torch.models.ngp import contract_tanh, contract_tanh_inv, contract_to_unisphere
from nerfacc_tpu_torch.rendering import propnet_render_rays as t_render


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_contract_tanh_round_trip_matches_jax():
    # tests/test_models.py:249-276.
    aabb = np.array([-1.0, -2.0, -1.0, 1.0, 2.0, 3.0], np.float32)
    x = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32) * 4
    u = contract_tanh(_t(x), _t(aabb))
    # XLA's and PyTorch's float32 tanh differ by up to two ulps of the
    # result (1.19e-7 measured): atol 2.5e-7.
    np.testing.assert_allclose(u.numpy(), np.asarray(j_tanh(jnp.asarray(x), jnp.asarray(aabb))), rtol=0, atol=2.5e-7)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    lo, hi = contract_tanh(_t(aabb[None, :3]), _t(aabb)), contract_tanh(_t(aabb[None, 3:]), _t(aabb))
    np.testing.assert_allclose(lo[0].numpy(), [0.5 - np.tanh(0.5) / 2] * 3, atol=1e-6)
    np.testing.assert_allclose(hi[0].numpy(), [0.5 + np.tanh(0.5) / 2] * 3, atol=1e-6)
    xm = np.random.default_rng(1).uniform(-1.5, 1.5, (500, 3)).astype(np.float32)
    back = contract_tanh_inv(contract_tanh(_t(xm), _t(aabb)), _t(aabb))
    np.testing.assert_allclose(back.numpy(), xm, rtol=1e-3, atol=1e-3)


def test_contract_to_unisphere_matches_jax_bit_for_bit():
    # The norm is XLA's sqrt(fma(z, z, fma(y, y, x * x))), every step
    # correctly rounded: a contracted position an ulp off can cross a cell
    # face of the fused encoder.
    aabb = np.array([-8.0] * 3 + [8.0] * 3, np.float32)
    x = (np.random.default_rng(4).normal(size=(200_000, 3)) * 20).astype(np.float32)
    got = contract_to_unisphere(_t(x), _t(aabb)).numpy()
    want = np.asarray(j_unisphere(jnp.asarray(x), jnp.asarray(aabb)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sampling_type", ["uniform", "lindisp"])
def test_transform_stot_matches_jax(sampling_type):
    s = np.random.default_rng(2).random((64, 33), dtype=np.float32)
    s[:, 0], s[:, -1] = 0.0, 1.0
    got = tprop._transform_stot(sampling_type, _t(s), 0.2, 1e3).numpy()
    want = np.asarray(jprop._transform_stot(sampling_type, jnp.asarray(s), 0.2, 1e3))
    # One float32 rounding an operation on both sides, none fused: equal.
    np.testing.assert_array_equal(got, want)


def test_proposal_cadence_matches_jax():
    a, b = tprop.get_proposal_requires_grad_fn(), jprop.get_proposal_requires_grad_fn()
    got = [a(step) for step in range(2000)]
    assert got == [b(step) for step in range(2000)]
    # From step 1000 on, one step in six.
    assert sum(got[1200:1800]) == 100


def test_pdf_loss_matches_jax_and_lossfun_outer():
    # tests/test_pdf.py:62-101 on the port, and each function against JAX.
    rng = np.random.default_rng(2)
    vals = np.sort(np.random.default_rng(42).random((5, 101), dtype=np.float32), -1)
    cdfs = np.sort(rng.random(vals.shape, dtype=np.float32), -1)
    from nerfacc_tpu_torch.pdf import importance_sampling

    out, _ = importance_sampling(RayIntervals(vals=_t(vals)), _t(cdfs), 10)
    t1 = out.vals.numpy()
    cdfs1 = np.sort(rng.random(t1.shape, dtype=np.float32), -1)
    loss = tprop._pdf_loss(RayIntervals(vals=_t(vals)), _t(cdfs), RayIntervals(vals=_t(t1)), _t(cdfs1)).numpy()
    loss2 = tprop._lossfun_outer(_t(vals), _t(cdfs[:, 1:] - cdfs[:, :-1]), _t(t1),
                                 _t(cdfs1[:, 1:] - cdfs1[:, :-1])).numpy()
    j_int = jprop.RayIntervals
    want = jprop._pdf_loss(j_int(vals=jnp.asarray(vals)), jnp.asarray(cdfs), j_int(vals=jnp.asarray(t1)),
                           jnp.asarray(cdfs1))
    want2 = jprop._lossfun_outer(jnp.asarray(vals), jnp.asarray(cdfs[:, 1:] - cdfs[:, :-1]), jnp.asarray(t1),
                                 jnp.asarray(cdfs1[:, 1:] - cdfs1[:, :-1]))
    np.testing.assert_allclose(loss, np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(loss2, np.asarray(want2), rtol=1e-6, atol=1e-7)
    # The two reference forms agree inside the key histogram's range; below
    # it _pdf_loss gives w^2 / (w + eps) (tests/test_pdf.py:83-101).
    in_range = (vals[:, :-1] >= t1[:, :1]) & (vals[:, 1:] <= t1[:, -1:])
    np.testing.assert_allclose(np.where(in_range, loss, 0.0), np.where(in_range, loss2, 0.0), atol=1e-4)
    w = cdfs[:, 1:] - cdfs[:, :-1]
    below = vals[:, 1:] <= t1[:, :1]
    np.testing.assert_allclose(np.where(below, loss, 0.0), np.where(below, w**2 / (w + 1e-7), 0.0), atol=1e-5)


# examples/train_ngp_nerf_prop.py:107-131 at a small size: 5 levels, F = 2,
# 2^(10 - 3) rows a level, MLP 16 wide.
PROP = dict(n_levels=5, n_features_per_level=2, log2_hashmap_size=10, mlp_width=16)
ROI = [-1.0] * 3 + [1.0] * 3


def _density_pair(max_resolution, unbounded, seed, cdt=None):
    jnet = JDensity(aabb=tuple(ROI), unbounded=unbounded, max_resolution=max_resolution,
                    compute_dtype=None if cdt is None else jnp.bfloat16, **PROP)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((8, 3)))
    tnet = TDensity(aabb=ROI, unbounded=unbounded, max_resolution=max_resolution, compute_dtype=cdt,
                    device="cpu", **PROP)
    tnet.load_state_dict(field_from_jax(_np(params)))
    return jnet, params, tnet


@pytest.mark.parametrize("unbounded", [False, True], ids=["bounded", "unbounded"])
@pytest.mark.parametrize("max_resolution", [128, 256])
def test_field_from_jax_gives_the_same_density_field(max_resolution, unbounded):
    jnet, params, tnet = _density_pair(max_resolution, unbounded, seed=max_resolution)
    assert set(tnet.state_dict()) == {"encoder.table", "mlp_base.0.weight", "mlp_base.0.bias",
                                      "mlp_base.2.weight", "mlp_base.2.bias"}
    x = np.random.default_rng(3).uniform(-1.6, 1.6, (4, 50, 3)).astype(np.float32)
    got = tnet(_t(x))
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    assert got.shape == want.shape == (4, 50, 1)
    # Float32, the same gathers and a 16-wide MLP: rtol 1e-5.
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-7)
    # Zero outside the box; the contraction keeps every finite point inside.
    assert (want > 0).any() and (want == 0).any() != unbounded


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_density_field_gradient_matches_jax(cdt):
    jnet, params, tnet = _density_pair(256, True, seed=5, cdt=cdt)
    rng = np.random.default_rng(4)
    x = rng.uniform(-3.0, 3.0, (300, 3)).astype(np.float32)
    r = rng.standard_normal((300, 1)).astype(np.float32)
    want = field_from_jax(_np(jax.grad(lambda p: jnp.sum(jnet.apply(p, jnp.asarray(x)) * r))(params)))
    (tnet(_t(x)) * _t(r)).sum().backward()
    # float32: 1e-4 of the largest (tests/test_models.py:539); bf16: 2e-2
    # (tests/test_models.py:549).  The table's gradient is autograd's
    # scatter of the 16-wide rows, as in JAX.
    rel = 1e-4 if cdt is None else 2e-2
    for name, p in tnet.named_parameters():
        g = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=rel * np.abs(g).max(), err_msg=name)
    assert np.abs(want["encoder.table"].numpy()).max() > 0


def test_density_overflow_outside_the_box_is_zero_as_in_jax():
    # trunc_exp(h - 1) overflows to inf for h > 89.  JAX multiplies it by
    # the selector, which XLA rewrites as a select: 0 outside the box, not
    # inf * 0 = NaN.
    jnet, params, tnet = _density_pair(128, False, seed=1)
    params = jax.tree_util.tree_map(lambda a: a, _np(params))
    params["params"]["mlp_base"]["layers_2"]["bias"] = np.full((1,), 200.0, np.float32)
    tnet.load_state_dict(field_from_jax(params))
    x = np.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [0.5, -0.5, 0.2]], np.float32)
    got = tnet(_t(x)).detach().numpy()
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert want[1, 0] == 0 and np.isinf(want[0, 0])


def _ball():
    def sigma_at(x):
        return torch.where(torch.linalg.vector_norm(x, dim=-1) < 0.5, 8.0, 0.0)

    def j_sigma_at(x):
        return jnp.where(jnp.linalg.norm(x, axis=-1) < 0.5, 8.0, 0.0)

    return sigma_at, j_sigma_at


def _ball_rays(n_rays=32):
    d = np.random.default_rng(0).normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (-2.0 * d).astype(np.float32), d


def test_propnet_render_rays_on_the_analytic_ball_matches_jax():
    # tests/test_renderers.py:123-159: every ray hits the opaque ball.
    o, d = _ball_rays()
    sigma_at, j_sigma_at = _ball()
    kw = dict(num_samples=32, prop_samples=(64,), near_plane=0.5, far_plane=4.0, sampling_type="uniform",
              opaque_bkgd=False, requires_grad=True)
    ot, dt = _t(o), _t(d)

    def points(ts, te):
        return ot[:, None] + ((ts + te) / 2)[..., None] * dt[:, None]

    colors, opac, depth, extras = t_render(
        lambda ts, te: (torch.sigmoid(points(ts, te) * 3.0), sigma_at(points(ts, te))),
        [lambda ts, te: sigma_at(points(ts, te))], tprop.PropNetEstimator(), ot, dt,
        render_bkgd=torch.ones(3), **kw,
    )
    assert colors.shape == (32, 3) and len(extras["prop_cache"]) == 2
    assert float(opac.mean()) > 0.9
    oj, dj = jnp.asarray(o), jnp.asarray(d)

    def jpoints(ts, te):
        return oj[:, None] + ((ts + te) / 2)[..., None] * dj[:, None]

    jc, jo, jd, jx = j_render(
        lambda ts, te: (jax.nn.sigmoid(jpoints(ts, te) * 3.0), j_sigma_at(jpoints(ts, te))),
        [lambda ts, te: j_sigma_at(jpoints(ts, te))], jprop.PropNetEstimator(), oj, dj,
        render_bkgd=jnp.ones(3), **kw,
    )
    np.testing.assert_allclose(extras["t_starts"].numpy(), np.asarray(jx["t_starts"]), rtol=0, atol=1e-6)
    for got, want in ((colors, jc), (opac, jo), (depth, jd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("zero_width", [False, True], ids=["last-interval", "zero-width-last-interval"])
def test_opaque_background_matches_jax(zero_width):
    # The last interval's density is set to inf out of place: its gradient
    # is zero.  A last interval of zero width gives inf * 0 = NaN there.
    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(0.2, 5.0, (6, 9)), -1).astype(np.float32)
    if zero_width:
        t[:, -1] = t[:, -2]
    sig = rng.uniform(0.0, 2.0, (6, 8)).astype(np.float32)
    rgb = rng.random((6, 8, 3), dtype=np.float32)
    wc = rng.standard_normal((6, 3)).astype(np.float32)

    class Fixed(jprop.PropNetEstimator):
        def sampling(self, *a, **k):
            return jnp.asarray(t[:, :-1]), jnp.asarray(t[:, 1:]), []

    def jloss(s):
        c, _, _, _ = j_render(lambda ts, te: (jnp.asarray(rgb), s), [], Fixed(), jnp.zeros((6, 3)),
                              jnp.zeros((6, 3)), prop_samples=(), opaque_bkgd=True, render_bkgd=jnp.ones(3))
        return jnp.sum(c * wc), c

    (_, jc), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(sig))

    class TFixed(tprop.PropNetEstimator):
        def sampling(self, *a, **k):
            return _t(t[:, :-1]), _t(t[:, 1:]), []

    s = _t(sig).requires_grad_(True)
    c, _, _, _ = t_render(lambda ts, te: (_t(rgb), s), [], TFixed(), torch.zeros(6, 3), torch.zeros(6, 3),
                          prop_samples=(), opaque_bkgd=True, render_bkgd=torch.ones(3))
    (c * _t(wc)).sum().backward()
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)
    if zero_width:
        assert np.isnan(np.asarray(jc)).all()
    else:
        assert (s.grad[:, -1] == 0).all() and np.isfinite(np.asarray(jc)).all()
