"""The inference renderer end to end: port against ``nerfacc_tpu`` on the
CPU, with the same (converted) weights, occupancy and camera rays.

rgb, opacity and depth agree to atol 1e-5 (float32 MLPs and per-ray sums
taken in another order); the traversal is exact, so sample counts are
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.datasets.procedural import _pose_spherical
from nerfacc_tpu.datasets.utils import generate_rays as j_generate_rays
from nerfacc_tpu.estimators.occ_grid import OccGridEstimator as JEstimator
from nerfacc_tpu.models.ngp import NGPRadianceField as JField
from nerfacc_tpu.rendering import gather_ray_od as j_gather
from nerfacc_tpu.rendering import occgrid_render_rays_test as j_render
from nerfacc_tpu_torch.convert import field_from_jax, occ_state_from_jax
from nerfacc_tpu_torch.datasets.procedural import pose_spherical
from nerfacc_tpu_torch.datasets.utils import generate_rays as t_generate_rays
from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator as TEstimator
from nerfacc_tpu_torch.models.ngp import NGPRadianceField as TField
from nerfacc_tpu_torch.rendering import gather_ray_od as t_gather
from nerfacc_tpu_torch.rendering import occgrid_render_rays_test as t_render

AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
FIELD_CFG = dict(n_levels=2, n_features_per_level=16, log2_hashmap_size=14, mlp_width=16)
SIDE = 24


def _shell(levels, res):
    g = (np.arange(res) + 0.5) / res * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt(gx**2 + gy**2 + gz**2)
    return np.stack([np.abs(r - 0.45) < 0.12] * levels)


def _camera():
    c2w = _pose_spherical(np.radians(-30.0), np.radians(-30.0), 4.0)[:3, :4]
    np.testing.assert_array_equal(
        pose_spherical(np.radians(-30.0), np.radians(-30.0), 4.0)[:3, :4], c2w
    )
    focal = 0.5 * SIDE / np.tan(0.5 * 0.6911112)
    K = np.array([[focal, 0, SIDE / 2], [0, focal, SIDE / 2], [0, 0, 1]], np.float32)
    xs, ys = np.meshgrid(np.arange(SIDE), np.arange(SIDE), indexing="xy")
    return xs, ys, K, c2w


@pytest.mark.parametrize("levels", [1, 2])
def test_occgrid_render_rays_test_matches_jax(levels):
    jfield = JField(aabb=AABB, encoder_type="fused", **FIELD_CFG)
    params = jfield.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    tfield = TField(aabb=AABB, device="cpu", **FIELD_CFG)
    tfield.load_state_dict(field_from_jax(jax.tree_util.tree_map(np.asarray, params)))

    je = JEstimator(roi_aabb=AABB, resolution=32, levels=levels)
    js = je.set_binaries(je.init(), jnp.asarray(_shell(levels, 32)))
    te = TEstimator(roi_aabb=AABB, resolution=32, levels=levels)
    ts = occ_state_from_jax(te, js, device="cpu")

    jrays = j_generate_rays(*_camera())
    trays = t_generate_rays(*_camera(), device="cpu")
    np.testing.assert_array_equal(trays.origins.numpy(), np.asarray(jrays.origins))
    np.testing.assert_array_equal(trays.viewdirs.numpy(), np.asarray(jrays.viewdirs))

    def j_builder(ro, rd):
        def fn(t0, t1, ri):
            o, d = j_gather(ro, rd, ri)
            rgb, sigma = jfield.apply(params, o + ((t0 + t1) / 2)[:, None] * d, d)
            return rgb, sigma[..., 0]

        return fn

    def t_builder(ro, rd):
        def fn(t0, t1, ri):
            o, d = t_gather(ro, rd, ri)
            rgb, sigma = tfield(o + ((t0 + t1) / 2)[:, None] * d, d)
            return rgb, sigma[..., 0]

        return fn

    kw = dict(max_samples=1024, samples_per_round=32, render_step_size=5e-3)
    want = j_render(
        j_builder, je, js, jrays.origins.reshape(-1, 3), jrays.viewdirs.reshape(-1, 3),
        render_bkgd=jnp.ones(3), **kw,
    )
    got = t_render(
        t_builder, te, ts, trays.origins.reshape(-1, 3), trays.viewdirs.reshape(-1, 3),
        render_bkgd=torch.ones(3), **kw,
    )
    assert got[3] == want[3] > 0
    for a, b in zip(want[:3], got[:3]):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)
