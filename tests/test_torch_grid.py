"""Grid traversal: port against ``nerfacc_tpu.grid``.

Sample counts and masks must be equal; t values agree to 1e-6 (the same
float32 operations on both sides, so in practice bit for bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu import grid as jgrid
from nerfacc_tpu.estimators.occ_grid import OccGridEstimator as JEstimator
from nerfacc_tpu_torch import grid as tgrid
from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator as TEstimator


def _shell(levels, res):
    g = (np.arange(res) + 0.5) / res * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt(gx**2 + gy**2 + gz**2)
    shell = np.abs(r - 0.45) < 0.12
    return np.stack([shell] + [np.roll(shell, l, axis=0) for l in range(1, levels)])


def _rays(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-2.5 * d + rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    return o, d


@pytest.mark.parametrize("levels,cone_angle", [(1, 0.0), (2, 0.0), (2, 0.01)])
def test_traverse_grids_matches_jax(levels, cone_angle):
    rng = np.random.default_rng(levels)
    res, n = 32, 96
    roi = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
    je = JEstimator(roi_aabb=roi, resolution=res, levels=levels)
    te = TEstimator(roi_aabb=roi, resolution=res, levels=levels)
    np.testing.assert_array_equal(te._aabbs_np, je._aabbs_np)
    assert te.max_t_range == je.max_t_range
    occ = _shell(levels, res)
    js = je.set_binaries(je.init(), jnp.asarray(occ))
    ts = te.set_binaries(te.init("cpu"), torch.from_numpy(occ))
    np.testing.assert_array_equal(ts.skip_grid.numpy(), np.asarray(js.skip_grid))

    o, d = _rays(rng, n)
    near = (rng.random(n) * 1.5).astype(np.float32)  # a window mid-way along
    mask = rng.random(n) < 0.8
    kw = dict(step_size=1e-2, cone_angle=cone_angle, traverse_steps_limit=24,
              max_lattice_steps=96)
    jr = jgrid.traverse_grids(
        jnp.asarray(o), jnp.asarray(d), js.binaries, js.aabbs,
        near_planes=jnp.asarray(near), far_planes=jnp.full((n,), 3.5),
        rays_mask=jnp.asarray(mask), **kw,
    )
    # On CPU tensors K1's wrapper runs its plain version.
    tr = tgrid.traverse_grids(
        torch.from_numpy(o), torch.from_numpy(d), ts.binaries, ts.aabbs,
        near_planes=torch.from_numpy(near), far_planes=torch.full((n,), 3.5),
        rays_mask=torch.from_numpy(mask), packed_grids=ts.binaries_packed, **kw,
    )
    np.testing.assert_array_equal(tr.num_valid.numpy(), np.asarray(jr.num_valid))
    np.testing.assert_array_equal(tr.is_valid.numpy(), np.asarray(jr.is_valid))
    for name in ("t_starts", "t_ends", "termination_planes", "far_effective"):
        np.testing.assert_allclose(
            getattr(tr, name).numpy(), np.asarray(getattr(jr, name)), rtol=0, atol=1e-6
        )
    assert 0 < int(tr.num_valid.sum())
    assert int(tr.num_valid[~torch.from_numpy(mask)].sum()) == 0


def test_ray_aabb_ladder_and_skip_grid_helpers_match_jax():
    rng = np.random.default_rng(9)
    o, d = _rays(rng, 64)
    d[:4, 0] = 0.0  # axis-parallel rays
    aabbs = np.array([[-1, -1, -1, 1, 1, 1], [-0.5, -0.2, -0.3, 0.4, 0.6, 0.2]], np.float32)
    j = jgrid.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabbs), 0.1, 4.0)
    t = tgrid.ray_aabb_intersect(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(aabbs), 0.1, 4.0)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    near = (rng.random(16) * 0.3).astype(np.float32)
    k = rng.integers(0, 300, size=(16, 5)).astype(np.int32)
    for cone in (0.0, 0.004):
        np.testing.assert_allclose(
            tgrid._march_ladder(torch.from_numpy(near), 300, 5e-3, cone).numpy(),
            np.asarray(jgrid._march_ladder(jnp.asarray(near), 300, 5e-3, cone)),
            rtol=1e-6,
        )
        np.testing.assert_allclose(
            tgrid._ladder_at(torch.from_numpy(near)[:, None], torch.from_numpy(k), 5e-3, cone).numpy(),
            np.asarray(jgrid._ladder_at(jnp.asarray(near)[:, None], jnp.asarray(k), 5e-3, cone)),
            rtol=1e-6,
        )
        for t_range in (1.0, 5.196):
            assert tgrid.num_ladder_steps(t_range, 5e-3, cone, 0.2) == jgrid.num_ladder_steps(
                t_range, 5e-3, cone, 0.2
            )
    grid = rng.random((2, 16, 8, 24)) < 0.05
    for factor, dil in ((4, 1), (2, 2), (8, 0)):
        np.testing.assert_array_equal(
            tgrid.build_skip_grid(torch.from_numpy(grid), factor, dil).numpy(),
            np.asarray(jgrid.build_skip_grid(jnp.asarray(grid), factor, dil)),
        )
