"""Fused traversal and compaction, traversal planning and ``sampling``: the
port against ``nerfacc_tpu.grid.traverse_and_compact`` and
``nerfacc_tpu.estimators.occ_grid``.

Every field is held exactly: the same float32 operations run on both sides.
The one exception is the geometric ladder's power at ``cone_angle > 0``:
XLA on the CPU calls the C library's ``powf``, and the port rounds a float64
power to float32 (so that the card and the CPU agree); the ladders differ
by up to two ulps on about one value in three hundred, so there the t
values are held to two ulps (rtol 2.4e-7) and every other field exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.estimators.occ_grid import OccGridEstimator as JEstimator
from nerfacc_tpu.grid import traverse_and_compact as j_tc
from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator as TEstimator
from nerfacc_tpu_torch.grid import traverse_and_compact as t_tc

ROI = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
RES = 64


def _shell(levels, res=RES):
    g = (np.arange(res) + 0.5) / res * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    shell = np.abs(np.sqrt(gx**2 + gy**2 + gz**2) - 0.45) < 0.1
    return np.stack([shell] + [np.roll(shell, 5 * l, axis=1) for l in range(1, levels)])


def _states(levels, skip_factor=2):
    je = JEstimator(ROI, RES, levels, skip_factor)
    te = TEstimator(ROI, RES, levels, skip_factor)
    occ = _shell(levels)
    js = je.set_binaries(je.init(), jnp.asarray(occ))
    ts = te.set_binaries(te.init("cpu"), torch.from_numpy(occ))
    return je, te, js, ts


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-2.5 * d + rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    near = (rng.random(n) * 0.01).astype(np.float32)
    return o, d, near


def _assert_same(got, want, cone_angle):
    for name in got._fields:
        if getattr(got, name) is None and getattr(want, name) is None:
            continue  # ray_comps without carry_rays
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        if cone_angle > 0 and name in ("t_starts", "t_ends", "termination_planes"):
            np.testing.assert_allclose(g, w, rtol=2.4e-7, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# (levels, capacity, macro_stride, max_macro_segments, cone_angle, skip):
CASES = {
    "dense": (1, 8192, 16, 8, 0.0, False),
    "macro-stride18-C1": (1, 8192, 18, 8, 0.0, True),
    "macro-stride16-C4": (1, 8192, 16, 8, 0.0, True),
    "cone": (1, 8192, 16, 8, 0.004, True),
    "cone-dense": (1, 8192, 16, 8, 0.01, False),
    "capacity-overflow": (1, 1024, 16, 8, 0.0, True),
    "macro-truncation": (1, 8192, 16, 2, 0.0, True),
    "two-levels": (2, 8192, 16, 8, 0.0, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_traverse_and_compact_matches_jax(case):
    levels, capacity, stride, k_keep, cone, skip = CASES[case]
    _, _, js, ts = _states(levels)
    o, d, near = _rays(len(case), 96)
    mask = np.ones(96, bool)
    mask[::17] = False
    kw = dict(
        step_size=1e-2, cone_angle=cone, traverse_steps_limit=128,
        max_lattice_steps=512, macro_stride=stride, max_macro_segments=k_keep,
    )
    want = j_tc(
        jnp.asarray(o), jnp.asarray(d), js.binaries, js.aabbs, capacity,
        near_planes=jnp.asarray(near), far_planes=jnp.full((96,), 3.6),
        rays_mask=jnp.asarray(mask), skip_grid=js.skip_grid if skip else None, **kw,
    )
    # On CPU tensors K1's wrapper runs its plain version.
    got = t_tc(
        torch.from_numpy(o), torch.from_numpy(d), ts.binaries, ts.aabbs, capacity,
        near_planes=torch.from_numpy(near), far_planes=torch.full((96,), 3.6),
        rays_mask=torch.from_numpy(mask), skip_grid=ts.skip_grid if skip else None,
        packed_skip=ts.skip_packed, packed_grids=ts.binaries_packed, **kw,
    )
    _assert_same(got, want, cone)
    n_kept = int(got.kept.sum())
    assert n_kept > 0
    assert (np.diff(got.ray_indices.numpy()) >= 0).all()
    if case == "capacity-overflow":
        assert int(got.num_valid.sum()) > capacity
    if case == "macro-truncation":
        assert bool(got.macro_truncated.any())
    if case == "macro-stride18-C1":  # C = 1: no padding inside a ray's range
        assert int(got.seg_counts.sum()) == n_kept
    if case == "macro-stride16-C4":  # C = 4: chunk-aligned ranges
        assert int(got.seg_counts.sum()) > n_kept and not (got.seg_starts % 4).any()


def test_plan_traversal_matches_jax_and_the_bench_plan():
    je = JEstimator([-1.5] * 3 + [1.5] * 3, 128, 1, 2)
    te = TEstimator([-1.5] * 3 + [1.5] * 3, 128, 1, 2)
    # bench.py's configuration: macro stride 18, so compaction takes C = 1.
    assert te.plan_traversal(5e-3, max_macro_segments=4) == (1040, True, 18, 4, 72)
    for args in [(5e-3, 0.0, 0.0, None, 4), (1e-2, 0.004, 0.2, 64, 8), (5e-3, 0.02, 0.0, None, 24),
                 (2e-3, 0.0, 0.5, 100, 24)]:
        for skip in (True, False):
            assert te.plan_traversal(*args, has_skip_grid=skip) == je.plan_traversal(
                *args, has_skip_grid=skip
            )


@pytest.mark.parametrize("stratified", [False, True])
def test_sampling_matches_jax(stratified):
    je, te, js, ts = _states(1)
    o, d, _ = _rays(7, 64)
    key = jax.random.PRNGKey(3)
    # The jitter JAX draws inside sampling(), handed to the port.
    jitter = np.array(jax.random.uniform(key, (64,), jnp.float32))
    kw = dict(render_step_size=1e-2, stratified=stratified, sample_capacity=4096,
              max_macro_segments=6, near_plane=0.1)
    want = je.sampling(js, jnp.asarray(o), jnp.asarray(d), key=key, return_extras=True, **kw)
    got = te.sampling(ts, torch.from_numpy(o), torch.from_numpy(d),
                      jitter=torch.from_numpy(jitter), return_extras=True, **kw)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[4]["macro_truncated"].numpy(), np.asarray(want[4]["macro_truncated"]))
    assert float(got[4]["macro_truncated_frac"]) == float(want[4]["macro_truncated_frac"])
    assert int(got[3].sum()) > 0
