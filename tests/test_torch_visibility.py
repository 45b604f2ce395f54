"""The visibility filter and what surrounds it: the port against
``nerfacc_tpu`` on the same inputs.

- ``render_visibility_from_alpha``/``_density``: the golden case of
  ``tests/test_rendering.py:21``, and both functions against JAX on random
  segments, through ``packed_info`` and ``ray_indices``;
- ``OccGridEstimator.sampling(sigma_fn=, alpha_fn=)`` and
  ``mark_invisible_cells`` (golden counts of ``tests/test_grid.py:164``);
- ``occgrid_render_rays`` with ``alpha_thre`` and ``refilter_capacity``;
- ``pack.flatten_batched`` and ``compact_flat``;
- the golden gradients of ``tests/test_rendering.py:107`` and the product
  gradient at zero of ``tests/test_scan.py:86``, on the port.

Masks are compared exactly.  Both sides take their densities from one
numpy function of the same t values, and the occupancies are multiples of
2^-12 over 2^15 cells, so that their mean, the filter's threshold, is exact
in float32 on both sides.  Where t values come from a traversal at
``cone_angle > 0``, both take JAX's, since the ladder's ``pow`` differs by
an ulp or two between the packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu import pack as jpack
from nerfacc_tpu import volrend as jvol
from nerfacc_tpu.estimators.occ_grid import OccGridEstimator as JEstimator
from nerfacc_tpu.grid import traverse_and_compact as j_tc
from nerfacc_tpu.rendering import occgrid_render_rays as j_render
from nerfacc_tpu_torch import pack as tpack
from nerfacc_tpu_torch import scan as tscan
from nerfacc_tpu_torch import volrend as tvol
from nerfacc_tpu_torch.convert import occ_state_from_jax
from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator as TEstimator
from nerfacc_tpu_torch.rendering import occgrid_render_rays as t_render

ROI = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
RAY_INDICES = [0, 2, 2, 2, 2]
PACKED_INFO = [[0, 1], [1, 0], [1, 4]]


def test_render_visibility_golden():
    alphas = torch.tensor([0.4, 0.3, 0.8, 0.8, 0.5])
    ri = torch.tensor(RAY_INDICES, dtype=torch.int32)
    # transmittance: [1.0, 1.0, 0.7, 0.14, 0.028]
    vis = tvol.render_visibility_from_alpha(alphas, ray_indices=ri, early_stop_eps=0.03, alpha_thre=0.0)
    assert vis.tolist() == [True, True, True, True, False]
    vis = tvol.render_visibility_from_alpha(alphas, ray_indices=ri, early_stop_eps=0.05, alpha_thre=0.35)
    assert vis.tolist() == [True, False, True, True, False]
    # The same through packed_info, and with the threshold a 0-d tensor.
    vis = tvol.render_visibility_from_alpha(
        alphas, packed_info=torch.tensor(PACKED_INFO, dtype=torch.int32),
        early_stop_eps=0.05, alpha_thre=torch.tensor(0.35),
    )
    assert vis.tolist() == [True, False, True, True, False]


def _segments(rng, n_rays=40):
    counts = rng.integers(0, 30, n_rays)
    ri = np.repeat(np.arange(n_rays), counts).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    packed = np.stack([starts, counts], -1).astype(np.int32)
    return ri, packed


@pytest.mark.parametrize("layout", ["ray_indices", "packed_info"])
def test_visibility_functions_match_jax(layout):
    rng = np.random.default_rng(3)
    ri, packed = _segments(rng)
    n = ri.shape[0]
    t0 = np.sort(rng.random(n, dtype=np.float32))
    t1 = (t0 + rng.random(n, dtype=np.float32) * 0.05).astype(np.float32)
    sigmas = (rng.random(n, dtype=np.float32) * 30.0).astype(np.float32)
    alphas = (rng.random(n, dtype=np.float32) * 0.6).astype(np.float32)
    prefix = rng.uniform(0.5, 1.0, n).astype(np.float32)
    seg = {"ray_indices": ri} if layout == "ray_indices" else {"packed_info": packed}
    jseg = {k: jnp.asarray(v) for k, v in seg.items()}
    tseg = {k: torch.from_numpy(v) for k, v in seg.items()}
    # Jitted: eagerly, JAX compiles each scan step anew (seconds).  The values
    # lie far from both thresholds, so a last-bit difference cannot flip one.
    vis_alpha = jax.jit(jvol.render_visibility_from_alpha, static_argnames=("early_stop_eps",))
    vis_density = jax.jit(jvol.render_visibility_from_density, static_argnames=("early_stop_eps", "alpha_thre"))
    for eps, thre, pre in ((1e-4, 0.0, None), (0.02, 0.125, None), (0.05, 0.125, prefix)):
        jp = None if pre is None else jnp.asarray(pre)
        tp = None if pre is None else torch.from_numpy(pre)
        want_a = vis_alpha(
            jnp.asarray(alphas), **jseg, early_stop_eps=eps, alpha_thre=jnp.float32(thre), prefix_trans=jp
        )
        got_a = tvol.render_visibility_from_alpha(
            torch.from_numpy(alphas), **tseg, early_stop_eps=eps, alpha_thre=torch.tensor(thre), prefix_trans=tp
        )
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
        want_d = vis_density(
            jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(sigmas), **jseg,
            early_stop_eps=eps, alpha_thre=thre, prefix_trans=jp,
        )
        got_d = tvol.render_visibility_from_density(
            torch.from_numpy(t0), torch.from_numpy(t1), torch.from_numpy(sigmas), **tseg,
            early_stop_eps=eps, alpha_thre=thre, prefix_trans=tp,
        )
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        assert 0 < int(got_d.sum()) < n


def _host(fn, *widths):
    """``fn`` (numpy in, float32 numpy out) as a JAX callback, so that the
    JAX side can be jitted: outputs ``(n,)``, or ``(n, w)`` for each width
    ``w`` given (a tuple when more than one)."""

    def cb(*args):
        n = args[0].shape[0]
        shapes = [jax.ShapeDtypeStruct((n,) + ((w,) if w else ()), jnp.float32) for w in widths or (0,)]
        out = jax.pure_callback(lambda *a: fn(*map(np.asarray, a)), shapes if widths else shapes[0], *args)
        return tuple(out) if widths else out

    return cb


def _ball_density(o, d, ts, te, ri):
    """Density of a soft ball of radius 0.5 at the interval midpoints, in
    float64 numpy from float32 inputs: the same float32 result on both
    sides for the same t values."""
    ri = np.asarray(ri).astype(np.int64)
    t = (np.asarray(ts, np.float64) + np.asarray(te, np.float64)) / 2
    x = o[ri].astype(np.float64) + t[:, None] * d[ri].astype(np.float64)
    r = np.linalg.norm(x, axis=-1)
    return (40.0 / (1.0 + np.exp((r - 0.5) * 40.0))).astype(np.float32)


def _grid_states(res=32, levels=1, seed=0):
    """Estimators and states of both packages: a ball of occupied cells,
    occupancies that are multiples of 2^-12 (so their mean is exact)."""
    je, te = JEstimator(ROI, res, levels), TEstimator(ROI, res, levels)
    rng = np.random.default_rng(seed)
    g = (np.arange(res) + 0.5) / res * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    ball = np.sqrt(gx**2 + gy**2 + gz**2) < 0.6
    binaries = np.broadcast_to(ball, (levels,) + ball.shape).copy()
    occs = (rng.integers(0, 64, binaries.size) / 4096.0).astype(np.float32)
    js = je.set_binaries(je.init(), jnp.asarray(binaries)).replace(occs=jnp.asarray(occs))
    ts = occ_state_from_jax(te, js, device="cpu")
    return je, te, js, ts


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-2.0 * d + rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    return o, d


@pytest.mark.parametrize("fn", ["sigma_fn", "alpha_fn"])
def test_sampling_visibility_filter_matches_jax(fn):
    je, te, js, ts = _grid_states()
    o, d = _rays(1, 64)
    key = jax.random.PRNGKey(5)
    jitter = np.array(jax.random.uniform(key, (64,), jnp.float32))
    step = 2e-2

    def field(ts_, te_, ri):
        sigma = _ball_density(o, d, ts_, te_, ri)
        if fn == "alpha_fn":
            dt = np.asarray(te_, np.float64) - np.asarray(ts_, np.float64)
            return (1.0 - np.exp(-sigma * dt)).astype(np.float32)
        return sigma

    kw = dict(near_plane=0.5, far_plane=4.0, render_step_size=step, early_stop_eps=1e-3,
              alpha_thre=0.05, stratified=True, max_samples=128, sample_capacity=64 * 128)
    # Eager, as the JAX package's own tests call it: under jit XLA fuses
    # the jittered near plane into a multiply-add, one rounding fewer.
    want = je.sampling(js, jnp.asarray(o), jnp.asarray(d), key=key, **{fn: _host(field)}, **kw)
    got = te.sampling(ts, torch.from_numpy(o), torch.from_numpy(d), jitter=torch.from_numpy(jitter),
                      **{fn: lambda *a: torch.from_numpy(field(*(x.numpy() for x in a)))}, **kw)
    for g, w, name in zip(got, want, ("ray_indices", "t_starts", "t_ends", "is_valid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # The filter dropped samples the traversal kept, and collapsed them.
    plain = te.sampling(ts, torch.from_numpy(o), torch.from_numpy(d), jitter=torch.from_numpy(jitter), **kw)
    dropped = plain[3] & ~got[3]
    assert int(got[3].sum()) > 0 and int(dropped.sum()) > 0
    assert torch.equal(got[2][dropped], got[1][dropped])
    # The threshold is min(alpha_thre, mean(occs)), exact here.
    assert float(ts.occs.mean()) < kw["alpha_thre"]


def test_sampling_t_min_t_max_and_extras():
    _, te, _, ts = _grid_states()
    o, d = _rays(2, 32)
    rng = np.random.default_rng(2)
    t_min = torch.from_numpy(rng.uniform(1.0, 1.5, 32).astype(np.float32))
    t_max = t_min + 0.8
    out = te.sampling(ts, torch.from_numpy(o), torch.from_numpy(d), t_min=t_min, t_max=t_max,
                      render_step_size=1e-2, max_samples=128, return_extras=True)
    ri, t0, t1, valid, extras = out
    assert int(valid.sum()) > 0 and float(extras["macro_truncated_frac"]) == 0.0
    lo, hi = t_min[ri.long()] - 5e-3, t_max[ri.long()] + 5e-3
    assert bool(((t0 >= lo) | ~valid).all()) and bool(((t1 <= hi) | ~valid).all())


def _cameras():
    width = height = 100
    K = np.array([[[width, 0, width / 2], [0, height, height / 2], [0, 0, 1]]], np.float32)
    pose = np.array([[[-1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, -1.0, 2.5]]], np.float32)
    return K, pose, width, height


def test_mark_invisible_cells_golden_counts():
    """Golden voxel counts of the reference (test_grid.py:207-233), in
    chunks smaller than a level."""
    K, pose, width, height = _cameras()
    est = TEstimator(ROI, 32, 4)
    for chunk in (32**3, 5000):
        state = est.mark_invisible_cells(est.init("cpu"), torch.from_numpy(K), torch.from_numpy(pose),
                                         width, height, chunk=chunk)
        assert int((state.occs == -1).sum()) == 77660
        assert int((state.occs == 0).sum()) == 53412


def test_mark_invisible_cells_matches_jax():
    """Two cameras (one with a near plane that cuts cells off), occs that
    were non-zero before, against JAX; then an update leaves -1 cells at
    -1."""
    K, pose, width, height = _cameras()
    pose2 = pose.copy()
    pose2[0, :3, 3] = [0.5, -0.3, 2.0]
    poses = np.concatenate([pose, pose2])
    je, te = JEstimator(ROI, 16, 2), TEstimator(ROI, 16, 2)
    occs = np.random.default_rng(0).random(2 * 16**3, dtype=np.float32) * 0.02
    js = je.init().replace(occs=jnp.asarray(occs))
    ts = te.init("cpu").replace(occs=torch.from_numpy(occs))
    want = je.mark_invisible_cells(js, jnp.asarray(K), jnp.asarray(poses), width, height, near_plane=1.5, chunk=1000)
    got = te.mark_invisible_cells(ts, torch.from_numpy(K), torch.from_numpy(poses), width, height,
                                  near_plane=1.5, chunk=1000)
    np.testing.assert_array_equal(got.occs.numpy(), np.asarray(want.occs))
    assert 0 < int((got.occs == -1).sum()) < got.occs.numel()
    after = te._update(got, 0, lambda x: torch.full((x.shape[0], 1), 0.5), warmup_steps=1)
    assert torch.equal(after.occs == -1, got.occs == -1)


def _render_setup(n_rays=64):
    """An analytic ball, its grid and occupancies from one JAX update."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-2.0 * d).astype(np.float32)
    je, te = JEstimator(ROI, 32, 1), TEstimator(ROI, 32, 1)

    def density(x):
        r = np.linalg.norm(np.asarray(x, np.float64), axis=-1)
        return (0.02 * 40.0 / (1.0 + np.exp((r - 0.5) * 40.0)))[:, None].astype(np.float32)

    js = je.update_every_n_steps(je.init(), 0, lambda x: jnp.asarray(density(x)), jax.random.PRNGKey(0))
    ts = occ_state_from_jax(te, js, device="cpu")
    return o, d, je, te, js, ts


def _fns(o, d, to_array):
    def rgb(ts_, te_, ri):
        ri = np.asarray(ri).astype(np.int64)
        t = (np.asarray(ts_, np.float64) + np.asarray(te_, np.float64)) / 2
        x = o[ri] + t[:, None] * d[ri]
        return (1.0 / (1.0 + np.exp(-3.0 * x))).astype(np.float32)

    def rgb_sigma_fn(*a):
        a = [np.asarray(v) for v in a]
        return to_array(rgb(*a)), to_array(_ball_density(o, d, *a))

    def sigma_fn(*a):
        return to_array(_ball_density(o, d, *(np.asarray(v) for v in a)))

    return rgb_sigma_fn, sigma_fn


@pytest.mark.parametrize("refilter", [None, 64 * 64], ids=["mask", "refilter"])
def test_render_visibility_filter_matches_jax(refilter):
    o, d, je, te, js, ts = _render_setup()
    rgb_sigma, sigma = _fns(o, d, lambda a: a)
    j_fns = (_host(rgb_sigma, 3, 0), _host(sigma))
    t_fns = _fns(o, d, torch.from_numpy)
    kw = dict(near_plane=0.5, far_plane=4.0, render_step_size=2e-2, alpha_thre=1e-3,
              early_stop_eps=1e-2, sample_capacity=64 * 256, refilter_capacity=refilter)
    cj, oj, dj, nj, ej = jax.jit(lambda o_, d_: j_render(
        *j_fns, je, js, o_, d_, render_bkgd=jnp.ones(3), **kw
    ))(jnp.asarray(o), jnp.asarray(d))
    ct, ot, dt, nt, et = t_render(*t_fns, te, ts, torch.from_numpy(o), torch.from_numpy(d),
                                  render_bkgd=torch.ones(3), **kw)
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(et["kept"].numpy(), np.asarray(ej["kept"]))
    np.testing.assert_array_equal(et["ray_indices"].numpy(), np.asarray(ej["ray_indices"]))
    # JAX takes each ray's sum as the difference of two values of one
    # float32 prefix over all samples (after a refilter, a scatter-add), the
    # port of a float64 prefix: atol 4 float32 ulps of the largest prefix
    # value, as tests/test_torch_train.py holds rendering(seg_bounds=...).
    for g, w in ((ct, cj), (ot, oj), (dt * ot, dj * oj)):
        w = np.asarray(w)
        atol = 4 * np.spacing(np.float32(np.abs(w).sum()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol)
    # Without the filter more samples are rendered.
    _, _, _, n_all, _ = t_render(t_fns[0], None, te, ts, torch.from_numpy(o), torch.from_numpy(d),
                                 **dict(kw, alpha_thre=0.0, refilter_capacity=None))
    assert 0 < int(nt) < int(n_all)


def test_refilter_capacity_matches_mask_path():
    """The re-compacted pass renders the image of the mask path
    (tests/test_renderers.py:200), on fewer slots, with the same gradient
    of the densities."""
    o, d, _, te, _, ts = _render_setup()
    _, sigma_fn = _fns(o, d, torch.from_numpy)
    sig_scale = torch.ones((), requires_grad=True)

    def rgb_sigma_fn(ts_, te_, ri):
        rgb, sigma = _fns(o, d, torch.from_numpy)[0](ts_, te_, ri)
        return rgb, sigma * sig_scale

    kw = dict(near_plane=0.5, far_plane=4.0, render_step_size=2e-2, alpha_thre=1e-3,
              early_stop_eps=1e-4, sample_capacity=64 * 256, render_bkgd=torch.ones(3))
    rays = (torch.from_numpy(o), torch.from_numpy(d))
    c1, o1, d1, n1, e1 = t_render(rgb_sigma_fn, sigma_fn, te, ts, *rays, **kw)
    (g1,) = torch.autograd.grad(c1.sum(), sig_scale)
    c2, o2, d2, n2, e2 = t_render(rgb_sigma_fn, sigma_fn, te, ts, *rays, refilter_capacity=64 * 64, **kw)
    (g2,) = torch.autograd.grad(c2.sum(), sig_scale)
    assert int(n2) == int(n1) and e2["kept"].shape[0] == 64 * 64
    for a, b in ((c1, c2), (o1, o2), (d1 * o1, d2 * o2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-5)
    # A capacity below the survivors keeps the first ones, in order.
    c3, _, _, n3, e3 = t_render(rgb_sigma_fn, sigma_fn, te, ts, *rays, refilter_capacity=256, **kw)
    assert int(n3) == 256 and bool(e3["kept"].all())
    np.testing.assert_array_equal(e3["ray_indices"].numpy(), e1["ray_indices"][e1["kept"]][:256].numpy())


def test_visibility_on_jax_cone_traversal_matches_jax():
    """At cone_angle > 0 both functions get the t values of JAX's traversal
    (4 levels, the geometric ladder and its four skip probes), and agree
    exactly on the masks."""
    je = JEstimator(ROI, 32, 4)
    rng = np.random.default_rng(4)
    binaries = rng.random((4, 32, 32, 32)) < 0.3
    js = je.set_binaries(je.init(), jnp.asarray(binaries))
    o, d = _rays(4, 64)
    lattice, use_skip, stride, max_macro, row_cap = je.plan_traversal(1e-2, 0.004, 0.2)
    assert use_skip
    cs = jax.jit(lambda o_, d_: j_tc(
        o_, d_, js.binaries, js.aabbs, 64 * 64, near_planes=jnp.full((64,), 0.2), step_size=1e-2,
        cone_angle=0.004, traverse_steps_limit=row_cap, max_lattice_steps=lattice, skip_grid=js.skip_grid,
        macro_stride=stride, max_macro_segments=max_macro, packed_grids=js.binaries_packed,
        packed_skip=js.skip_packed,
    ))(jnp.asarray(o), jnp.asarray(d))
    ts_, te_, ri = (np.array(a) for a in (cs.t_starts, cs.t_ends, cs.ray_indices))
    kept = np.asarray(cs.kept)
    sig = np.where(kept, _ball_density(o, d, ts_, te_, ri) + 0.5, 0.0).astype(np.float32)
    thre = np.float32(1.0 / 256)
    want = jvol.render_visibility_from_density(
        jnp.asarray(ts_), jnp.asarray(te_), jnp.asarray(sig), ray_indices=jnp.asarray(ri),
        early_stop_eps=1e-3, alpha_thre=thre,
    )
    got = tvol.render_visibility_from_density(
        torch.from_numpy(ts_), torch.from_numpy(te_), torch.from_numpy(sig), ray_indices=torch.from_numpy(ri),
        early_stop_eps=1e-3, alpha_thre=torch.tensor(thre),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int((got.numpy() & kept).sum()) < int(kept.sum())


def test_flatten_batched_and_compact_flat_match_jax():
    rng = np.random.default_rng(6)
    a = rng.random((5, 7), dtype=np.float32)
    b = rng.random((5, 7, 3), dtype=np.float32)
    want = jpack.flatten_batched(jnp.asarray(a), jnp.asarray(b))
    got = tpack.flatten_batched(torch.from_numpy(a), torch.from_numpy(b))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    valid = rng.random(200) < 0.4
    for capacity in (32, int(valid.sum()), 150):
        wi, wk = jpack.compact_flat(jnp.asarray(valid), capacity)
        gi, gk = tpack.compact_flat(torch.from_numpy(valid), capacity)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))


def test_golden_grads_on_the_port():
    """The reference's golden weights and density gradients
    (tests/test_rendering.py:107), through every equivalent formulation of
    the port's volrend."""
    sigmas0 = torch.tensor([0.4, 0.8, 0.1, 0.8, 0.1])
    t_starts = torch.from_numpy(np.random.default_rng(2).random(5, dtype=np.float32))
    t_ends = t_starts + 1.0
    ri = torch.tensor(RAY_INDICES, dtype=torch.int32)
    packed = torch.tensor(PACKED_INFO, dtype=torch.int32)
    weights_ref = np.array([0.3297, 0.5507, 0.0428, 0.2239, 0.0174])
    sigmas_grad_ref = np.array([0.6703, 0.1653, 0.1653, 0.1653, 0.1653])

    def naive(seg):
        def fn(s):
            trans, _ = tvol.render_transmittance_from_density(t_starts, t_ends, s, n_rays=3, **seg)
            return trans * (1.0 - torch.exp(-s * (t_ends - t_starts)))
        return fn

    def weight_density(seg):
        return lambda s: tvol.render_weight_from_density(t_starts, t_ends, s, n_rays=3, **seg)[0]

    def weight_alpha(seg):
        return lambda s: tvol.render_weight_from_alpha(1.0 - torch.exp(-s * (t_ends - t_starts)), n_rays=3, **seg)[0]

    for make in (naive, weight_density, weight_alpha):
        for seg in ({"ray_indices": ri}, {"packed_info": packed}):
            s = sigmas0.clone().requires_grad_(True)
            w = make(seg)(s)
            w.sum().backward()
            np.testing.assert_allclose(w.detach().numpy(), weights_ref, atol=1e-4)
            np.testing.assert_allclose(s.grad.numpy(), sigmas_grad_ref, atol=1e-4)


def test_prod_grad_at_zero_is_exact():
    """Autograd through the port's segmented product scan is exact at a
    zero (tests/test_scan.py:86; the reference's CUDA backward is not)."""
    x = torch.tensor([0.5, 0.0, 2.0], requires_grad=True)
    tscan.inclusive_prod(x, packed_info=torch.tensor([[0, 3]], dtype=torch.int32)).sum().backward()
    # y = [x0, x0*x1, x0*x1*x2]; d/dx1 = x0 + x0*x2 = 0.5 + 1.0
    np.testing.assert_allclose(x.grad.numpy(), [1.0, 1.5, 0.0])
