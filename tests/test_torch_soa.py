"""The structure-of-arrays route through the occupancy path, against the JAX
package and against the port's array route: the flag-form scans, the
macro-skip branch of ``traverse_grids``, ``traverse_and_compact(carry_rays=
True)``, ``chunked_ray_components``, the field on ``(xs, ys, zs)`` tuples,
``occgrid_render_rays(rgb_sigma_soa_fn=)`` (with and without the refilter)
and ``_update(soa_positions=True)``.  Each test states its tolerance and the
JAX test it mirrors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu import grid as jgrid
from nerfacc_tpu import scan as jscan
from nerfacc_tpu.estimators.occ_grid import OccGridEstimator as JEstimator
from nerfacc_tpu.models.ngp import NGPRadianceField as JField
from nerfacc_tpu.rendering import chunked_ray_components as j_chunked
from nerfacc_tpu.rendering import occgrid_render_rays as j_render_rays
from nerfacc_tpu_torch import scan as tscan
from nerfacc_tpu_torch.convert import field_from_jax
from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator as TEstimator
from nerfacc_tpu_torch.grid import _enlarge_aabb, build_skip_grid, traverse_and_compact, traverse_grids
from nerfacc_tpu_torch.models.ngp import NGPRadianceField as TField
from nerfacc_tpu_torch.ops.occ_query import bitpack_grid
from nerfacc_tpu_torch.rendering import chunked_ray_components, occgrid_render_rays

SEG_SCANS = ("seg_inclusive_sum", "seg_exclusive_sum", "seg_inclusive_prod", "seg_exclusive_prod")
# nerfacc's docstring goldens (tests/test_scan.py:28): segments [1 2], [3 4 5], [6 7 8 9].
GOLDEN = {
    "seg_inclusive_sum": [1, 3, 3, 7, 12, 6, 13, 21, 30],
    "seg_exclusive_sum": [0, 1, 0, 3, 7, 0, 6, 13, 21],
    "seg_inclusive_prod": [1, 2, 3, 12, 60, 6, 42, 336, 3024],
    "seg_exclusive_prod": [1, 1, 1, 3, 12, 1, 6, 42, 336],
}
GOLDEN_FLAGS = [True, False, True, False, False, True, False, False, False]


@pytest.mark.parametrize("name", SEG_SCANS)
def test_flag_scans_golden_values_and_gradients_match_jax(name):
    x = torch.arange(1.0, 10.0)
    flags = torch.tensor(GOLDEN_FLAGS)
    np.testing.assert_array_equal(getattr(tscan, name)(x, flags).numpy(), GOLDEN[name])
    # The JAX package's gradients (custom VJPs for the sums, autodiff for the
    # products) on ragged segments with zeros in them: rtol 1e-5 (float32
    # reversed scans against float64 sums and products).
    rng = np.random.default_rng(3)
    counts = rng.integers(1, 12, 12)  # at most 128 elements: one JAX block
    f = np.zeros(counts.sum(), bool)
    f[np.concatenate([[0], np.cumsum(counts)[:-1]])] = True
    v = rng.uniform(0.5, 1.5, f.shape[0]).astype(np.float32)
    v[::17] = 0.0
    r = rng.standard_normal(f.shape[0]).astype(np.float32)
    fn = getattr(jscan, name)
    out_j, g_j = jax.jit(jax.value_and_grad(lambda a: jnp.sum(fn(a, jnp.asarray(f)) * r)))(jnp.asarray(v))
    vt = torch.from_numpy(v).requires_grad_(True)
    out = (getattr(tscan, name)(vt, torch.from_numpy(f)) * torch.from_numpy(r)).sum()
    out.backward()
    assert float(out) == pytest.approx(float(out_j), rel=1e-5)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-5)


def test_prod_grad_at_zero_is_correct():
    # tests/test_scan.py:86: y = [x0, x0 x1, x0 x1 x2]; d/dx1 = x0 + x0 x2.
    x = torch.tensor([0.5, 0.0, 2.0], requires_grad=True)
    tscan.seg_inclusive_prod(x, torch.tensor([True, False, False])).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [1.0, 1.5, 0.0])


def _rand_rays(n_rays, seed, origin_scale):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n_rays, 3)).astype(np.float32) * origin_scale
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _shell(res, r0, width):
    g = (np.arange(res) + 0.5) / res * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    return np.abs(np.sqrt(gx**2 + gy**2 + gz**2) - r0) < width


def _traverse(o, d, binaries, aabbs, skip=None, **kw):
    b = torch.from_numpy(binaries)
    extra = {} if skip is None else dict(skip_grid=skip, packed_skip=bitpack_grid(skip))
    return traverse_grids(
        torch.from_numpy(o), torch.from_numpy(d), b, aabbs, packed_grids=bitpack_grid(b), **extra, **kw
    )


def _traverse_both(o, d, binaries, aabbs, skip, **kw):
    """The port's macro-skip traverse_grids and the JAX package's (jitted,
    its plain occupancy query) on the same rays and grids."""
    tr = _traverse(o, d, binaries, aabbs, skip, **kw)
    jextra = dict(skip_grid=jnp.asarray(skip.numpy()))
    arrays = {k: jnp.asarray(v.numpy()) for k, v in kw.items() if isinstance(v, torch.Tensor)}
    static = {k: v for k, v in kw.items() if not isinstance(v, torch.Tensor)}
    jr = jax.jit(functools.partial(jgrid.traverse_grids, **static))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(binaries), jnp.asarray(aabbs.numpy()), **jextra, **arrays
    )
    return tr, jr


def _assert_traversals_equal(tr, jr, rtol, atol):
    # Every field, the invalid slots' termination planes included.
    np.testing.assert_array_equal(tr.num_valid.numpy(), np.asarray(jr.num_valid))
    np.testing.assert_array_equal(tr.is_valid.numpy(), np.asarray(jr.is_valid))
    for name in ("t_starts", "t_ends", "termination_planes", "far_effective"):
        np.testing.assert_allclose(
            getattr(tr, name).numpy(), np.asarray(getattr(jr, name)), rtol=rtol, atol=atol, err_msg=name
        )


def _aimed_rays(n_rays, seed):
    # Rays at the shell.  (tests/test_grid.py:187 draws random origins of
    # scale 2 and random directions: none of its 32 rays meets the shell,
    # so both branches emit no sample there.)
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (-2.5 * d + rng.normal(size=(n_rays, 3)) * 0.3).astype(np.float32), d


def test_skip_grid_traversal_matches_dense():
    # tests/test_grid.py:187: the macro-skip branch emits the dense branch's
    # samples (same num_valid, intervals within 1e-5), and equals JAX's in
    # every field (atol 1e-5; the dense branch is held against JAX's in
    # tests/test_torch_grid.py).
    o, d = _aimed_rays(32, 3)
    binaries = _shell(64, 0.5, 0.1)[None]
    aabbs = torch.tensor([[-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]])
    skip = build_skip_grid(torch.from_numpy(binaries), factor=4)
    kw = dict(step_size=0.02, max_lattice_steps=256)
    macro = dict(macro_stride=8, max_macro_segments=24)
    dense = _traverse(o, d, binaries, aabbs, **kw)
    skipr, jskip = _traverse_both(o, d, binaries, aabbs, skip, **macro, **kw)
    _assert_traversals_equal(skipr, jskip, 0, 1e-5)
    np.testing.assert_array_equal(dense.num_valid.numpy(), skipr.num_valid.numpy())
    assert int((dense.num_valid > 0).sum()) > 16
    for a, b in ((dense.t_starts, skipr.t_starts), (dense.t_ends, skipr.t_ends)):
        np.testing.assert_allclose(
            torch.where(dense.is_valid, a, 0.0).numpy(), torch.where(skipr.is_valid, b, 0.0).numpy(), atol=1e-5
        )


def _cone_scene(n_rays=24):
    rng = np.random.default_rng(9)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-3.0 * d).astype(np.float32)
    base = torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0])
    aabbs = torch.stack([_enlarge_aabb(base, 2**i) for i in range(2)])
    shell = _shell(32, 0.55, 0.12)
    binaries = np.stack([shell, shell])
    return o, d, binaries, aabbs, build_skip_grid(torch.from_numpy(binaries), 2)


def test_cone_macro_skip_preserves_samples():
    # tests/test_grid.py:254: on the geometric ladder (cone 0.008) with
    # four probes a segment, each ray keeps the dense samples (rtol 1e-5,
    # atol 1e-6), over two nested levels; the skip branch equals JAX's in
    # every field (the same tolerances).
    o, d, binaries, aabbs, skip = _cone_scene()
    kw = dict(step_size=0.01, cone_angle=0.008, max_lattice_steps=512, traverse_steps_limit=256)
    dense = _traverse(o, d, binaries, aabbs, **kw)
    macro, jmacro = _traverse_both(o, d, binaries, aabbs, skip, macro_stride=16, max_macro_segments=16, **kw)
    _assert_traversals_equal(macro, jmacro, 1e-5, 1e-6)
    assert int(dense.is_valid.sum()) > 0
    for ray in range(24):
        a = np.sort(dense.t_starts[ray][dense.is_valid[ray]].numpy())
        b = np.sort(macro.t_starts[ray][macro.is_valid[ray]].numpy())
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cone", [False, True], ids=["uniform", "cone"])
def test_truncated_macro_skip_matches_jax(cone):
    # A macro budget too small for the shell: rays whose occupied segments
    # pass it end their examined span at the last kept segment (grid.py:
    # 842-851), which sets the termination plane of their invalid slots.
    # Near and far planes and a ray mask as tests/test_torch_grid.py gives
    # them; every field against JAX's (rtol 1e-5, atol 1e-6).
    if cone:
        o, d, binaries, aabbs, skip = _cone_scene()
        kw = dict(step_size=0.01, cone_angle=0.008, max_lattice_steps=512, traverse_steps_limit=256,
                  macro_stride=16, max_macro_segments=2)
    else:
        o, d = _aimed_rays(32, 3)
        binaries = _shell(64, 0.5, 0.1)[None]
        aabbs = torch.tensor([[-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]])
        skip = build_skip_grid(torch.from_numpy(binaries), factor=4)
        kw = dict(step_size=0.02, max_lattice_steps=256, macro_stride=8, max_macro_segments=2)
    rng = np.random.default_rng(4)
    n = o.shape[0]
    kw.update(near_planes=torch.from_numpy((rng.random(n) * 0.5).astype(np.float32)),
              far_planes=torch.full((n,), 6.0), rays_mask=torch.from_numpy(rng.random(n) < 0.9))
    tr, jr = _traverse_both(o, d, binaries, aabbs, skip, skip_factor=int(binaries.shape[-1] // skip.shape[-1]),
                            **kw)
    _assert_traversals_equal(tr, jr, 1e-5, 1e-6)
    dense_kw = {k: v for k, v in kw.items() if k not in ("macro_stride", "max_macro_segments")}
    dense = _traverse(o, d, binaries, aabbs, **dense_kw)
    cut = (tr.num_valid < dense.num_valid).numpy()
    assert cut.any() and (tr.num_valid > 0).any()
    # A cut ray stops examining before the dense branch does.
    assert bool((tr.termination_planes[cut] < dense.termination_planes[cut]).all())
    with pytest.raises(ValueError, match="skip_factor"):
        traverse_grids(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(binaries), aabbs,
                       packed_grids=bitpack_grid(torch.from_numpy(binaries)), skip_grid=skip,
                       packed_skip=bitpack_grid(skip), skip_factor=3)


def test_carried_ray_components_are_the_gather_of_their_rays():
    # The carry's contract (grid.py:613-640): each slot's components equal
    # rays_o[ray_indices, k] and rays_d[ray_indices, k], padding slots
    # (ray n_rays - 1, JAX's col[-1] fill) included, bit for bit; the rest
    # of the compaction unchanged.  (traverse_and_compact is held against
    # JAX in tests/test_torch_traverse_compact.py.)
    te = TEstimator([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], 32, 1, 2)
    ts = te.set_binaries(te.init("cpu"), torch.from_numpy(_shell(32, 0.5, 0.12)[None]))
    o, d = _rand_rays(48, 5, 0.2)
    o = (o - 2.5 * d).astype(np.float32)
    kw = dict(near_planes=None, step_size=0.02, traverse_steps_limit=64, max_lattice_steps=256,
              macro_stride=8, max_macro_segments=8)
    cap = 48 * 64
    got = traverse_and_compact(
        torch.from_numpy(o), torch.from_numpy(d), ts.binaries, ts.aabbs, cap, packed_grids=ts.binaries_packed,
        skip_grid=ts.skip_grid, packed_skip=ts.skip_packed, carry_rays=True, **kw,
    )
    plain = traverse_and_compact(
        torch.from_numpy(o), torch.from_numpy(d), ts.binaries, ts.aabbs, cap, packed_grids=ts.binaries_packed,
        skip_grid=ts.skip_grid, packed_skip=ts.skip_packed, **kw,
    )
    assert plain.ray_comps is None
    for name in ("ray_indices", "t_starts", "t_ends", "kept"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    assert not bool(got.kept.all())  # padding slots present
    ri = got.ray_indices.long().numpy()
    assert ri[-1] == 47
    for k in range(3):
        for part, rays in ((0, o), (1, d)):
            comp = got.ray_comps[part][k]
            assert comp.is_contiguous() and comp.shape == (cap,)
            np.testing.assert_array_equal(comp.numpy(), rays[ri, k])


def test_chunked_ray_components_match_jax():
    # rendering.py:56-98: one gather a chunk of 4, bit-equal to JAX's and to
    # the per-sample gather; n % 4 != 0 falls back to per-sample gathers.
    rng = np.random.default_rng(0)
    o = rng.normal(size=(64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    ri = np.repeat(np.arange(64, dtype=np.int32), 8)
    for n in (ri.shape[0], ri.shape[0] - 1):
        got = chunked_ray_components(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(ri[:n]))
        want = j_chunked(jnp.asarray(o), jnp.asarray(d), jnp.asarray(ri[:n]))
        for part, rays in ((0, o), (1, d)):
            for k in range(3):
                np.testing.assert_array_equal(got[part][k].numpy(), np.asarray(want[part][k]))
                np.testing.assert_array_equal(got[part][k].numpy(), rays[ri[:n], k])


def _field_params(jfield, seed=0):
    """The JAX field's parameters drawn as flax draws them (the table
    ``U(0, 2e-4)``, kernels LeCun-normal, biases 0), from numpy:
    ``jax.eval_shape`` gives the tree without compiling ``init``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jfield.init, jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3)))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['table']"):
            v = rng.uniform(0.0, 2e-4, leaf.shape)
        elif name.endswith("['kernel']"):
            v = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])
        else:
            v = np.zeros(leaf.shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize(
    "cfg",
    [
        dict(encoder_type="fused", n_levels=4, n_features_per_level=16, log2_hashmap_size=15),
        dict(encoder_type="fused", n_levels=4, n_features_per_level=16, log2_hashmap_size=15, unbounded=True),
        dict(encoder_type="grouped", n_levels=16, n_features_per_level=2, log2_hashmap_size=12),
    ],
    ids=["fused", "fused-unbounded", "grouped"],
)
def test_ngp_soa_query_matches_array_path_and_jax(cfg):
    # tests/test_models.py:379: the field on (xs, ys, zs) tuples through
    # chunked_ray_components against the (n, 3) array path (rgb atol 1e-6,
    # density rtol 1e-5 / atol 1e-6), and against JAX's tuple path (the same
    # tolerances).
    aabb = [-1.5] * 3 + [1.5] * 3
    jfield = JField(aabb=aabb, **cfg)
    params = _field_params(jfield)
    tfield = TField(aabb=aabb, device="cpu", **cfg)
    tfield.load_state_dict(field_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(0)
    ri = np.repeat(np.arange(64, dtype=np.int32), 8)
    ro = rng.normal(size=(64, 3)).astype(np.float32)
    rd = rng.normal(size=(64, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    mid = rng.random(ri.shape[0]).astype(np.float32) + 2.5e-3
    scale = 3.0 if cfg.get("unbounded") else 1.0
    rays_o, rays_d, ri_t, mid_t = (torch.from_numpy(a) for a in (ro, rd, ri, mid))
    x = rays_o[ri_t.long()] + mid_t[:, None] * rays_d[ri_t.long()]
    rgb0, s0 = tfield(scale * x, rays_d[ri_t.long()])
    (ox, oy, oz), dirs = chunked_ray_components(rays_o, rays_d, ri_t)
    xs = tuple(scale * (c + mid_t * dc) for c, dc in zip((ox, oy, oz), dirs))
    rgb1, s1 = tfield(xs, dirs)
    np.testing.assert_allclose(rgb1.detach().numpy(), rgb0.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(s1.detach().numpy(), s0.detach().numpy(), rtol=1e-5, atol=1e-6)
    rgb_j, s_j = jax.jit(jfield.apply)(params, tuple(jnp.asarray(c.numpy()) for c in xs),
                                       tuple(jnp.asarray(c.numpy()) for c in dirs))
    np.testing.assert_allclose(rgb1.detach().numpy(), np.asarray(rgb_j), atol=1e-6)
    np.testing.assert_allclose(s1.detach().numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-6)


def test_soa_query_needs_the_fused_or_grouped_encoder():
    field = TField(aabb=[-1.0] * 3 + [1.0] * 3, encoder_type="hash", n_levels=2, log2_hashmap_size=10,
                   device="cpu")
    with pytest.raises(ValueError, match="fused or grouped"):
        field.query_density(tuple(torch.zeros(4) for _ in range(3)))


def _scene_fns(rays_o, rays_d, lib=torch):
    """The analytic scene of tests/test_renderers.py, in ``lib`` (torch or
    jax.numpy), with the array, SoA and density callbacks on it."""
    def take(rays, ri):
        return rays[ri.long()] if lib is torch else rays[ri]

    def sigma_at(x):
        return lib.where(lib.sqrt((x * x).sum(-1)) < 0.5, 8.0, 0.0)

    def rgb_at(x):
        return 1.0 / (1.0 + lib.exp(-3.0 * x))

    def rgb_sigma_fn(ts, te, ri):
        x = take(rays_o, ri) + ((ts + te) / 2)[:, None] * take(rays_d, ri)
        return rgb_at(x), sigma_at(x)

    def soa_fn(o, d, ts, te):
        tm = (ts + te) * 0.5
        x = lib.stack([o[k] + tm * d[k] for k in range(3)], -1)
        return rgb_at(x), sigma_at(x)

    def sigma_fn(ts, te, ri):
        return rgb_sigma_fn(ts, te, ri)[1]

    return rgb_sigma_fn, soa_fn, sigma_fn, sigma_at


@pytest.mark.parametrize("refilter", [None, 1536], ids=["plain", "refilter"])
def test_soa_render_matches_array_path(refilter):
    # tests/test_renderers.py:277: the SoA field callback renders sample for
    # sample as the array path (colour and depth atol 1e-6, the same kept
    # count), with and without the refilter; and as the JAX package's
    # occgrid_render_rays(rgb_sigma_soa_fn=), jitted, on the same grid: the
    # same samples and kept slots; colour, opacity and depth within atol
    # 1e-5 (tests/test_torch_render.py's) and rtol 1e-5 (float32 sums over
    # a ray's ~50 samples in another order: depths near 1.6 differ by 7e-6
    # of themselves).
    d = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o, rays_d = torch.from_numpy(-2.0 * d), torch.from_numpy(d)
    roi = [-1, -1, -1, 1, 1, 1]
    est = TEstimator(roi, 32, 1)
    rgb_sigma_fn, soa_fn, sigma_fn, sigma_at = _scene_fns(rays_o, rays_d)
    state = est._update(est.init("cpu"), 0, lambda x: sigma_at(x) * 0.02, warmup_steps=1,
                        draws=est.make_draws(0, torch.Generator().manual_seed(0), 1, device="cpu"))
    kw = dict(near_plane=0.0, far_plane=1e10, render_step_size=2e-2, sample_capacity=64 * 64,
              max_macro_segments=8, refilter_capacity=refilter, alpha_thre=1e-2 if refilter else 0.0)
    fn = sigma_fn if refilter else None
    c0, o0, d0, n0, e0 = occgrid_render_rays(rgb_sigma_fn, fn, est, state, rays_o, rays_d,
                                             render_bkgd=torch.ones(3), **kw)
    called = []

    def array_fn(*a):
        called.append(1)
        return rgb_sigma_fn(*a)

    c1, o1, d1, n1, e1 = occgrid_render_rays(array_fn, fn, est, state, rays_o, rays_d, rgb_sigma_soa_fn=soa_fn,
                                             render_bkgd=torch.ones(3), **kw)
    assert not called  # the SoA callback replaces the array one
    assert int(n0) == int(n1) > 0
    np.testing.assert_array_equal(e0["ray_indices"].numpy(), e1["ray_indices"].numpy())
    np.testing.assert_allclose(c1.numpy(), c0.numpy(), atol=1e-6)
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), atol=1e-6)
    assert float(o0.max()) > 0.5

    je = JEstimator(roi, 32, 1)
    js = je.set_binaries(je.init(), jnp.asarray(state.binaries.numpy())).replace(
        occs=jnp.asarray(state.occs.numpy()))

    def j_run(st, ro, rd):
        j_rgb_sigma, j_soa, j_sigma, _ = _scene_fns(ro, rd, jnp)
        return j_render_rays(j_rgb_sigma, j_sigma if refilter else None, je, st, ro, rd,
                             rgb_sigma_soa_fn=j_soa, render_bkgd=jnp.ones(3), **kw)

    cj, oj, dj, nj, ej = jax.jit(j_run)(js, jnp.asarray(rays_o.numpy()), jnp.asarray(rays_d.numpy()))
    assert int(n1) == int(nj)
    np.testing.assert_array_equal(e1["ray_indices"].numpy(), np.asarray(ej["ray_indices"]))
    np.testing.assert_array_equal(e1["kept"].numpy(), np.asarray(ej["kept"]))
    for got, want in ((c1, cj), (o1, oj), (d1, dj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_update_soa_positions_matches_array_path_and_jax():
    # tests/test_grid.py:396: the SoA update probes the same points as the
    # array update given the same jitter (the occupancies bit-equal), hands
    # occ_eval_fn a tuple, and equals JAX's SoA update with the jitter JAX
    # draws per component (fold_in(k_jit, c)), bit for bit.
    roi = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
    je, te = JEstimator(roi, 16, 2), TEstimator(roi, 16, 2)
    rng = np.random.default_rng(11)
    binaries = rng.random((2, 16, 16, 16)) > 0.7

    def density(xs, ys, zs, lib):
        return lib.exp(-4.0 * (xs * xs + ys * ys + zs * zs)) * (1.0 + 0.5 * lib.sin(7.0 * xs))

    seen = []

    def t_eval(x):
        seen.append(isinstance(x, tuple))
        xs, ys, zs = x if isinstance(x, tuple) else x.unbind(-1)
        return density(xs, ys, zs, torch)[..., None]

    def j_eval(x):
        return density(*x, jnp)[..., None]

    key = jax.random.PRNGKey(5)
    n = te.cells_per_lvl
    jitter = []
    k = key
    for _ in range(2):  # occ_grid.py:559-580: one split a level, a fold_in per component
        k, k_jit = jax.random.split(k)
        jitter.append({"jitter": tuple(
            torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(k_jit, c), (n,), jnp.float32)))
            for c in range(3))})
    ts0 = te.set_binaries(te.init("cpu"), torch.from_numpy(binaries))
    js0 = je.set_binaries(je.init(), jnp.asarray(binaries))
    soa = te._update(ts0, 0, t_eval, draws=jitter, soa_positions=True)
    arr = te._update(ts0, 0, t_eval, draws=jitter)
    assert seen == [True, True, False, False]
    np.testing.assert_array_equal(soa.occs.numpy(), arr.occs.numpy())
    # Eager: under jit XLA contracts the probe arithmetic into multiply-adds.
    want = je._update(js0, step=0, occ_eval_fn=j_eval, key=key, soa_positions=True)
    # The probes are the same float32 points; the density's exp and sin may
    # differ in their last bit between XLA and PyTorch: rtol 1e-6.
    np.testing.assert_allclose(soa.occs.numpy(), np.asarray(want.occs), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(soa.binaries.numpy(), np.asarray(want.binaries))
