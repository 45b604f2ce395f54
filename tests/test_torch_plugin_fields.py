"""The plug-in fields against the JAX package: TensoRF, K-Planes (static,
view-dependent or not, and dynamic) and TiNeuVox from converted weights
(``convert.field_from_jax``), forward and every parameter's gradient,
at points inside the box, outside it and on its faces; and the properties
``tests/test_models.py:176,196,212`` check on the JAX fields.

The weights are drawn in numpy at the JAX parameters' shapes (no flax
``init`` compiles), larger than the initialisers draw them, so the
deformation net moves points across cells and out of the box.  The JAX side
is jitted: its inputs are positions, and on them the jitted floats are the
eager ones within the tolerances.  Tolerances: forward rtol 1e-5 (atol
1e-7); every gradient within 1e-5 of its largest entry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.models import tensorf as jtensorf
from nerfacc_tpu.models import tineuvox as jtineuvox
from nerfacc_tpu_torch.convert import field_from_jax
from nerfacc_tpu_torch.models import KPlanesRadianceField, TensoRFRadianceField, TiNeuVoxRadianceField
from nerfacc_tpu_torch.models import tensorf as ttensorf

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
N = 64

# name: (JAX class, port class, keyword arguments shared by both, port-only
# keyword arguments, the call's arguments: "x", "t", "d" or None)
CASES = {
    "tensorf": (jtensorf.TensoRFRadianceField, TensoRFRadianceField,
                dict(resolution=16, density_components=4, appearance_components=8, appearance_dim=9,
                     mlp_width=16), {}, ("x", "d")),
    "kplanes": (jtensorf.KPlanesRadianceField, KPlanesRadianceField,
                dict(resolution=16, n_features=16, mlp_width=16), {}, ("x", None, "d")),
    # The occupancy CLI's call: (x, d) puts d in t and leaves no directions.
    "kplanes_cli": (jtensorf.KPlanesRadianceField, KPlanesRadianceField,
                    dict(resolution=16, n_features=16, mlp_width=16), dict(use_viewdirs=False), ("x", "d")),
    "kplanes_dynamic": (jtensorf.KPlanesRadianceField, KPlanesRadianceField,
                        dict(resolution=16, time_resolution=8, n_features=16, dynamic=True, mlp_width=16), {},
                        ("x", "t", "d")),
    "tineuvox": (jtineuvox.TiNeuVoxRadianceField, TiNeuVoxRadianceField,
                 dict(resolution=24, net_width=16), {}, ("x", "t", "d")),
}


def _points(seed):
    """16 on the box's faces (one coordinate at +-1 exactly) and corners, 8
    outside, 8 on plane-cell faces, the rest inside."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.95, 0.95, (N, 3))
    face = rng.integers(0, 3, 16)
    x[np.arange(16), face] = rng.choice([-1.0, 1.0], 16)
    x[16:18] = [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]
    x[18:26] = rng.uniform(1.02, 1.3, (8, 3)) * rng.choice([-1.0, 1.0], (8, 3))
    k = rng.integers(0, 16, (8, 3))
    x[26:34] = -1.0 + 2.0 * k / 15.0
    return x.astype(np.float32)


def _inputs(seed):
    rng = np.random.default_rng(seed + 100)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(x=_points(seed), d=d, t=rng.random((N, 1), dtype=np.float32))


def _draw(path, leaf, rng):
    name = path[-1].key
    shape = leaf.shape
    if name == "kernel":
        return rng.normal(0.0, 1.0 / np.sqrt(shape[0]), shape).astype(np.float32)
    if name == "bias":
        return rng.normal(0.0, 0.1, shape).astype(np.float32)
    if name == "grid":
        return rng.normal(0.0, 0.1, shape).astype(np.float32)
    if name[:2] in ("sp", "tp"):
        return rng.uniform(0.0, 0.4, shape).astype(np.float32)
    return rng.normal(0.0, 0.3, shape).astype(np.float32)  # TensoRF planes and lines


def _build(case, seed=0):
    jcls, tcls, kw, tkw, names = CASES[case]
    jfield = jcls(aabb=AABB, **kw)
    inp = _inputs(seed)
    args = [None if a is None else inp[a] for a in names]
    rng = np.random.default_rng(seed + 200)
    shapes = jax.eval_shape(jfield.init, jax.random.PRNGKey(0), *args)
    params = jax.tree_util.tree_map_with_path(lambda p, s: _draw(p, s, rng), shapes)
    tfield = tcls(aabb=AABB, **kw, **tkw, device="cpu")
    tfield.load_state_dict(field_from_jax(params))
    return jfield, params, tfield, args


def _t(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


def _density_args(case, args):
    """``query_density`` takes the positions (and a time field's times)."""
    return args[:1] + ([args[1]] if case in ("kplanes_dynamic", "tineuvox") else [])


def _loss_weights():
    rng = np.random.default_rng(7)
    return rng.normal(size=(N, 3)).astype(np.float32), rng.normal(size=(N, 1)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The port's field and its inputs, and JAX's outputs on them: ``(rgb,
    sigma, query_density)`` and the gradient of a weighted sum of ``rgb``
    and ``sigma``, in one jitted call."""
    jfield, params, tfield, args = _build(case)
    w_rgb, w_sigma = _loss_weights()

    def outputs(p):
        rgb, sigma = jfield.apply(p, *args)
        return rgb, sigma, jfield.apply(p, *_density_args(case, args), method="query_density")

    def loss(p):
        rgb, sigma, _ = outputs(p)
        return jnp.sum(rgb * w_rgb) + jnp.sum(sigma * w_sigma)

    outs, grads = jax.jit(lambda p: (outputs(p), jax.grad(loss)(p)))(params)
    return tfield, args, [np.asarray(o) for o in outs], jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    tfield, args, (rgb_j, sigma_j, dens_j), _ = _reference(case)
    with torch.no_grad():
        rgb_t, sigma_t = tfield(*_t(args))
        dens_t = tfield.query_density(*_t(_density_args(case, args)))
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(sigma_t.numpy(), sigma_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dens_t.numpy(), dens_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(dens_t.numpy(), sigma_t.numpy())
    if case == "tineuvox":  # query_opacity is the density times the step, as in JAX
        with torch.no_grad():
            op_t = tfield.query_opacity(*_t(_density_args(case, args)), 1e-2)
        np.testing.assert_array_equal(op_t.numpy(), dens_t.numpy() * np.float32(1e-2))
    # The points on the box's faces and outside it have zero density.
    inside = ((args[0] > -1.0) & (args[0] < 1.0)).all(-1)
    if case != "tineuvox":  # its selector is on the warped point
        assert (sigma_t.numpy()[~inside] == 0).all() and (~inside).sum() >= 26
    assert np.isfinite(rgb_t.numpy()).all()


@pytest.mark.parametrize("case", list(CASES))
def test_every_gradient_matches_jax(case):
    tfield, args, _, grads = _reference(case)
    w_rgb, w_sigma = _loss_weights()
    tfield.zero_grad(set_to_none=True)
    rgb, sigma = tfield(*_t(args))
    ((rgb * torch.from_numpy(w_rgb)).sum() + (sigma * torch.from_numpy(w_sigma)).sum()).backward()
    grads = field_from_jax(grads)
    named = dict(tfield.named_parameters())
    assert set(named) == set(grads)
    for name, g_want in grads.items():
        g_want = g_want.numpy()
        g_got = named[name].grad.numpy()
        assert np.abs(g_want).max() > 0, name
        np.testing.assert_allclose(g_got, g_want, rtol=0, atol=1e-5 * np.abs(g_want).max(), err_msg=name)


def test_interpolation_matches_jax_at_cell_faces_and_the_clip():
    # _interp_plane and _interp_line at coordinates on every cell face, at
    # 0 and 1, and outside [0, 1] (clipped), with their gradients in the
    # plane and in the coordinates (jnp.clip halves it at a bound).
    rng = np.random.default_rng(3)
    plane = rng.normal(size=(6, 5, 4)).astype(np.float32)
    line = rng.normal(size=(7, 4)).astype(np.float32)
    u = np.concatenate([np.arange(6) / 5.0, [0.0, 1.0, -0.2, 1.3], rng.random(6)]).astype(np.float32)
    v = np.concatenate([np.arange(6) / 4.0, [1.0, 0.0, 1.1, -0.4], rng.random(6)]).astype(np.float32)
    w = rng.normal(size=(u.shape[0], 4)).astype(np.float32)

    def jloss(pl, li, uu, vv):
        return jnp.sum((jtensorf._interp_plane(pl, uu, vv) + jtensorf._interp_line(li, uu)) * w)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(plane, line, u, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (plane, line, u, v)]
    out = ttensorf._interp_plane(ts[0], ts[2], ts[3]) + ttensorf._interp_line(ts[1], ts[2])
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jtensorf._interp_plane(plane, u, v) + jtensorf._interp_line(line, u)),
                               rtol=1e-6, atol=1e-7)
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-6)


def test_tensorf_field_properties():
    # tests/test_models.py:176 on the port: shapes, non-negative density,
    # zero density outside the box, gradients in the planes and lines.
    f = TensoRFRadianceField(aabb=AABB, resolution=32, mlp_width=32, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).random((16, 3), dtype=np.float32))
    d = torch.full((16, 3), 0.577)
    rgb, sig = f(x, d)
    assert rgb.shape == (16, 3) and sig.shape == (16, 1)
    assert float(sig.detach().min()) >= 0
    assert float(f.query_density(torch.tensor([[3.0, 0.0, 0.0]]))[0, 0]) == 0.0
    sig.sum().backward()
    assert float(f.dp0.grad.abs().sum()) > 0 and float(f.dl0.grad.abs().sum()) > 0
    # The initialisers: normal(0.1) planes, lecun-normal kernels, no bias
    # in the basis matrix.
    assert 0.08 < float(f.dp0.std()) < 0.12
    assert f.basis_mat.bias is None and f.rgb_mlp[0].in_features == 27 + 3


def test_kplanes_dynamic_depends_on_time():
    # tests/test_models.py:196 on the port.
    f = KPlanesRadianceField(aabb=AABB, resolution=16, dynamic=True, mlp_width=16, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).random((8, 3), dtype=np.float32))
    d = torch.full((8, 3), 0.577)
    rgb, sig = f(x, torch.full((8, 1), 0.3), d)
    assert rgb.shape == (8, 3) and sig.shape == (8, 1)
    sig2 = f.query_density(x, torch.full((8, 1), 0.9))
    assert float((sig - sig2).abs().max()) > 0
    # flax's uniform(0.2) draws on [0, 0.2).
    assert 0.0 <= float(f.sp0.min()) and float(f.sp0.max()) < 0.2
    with pytest.raises(ValueError, match="timestamps"):
        f.query_density(x)


def test_tineuvox_field_properties():
    # tests/test_models.py:212 on the port: shapes, time dependence, the
    # opacity probe, gradients everywhere.
    field = TiNeuVoxRadianceField(aabb=AABB, resolution=16, net_width=16, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).uniform(-0.8, 0.8, (33, 3)).astype(np.float32))
    d = torch.ones((33, 3)) / np.sqrt(3.0)
    t0, t1 = torch.zeros((33, 1)), torch.full((33, 1), 0.7)
    rgb, sigma = field(x, t0, d)
    assert rgb.shape == (33, 3) and sigma.shape == (33, 1)
    assert bool(torch.isfinite(rgb).all())
    s0 = field.query_density(x, t0)
    s1 = field.query_density(x, t1)
    assert not torch.allclose(s0, s1)
    assert field.query_opacity(x, t0, 1e-2).shape == (33, 1)
    rgb, sigma = field(x, t1, d)
    (rgb.sum() + sigma.sum()).backward()
    assert sum(float(p.grad.abs().sum()) for p in field.parameters()) > 0
    # The deformation net's last kernel draws normal(1e-4).
    assert float(field.deform_net[4].weight.abs().max()) < 1e-3
