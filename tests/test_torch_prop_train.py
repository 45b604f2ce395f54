"""One whole prop train step of ``examples/train_ngp_nerf_prop.py:133-197``
at a small size on the port against one JAX step, in the bounded
(``uniform``) and the unbounded (``lindisp``, opaque background)
configurations, with and without a proposal update; and the estimator's
sampling with and without proposal gradients.

The train step is held in stages, because resampling amplifies last-bit
differences: each level's cdf is ``1 - exp(-cumsum(sigma dt))``, XLA's and
PyTorch's ``cumsum`` round differently, a cdf a few ulps off moves the
resampled s values, and three levels compound that.  So:

1. sampling given the same densities (JAX's, fed to the port): s values at
   every level within atol 1e-6;
2. render, loss, backward and Adam on one set of samples (JAX's s values
   replayed into the port): the loss within rtol 1e-4, every gradient
   within 1e-4 of its largest value, the parameters after Adam within 1e-6
   where the gradients' signs agree (the bounded occupancy step's float32
   tolerances, ``tests/test_torch_train.py``);
3. the whole chained step: finite, the losses within rtol 1e-3.

Stratified draws are JAX's: one key split a level and one for the final
pass (``prop_net.py:73-76,102-105``), one uniform a ray
(``pdf.py:217-221``), passed to the port as ``jitter``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as Fn

from nerfacc_tpu.estimators import prop_net as jprop
from nerfacc_tpu.models.ngp import NGPDensityField as JDensity
from nerfacc_tpu.models.ngp import NGPRadianceField as JField
from nerfacc_tpu.rendering import propnet_render_rays as j_render
from nerfacc_tpu_torch.convert import field_from_jax
from nerfacc_tpu_torch.data_specs import RayIntervals, RaySamples
from nerfacc_tpu_torch.estimators import prop_net as tprop
from nerfacc_tpu_torch.models.ngp import NGPDensityField as TDensity
from nerfacc_tpu_torch.models.ngp import NGPRadianceField as TField
from nerfacc_tpu_torch.ops.table_grad import table_grad_w3
from nerfacc_tpu_torch.rendering import propnet_render_rays as t_render


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# examples/train_ngp_nerf_prop.py:107-131 at a small size: 5 levels, F = 2,
# 2^(10 - 3) rows a level, MLP 16 wide.
PROP = dict(n_levels=5, n_features_per_level=2, log2_hashmap_size=10, mlp_width=16)
ROI = [-1.0] * 3 + [1.0] * 3


# examples/train_ngp_nerf_prop.py:67-82 at a small size.
CONFIGS = {
    # The bounded (NeRF-synthetic) block: one proposal level.
    "uniform": dict(aabb=[-1.5] * 3 + [1.5] * 3, unbounded=False, near_plane=2.0, far_plane=6.0,
                    sampling_type="uniform", num_samples=16, prop_samples=(32,), max_res=(128,), opaque_bkgd=False),
    # The unbounded (Mip-NeRF 360) block: two levels, lindisp, opaque.
    "lindisp": dict(aabb=ROI, unbounded=True, near_plane=0.2, far_plane=1e3, sampling_type="lindisp",
                    num_samples=16, prop_samples=(32, 16), max_res=(128, 256), opaque_bkgd=True),
}
FIELD = dict(n_levels=2, n_features_per_level=16, log2_hashmap_size=12, mlp_width=16, geo_feat_dim=15)
N_RAYS = 64


def _prop_rays(cfg):
    rng = np.random.default_rng(5)
    if cfg["unbounded"]:  # origins on the unit sphere, aimed at points in +-0.5
        o = rng.normal(size=(N_RAYS, 3))
        o /= np.linalg.norm(o, axis=-1, keepdims=True)
        d = rng.uniform(-0.5, 0.5, (N_RAYS, 3)) - o
    else:  # origins at radius 4, aimed at points in +-0.5
        o = rng.normal(size=(N_RAYS, 3))
        o *= 4.0 / np.linalg.norm(o, axis=-1, keepdims=True)
        d = rng.uniform(-0.5, 0.5, (N_RAYS, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), rng.random((N_RAYS, 3), dtype=np.float32)


class _Jax:
    """The example's fields, initialised from one key as its loop does, and
    its render and train step (``train_ngp_nerf_prop.py:107-188``)."""

    def __init__(self, cfg):
        self.cfg = cfg
        aabb = tuple(cfg["aabb"])
        self.field = JField(aabb=aabb, unbounded=cfg["unbounded"], compute_dtype=None, table_grad="factor", **FIELD)
        key, sub = jax.random.split(jax.random.PRNGKey(42))
        self.fp = self.field.init(sub, jnp.zeros((8, 3)), jnp.zeros((8, 3)))
        self.nets = [JDensity(aabb=aabb, unbounded=cfg["unbounded"], max_resolution=mr, **PROP)
                     for mr in cfg["max_res"]]
        pp = []
        for net in self.nets:
            key, sub = jax.random.split(key)
            pp.append(net.init(sub, jnp.zeros((8, 3))))
        self.pp = tuple(pp)
        self.est = jprop.PropNetEstimator()

    def step(self, o, d, pixels, key, requires_grad):
        """One train step, run eagerly (under jit XLA contracts multiply-adds,
        such as the positions o + t d, and a position an ulp off can cross a
        cell face, where the fused encoder's features jump).  Also returns
        each resampling's interval edges in s and each level's densities,
        as the step computed them."""
        c = self.cfg
        edges, densities = {}, {}
        calls = itertools.count()

        def keep(store, i, value):
            jax.debug.callback(lambda v: store.__setitem__(i, np.asarray(v)), value)

        def recording(*a, **k):
            intervals, samples = importance_sampling(*a, **k)
            keep(edges, next(calls), intervals.vals)
            return intervals, samples

        def prop_fn(ts, te, net, p, i):
            sigma = net.apply(p, o[:, None] + ((ts + te) / 2.0)[..., None] * d[:, None])[..., 0]
            keep(densities, i, sigma)
            return sigma

        def loss_fn(fp, pp):
            def rgb_sigma_fn(ts, te):
                x = o[:, None] + ((ts + te) / 2.0)[..., None] * d[:, None]
                rgb, sigma = self.field.apply(fp, x, jnp.broadcast_to(d[:, None], x.shape))
                return rgb, sigma[..., 0]

            prop_fns = [lambda ts, te, net=net, p=p, i=i: prop_fn(ts, te, net, p, i)
                        for i, (net, p) in enumerate(zip(self.nets, pp))]
            colors, _, _, extras = j_render(
                rgb_sigma_fn, prop_fns, self.est, o, d, num_samples=c["num_samples"],
                prop_samples=c["prop_samples"], near_plane=c["near_plane"], far_plane=c["far_plane"],
                sampling_type=c["sampling_type"], opaque_bkgd=c["opaque_bkgd"], render_bkgd=jnp.ones(3),
                stratified=True, requires_grad=requires_grad, key=key,
            )
            loss = optax.huber_loss(colors, pixels, delta=1.0).mean()
            prop_loss = self.est.compute_loss(extras["prop_cache"], extras["trans"])
            return loss + prop_loss, (loss, prop_loss, extras["t_starts"])

        importance_sampling = jprop.importance_sampling
        jprop.importance_sampling = recording
        try:
            (_, (loss, prop_loss, ts)), (gf, gp) = jax.value_and_grad(
                loss_fn, argnums=(0, 1), has_aux=True
            )(self.fp, self.pp)
            jax.effects_barrier()
        finally:
            jprop.importance_sampling = importance_sampling
        tx = optax.adam(1e-2, eps=1e-15)
        fp = optax.apply_updates(self.fp, tx.update(gf, tx.init(self.fp))[0])
        pp = optax.apply_updates(self.pp, tx.update(gp, tx.init(self.pp))[0]) if requires_grad else self.pp
        return dict(
            loss=float(loss), prop_loss=float(prop_loss), gf=gf, gp=gp, fp=fp, pp=pp, t_starts=np.asarray(ts),
            edges=[edges[i] for i in sorted(edges)], densities=[densities[i] for i in sorted(densities)],
        )


def _port(j):
    """The port's fields with the JAX fields' weights."""
    c = j.cfg
    field = TField(aabb=c["aabb"], unbounded=c["unbounded"], compute_dtype=None, device="cpu", **FIELD)
    field.load_state_dict(field_from_jax(_np(j.fp)))
    props = []
    for mr, p in zip(c["max_res"], j.pp):
        net = TDensity(aabb=c["aabb"], unbounded=c["unbounded"], max_resolution=mr, device="cpu", **PROP)
        net.load_state_dict(field_from_jax(_np(p)))
        props.append(net)
    return field, props


def _port_step(j, o, d, pixels, jitter, requires_grad):
    """One step of the example's loop on the port: render, Huber loss plus
    the proposal loss, one backward, the field's Adam, and the proposal
    nets' Adam only when ``requires_grad``."""
    c = j.cfg
    field, props = _port(j)
    opt_f = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)
    opt_p = torch.optim.Adam([p for net in props for p in net.parameters()], lr=1e-2, eps=1e-15)

    def rgb_sigma_fn(ts, te):
        x = o[:, None] + ((ts + te) / 2.0)[..., None] * d[:, None]
        rgb, sigma = field(x, d[:, None].expand(x.shape))
        return rgb, sigma[..., 0]

    prop_fns = [lambda ts, te, net=net: net(o[:, None] + ((ts + te) / 2.0)[..., None] * d[:, None])[..., 0]
                for net in props]
    colors, _, _, extras = t_render(
        rgb_sigma_fn, prop_fns, tprop.PropNetEstimator(), o, d, num_samples=c["num_samples"],
        prop_samples=c["prop_samples"], near_plane=c["near_plane"], far_plane=c["far_plane"],
        sampling_type=c["sampling_type"], opaque_bkgd=c["opaque_bkgd"], render_bkgd=torch.ones(3),
        stratified=True, requires_grad=requires_grad, jitter=jitter,
    )
    loss = Fn.huber_loss(colors, pixels, delta=1.0)
    prop_loss = tprop.PropNetEstimator().compute_loss(extras["prop_cache"], extras["trans"])
    opt_f.zero_grad(set_to_none=True)
    opt_p.zero_grad(set_to_none=True)
    (loss + prop_loss).backward()
    opt_f.step()
    if requires_grad:
        opt_p.step()
    grads = {k: v.grad for k, v in field.named_parameters()}
    grads.update({f"prop{i}.{k}": v.grad for i, net in enumerate(props) for k, v in net.named_parameters()})
    params = {k: v.detach() for k, v in field.named_parameters()}
    params.update({f"prop{i}.{k}": v.detach() for i, net in enumerate(props) for k, v in net.named_parameters()})
    return float(loss.detach()), float(prop_loss.detach()), grads, params, extras


def _jax_draws(key, levels):
    """The stratified offsets the JAX estimator draws from ``key``."""
    draws = []
    for _ in range(levels + 1):
        key, sub = jax.random.split(key)
        draws.append(_t(jax.random.uniform(sub, (N_RAYS, 1), jnp.float32)))
    return draws


@pytest.mark.parametrize("requires_grad", [True, False], ids=["prop-update", "no-prop-update"])
@pytest.mark.parametrize("sampling_type", ["uniform", "lindisp"])
def test_one_prop_train_step_matches_jax(sampling_type, requires_grad, monkeypatch):
    cfg = CONFIGS[sampling_type]
    j = _Jax(cfg)
    o, d, pixels = _prop_rays(cfg)
    oj, dj, pj = jnp.asarray(o), jnp.asarray(d), jnp.asarray(pixels)
    ot, dt, pt = _t(o), _t(d), _t(pixels)
    key = jax.random.PRNGKey(1)
    jitter = _jax_draws(key, len(cfg["prop_samples"]))
    n_levels = len(cfg["prop_samples"])

    js = j.step(oj, dj, pj, key, requires_grad)
    assert len(js["edges"]) == n_levels + 1 and len(js["densities"]) == n_levels

    # 1. Sampling given JAX's densities: the s values of every level.
    fed = iter(js["densities"])
    _, _, t_cache = tprop.PropNetEstimator().sampling(
        [lambda ts, te: _t(next(fed))] * n_levels, list(cfg["prop_samples"]), cfg["num_samples"], N_RAYS,
        cfg["near_plane"], cfg["far_plane"], cfg["sampling_type"], stratified=True, requires_grad=True,
        jitter=jitter, device="cpu",
    )
    assert len(t_cache) == n_levels + 1
    for lvl, (got, want) in enumerate(zip(t_cache, js["edges"])):
        err = float(np.abs(got[0].numpy() - want).max())
        assert err <= 1e-6, f"level {lvl}: s max abs err {err}"

    # 2. One set of samples: JAX's s values replayed into the port, which
    # maps them to the same t values (test_transform_stot_matches_jax).
    replay = iter(js["edges"])

    def replayed(intervals, cdfs, n, *a, **k):
        s = _t(next(replay))
        return RayIntervals(vals=s), RaySamples(vals=(s[:, 1:] + s[:, :-1]) / 2)

    monkeypatch.setattr(tprop, "importance_sampling", replayed)
    before = table_grad_w3.launches
    loss_t, prop_t, grads, params, extras = _port_step(j, ot, dt, pt, jitter, requires_grad)
    monkeypatch.undo()
    assert table_grad_w3.launches == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(extras["t_starts"].numpy(), js["t_starts"])
    assert loss_t == pytest.approx(js["loss"], rel=1e-4)
    assert prop_t == pytest.approx(js["prop_loss"], rel=1e-4, abs=1e-9)
    assert (js["prop_loss"] > 0) == requires_grad
    want_g = field_from_jax(_np(js["gf"]))
    want_p = field_from_jax(_np(js["fp"]))
    for i in range(len(j.nets)):
        want_g.update({f"prop{i}.{k}": v for k, v in field_from_jax(_np(js["gp"][i])).items()})
        want_p.update({f"prop{i}.{k}": v for k, v in field_from_jax(_np(js["pp"][i])).items()})
    for name, g_want in want_g.items():
        g_want, p_want, p_got = g_want.numpy(), want_p[name].numpy(), params[name].numpy()
        if grads[name] is None:  # no proposal update: no gradient reached the net
            assert name.startswith("prop") and not requires_grad and not g_want.any(), name
            np.testing.assert_array_equal(p_got, p_want, err_msg=name)
            continue
        g_got = grads[name].numpy()
        tol = 1e-4 * np.abs(g_want).max()
        np.testing.assert_allclose(g_got, g_want, rtol=0, atol=tol, err_msg=name)
        # Adam's first step moves a parameter by about lr * sign(g): held
        # where the signs agree and |g| is far above eps.
        agree = np.sign(g_got) == np.sign(g_want)
        assert (np.abs(g_want[~agree]) <= tol).all(), name
        held = agree & (np.abs(g_want) > 1e-9)
        np.testing.assert_allclose(p_got[held], p_want[held], rtol=0, atol=1e-6, err_msg=name)
    assert np.abs(want_g["encoder.table"].numpy()).max() > 0
    if requires_grad:
        assert all(np.abs(want_g[f"prop{i}.encoder.table"].numpy()).max() > 0 for i in range(len(j.nets)))

    # 3. The chained step, the port's own sampling from the same draws.
    loss_c, prop_c, _, params_c, extras_c = _port_step(j, ot, dt, pt, jitter, requires_grad)
    assert all(torch.isfinite(v).all() for v in params_c.values())
    assert torch.isfinite(extras_c["t_starts"]).all()
    ts_j = _t(js["t_starts"])
    print(f"{sampling_type}: chained loss {loss_c:.7f} vs JAX {js['loss']:.7f}, prop loss {prop_c:.7g} vs "
          f"{js['prop_loss']:.7g}, t max rel err {float(((extras_c['t_starts'] - ts_j) / ts_j).abs().max()):.2e}")
    assert loss_c == pytest.approx(js["loss"], rel=1e-3)
    assert prop_c == pytest.approx(js["prop_loss"], rel=1e-3, abs=1e-9)


def test_requires_grad_only_adds_the_cache():
    # The same samples with and without proposal gradients; without them the
    # nets run under no_grad and the cache is empty.
    cfg = CONFIGS["lindisp"]
    j = _Jax(cfg)
    o, d, _ = _prop_rays(cfg)
    ot, dt = _t(o), _t(d)
    _, props = _port(j)
    seen = []

    def fn(net):
        def sigma(ts, te):
            out = net(ot[:, None] + ((ts + te) / 2.0)[..., None] * dt[:, None])[..., 0]
            seen.append(out.requires_grad)
            return out

        return sigma

    outs = []
    for rg in (True, False):
        outs.append(tprop.PropNetEstimator().sampling(
            [fn(net) for net in props], [32, 16], 16, N_RAYS, 0.2, 1e3, "lindisp", stratified=True,
            requires_grad=rg, generator=torch.Generator().manual_seed(0), device="cpu",
        ))
    (ts1, te1, cache1), (ts0, te0, cache0) = outs
    assert torch.equal(ts1, ts0) and torch.equal(te1, te0)
    assert len(cache1) == 3 and cache0 == [] and seen == [True, True, False, False]
    assert cache1[0][1].requires_grad and not ts1.requires_grad
