"""The plug-in fields' train paths against the JAX examples: one TensoRF
step and one K-Planes step through ``train_ngp_nerf_occ.train_step``
(``examples/train_ngp_nerf_occ.py:243-270``: Adam with coupled weight decay
at the schedule's rate), one TiNeuVox step through
``train_mlp_tnerf.train_step`` (``examples/train_mlp_tnerf.py:133-151``),
from the same weights, occupancy state, stratified jitter and rays;
32 TensoRF steps of both loops, the density factors' decay held step by
step (ROADMAP Queue 3); and the CLIs' fields, built as the JAX examples
build them.

The JAX step is jitted and renders on the port's own samples (see
``_recorded``), its positions rounded as eager JAX rounds them (see
``_jax_step``).  Tolerances: kept samples equal; the loss within rtol 1e-5;
every gradient within 1e-5 of its largest entry, but TiNeuVox's time and
deformation nets at 5e-5 (below); Adam's update where the gradients' signs
agree.

The JAX example calls every field of the occupancy CLI as ``field.apply(
params, x, d)``, and ``KPlanesRadianceField.__call__`` takes ``(x, t,
directions)``: the view direction lands in ``t``, which a static field
ignores, so K-Planes there renders a view-independent colour from an MLP of
32 inputs.  The port's CLI builds that field (``use_viewdirs=False``), and
the tests pin it.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nerfacc_tpu.rendering as jrendering
from nerfacc_tpu.estimators.occ_grid import OccGridEstimator as JEstimator
from nerfacc_tpu.grid import CompactSamples as JCompactSamples
from nerfacc_tpu.models.tensorf import KPlanesRadianceField as JKPlanes
from nerfacc_tpu.models.tensorf import TensoRFRadianceField as JTensoRF
from nerfacc_tpu.models.tineuvox import TiNeuVoxRadianceField as JTiNeuVox
from nerfacc_tpu.rendering import gather_ray_od as j_gather_ray_od
from nerfacc_tpu.rendering import occgrid_render_rays as j_render
from nerfacc_tpu_torch.convert import occ_state_from_jax, field_from_jax
from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator as TEstimator
from nerfacc_tpu_torch.examples import train_mlp_nerf as mlp_cli
from nerfacc_tpu_torch.examples import train_mlp_tnerf as tnerf_cli
from nerfacc_tpu_torch.examples import train_ngp_nerf_occ as occ_cli
from nerfacc_tpu_torch.models import KPlanesRadianceField, TensoRFRadianceField, TiNeuVoxRadianceField

AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
N_RAYS, STEP, RES = 64, 5e-3, 32
CAPACITY = N_RAYS * 48
WEIGHT_DECAY, MAX_STEPS = 1e-6, 20000  # the CLI's NeRF-Synthetic block


def _shell(res):
    g = (np.arange(res) + 0.5) / res * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    return (np.abs(np.sqrt(gx**2 + gy**2 + gz**2) - 0.45) < 0.12)[None]


def _states():
    est_j = JEstimator(AABB, RES, 1)
    state_j = est_j.set_binaries(est_j.init(), jnp.asarray(_shell(RES)))
    est_t = TEstimator(AABB, RES, 1)
    return est_j, state_j, est_t, occ_state_from_jax(est_t, state_j, "cpu")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-3.0 * d + rng.normal(scale=0.05, size=(N_RAYS, 3))).astype(np.float32)
    return o, d, rng.random((N_RAYS, 3), dtype=np.float32), rng.random((N_RAYS, 1), dtype=np.float32)


def _params(jfield, args, seed):
    """Weights at the JAX parameters' shapes, drawn in numpy (no flax
    ``init`` compiles): planes near their initialisers' scale."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(0.0, 1.0 / np.sqrt(shape[0]), shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0.0, 0.05, shape).astype(np.float32)
        if name[:2] in ("sp", "tp"):
            return rng.uniform(0.0, 0.4, shape).astype(np.float32)
        return rng.normal(0.0, 0.2, shape).astype(np.float32)

    shapes = jax.eval_shape(jfield.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jitter(key):
    # rendering.py:137-142: the stratified jitter is uniform of the key's
    # second half.
    return np.array(jax.random.uniform(jax.random.split(key)[1], (N_RAYS,), jnp.float32))


def _jax_stepper(field, est, state, tx, timed=False):
    """The JAX examples' train step, written as they write it:
    ``step(params, opt_state, samples, o, d, pixels, key[, times])`` renders
    on the port's ``samples`` (see :func:`_recorded`) and returns the loss,
    the kept count, the gradients, and the parameters and optimizer state
    after the update.  Jitted with the samples as arguments, a loop of
    steps compiles once; one step (:func:`_jax_step`) compiles them in as
    constants."""

    def step(params, opt_state, samples, o, d, pixels, key, times=None):
        def loss_fn(p):
            def x_at(t_starts, t_ends, ray_indices):
                oo, dd = j_gather_ray_od(o, d, ray_indices)
                # The barrier keeps XLA from fusing o + t d into a
                # multiply-add: the product is rounded, as eager JAX and the
                # port round it.
                return oo + jax.lax.optimization_barrier(((t_starts + t_ends) / 2.0)[:, None] * dd), dd

            def time_of(ray_indices):
                return (times[ray_indices],) if timed else ()

            def sigma_fn(t_starts, t_ends, ray_indices):
                x, _ = x_at(t_starts, t_ends, ray_indices)
                return field.apply(p, x, *time_of(ray_indices), method="query_density")[..., 0]

            def rgb_sigma_fn(t_starts, t_ends, ray_indices):
                x, dd = x_at(t_starts, t_ends, ray_indices)
                rgb, sigma = field.apply(p, x, *time_of(ray_indices), dd)
                return rgb, sigma[..., 0]

            colors, _, _, n_samp, _ = j_render(
                rgb_sigma_fn, sigma_fn, est, state, o, d, near_plane=0.0, far_plane=1e10,
                render_step_size=STEP, render_bkgd=jnp.ones(3), stratified=True, key=key,
                sample_capacity=CAPACITY,
            )
            return optax.huber_loss(colors, pixels, delta=1.0).mean(), n_samp

        real = jrendering.traverse_and_compact
        jrendering.traverse_and_compact = lambda *a, **k: samples
        try:
            (loss, n_samp), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        finally:
            jrendering.traverse_and_compact = real
        updates, opt_state = tx.update(grads, opt_state, params)
        return loss, n_samp, grads, optax.apply_updates(params, updates), opt_state

    return step


@functools.lru_cache(maxsize=None)
def _occ_case(name):
    """The JAX field of the occupancy CLI's steps (``name``: tensorf or
    kplanes), a maker of its port, and its step (:func:`_jax_stepper`)."""
    kw = dict(resolution=24, mlp_width=16)
    if name == "tensorf":
        jfield = JTensoRF(aabb=AABB, density_components=4, appearance_components=8, appearance_dim=9, **kw)

        def tfield():
            return TensoRFRadianceField(AABB, density_components=4, appearance_components=8, appearance_dim=9,
                                        **kw, device="cpu")
    else:
        jfield = JKPlanes(aabb=AABB, n_features=16, **kw)

        def tfield():
            return KPlanesRadianceField(AABB, n_features=16, use_viewdirs=False, **kw, device="cpu")
    est_j, state_j, _, _ = _states()
    return jfield, tfield, _jax_stepper(jfield, est_j, state_j, _occ_tx())


def _jax_step(step, params, tx, o, d, pixels, key, samples, times=None):
    """One ``step`` (see :func:`_jax_stepper`) from a fresh optimizer state,
    jitted with everything but the parameters as constants (with the
    samples as arguments, XLA rounds TiNeuVox's warped positions otherwise
    than eager JAX: its deformation-net gradients move by 2e-3 of their
    largest entry).  The loss and kept count as Python numbers."""
    extra = () if times is None else (jnp.asarray(times),)
    loss, n_samp, grads, new, _ = jax.jit(lambda p: step(p, tx.init(p), samples, jnp.asarray(o), jnp.asarray(d),
                                                         jnp.asarray(pixels), key, *extra))(params)
    return float(loss), int(n_samp), grads, new


@contextlib.contextmanager
def _recorded(estimator, out: list):
    """Record the port's traversal and compaction of a step as JAX's
    ``CompactSamples``.  The JAX step renders on them: its traversal, jitted,
    moves t values by an ulp, which TiNeuVox's degree-8 encoding multiplies
    by up to 2^7, and eager, the traversal and rendering take a minute to
    compile.  The port's traversal is eager JAX's bit for bit
    (``tests/test_torch_traverse_compact.py``)."""
    real = estimator.compact_samples

    def recording(*a, **k):
        cs = real(*a, **k)
        out.append(JCompactSamples(*(None if v is None else jnp.asarray(v.numpy()) for v in cs)))
        return cs

    estimator.compact_samples = recording
    try:
        yield
    finally:
        del estimator.compact_samples


def _compare(loss_t, n_t, field, loss_j, n_j, grads_j, params_j, grads_t, params_atol=1e-7, wide=()):
    """Held as the module docstring says; the parameters whose names start
    with one of ``wide`` at 5e-5 of their largest entry."""
    assert n_t == n_j and n_t > 0
    assert loss_t == pytest.approx(loss_j, rel=1e-5)
    want_g = field_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    want_p = field_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
    new_p = dict(field.named_parameters())
    assert set(want_g) == set(new_p)
    for name, g_want in want_g.items():
        g_want, g_got = g_want.numpy(), grads_t[name].numpy()
        assert np.abs(g_want).max() > 0, name
        tol = (5e-5 if name.startswith(wide) else 1e-5) * np.abs(g_want).max()
        np.testing.assert_allclose(g_got, g_want, rtol=0, atol=tol, err_msg=name)
        # Adam's first step moves a parameter by about lr * sign(g): held
        # where the signs agree and |g| is far above eps.
        agree = np.sign(g_got) == np.sign(g_want)
        assert (np.abs(g_want[~agree]) <= tol).all(), name
        held = agree & (np.abs(g_want) > 1e-6)
        np.testing.assert_allclose(new_p[name].detach().numpy()[held], want_p[name].numpy()[held], rtol=0,
                                   atol=params_atol, err_msg=name)


def _grads(field):
    return {k: p.grad.clone() if p.grad is not None else torch.zeros_like(p) for k, p in field.named_parameters()}


def _occ_run(field, est_t, state_t, weight_decay=WEIGHT_DECAY):
    cfg = dict(near_plane=0.0, far_plane=1e10, render_step_size=STEP, cone_angle=0.0, alpha_thre=0.0,
               target_sample_batch_size=CAPACITY)
    return occ_cli.Run(cfg=cfg, field=field, estimator=est_t, occ_state=state_t,
                       opt=occ_cli.make_optimizer(field, weight_decay), schedule=occ_cli.lr_schedule(MAX_STEPS),
                       generator=torch.Generator())


def _occ_tx():
    # train_ngp_nerf_occ.py:188-208; the first update's rate is the
    # warm-up's 1e-4.
    schedule = optax.join_schedules(
        [optax.linear_schedule(0.01 / 100, 0.01, 100),
         optax.piecewise_constant_schedule(0.01, {MAX_STEPS // 2: 0.33, MAX_STEPS * 3 // 4: 0.33,
                                                  MAX_STEPS * 9 // 10: 0.33})],
        [100],
    )
    return optax.chain(optax.add_decayed_weights(WEIGHT_DECAY), optax.scale_by_adam(eps=1e-15),
                       optax.scale_by_schedule(schedule), optax.scale(-1.0))


@pytest.mark.parametrize("name", ["tensorf", "kplanes"])
def test_one_occupancy_cli_step_matches_jax(name):
    _, _, est_t, state_t = _states()
    o, d, pixels, _ = _inputs(0)
    jfield, tfield, step = _occ_case(name)
    tfield = tfield()
    # The example initialises every field with (x, d).
    params = _params(jfield, (np.zeros((8, 3), np.float32),) * 2, seed=1)
    key = jax.random.PRNGKey(3)
    tfield.load_state_dict(field_from_jax(params))
    run = _occ_run(tfield, est_t, state_t)
    samples = []
    with _recorded(est_t, samples):
        loss_t, n_t, _, _ = occ_cli.train_step(run, *(torch.from_numpy(a) for a in (o, d, pixels)), torch.ones(3),
                                               torch.from_numpy(_jitter(key)))
    loss_j, n_j, grads_j, params_j = _jax_step(step, params, _occ_tx(), o, d, pixels, key, samples[0])
    _compare(float(loss_t), int(n_t), tfield, loss_j, n_j, grads_j, params_j, _grads(tfield))


DECAY_STEPS = 32


def _density_magnitudes(named) -> np.ndarray:
    """The mean magnitude of each density factor, dp0 .. dp2 and dl0 .. dl2."""
    return np.array([float(np.abs(np.asarray(named[f"{k}{i}"])).mean()) for k in ("dp", "dl") for i in range(3)])


def test_tensorf_density_planes_decay_under_the_clis_optimizer_as_in_jax():
    # ROADMAP Queue 3: TensoRF collapses under the occupancy CLI's
    # optimizer.  DECAY_STEPS steps of both loops from the same weights (the
    # planes and lines at the initialiser's normal(0.1)) on the same samples,
    # with the CLI's Adam (eps 1e-15), coupled weight decay 1e-6 and
    # schedule: each step's loss within rtol 1e-5, and each density
    # factor's mean magnitude within 1e-5 of JAX's, relative (2.5e-06 at
    # most, measured).  The planes' magnitudes fall by a quarter or more on
    # both sides (to 0.66 of their start, measured), and the port's loop
    # without the weight decay keeps them: Adam at eps 1e-15 turns the
    # decay's gradient on the entries no sample reaches into full-rate
    # steps toward 0.
    _, _, est_t, state_t = _states()
    jfield, make_tfield, step = _occ_case("tensorf")
    step = jax.jit(step)
    rng = np.random.default_rng(4)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(0.0, 1.0 / np.sqrt(shape[0]), shape).astype(np.float32)
        if name == "bias":
            return np.zeros(shape, np.float32)
        return rng.normal(0.0, 0.1, shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jfield.init, jax.random.PRNGKey(0), *(np.zeros((8, 3), np.float32),) * 2))
    tx = _occ_tx()
    opt_state = tx.init(params)
    fields = {}
    for wd in (WEIGHT_DECAY, 0.0):
        fields[wd] = make_tfield()
        fields[wd].load_state_dict(field_from_jax(params))
    runs = {wd: _occ_run(f, est_t, state_t, wd) for wd, f in fields.items()}
    start = _density_magnitudes(field_from_jax(params))
    for i in range(DECAY_STEPS):
        o, d, pixels, _ = _inputs(100 + i)
        key = jax.random.PRNGKey(1000 + i)
        batch = [torch.from_numpy(a) for a in (o, d, pixels)] + [torch.ones(3), torch.from_numpy(_jitter(key))]
        samples = []
        with _recorded(est_t, samples):
            loss_t, n_t, _, _ = occ_cli.train_step(runs[WEIGHT_DECAY], *batch)
        occ_cli.train_step(runs[0.0], *batch)
        loss_j, n_j, _, params, opt_state = step(params, opt_state, samples[0], jnp.asarray(o), jnp.asarray(d),
                                                 jnp.asarray(pixels), key)
        assert int(n_t) == int(n_j) > 0
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5), i
        got = _density_magnitudes({k: p.detach() for k, p in fields[WEIGHT_DECAY].named_parameters()})
        want = _density_magnitudes(field_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=f"step {i}")
    assert (want[:3] < 0.75 * start[:3]).all() and (got[:3] < 0.75 * start[:3]).all(), (start, want)
    kept = _density_magnitudes({k: p.detach() for k, p in fields[0.0].named_parameters()})
    assert (kept[:3] > 0.95 * start[:3]).all(), (start, kept)


def test_one_tineuvox_step_matches_jax():
    est_j, state_j, est_t, state_t = _states()
    o, d, pixels, times = _inputs(1)
    jfield = JTiNeuVox(aabb=tuple(AABB), resolution=24, net_width=16)
    params = _params(jfield, (np.zeros((8, 3), np.float32), np.zeros((8, 1), np.float32),
                              np.zeros((8, 3), np.float32)), seed=2)
    key = jax.random.PRNGKey(5)
    tfield = TiNeuVoxRadianceField(AABB, resolution=24, net_width=16, device="cpu")
    tfield.load_state_dict(field_from_jax(params))
    cfg = dict(near_plane=0.0, far_plane=1e10, render_step_size=STEP, sample_capacity=CAPACITY)
    run = mlp_cli.Run(cfg=cfg, field=tfield, estimator=est_t, occ_state=state_t,
                      opt=torch.optim.Adam(tfield.parameters(), lr=mlp_cli.LR), generator=torch.Generator())
    samples = []
    with _recorded(est_t, samples):
        loss_t, n_t = tnerf_cli.train_step(run, *(torch.from_numpy(a) for a in (o, d, times, pixels)),
                                           torch.ones(3), torch.from_numpy(_jitter(key)))
    tx = optax.adam(mlp_cli.LR)
    loss_j, n_j, grads_j, params_j = _jax_step(_jax_stepper(jfield, est_j, state_j, tx, timed=True), params, tx,
                                               o, d, pixels, key, samples[0], times)
    # The time and deformation nets reach the loss only through the warped
    # point, which the degree-8 encoding multiplies by up to 2^7 before its
    # sin; under jit XLA fuses the voxel taps' and the layers' products and
    # sums into multiply-adds, so their gradients, summed over ~3000
    # samples, are 1.4e-05 of the largest entry apart (measured; 1.2e-06
    # for the voxel grid, 7.6e-07 for the heads).
    _compare(float(loss_t), int(n_t), tfield, loss_j, n_j, grads_j, params_j, _grads(tfield),
             wide=("time_net", "deform_net"))


def _n_params(tree) -> int:
    return sum(int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("name", ["tensorf", "kplanes"])
def test_occupancy_cli_builds_the_jax_examples_field(name):
    # train_ngp_nerf_occ.py:176-185: the field on the estimator's last-level
    # box at its defaults, initialised with (x, d); K-Planes' d lands in t.
    cfg = occ_cli.build_config("lego")
    est = TEstimator(roi_aabb=cfg["aabb"], resolution=cfg["grid_resolution"], levels=cfg["grid_nlvl"])
    field = occ_cli.make_field(cfg, est, field=name, device="cpu", generator=torch.Generator().manual_seed(0))
    jcls = {"tensorf": JTensoRF, "kplanes": JKPlanes}[name]
    aabb = tuple(np.asarray(est._aabbs_np[-1]).tolist())
    zeros = jnp.zeros((8, 3))
    want = jax.eval_shape(jcls(aabb=aabb).init, jax.random.PRNGKey(0), zeros, zeros)
    assert {k: tuple(v.shape) for k, v in field_from_jax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), want)).items()} == {
        k: tuple(p.shape) for k, p in field.named_parameters()}
    assert tuple(field.aabb.tolist()) == aabb
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1.0, 1.0, (32, 3)).astype(np.float32))
    d1 = torch.nn.functional.normalize(torch.randn(32, 3, generator=torch.Generator().manual_seed(1)), dim=-1)
    with torch.no_grad():
        rgb1, _ = field(x, d1)
        rgb2, _ = field(x, -d1)
    if name == "kplanes":  # view-independent, as the JAX example's
        assert field.rgb_mlp[0].in_features == 32
        torch.testing.assert_close(rgb1, rgb2, rtol=0, atol=0)
    else:
        assert field.rgb_mlp[0].in_features == 27 + 3
        assert float((rgb1 - rgb2).abs().max()) > 0


@pytest.mark.parametrize("smoke", [True, False])
def test_tnerf_cli_builds_the_jax_examples_tineuvox(smoke):
    # train_mlp_tnerf.py:85-91: resolution 32 with --smoke, 96 otherwise,
    # on the configuration's box.
    cfg = dict(aabb=np.array([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], np.float32))
    field = tnerf_cli.make_field("tineuvox", cfg, smoke, device="cpu", generator=torch.Generator().manual_seed(0))
    res = 32 if smoke else 96
    want = jax.eval_shape(JTiNeuVox(aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), resolution=res).init,
                          jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 1)), jnp.zeros((8, 3)))
    assert _n_params(want) == sum(p.numel() for p in field.parameters())
    assert field.voxels.grid.shape == (res**3, 8) and tuple(field.aabb.tolist()) == (-1.0,) * 3 + (1.0,) * 3
