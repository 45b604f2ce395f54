"""The MLP family's train path against the JAX package: one vanilla-NeRF
step and one T-NeRF step (``examples/train_mlp_nerf.py:136-161`` and
``examples/train_mlp_tnerf.py:133-151``, through the port CLIs' own
``train_step``) from the same weights, occupancy state (carried over by
``occ_state_from_jax``), stratified jitter and update draws; and 16 steps of
``train_mlp_nerf``'s loop beside the JAX example's loop.

The single steps run JAX eagerly: under jit XLA fuses ``o + t d`` into a
multiply-add, which moves a sample position by an ulp, and the degree-10
positional encoding multiplies a position by up to 2^9 before its sin
(``tests/test_torch_prop_train.py`` runs its JAX step eagerly for the same
reason).  Tolerances: kept samples equal; the loss within rtol 1e-5; every
gradient within atol 1e-5 of its largest entry (float32 GEMMs summed in
another order); Adam's update held where the gradients' signs agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nerfacc_tpu.datasets._native as jnative
from nerfacc_tpu.datasets.procedural import make_loaders as j_make_loaders
from nerfacc_tpu.estimators.occ_grid import OccGridEstimator as JEstimator
from nerfacc_tpu.models import mlp as jmlp
from nerfacc_tpu.rendering import gather_ray_od as j_gather_ray_od
from nerfacc_tpu.rendering import occgrid_render_rays as j_render
from nerfacc_tpu_torch.convert import mlp_field_from_jax, occ_state_from_jax
from nerfacc_tpu_torch.datasets import procedural as tproc
from nerfacc_tpu_torch.datasets.nerf_synthetic import SubjectLoader as TLoader
from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator as TEstimator
from nerfacc_tpu_torch.examples import common
from nerfacc_tpu_torch.examples import train_mlp_nerf as mlp_cli
from nerfacc_tpu_torch.examples import train_mlp_tnerf as tnerf_cli
from nerfacc_tpu_torch.models import mlp as tmlp

AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
# 48 slots a ray (train_mlp_tnerf.py's) for every step here: eager JAX
# compiles each operation once a shape, so one capacity compiles once.
N_RAYS, STEP, RES = 64, 5e-3, 32
CAPACITY = N_RAYS * 48


def _shell(res):
    g = (np.arange(res) + 0.5) / res * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    return (np.abs(np.sqrt(gx**2 + gy**2 + gz**2) - 0.45) < 0.12)[None]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-3.0 * d + rng.normal(scale=0.05, size=(N_RAYS, 3))).astype(np.float32)
    pixels = rng.random((N_RAYS, 3), dtype=np.float32)
    times = rng.random((N_RAYS, 1), dtype=np.float32)
    return o, d, pixels, times


def _jax_step(field, params, est, state, o, d, pixels, key, capacity, times=None):
    """The JAX examples' train step, written as they write it (eager)."""
    tx = optax.adam(5e-4)
    rays_o, rays_d = jnp.asarray(o), jnp.asarray(d)
    ts = None if times is None else jnp.asarray(times)

    def loss_fn(p):
        def fn_args(t_starts, t_ends, ray_indices):
            oo, dd = j_gather_ray_od(rays_o, rays_d, ray_indices)
            x = oo + ((t_starts + t_ends) / 2.0)[:, None] * dd
            return (x,) if ts is None else (x, ts[ray_indices])

        def sigma_fn(t_starts, t_ends, ray_indices):
            return field.apply(p, *fn_args(t_starts, t_ends, ray_indices), method="query_density")[..., 0]

        def rgb_sigma_fn(t_starts, t_ends, ray_indices):
            _, dd = j_gather_ray_od(rays_o, rays_d, ray_indices)
            rgb, sigma = field.apply(p, *fn_args(t_starts, t_ends, ray_indices), dd)
            return rgb, sigma[..., 0]

        colors, _, _, n_samp, _ = j_render(
            rgb_sigma_fn, sigma_fn, est, state, rays_o, rays_d, near_plane=0.0, far_plane=1e10,
            render_step_size=STEP, render_bkgd=jnp.ones(3), stratified=True, key=key, sample_capacity=capacity,
        )
        return optax.huber_loss(colors, jnp.asarray(pixels), delta=1.0).mean(), n_samp

    (loss, n_samp), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, _ = tx.update(grads, tx.init(params))
    return float(loss), int(n_samp), grads, optax.apply_updates(params, updates)


def _run(field, est_t, state_t, capacity):
    cfg = dict(near_plane=0.0, far_plane=1e10, render_step_size=STEP, sample_capacity=capacity)
    return mlp_cli.Run(cfg=cfg, field=field, estimator=est_t, occ_state=state_t,
                       opt=torch.optim.Adam(field.parameters(), lr=mlp_cli.LR), generator=torch.Generator())


def _compare(loss_t, n_t, field, loss_j, n_j, grads_j, params_j, grads_t, atol_of_max=1e-5, params_atol=1e-7):
    assert n_t == n_j and n_t > 0
    assert loss_t == pytest.approx(loss_j, rel=1e-5)
    want_g = mlp_field_from_jax(_np(grads_j))
    want_p = mlp_field_from_jax(_np(params_j))
    new_p = dict(field.named_parameters())
    assert set(want_g) == set(new_p)
    for name, g_want in want_g.items():
        g_want, g_got = g_want.numpy(), grads_t[name].numpy()
        tol = atol_of_max * np.abs(g_want).max()
        np.testing.assert_allclose(g_got, g_want, rtol=0, atol=tol, err_msg=name)
        # Adam's first step moves each parameter by about lr * sign(g): held
        # where the signs agree and |g| is far above eps = 1e-8.
        agree = np.sign(g_got) == np.sign(g_want)
        assert (np.abs(g_want[~agree]) <= tol).all(), name
        held = agree & (np.abs(g_want) > 1e-6)
        np.testing.assert_allclose(new_p[name].detach().numpy()[held], want_p[name].numpy()[held], rtol=0,
                                   atol=params_atol, err_msg=name)


def _states():
    est_j = JEstimator(AABB, RES, 1)
    state_j = est_j.set_binaries(est_j.init(), jnp.asarray(_shell(RES)))
    est_t = TEstimator(AABB, RES, 1)
    return est_j, state_j, est_t, occ_state_from_jax(est_t, state_j, "cpu")


def _jitter(key):
    # rendering.py:137-142: the stratified jitter is uniform of the key's
    # second half.
    return np.array(jax.random.uniform(jax.random.split(key)[1], (N_RAYS,), jnp.float32))


def test_one_vanilla_nerf_train_step_matches_jax():
    cfg = dict(net_depth=2, net_width=32, skip_layer=1)
    est_j, state_j, est_t, state_t = _states()
    o, d, pixels, _ = _inputs(0)
    jfield = jmlp.VanillaNeRFRadianceField(**cfg)
    params = jfield.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    key, capacity = jax.random.PRNGKey(1), CAPACITY
    loss_j, n_j, grads_j, params_j = _jax_step(jfield, params, est_j, state_j, o, d, pixels, key, capacity)

    tfield = tmlp.VanillaNeRFRadianceField(**cfg, device="cpu")
    tfield.load_state_dict(mlp_field_from_jax(_np(params)))
    run = _run(tfield, est_t, state_t, capacity)
    loss_t, n_t = mlp_cli.train_step(run, *(torch.from_numpy(a) for a in (o, d, pixels)), torch.ones(3),
                                     torch.from_numpy(_jitter(key)))
    grads_t = {k: p.grad.clone() for k, p in tfield.named_parameters()}
    _compare(float(loss_t), int(n_t), tfield, loss_j, n_j, grads_j, params_j, grads_t)


@pytest.mark.parametrize("field", ["tnerf", "ndr"])
def test_one_dynamic_train_step_matches_jax(field):
    est_j, state_j, est_t, state_t = _states()
    o, d, pixels, times = _inputs(1)
    jcls, tcls = {"tnerf": (jmlp.TNeRFRadianceField, tmlp.TNeRFRadianceField),
                  "ndr": (jmlp.NDRTNeRFRadianceField, tmlp.NDRTNeRFRadianceField)}[field]
    jfield = jcls()
    params = jfield.init(jax.random.PRNGKey(2), jnp.zeros((8, 3)), jnp.zeros((8, 1)), jnp.zeros((8, 3)))
    key, capacity = jax.random.PRNGKey(3), CAPACITY
    loss_j, n_j, grads_j, params_j = _jax_step(jfield, params, est_j, state_j, o, d, pixels, key, capacity, times)

    tfield = tcls(device="cpu")
    tfield.load_state_dict(mlp_field_from_jax(_np(params)))
    run = _run(tfield, est_t, state_t, capacity)
    loss_t, n_t = tnerf_cli.train_step(run, *(torch.from_numpy(a) for a in (o, d, times, pixels)), torch.ones(3),
                                       torch.from_numpy(_jitter(key)))
    grads_t = {k: p.grad.clone() if p.grad is not None else torch.zeros_like(p) for k, p in tfield.named_parameters()}
    # NDR's three warp blocks round a position an ulp away from JAX's now
    # and then (their GEMMs sum in another order, and a rotation by ~1e-4
    # rad of a coordinate near 1 keeps that ulp), and the vanilla field's
    # degree-10 encoding multiplies a position by up to 2^9 before its sin:
    # NDR's gradients are held at atol 5e-3 of their largest entry (1.26e-3
    # measured, in the vanilla field's second layer; T-NeRF's and the
    # vanilla step's are within 1.0e-6), and Adam's update of a parameter
    # with a small gradient (|g| near 1e-6, where eps = 1e-8 still counts)
    # within 1e-6 (1.1e-7 measured).  tests/test_torch_mlp.py holds NDR's
    # warp and its field on JAX's own warped positions at 1e-6.
    ndr = field == "ndr"
    _compare(float(loss_t), int(n_t), tfield, loss_j, n_j, grads_j, params_j, grads_t,
             atol_of_max=5e-3 if ndr else 1e-5, params_atol=1e-6 if ndr else 1e-7)


def test_tnerf_occupancy_probe_takes_the_given_times():
    # The probe's timestamps, injected, replace the generator's draws: the
    # update equals one made with a field that reads those times.
    est = TEstimator([-1.0] * 3 + [1.0] * 3, 16, 1)
    field = tmlp.TNeRFRadianceField(device="cpu", generator=torch.Generator().manual_seed(0))
    run = _run(field, est, est.init("cpu"), 1024)
    cells = est.cells_per_lvl
    draws = est.make_draws(0, torch.Generator().manual_seed(1), warmup_steps=1, device="cpu")
    times = torch.rand((cells, 1), generator=torch.Generator().manual_seed(2))
    tnerf_cli.occ_update(run, True, torch.tensor([0.0, 1.0]), draws=draws, probe_times=times)
    want = est._update(est.init("cpu"), 0, lambda x: field.query_density(x, times) * STEP, warmup_steps=1,
                       draws=draws)
    torch.testing.assert_close(run.occ_state.occs, want.occs, rtol=0, atol=0)


# train_mlp_nerf's smoke block at 32x32 and 128 rays, its field at full width.
ARGV = ["--smoke", "--device", "cpu", "--num_rays", "128", "--max_steps", "16"]
SIZE, N_STEPS = 32, 16


def _jax_loop(train_ds, test_ds):
    """The JAX example's loop (train_mlp_nerf.py:91-224) at the settings of
    ``ARGV``, its train step, update and eval jitted as it jits them."""
    aabb = np.array([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], np.float32)
    near, far, step_size, capacity = train_ds.near, train_ds.far, 8e-3, 128 * 64
    key = jax.random.PRNGKey(42)
    field = jmlp.VanillaNeRFRadianceField()
    key, sub = jax.random.split(key)
    params = field.init(sub, jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    params0 = _np(params)
    estimator = JEstimator(roi_aabb=aabb, resolution=32, levels=1)
    occ_state = estimator.init()
    tx = optax.adam(5e-4)
    opt_state = tx.init(params)

    def make_fns(params, rays_o, rays_d):
        def sigma_fn(t_starts, t_ends, ray_indices):
            o, d = j_gather_ray_od(rays_o, rays_d, ray_indices)
            return field.apply(params, o + ((t_starts + t_ends) / 2.0)[:, None] * d, method="query_density")[..., 0]

        def rgb_sigma_fn(t_starts, t_ends, ray_indices):
            o, d = j_gather_ray_od(rays_o, rays_d, ray_indices)
            rgb, sigma = field.apply(params, o + ((t_starts + t_ends) / 2.0)[:, None] * d, d)
            return rgb, sigma[..., 0]

        return sigma_fn, rgb_sigma_fn

    @jax.jit
    def train_step(params, opt_state, occ_state, rays_o, rays_d, pixels, bkgd, key):
        def loss_fn(p):
            sigma_fn, rgb_sigma_fn = make_fns(p, rays_o, rays_d)
            colors, _, _, n_samp, _ = j_render(
                rgb_sigma_fn, sigma_fn, estimator, occ_state, rays_o, rays_d, near_plane=near, far_plane=far,
                render_step_size=step_size, render_bkgd=bkgd, stratified=True, key=key, sample_capacity=capacity,
            )
            return optax.huber_loss(colors, pixels, delta=1.0).mean(), n_samp

        (loss, n_samp), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, n_samp

    @jax.jit
    def occ_update(occ_state, params, key):
        def occ_eval_fn(x):
            return field.apply(params, x, step_size, method="query_opacity")

        return estimator._update(occ_state, step=0, occ_eval_fn=occ_eval_fn, key=key, warmup_steps=1)

    losses, keys = [], {}
    for step in range(N_STEPS):
        if step % 16 == 0:
            key, sub = jax.random.split(key)
            keys[("update", step)] = sub
            occ_state = occ_update(occ_state, params, sub)
        batch = train_ds[step % len(train_ds)]
        key, sub = jax.random.split(key)
        keys[("step", step)] = sub
        params, opt_state, loss, n_samp = train_step(
            params, opt_state, occ_state, batch["rays"].origins, batch["rays"].viewdirs, batch["pixels"],
            batch["color_bkgd"], sub,
        )
        losses.append(float(loss))

    @jax.jit
    def eval_render(params, occ_state, rays_o, rays_d):
        sigma_fn, rgb_sigma_fn = make_fns(params, rays_o, rays_d)
        return j_render(rgb_sigma_fn, sigma_fn, estimator, occ_state, rays_o, rays_d, near_plane=near,
                        far_plane=far, render_step_size=step_size, render_bkgd=jnp.ones(3),
                        sample_capacity=2048 * 64)[0]

    rays = test_ds[0]["rays"]
    o, d = (jnp.reshape(jnp.asarray(a), (-1, 3)) for a in (rays.origins, rays.viewdirs))
    n = o.shape[0]
    pad = (-n) % 2048
    o = jnp.concatenate([o, jnp.broadcast_to(o[-1:], (pad, 3))])
    d = jnp.concatenate([d, jnp.broadcast_to(d[-1:], (pad, 3))])
    img = np.asarray(eval_render(params, occ_state, o, d))[:n].reshape(SIZE, SIZE, 3)
    mse = float(np.mean((img - np.asarray(test_ds[0]["pixels"])) ** 2))
    return params0, losses, keys, -10.0 * np.log10(mse), occ_state


def test_train_loop_matches_the_jax_example_over_16_steps(monkeypatch):
    # Both loaders on their numpy path, so both loops see the same batches
    # (tests/test_torch_native.py holds the native sampler's).
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(TLoader, "NATIVE_SAMPLER", False)
    j_train, j_test = j_make_loaders(num_rays=128, width=SIZE, height=SIZE, n_train=12, n_test=1)
    params0, losses_j, keys, psnr_j, occ_j = _jax_loop(j_train, j_test)

    def small(**kw):
        return tproc.make_loaders(**dict(kw, width=SIZE, height=SIZE))

    monkeypatch.setattr(mlp_cli, "make_loaders", small)
    run, train_ds, test_ds, chunk = mlp_cli.setup(mlp_cli.parse_args(ARGV))
    assert (run.cfg["grid_resolution"], run.cfg["render_step_size"]) == (32, 8e-3)
    assert (run.cfg["sample_capacity"], train_ds.num_rays, chunk) == (128 * 64, 128, 2048)
    run.field.load_state_dict(mlp_field_from_jax(params0))
    cells = run.estimator.cells_per_lvl

    def jitter(step):
        return torch.from_numpy(np.array(jax.random.uniform(jax.random.split(keys[("step", step)])[1], (128,))))

    def draws(step):
        # The warm-up draws of JAX's _update: one jitter a cell (occ_grid.py:559).
        _, k_jit = jax.random.split(keys[("update", step)])
        return [{"jitter": torch.from_numpy(np.array(jax.random.uniform(k_jit, (cells, 3), jnp.float32)))}]

    losses_t, _ = mlp_cli.train(run, train_ds, N_STEPS, jitter=jitter, draws=draws)
    assert run.step == N_STEPS
    # The grid from the warm-up update of the same weights: the same cells
    # (the occupancies within 1e-6 of their largest value).
    occ_t, occ_w = run.occ_state.occs.numpy(), np.asarray(occ_j.occs)
    np.testing.assert_allclose(occ_t, occ_w, rtol=0, atol=1e-6 * np.abs(occ_w).max())
    np.testing.assert_array_equal(run.occ_state.binaries.numpy(), np.asarray(occ_j.binaries))

    losses_t = np.array([float(v) for v in losses_t])
    rel = np.abs(losses_t - np.array(losses_j)) / np.array(losses_j)
    print(f"16 steps: loss rel err by step {np.array2string(rel, precision=2)}; "
          f"first {losses_t[0]:.6f} last {losses_t[-1]:.6f}")
    # The JAX loop is jitted, as the example jits it, so XLA fuses o + t d
    # into a multiply-add and a sample position moves by an ulp, which the
    # degree-10 encoding multiplies by up to 2^9: the first step's losses,
    # from the same weights, are 5.2e-4 apart and no step is more than
    # 9.3e-4 apart (measured); rtol 3e-3.
    np.testing.assert_allclose(losses_t, losses_j, rtol=3e-3)
    img = mlp_cli.render_image_chunked(lambda o, d: mlp_cli.eval_render(run, o, d), test_ds[0]["rays"], chunk)
    psnr_t = common.psnr(img, test_ds[0]["pixels"])
    print(f"eval PSNR after 16 steps: port {psnr_t:.6f}, JAX {psnr_j:.6f}")
    # 1e-2 dB (6.7e-4 measured).
    assert psnr_t == pytest.approx(psnr_j, abs=1e-2)


@pytest.mark.parametrize("cli", [mlp_cli, tnerf_cli], ids=["mlp", "tnerf"])
def test_default_device_raises_without_a_card(cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.parse_args(["--smoke"]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--smoke"])

