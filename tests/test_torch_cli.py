"""The NGP-occ training CLI of the port against the JAX example's own code.

- The learning-rate schedule equals the optax schedule of
  ``examples/train_ngp_nerf_occ.py:188-201`` at every step.
- Adam with coupled weight decay follows optax's chain
  (``add_decayed_weights``, ``scale_by_adam``, the schedule) within rtol
  1e-6 of each parameter.
- The CLI's loop (``train``: occupancy updates, schedule, macro budget) runs
  32 steps beside a JAX loop written as the JAX example writes it (its
  train step, update and eval jitted), on the procedural smoke scene at
  32x32, fed the same stratified jitter and update draws (rebuilt from the
  JAX keys as ``tests/test_torch_train.py`` does).  Under jit, XLA rounds
  some sample positions an ulp from the port's (``tests/test_torch_prop_train.py``
  runs its JAX step eagerly for that reason), and the fused encoder keeps
  eight corners a cell, so a position an ulp across
  a fine cell face moves its density by a finite amount: a few steps' losses
  differ by up to 9.6e-4 (relative) before the second occupancy update.
  That update (step 16) thresholds the grid at the mean occupancy, and
  after 16 steps of a random field 99% of the cells lie within 1e-4 of it;
  the ~1e-5 the occupancies differ by flips about 200 of 32768 cells, all
  within 5e-6 of the threshold, and the traversals then differ by those
  cells: up to 8.2e-3 after step 16.
- ``--encoder hash|soa|folded`` builds the JAX examples' fields; the
  default device raises without a card.
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
from nerfacc_tpu.models.ngp import NGPDensityField as JDensity
from nerfacc_tpu.models.ngp import NGPRadianceField as JField
from nerfacc_tpu.rendering import gather_ray_od as j_gather_ray_od
from nerfacc_tpu.rendering import occgrid_render_rays as j_render
from nerfacc_tpu_torch.convert import field_from_jax
from nerfacc_tpu_torch.datasets import procedural as tproc
from nerfacc_tpu_torch.datasets.nerf_synthetic import SubjectLoader as TLoader
from nerfacc_tpu_torch.examples import common
from nerfacc_tpu_torch.examples import train_ngp_nerf_occ as occ_cli
from nerfacc_tpu_torch.examples import train_ngp_nerf_prop as prop_cli
from nerfacc_tpu_torch.examples import render as render_cli


def _optax_schedule(max_steps):
    # train_ngp_nerf_occ.py:188-201, as written there.
    return optax.join_schedules(
        [
            optax.linear_schedule(0.01 / 100, 0.01, 100),
            optax.piecewise_constant_schedule(
                0.01, {max_steps // 2: 0.33, max_steps * 3 // 4: 0.33, max_steps * 9 // 10: 0.33}
            ),
        ],
        [100],
    )


@pytest.mark.parametrize("max_steps", [200, 20000, 3])
def test_schedule_equals_optax_at_every_step(max_steps):
    want = _optax_schedule(max_steps)
    got = occ_cli.lr_schedule(max_steps)
    steps = range(max_steps + 2) if max_steps < 1000 else list(range(300)) + list(range(10000, 20002, 7))
    for count in steps:
        assert got(count) == float(want(count)), count


def test_schedule_drops_after_the_join_offset():
    # max_steps 200: the drops land at 100 + 100, 100 + 150 and 100 + 180
    # (float32 values, rel 1e-5).
    lr = occ_cli.lr_schedule(200)
    assert lr(0) == pytest.approx(1e-4, rel=1e-5)
    assert lr(100) == pytest.approx(1e-2, rel=1e-5)
    assert lr(199) == pytest.approx(1e-2, rel=1e-5)
    assert lr(200) == pytest.approx(3.3e-3, rel=1e-5)
    assert lr(249) == pytest.approx(3.3e-3, rel=1e-5)
    assert lr(250) == pytest.approx(1.089e-3, rel=1e-5)
    assert lr(280) == pytest.approx(3.5937e-4, rel=1e-5)


def test_adam_with_weight_decay_follows_optax():
    rng = np.random.default_rng(0)
    shapes = {"w": (7, 5), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()} for _ in range(6)]
    max_steps, wd = 4, 1e-2  # a short schedule, so that its drops land within six updates

    tx = optax.chain(
        optax.add_decayed_weights(wd),
        optax.scale_by_adam(eps=1e-15),
        optax.scale_by_schedule(_optax_schedule(max_steps)),
        optax.scale(-1.0),
    )
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)

    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = occ_cli.make_optimizer(module, wd)
    schedule = occ_cli.lr_schedule(max_steps)
    for g in grads:
        # The schedule's count before this update (scale_by_schedule's state).
        assert occ_cli.updates_done(opt) == int(state[2].count)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for group in opt.param_groups:
            group["lr"] = schedule(occ_cli.updates_done(opt))
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=0, err_msg=k)


# The smoke settings at 32x32 and 128 rays, with a small field.
ARGV = ["--smoke", "--device", "cpu", "--num_rays", "128", "--levels", "2", "--log2t", "12",
        "--max_steps", "32"]
SIZE = 32
N_STEPS = 32


def _jax_loop(train_ds, test_ds, n_steps):
    """The JAX example's loop (train_ngp_nerf_occ.py:119-380) at the settings
    of ``ARGV``; returns the initial parameters, every step's loss and
    the keys it drew, and the eval PSNR."""
    cfg = occ_cli.build_config("lego")
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    step_size, capacity = 1e-2, 1024 * 16
    estimator = JEstimator(roi_aabb=aabb, resolution=32, levels=1)
    occ_state = estimator.init()
    field = JField(aabb=tuple(np.asarray(estimator._aabbs_np[-1]).tolist()), unbounded=False, encoder_type="fused",
                   n_levels=2, n_features_per_level=16, log2_hashmap_size=12, compute_dtype=None)
    key = jax.random.PRNGKey(42)
    key, sub = jax.random.split(key)
    params = field.init(sub, jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    params0 = jax.tree_util.tree_map(np.asarray, params)
    tx = optax.chain(
        optax.add_decayed_weights(cfg["weight_decay"]),
        optax.scale_by_adam(eps=1e-15),
        optax.scale_by_schedule(_optax_schedule(n_steps)),
        optax.scale(-1.0),
    )
    opt_state = tx.init(params)
    render_kwargs = dict(near_plane=train_ds.near, far_plane=train_ds.far, render_step_size=step_size,
                         cone_angle=0.0, alpha_thre=0.0)

    def make_fns(params, rays_o, rays_d):
        def sigma_fn(t_starts, t_ends, ray_indices):
            o, d = j_gather_ray_od(rays_o, rays_d, ray_indices)
            return field.apply(params, o + ((t_starts + t_ends) / 2.0)[:, None] * d, method="query_density")[..., 0]

        def rgb_sigma_fn(t_starts, t_ends, ray_indices):
            o, d = j_gather_ray_od(rays_o, rays_d, ray_indices)
            rgb, sigma = field.apply(params, o + ((t_starts + t_ends) / 2.0)[:, None] * d, d)
            return rgb, sigma[..., 0]

        return sigma_fn, rgb_sigma_fn

    def train_step(params, opt_state, occ_state, rays_o, rays_d, pixels, bkgd, key, max_macro=24):
        def loss_fn(p):
            sigma_fn, rgb_sigma_fn = make_fns(p, rays_o, rays_d)
            colors, _, _, n_samp, extras = j_render(
                rgb_sigma_fn, sigma_fn, estimator, occ_state, rays_o, rays_d, render_bkgd=bkgd,
                stratified=True, key=key, sample_capacity=capacity, max_macro_segments=max_macro,
                **render_kwargs,
            )
            loss = optax.huber_loss(colors, pixels, delta=1.0).mean()
            return loss, (n_samp, extras["macro_truncated_frac"])

        (loss, (n_samp, trunc)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, n_samp, trunc

    def occ_update(occ_state, params, key):
        def occ_eval_fn(x):
            return field.apply(params, x, method="query_density") * step_size

        return estimator._update(occ_state, step=0, occ_eval_fn=occ_eval_fn, key=key, warmup_steps=1)

    train_step = jax.jit(train_step, static_argnames=("max_macro",))
    occ_update = jax.jit(occ_update)
    losses, keys = [], {}
    max_macro, trunc = 24, None
    for step in range(n_steps):
        if step % 16 == 0:
            key, sub = jax.random.split(key)
            keys[("update", step)] = sub
            occ_state = occ_update(occ_state, params, sub)
            if trunc is not None and float(trunc) > 1e-3:
                max_macro = min(64, max_macro * 2)
        batch = train_ds[step % len(train_ds)]
        key, sub = jax.random.split(key)
        keys[("step", step)] = sub
        params, opt_state, loss, n_samp, trunc = train_step(
            params, opt_state, occ_state, batch["rays"].origins, batch["rays"].viewdirs, batch["pixels"],
            batch["color_bkgd"], sub, max_macro,
        )
        losses.append(float(loss))

    def eval_render(params, occ_state, rays_o, rays_d):
        sigma_fn, rgb_sigma_fn = make_fns(params, rays_o, rays_d)
        return j_render(rgb_sigma_fn, sigma_fn, estimator, occ_state, rays_o, rays_d, render_bkgd=jnp.ones(3),
                        sample_capacity=2048 * 64, **render_kwargs)[0]

    batch = test_ds[0]
    rays = batch["rays"]
    o, d = (jnp.reshape(jnp.asarray(a), (-1, 3)) for a in (rays.origins, rays.viewdirs))
    n = o.shape[0]
    pad = (-n) % 2048
    o = jnp.concatenate([o, jnp.broadcast_to(o[-1:], (pad, 3))])
    d = jnp.concatenate([d, jnp.broadcast_to(d[-1:], (pad, 3))])
    colors = jax.jit(eval_render)(params, occ_state, o, d)
    img = np.asarray(colors)[:n].reshape(SIZE, SIZE, 3)
    mse = float(np.mean((img - np.asarray(batch["pixels"])) ** 2))
    return params0, losses, keys, -10.0 * np.log10(mse), occ_state


def _jax_update_draws(key, cells):
    """The warm-up draws of JAX's _update for ``key``: one jitter a cell
    (occ_grid.py:559), as the port takes them."""
    _, k_jit = jax.random.split(key)
    return [{"jitter": torch.from_numpy(np.array(jax.random.uniform(k_jit, (cells, 3), jnp.float32)))}]


def _small_loaders(make):
    def loaders(**kw):
        return make(**dict(kw, width=SIZE, height=SIZE))

    return loaders


def test_train_loop_matches_the_jax_example_over_32_steps(monkeypatch):
    # Both loaders on their numpy path, so both loops see the same batches
    # (tests/test_torch_native.py holds the native sampler's).
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(TLoader, "NATIVE_SAMPLER", False)
    j_train, j_test = j_make_loaders(num_rays=128, width=SIZE, height=SIZE, n_train=12, n_test=1)
    params0, losses_j, keys, psnr_j, occ_j = _jax_loop(j_train, j_test, N_STEPS)

    monkeypatch.setattr(occ_cli, "make_loaders", _small_loaders(tproc.make_loaders))
    run, train_ds, test_ds, chunk = occ_cli.setup(occ_cli.parse_args(ARGV))
    assert (run.cfg["grid_resolution"], run.cfg["render_step_size"]) == (32, 1e-2)
    assert (run.cfg["target_sample_batch_size"], train_ds.num_rays, chunk) == (16384, 128, 2048)
    run.field.load_state_dict(field_from_jax(params0))
    cells = run.estimator.cells_per_lvl

    def jitter(step):
        return torch.from_numpy(np.array(jax.random.uniform(jax.random.split(keys[("step", step)])[1], (128,))))

    def draws(step):
        return _jax_update_draws(keys[("update", step)], cells)

    losses_t, _ = occ_cli.train(run, train_ds, N_STEPS, jitter=jitter, draws=draws)
    assert run.step == N_STEPS and run.max_macro == 24

    # The grid after the second update: occupancies within 5e-5 (1.05e-05
    # measured), and a cell's bit may differ only where the two thresholds
    # and occupancies leave it on either side.
    occ_t, occ_w = run.occ_state.occs.numpy(), np.asarray(occ_j.occs)
    np.testing.assert_allclose(occ_t, occ_w, rtol=0, atol=5e-5)
    thre_t, thre_w = (min(float(o[o >= 0].mean()), 1e-2) for o in (occ_t, occ_w))
    flipped = run.occ_state.binaries.numpy().reshape(-1) != np.asarray(occ_j.binaries).reshape(-1)
    band = np.abs(occ_t - occ_w).max() + abs(thre_t - thre_w)
    print(f"grid: {int(flipped.sum())} of {flipped.size} cells differ, all within {band:.2e} of the threshold")
    assert (np.abs(occ_w[flipped] - thre_w) <= band).all()

    losses_t = np.array([float(v) for v in losses_t])
    losses_j = np.array(losses_j)
    rel = np.abs(losses_t - losses_j) / losses_j
    print(f"32 steps: loss rel err by step {np.array2string(rel, precision=2)}; "
          f"first {losses_t[0]:.6f} last {losses_t[-1]:.6f}")
    # rtol 2e-3 before the second update and 2e-2 after it (9.6e-4 and 8.2e-3
    # measured; see the module docstring).
    np.testing.assert_allclose(losses_t[:16], losses_j[:16], rtol=2e-3)
    np.testing.assert_allclose(losses_t[16:], losses_j[16:], rtol=2e-2)

    img = occ_cli.render_image(run, test_ds[0]["rays"], chunk)
    psnr_t = common.psnr(img, test_ds[0]["pixels"])
    print(f"eval PSNR after 32 steps: port {psnr_t:.6f}, JAX {psnr_j:.6f}")
    # 1e-2 dB (2.9e-3 measured).
    assert psnr_t == pytest.approx(psnr_j, abs=1e-2)
    assert psnr_t > 14.0


def _n_params(tree) -> int:
    return sum(int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("encoder", ["hash", "soa", "folded"])
def test_both_clis_build_each_encoder_as_the_jax_examples_do(encoder, monkeypatch):
    # --encoder hash|soa|folded through each CLI's setup on the CPU: the
    # radiance field (and the prop CLI's proposal net) has the JAX example's
    # parameter count (examples/train_ngp_nerf_occ.py:162-175,
    # train_ngp_nerf_prop.py:107-125) and, on the JAX field's converted
    # weights, its forward within atol 1e-6.  The procedural views are
    # shrunk to 8x8: the field does not depend on them.
    real = tproc.make_loaders
    for cli in (occ_cli, prop_cli):
        monkeypatch.setattr(cli, "make_loaders", lambda **kw: real(**dict(kw, width=8, height=8, n_train=1)))
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.9, 0.9, (64, 3)).astype(np.float32)
    d = x / np.linalg.norm(x, axis=-1, keepdims=True)
    fused = encoder == "folded"
    jkw = dict(encoder_type=encoder, n_levels=8 if fused else 16, n_features_per_level=16 if fused else 2,
               log2_hashmap_size=18 if fused else 19)
    run = occ_cli.setup(occ_cli.parse_args(["--smoke", "--device", "cpu", "--encoder", encoder]))[0]
    prun = prop_cli.setup(prop_cli.parse_args(["--smoke", "--device", "cpu", "--encoder", encoder]))[0]
    for field in (run.field, prun.field):
        assert field.encoder_type == encoder
        aabb = tuple(field.aabb.tolist())
        jfield = JField(aabb=aabb, **jkw)
        params = jax.jit(jfield.init)(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
        assert sum(p.numel() for p in field.parameters()) == _n_params(params)
        field.load_state_dict(field_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        rgb_j, sig_j = jax.jit(jfield.apply)(params, jnp.asarray(x), jnp.asarray(d))
        rgb_t, sig_t = field(torch.from_numpy(x), torch.from_numpy(d))
        np.testing.assert_allclose(rgb_t.detach().numpy(), np.asarray(rgb_j), atol=1e-6)
        np.testing.assert_allclose(sig_t.detach().numpy(), np.asarray(sig_j), atol=1e-6)
    (net,) = prun.prop_nets
    jnet = JDensity(aabb=tuple(net.aabb.tolist()), n_levels=5, max_resolution=128, encoder_type=encoder)
    nparams = jax.jit(jnet.init)(jax.random.PRNGKey(1), jnp.zeros((8, 3)))
    assert net.encoder_type == encoder and sum(p.numel() for p in net.parameters()) == _n_params(nparams)
    net.load_state_dict(field_from_jax(jax.tree_util.tree_map(np.asarray, nparams)))
    np.testing.assert_allclose(net(torch.from_numpy(x)).detach().numpy(), np.asarray(jnet.apply(nparams, jnp.asarray(x))),
                               atol=1e-6)


@pytest.mark.parametrize("cli", [occ_cli, prop_cli, render_cli], ids=["occ", "prop", "render"])
def test_default_device_raises_without_a_card(cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--model_path", "unused"] if cli is render_cli else ["--smoke"]
    assert cli.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
