"""BARF on the port against the JAX package: the oracles of
``tests/test_barf.py`` (SE(3) group identities, the annealed encoder's
endpoints, the numpy ray generator, pose gradients) on the port; ``se3_exp``,
``rays_from_pixels`` and ``AnnealedSinusoidalEncoder`` against JAX's; one
step of ``train_barf.train_step`` against the JAX example's step (loss,
field and pose gradients, the parameters after both Adams); the example's
schedules, annealing and pose metrics; and the CLI to its ``FINAL`` lines.

Tolerances: ``se3_exp`` within 1e-6 (values) and 1e-5 of the largest entry
(gradients); rays bit for bit; the step's loss within rtol 1e-5 and every
gradient within 1e-5 of its largest entry.
"""

import contextlib
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nerfacc_tpu.rendering as jrendering
from nerfacc_tpu.datasets.utils import generate_rays
from nerfacc_tpu.estimators.occ_grid import OccGridEstimator as JEstimator
from nerfacc_tpu.grid import CompactSamples as JCompactSamples
from nerfacc_tpu.models import barf as jbarf
from nerfacc_tpu.models.mlp import SinusoidalEncoder as JSinusoidal
from nerfacc_tpu.rendering import gather_ray_od as j_gather_ray_od
from nerfacc_tpu.rendering import occgrid_render_rays as j_render
from nerfacc_tpu_torch.convert import barf_from_jax, occ_state_from_jax
from nerfacc_tpu_torch.datasets.procedural import pose_spherical
from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator as TEstimator
from nerfacc_tpu_torch.examples import train_barf as barf_cli
from nerfacc_tpu_torch.models import SinusoidalEncoder
from nerfacc_tpu_torch.models.barf import (
    AnnealedSinusoidalEncoder,
    BARFRadianceField,
    PoseRefine,
    compose_pose,
    rays_from_pixels,
    se3_exp,
)

REPO = Path(__file__).resolve().parents[1]


def _to44(m34):
    m34 = np.asarray(m34)
    pad = np.tile(np.asarray([[0, 0, 0, 1.0]]), (m34.shape[0], 1, 1))
    return np.concatenate([m34, pad], axis=1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# --- tests/test_barf.py on the port ------------------------------------------


def test_se3_exp_identities():
    rng = np.random.default_rng(0)
    xi = _t(rng.normal(0, 0.7, size=(32, 6)))
    T = se3_exp(xi).numpy()
    prod = _to44(T) @ _to44(se3_exp(-xi).numpy())
    np.testing.assert_allclose(prod, np.tile(np.eye(4), (32, 1, 1)), atol=1e-5)
    np.testing.assert_allclose(se3_exp(torch.zeros(6)).numpy(), np.eye(4)[:3], atol=0)
    R = T[:, :, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.tile(np.eye(3), (32, 1, 1)), atol=1e-5)
    np.testing.assert_allclose(se3_exp(torch.full((6,), 1e-6)).numpy(), np.eye(4)[:3], atol=1e-5)


@pytest.mark.parametrize("value", [0.0, 1e-10])
def test_se3_exp_grad_finite_at_zero(value):
    xi = torch.full((6,), value, requires_grad=True)
    (se3_exp(xi) ** 2).sum().backward()
    assert bool(torch.isfinite(xi.grad).all())


def test_compose_pose_matches_matmul():
    rng = np.random.default_rng(1)
    delta = se3_exp(_t(rng.normal(0, 0.5, size=(8, 6))))
    c2w = se3_exp(_t(rng.normal(0, 0.5, size=(8, 6))))
    want = (_to44(delta.numpy()) @ _to44(c2w.numpy()))[:, :3]
    np.testing.assert_allclose(compose_pose(delta, c2w).numpy(), want, atol=1e-5)


def test_annealed_encoder_endpoints():
    x = _t(np.random.default_rng(2).normal(size=(64, 3)))
    enc = AnnealedSinusoidalEncoder(3, 0, 6)
    full = enc(x, 1.0)
    np.testing.assert_array_equal(full.numpy(), SinusoidalEncoder(3, 0, 6)(x).numpy())
    assert full.shape[-1] == enc.latent_dim
    zero = enc(x, 0.0).numpy()
    np.testing.assert_array_equal(zero[:, :3], x.numpy())
    np.testing.assert_array_equal(zero[:, 3:], 0.0)
    mid = enc(x, 0.5).numpy()
    assert np.abs(mid[:, 3:6]).max() > 0.01  # k = 0 on
    np.testing.assert_array_equal(mid[:, 3 + 5 * 3 : 3 + 6 * 3], 0.0)  # k = 5 off


def test_rays_from_pixels_matches_numpy_oracle():
    rng = np.random.default_rng(3)
    K = np.array([[120.0, 0, 64], [0, 120.0, 48], [0, 0, 1]], np.float32)
    c2w = se3_exp(_t(rng.normal(0, 0.4, size=(6,)))).numpy()
    x = rng.integers(0, 128, 200).astype(np.float32)
    y = rng.integers(0, 96, 200).astype(np.float32)
    want = generate_rays(x, y, K, c2w, opengl=True)
    o, d = rays_from_pixels(_t(x), _t(y), _t(K), _t(c2w).expand(200, 3, 4))
    np.testing.assert_allclose(o.numpy(), np.asarray(want.origins), atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(want.viewdirs), atol=1e-5)


def test_pose_gradients_flow():
    poser = PoseRefine(n_cams=4, device="cpu")
    assert poser.pose_deltas.shape == (4, 6) and not poser.pose_deltas.any()
    nominal = se3_exp(_t(np.random.default_rng(4).normal(0, 0.3, (4, 6))))
    K = torch.tensor([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]])
    cam_ids = torch.tensor([0, 1, 2, 3])
    c2w = poser(cam_ids, nominal[cam_ids])
    o, d = rays_from_pixels(torch.tensor([5.0, 10.0, 20.0, 30.0]), torch.tensor([6.0, 12.0, 24.0, 31.0]), K, c2w)
    ((o + 2.0 * d - 1.0) ** 2).sum().backward()
    g = poser.pose_deltas.grad
    assert g.shape == (4, 6) and float(g.abs().sum()) > 0.0 and bool(torch.isfinite(g).all())


def test_barf_field_annealed_density():
    field = BARFRadianceField(net_depth=2, net_width=32, net_width_condition=16, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    x = torch.zeros((8, 3))
    d = torch.ones((8, 3)) / np.sqrt(3.0)
    rgb, sigma = field(x, d, 0.3)
    assert rgb.shape == (8, 3) and sigma.shape == (8, 1)
    s0, s1 = field.query_density(x, 0.0), field.query_density(x, 1.0)
    assert s0.shape == s1.shape == (8, 1)
    np.testing.assert_array_equal(field.query_opacity(x, 1e-2, 1.0).detach().numpy(),
                                  s1.detach().numpy() * np.float32(1e-2))


# --- against the JAX package ---------------------------------------------------


@pytest.mark.parametrize("scale", [0.0, 1e-6, 0.05, 0.7])
def test_se3_exp_matches_jax_in_value_and_gradient(scale):
    # At zero and in the Taylor branch (|w|^2 < 1e-8), and away from it.
    rng = np.random.default_rng(5)
    xi = (rng.normal(size=(16, 6)) * scale).astype(np.float32)
    w = rng.normal(size=(16, 3, 4)).astype(np.float32)
    # Jitted: eager JAX compiles each of se3_exp's ops once (5 s).
    want, want_g = jax.jit(jax.value_and_grad(lambda a: jnp.sum(jbarf.se3_exp(a) * w)))(xi)
    t = _t(xi).requires_grad_()
    got = (se3_exp(t) * _t(w)).sum()
    got.backward()
    np.testing.assert_allclose(se3_exp(_t(xi)).numpy(), np.asarray(jax.jit(jbarf.se3_exp)(xi)), rtol=0, atol=1e-6)
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want_g)).max())
    assert bool(torch.isfinite(t.grad).all())


def test_rays_from_pixels_matches_jax_bit_for_bit():
    # The direction's products rounded, then summed in axis order, and the
    # norm in sqrt(fma) form: as eager JAX computes them.
    rng = np.random.default_rng(6)
    K = np.array([[86.4, 0, 48], [0, 86.4, 48], [0, 0, 1]], np.float32)
    c2w = np.stack([pose_spherical(th, -0.6, 2.5)[:3] for th in rng.uniform(0, 6.3, 512)]).astype(np.float32)
    c2w = barf_cli.apply_deltas(rng.normal(0, 0.1, (512, 6)).astype(np.float32), c2w)
    x = rng.integers(0, 96, 512).astype(np.float32)
    y = rng.integers(0, 96, 512).astype(np.float32)
    oj, dj = jbarf.rays_from_pixels(x, y, K, c2w)
    ot, dt = rays_from_pixels(_t(x), _t(y), _t(K), _t(c2w))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_annealed_encoder_matches_jax(alpha):
    x = np.random.default_rng(7).normal(size=(64, 3)).astype(np.float32)
    enc = jbarf.AnnealedSinusoidalEncoder(3, 0, 10)
    want = enc.apply({}, x, jnp.float32(alpha))
    got = AnnealedSinusoidalEncoder(3, 0, 10)(_t(x), torch.tensor(alpha, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    if alpha == 1.0:
        np.testing.assert_allclose(got.numpy(), np.asarray(JSinusoidal(3, 0, 10).apply({}, x)), rtol=0, atol=1e-6)


def _jax_example():
    """``examples/train_barf.py`` as a module (its ``common`` import needs
    ``examples/`` on the path)."""
    sys.path.insert(0, str(REPO / "examples"))
    try:
        spec = importlib.util.spec_from_file_location("jax_train_barf", REPO / "examples" / "train_barf.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(REPO / "examples"))
    return mod


def test_pose_metrics_schedules_and_annealing_match_the_example():
    ex = _jax_example()
    rng = np.random.default_rng(8)
    gt = np.stack([pose_spherical(th, -0.5, 2.5)[:3] for th in np.linspace(0, 6, 10)]).astype(np.float32)
    pred = barf_cli.apply_deltas(rng.normal(0, 0.1, (10, 6)).astype(np.float32), gt)
    (R, t), rot, tr = barf_cli.align_poses(pred, gt)
    (Rj, tj), rotj, trj = ex.align_poses(pred, gt)
    for a, b in ((R, Rj), (t, tj), (rot, rotj), (tr, trj)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(barf_cli.rotation_geodesic_deg(pred[:, :, :3], gt[:, :, :3]),
                                  ex.rotation_geodesic_deg(pred[:, :, :3], gt[:, :, :3]))
    # The noisy poses: the example's delta through JAX's se3_exp.
    noise = np.random.default_rng(7).normal(0.0, 0.1, size=(10, 6)).astype(np.float32)
    noise[:, 3:] *= 0.5
    delta = np.asarray(jbarf.se3_exp(jnp.asarray(noise)))
    want = np.concatenate([np.einsum("nij,njk->nik", delta[:, :, :3], gt[:, :, :3]),
                           (np.einsum("nij,nj->ni", delta[:, :, :3], gt[:, :, 3]) + delta[:, :, 3])[:, :, None]], -1)
    np.testing.assert_allclose(barf_cli.noisy_poses(gt, 0.1), want, rtol=0, atol=2e-6)
    # optax.exponential_decay (train_barf.py:141-147) and the annealing
    # window (:153-157).
    for lr0, rate in (barf_cli.FIELD_LR, barf_cli.POSE_LR):
        sched = optax.exponential_decay(lr0, 300, rate)
        for count in (0, 1, 7, 150, 299, 300):
            assert barf_cli.decayed_lr(lr0, rate, count, 300) == pytest.approx(float(sched(count)), rel=1e-6)
    for step in (0, 30, 31, 77, 150, 151, 300):
        want_a = float(jnp.clip((step / 300 - 0.1) / 0.4, 0.0, 1.0))
        assert barf_cli.alpha_at(step, 300) == want_a
    assert barf_cli.alpha_at(5, 300, anneal=False) == 1.0


# One step of train_barf.train_step against the JAX example's step
# (train_barf.py:180-207) at a small width, on 4 noisy cameras.
N_RAYS, SPR, RES, STEP, SIZE = 64, 48, 32, 8e-3, 32
NEAR, FAR = 2.5 - 1.2, 2.5 + 1.2


def _shell(res):
    g = (np.arange(res) + 0.5) / res * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    return (np.abs(np.sqrt(gx**2 + gy**2 + gz**2) - 0.45) < 0.12)[None]


@contextlib.contextmanager
def _recorded(estimator, out: list):
    """The port's traversal and compaction of a step, as JAX's
    ``CompactSamples``: the JAX step renders on them (jitted, its
    traversal moves t values by an ulp, which the degree-10 encoding
    multiplies by up to 2^9; the port's traversal is eager JAX's bit for
    bit, ``tests/test_torch_traverse_compact.py``).  The traversal gives the
    rays no gradient in either package."""
    real = estimator.compact_samples

    def recording(*a, **k):
        cs = real(*a, **k)
        out.append(JCompactSamples(*(None if v is None else jnp.asarray(v.detach().numpy()) for v in cs)))
        return cs

    estimator.compact_samples = recording
    try:
        yield
    finally:
        del estimator.compact_samples


def _jax_rays(x, y, K, c2w):
    """``jbarf.rays_from_pixels`` with its products kept apart from their
    sums (``optimization_barrier``), as eager JAX rounds them; held equal to
    the package's own function below."""
    dirs = jnp.stack([(x + 0.5 - K[0, 2]) / K[0, 0], (y + 0.5 - K[1, 2]) / K[1, 1] * -1.0, -jnp.ones_like(x)], -1)
    d = jax.lax.optimization_barrier(dirs[..., None, :] * c2w[..., :3, :3]).sum(-1)
    viewdirs = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.broadcast_to(c2w[..., :3, 3], viewdirs.shape), viewdirs


def test_one_barf_step_matches_jax():
    rng = np.random.default_rng(9)
    n_cams = 4
    gt = np.stack([pose_spherical(th, -0.6, 2.5)[:3] for th in (0.3, 1.9, 3.4, 5.0)]).astype(np.float32)
    nominal = barf_cli.noisy_poses(gt, 0.1)
    K = np.array([[0.9 * SIZE, 0, SIZE / 2], [0, 0.9 * SIZE, SIZE / 2], [0, 0, 1]], np.float32)
    cam_ids = rng.integers(0, n_cams, N_RAYS)
    px = rng.integers(0, SIZE, N_RAYS).astype(np.float32)
    py = rng.integers(0, SIZE, N_RAYS).astype(np.float32)
    pixels = rng.random((N_RAYS, 3), dtype=np.float32)
    bkgd = rng.random(3, dtype=np.float32)
    alpha, max_steps = np.float32(0.3), 100
    key = jax.random.PRNGKey(11)
    jitter = np.array(jax.random.uniform(jax.random.split(key)[1], (N_RAYS,), jnp.float32))

    jfield, jposer = jbarf.BARFRadianceField(net_depth=2, net_width=32, net_width_condition=16), jbarf.PoseRefine(n_cams)
    # The field's weights drawn in numpy at flax's shapes (no init
    # compiles); the pose deltas zeros, as PoseRefine starts them.
    shapes = jax.eval_shape(jfield.init, jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    params = {
        "field": jax.tree_util.tree_map_with_path(
            lambda path, s: rng.normal(0.0, 1.0 / np.sqrt(s.shape[0]) if path[-1].key == "kernel" else 0.05,
                                       s.shape).astype(np.float32), shapes),
        "pose": {"params": {"pose_deltas": np.zeros((n_cams, 6), np.float32)}},
    }
    est_j = JEstimator(np.array([-1, -1, -1, 1, 1, 1], np.float32), RES, 1)
    state_j = est_j.set_binaries(est_j.init(), jnp.asarray(_shell(RES)))

    # The port, through the CLI's train_step.
    est_t = TEstimator(np.array([-1, -1, -1, 1, 1, 1], np.float32), RES, 1)
    field = BARFRadianceField(net_depth=2, net_width=32, net_width_condition=16, device="cpu")
    poser = PoseRefine(n_cams, device="cpu")
    field_sd, pose_sd = barf_from_jax(jax.tree_util.tree_map(np.asarray, params))
    field.load_state_dict(field_sd)
    poser.load_state_dict(pose_sd)
    cfg = dict(max_steps=max_steps, num_rays=N_RAYS, samples_per_ray=SPR, sample_capacity=N_RAYS * SPR,
               render_step_size=STEP, near_plane=NEAR, far_plane=FAR)
    run = barf_cli.Run(cfg=cfg, field=field, poser=poser, estimator=est_t,
                       occ_state=occ_state_from_jax(est_t, state_j, "cpu"), opt=barf_cli.make_optimizer(field, poser),
                       nominal=_t(nominal), K=_t(K), generator=torch.Generator(), pixel_rng=np.random.default_rng(1))
    samples = []
    with _recorded(est_t, samples):
        loss_t, n_t = barf_cli.train_step(run, torch.from_numpy(cam_ids), _t(px), _t(py), _t(pixels), _t(bkgd),
                                          torch.tensor(alpha), _t(jitter))

    # The JAX example's step, jitted, on the port's samples.
    tx = optax.multi_transform(
        {"field": optax.adam(optax.exponential_decay(5e-4, max_steps, 0.2)),
         "pose": optax.adam(optax.exponential_decay(1e-3, max_steps, 0.01))},
        {"field": "field", "pose": "pose"},
    )

    def step(p):
        def loss_fn(p):
            c2w = jposer.apply(p["pose"], cam_ids, jnp.asarray(nominal)[cam_ids])
            rays_o, rays_d = _jax_rays(jnp.asarray(px), jnp.asarray(py), jnp.asarray(K), c2w)

            def x_at(ts, te, ri):
                o, d = j_gather_ray_od(rays_o, rays_d, ri)
                return o + jax.lax.optimization_barrier(((ts + te) / 2.0)[:, None] * d), d

            def sigma_fn(ts, te, ri):
                return jfield.apply(p["field"], x_at(ts, te, ri)[0], alpha, method="query_density")[..., 0]

            def rgb_sigma_fn(ts, te, ri):
                rgb, sigma = jfield.apply(p["field"], *x_at(ts, te, ri), alpha)
                return rgb, sigma[..., 0]

            colors, _, _, n_samp, _ = j_render(
                rgb_sigma_fn, sigma_fn, est_j, state_j, rays_o, rays_d, near_plane=NEAR, far_plane=FAR,
                render_step_size=STEP, render_bkgd=jnp.asarray(bkgd), stratified=True, key=key,
                sample_capacity=N_RAYS * SPR,
            )
            return optax.huber_loss(colors, jnp.asarray(pixels), delta=1.0).mean(), n_samp

        (loss, n_samp), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p))
        return loss, n_samp, grads, optax.apply_updates(p, updates)

    real = jrendering.traverse_and_compact
    jrendering.traverse_and_compact = lambda *a, **k: samples[0]
    try:
        loss_j, n_j, grads_j, params_j = jax.jit(step)(params)
    finally:
        jrendering.traverse_and_compact = real

    # The barrier copy of the rays is the package's rays_from_pixels, eager.
    c2w0 = jnp.asarray(nominal)[cam_ids]
    for a, b in zip(_jax_rays(px, py, K, c2w0), jbarf.rays_from_pixels(px, py, K, c2w0)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    assert int(n_t) == int(n_j) > 0
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    gf, gp = barf_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    pf, pp = barf_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
    got = [(k, p) for k, p in field.named_parameters()] + [("pose_deltas", poser.pose_deltas)]
    want_g, want_p = dict(gf, **gp), dict(pf, **pp)
    assert {k for k, _ in got} == set(want_g)
    for name, p in got:
        g_want, g_got = want_g[name].numpy(), p.grad.numpy()
        assert np.abs(g_want).max() > 0, name
        tol = 1e-5 * np.abs(g_want).max()
        np.testing.assert_allclose(g_got, g_want, rtol=0, atol=tol, err_msg=name)
        # Both Adams' first step, where the gradients' signs agree.
        agree = (np.sign(g_got) == np.sign(g_want)) & (np.abs(g_want) > 1e-6)
        np.testing.assert_allclose(p.detach().numpy()[agree], want_p[name].numpy()[agree], rtol=0, atol=1e-7,
                                   err_msg=name)
    # A camera's pose has a gradient only where one of its rays kept a
    # sample (and some do).
    cs = samples[0]
    seen = np.unique(cam_ids[np.asarray(cs.ray_indices)[np.asarray(cs.kept)]])
    moved = np.flatnonzero(np.abs(gp["pose_deltas"].numpy()).sum(-1) > 0)
    assert moved.size > 0 and set(moved) <= set(seen)


def test_barf_cli_runs_to_its_final_lines(capsys, monkeypatch):
    # The smoke block with its views rendered at 24x24 (the procedural
    # scene's renders take most of a smoke run on the CPU).
    real = barf_cli.generate_dataset
    monkeypatch.setattr(barf_cli, "generate_dataset", lambda **kw: real(**dict(kw, width=24, height=24)))
    psnr, rot, trans = barf_cli.main(["--smoke", "--device", "cpu", "--max_steps", "2", "--num_rays", "64"])
    out = capsys.readouterr().out
    assert "initial pose error: rot " in out and "refined pose error: rot " in out
    assert f"FINAL mean PSNR {psnr:.2f} dB" in out
    assert f"FINAL pose errors rot {rot:.3f} deg trans {trans:.4f}" in out
    assert np.isfinite([psnr, rot, trans]).all()


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert barf_cli.parse_args(["--smoke"]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        barf_cli.main(["--smoke"])
