"""The training path: scan gradients, ``rendering(seg_bounds=...)`` forward
and backward, and one whole NGP-occ train step (``bench.py:59-214`` at a
small size), each against the JAX package on the same inputs.

The train step draws its stratified jitter from a ``jax.random`` key as
``rendering.py:137-142`` does; the same numbers go to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as Fn

from nerfacc_tpu import scan as jscan
from nerfacc_tpu.estimators.occ_grid import OccGridEstimator as JEstimator
from nerfacc_tpu.grid import traverse_and_compact as j_tc
from nerfacc_tpu.models.ngp import NGPRadianceField as JField
from nerfacc_tpu.rendering import occgrid_render_rays as j_render
from nerfacc_tpu.volrend import rendering as j_rendering
from nerfacc_tpu_torch import scan as tscan
from nerfacc_tpu_torch.convert import field_from_jax
from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator as TEstimator
from nerfacc_tpu_torch.models.ngp import NGPRadianceField as TField
from nerfacc_tpu_torch.ops.table_grad import table_grad_u10, table_grad_w3
from nerfacc_tpu_torch.rendering import gather_ray_od
from nerfacc_tpu_torch.rendering import occgrid_render_rays as t_render
from nerfacc_tpu_torch.volrend import rendering as t_rendering

AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]


def _shell(res):
    g = (np.arange(res) + 0.5) / res * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    return (np.abs(np.sqrt(gx**2 + gy**2 + gz**2) - 0.45) < 0.12)[None]


def _rays(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (-3.0 * d).astype(np.float32), d


@pytest.mark.parametrize("name", ["inclusive_sum", "exclusive_sum", "inclusive_prod", "exclusive_prod"])
def test_flat_scan_gradients_match_jax(name):
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 40, 50)
    ri = np.repeat(np.arange(50), counts).astype(np.int32)
    x = rng.uniform(0.5, 1.5, ri.shape[0]).astype(np.float32)
    r = rng.standard_normal(ri.shape[0]).astype(np.float32)

    def jloss(a):
        return jnp.sum(getattr(jscan, name)(a, ray_indices=jnp.asarray(ri)) * r)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (getattr(tscan, name)(xt, ray_indices=torch.from_numpy(ri)) * torch.from_numpy(r)).sum().backward()
    # rtol 1e-5: float32 reversed scans against float64 sums and products.
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rendering_with_seg_bounds_matches_jax_forward_and_backward():
    est = JEstimator([-1.0] * 3 + [1.0] * 3, 64, 1, 2)
    state = est.set_binaries(est.init(), jnp.asarray(_shell(64)))
    rng = np.random.default_rng(7)
    n_rays, cap = 96, 4096
    o, d = _rays(rng, n_rays)
    cs = j_tc(
        jnp.asarray(o / 1.2), jnp.asarray(d), state.binaries, state.aabbs, cap,
        near_planes=jnp.zeros((n_rays,)), step_size=1e-2, traverse_steps_limit=128,
        max_lattice_steps=512, skip_grid=state.skip_grid, macro_stride=16, max_macro_segments=8,
    )
    rgbs = rng.random((cap, 3), dtype=np.float32)
    sigmas = (rng.random(cap, dtype=np.float32) * 40.0).astype(np.float32)
    w_c = rng.standard_normal((n_rays, 3)).astype(np.float32)
    w_o = rng.standard_normal((n_rays, 1)).astype(np.float32)
    arrays = {f: np.asarray(getattr(cs, f)) for f in ("t_starts", "t_ends", "ray_indices", "kept", "seg_starts", "seg_counts")}

    def jloss(rgb, sig):
        c, op, dep, _ = j_rendering(
            cs.t_starts, cs.t_ends, ray_indices=cs.ray_indices, n_rays=n_rays,
            rgb_sigma_fn=lambda *_: (rgb, sig), render_bkgd=jnp.ones(3),
            is_valid=cs.kept, seg_bounds=(cs.seg_starts, cs.seg_counts),
        )
        return jnp.sum(c * w_c) + jnp.sum(op * w_o) + jnp.sum(dep), (c, op, dep)

    (_, want), (g_rgb, g_sig) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(rgbs), jnp.asarray(sigmas)
    )
    t = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    rgb_t = torch.from_numpy(rgbs).requires_grad_(True)
    sig_t = torch.from_numpy(sigmas).requires_grad_(True)
    c, op, dep, _ = t_rendering(
        t["t_starts"], t["t_ends"], ray_indices=t["ray_indices"], n_rays=n_rays,
        rgb_sigma_fn=lambda *_: (rgb_t, sig_t), render_bkgd=torch.ones(3),
        is_valid=t["kept"], seg_bounds=(t["seg_starts"], t["seg_counts"]),
    )
    ((c * torch.from_numpy(w_c)).sum() + (op * torch.from_numpy(w_o)).sum() + dep.sum()).backward()
    # JAX takes each ray's sum as the difference of two values of one
    # float32 prefix over all samples, the port of a float64 prefix: atol 4
    # float32 ulps of the largest prefix value.  Depth is compared before
    # its division by the opacity, which would scale that error up.
    c_w, op_w, dep_w = (np.asarray(a) for a in want)
    for got, w in ((c, c_w), (op, op_w), (dep * op, dep_w * op_w)):
        got = got.detach().numpy()
        atol = 4 * np.spacing(np.float32(np.abs(w).sum()))
        np.testing.assert_allclose(got, w, rtol=0, atol=atol)
    # Gradients: the same gather backward and autograd of the same float32
    # transmittance (float64 scans in the port): rtol 1e-4 (test_ops.py:215).
    np.testing.assert_allclose(rgb_t.grad.numpy(), np.asarray(g_rgb), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sig_t.grad.numpy(), np.asarray(g_sig), rtol=1e-4, atol=1e-6)
    assert float(op.detach().max()) > 0.5


def _train_setup(cdt):
    est_j = JEstimator(AABB, 32, 1, 2)
    est_t = TEstimator(AABB, 32, 1, 2)
    js = est_j.set_binaries(est_j.init(), jnp.asarray(_shell(32)))
    ts = est_t.set_binaries(est_t.init("cpu"), torch.from_numpy(_shell(32)))
    cfg = dict(n_levels=2, n_features_per_level=16, log2_hashmap_size=12, mlp_width=16, geo_feat_dim=15)
    jfield = JField(aabb=AABB, compute_dtype=None if cdt is None else jnp.bfloat16, table_grad="factor", **cfg)
    params = jfield.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    tfield = TField(aabb=AABB, compute_dtype=cdt, device="cpu", **cfg)
    tfield.load_state_dict(field_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return est_j, est_t, js, ts, jfield, params, tfield


# render_step_size 0.02 on a res-32 grid over +-1.5 gives macro stride 18,
# so compaction takes C = 1, as at bench.py's configuration.
STEP, N_RAYS, CAP = 0.02, 128, 4096


def _jax_step(est, state, field, params, rays_o, rays_d, pixels, key):
    tx = optax.adam(1e-2, eps=1e-15)
    od = jnp.concatenate([rays_o, rays_d], axis=-1)

    def loss_fn(p):
        def rgb_sigma_fn(ts, te, ri):
            g = jnp.take(od, ri, axis=0)
            o, d = g[:, :3], g[:, 3:]
            rgb, sigma = field.apply(p, o + ((ts + te) / 2)[:, None] * d, d)
            return rgb, sigma[..., 0]

        colors, _, _, n_samp, _ = j_render(
            rgb_sigma_fn, None, est, state, rays_o, rays_d, near_plane=0.0, far_plane=1e10,
            render_step_size=STEP, render_bkgd=jnp.ones(3), stratified=True, key=key,
            sample_capacity=CAP, max_macro_segments=4,
        )
        return optax.huber_loss(colors, pixels, delta=1.0).mean(), n_samp

    (loss, n_samp), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    return float(loss), int(n_samp), grads, optax.apply_updates(params, updates)


def _torch_step(est, state, field, rays_o, rays_d, pixels, jitter):
    opt = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)

    def rgb_sigma_fn(ts, te, ri):
        o, d = gather_ray_od(rays_o, rays_d, ri)
        rgb, sigma = field(o + ((ts + te) / 2)[:, None] * d, d)
        return rgb, sigma[..., 0]

    colors, _, _, n_samp, extras = t_render(
        rgb_sigma_fn, None, est, state, rays_o, rays_d, near_plane=0.0, far_plane=1e10,
        render_step_size=STEP, render_bkgd=torch.ones(3), stratified=True, jitter=jitter,
        sample_capacity=CAP, max_macro_segments=4,
    )
    loss = Fn.huber_loss(colors, pixels, delta=1.0)
    opt.zero_grad()
    loss.backward()
    grads = {k: v.grad.clone() for k, v in field.named_parameters()}
    opt.step()
    return float(loss.detach()), int(n_samp), grads, extras


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_one_train_step_matches_jax(cdt):
    est_j, est_t, js, ts, jfield, params, tfield = _train_setup(cdt)
    rng = np.random.default_rng(0)
    o, d = _rays(rng, N_RAYS)
    pixels = rng.random((N_RAYS, 3), dtype=np.float32)
    key = jax.random.PRNGKey(1)
    jitter = np.array(jax.random.uniform(jax.random.split(key)[1], (N_RAYS,), jnp.float32))

    loss_j, n_j, grads_j, params_j = _jax_step(
        est_j, js, jfield, params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(pixels), key
    )
    before = table_grad_u10.launches, table_grad_w3.launches
    loss_t, n_t, grads_t, extras = _torch_step(
        est_t, ts, tfield, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(pixels),
        torch.from_numpy(jitter),
    )
    # CPU tensors take the plain versions: no kernel launches.
    assert (table_grad_u10.launches, table_grad_w3.launches) == before

    assert n_t == n_j and 0.5 * CAP < n_t <= CAP
    # f32: rtol 1e-4 as tests/test_models.py:539; bf16: XLA and PyTorch round
    # bf16 products at other places, 2e-2 of the largest value
    # (tests/test_models.py:549).
    rel = 1e-4 if cdt is None else 2e-2
    assert loss_t == pytest.approx(loss_j, rel=rel)

    want_grads = field_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    want_params = field_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
    new_params = dict(tfield.named_parameters())
    for name, g_want in want_grads.items():
        g_want = g_want.numpy()
        g_got = grads_t[name].numpy()
        tol = rel * np.abs(g_want).max()
        np.testing.assert_allclose(g_got, g_want, rtol=rel, atol=tol, err_msg=name)
        # Adam's first step moves each parameter by lr * g / (|g| + eps),
        # about lr * sign(g); a sign can differ only where the gradients
        # agree to within tol, and the step is held where the signs agree
        # and |g| is far above eps = 1e-15.
        agree = np.sign(g_got) == np.sign(g_want)
        assert (np.abs(g_want[~agree]) <= tol).all(), name
        held = agree & (np.abs(g_want) > 1e-9)
        p_got = new_params[name].detach().numpy()
        np.testing.assert_allclose(p_got[held], want_params[name].numpy()[held], rtol=0, atol=1e-6, err_msg=name)
    assert np.abs(want_grads["encoder.table"].numpy()).max() > 0
