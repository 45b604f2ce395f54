"""The last of the JAX package's public surface, held against it on the CPU:
the grouped encoder's ``table_grad="scatter"`` route (positions get their
gradient), ``hash_table_lookup_sized`` and ``hash_lookup_combine`` with the
level split, ``hash_lookup_combine3``'s level arguments,
``contract_to_unisphere(ord=)`` and ``occgrid_render_rays_test``'s
``lattice_per_round``.  The JAX side runs its Pallas kernels in interpret
mode.  Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.datasets.procedural import _pose_spherical
from nerfacc_tpu.datasets.utils import generate_rays as j_generate_rays
from nerfacc_tpu.estimators.occ_grid import OccGridEstimator as JEstimator
from nerfacc_tpu.models.hash_soa import HashGridEncoderGrouped as JGrouped
from nerfacc_tpu.models.ngp import NGPRadianceField as JField
from nerfacc_tpu.models.ngp import contract_to_unisphere as j_unisphere
from nerfacc_tpu.ops import table_grad as jtg
from nerfacc_tpu.rendering import gather_ray_od as j_gather
from nerfacc_tpu.rendering import occgrid_render_rays_test as j_render
import nerfacc_tpu_torch.ops.table_grad as tg
from nerfacc_tpu_torch.convert import field_from_jax, occ_state_from_jax
from nerfacc_tpu_torch.datasets.utils import generate_rays as t_generate_rays
from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator as TEstimator
from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderGrouped as TGrouped
from nerfacc_tpu_torch.models.ngp import NGPRadianceField as TField
from nerfacc_tpu_torch.models.ngp import contract_to_unisphere
from nerfacc_tpu_torch.ops import hash_lookup_combine, hash_lookup_combine3, hash_table_lookup_sized
from nerfacc_tpu_torch.rendering import gather_ray_od as t_gather
from nerfacc_tpu_torch.rendering import occgrid_render_rays_test as t_render

T = 256  # rows a level: a window of the JAX kernels divides it
M = 600  # samples a level


def _jdtype(cdt):
    return None if cdt is None else jnp.bfloat16


def _level_major(rng, n_levels, level_base, ragged=False):
    """Level-major rows: level ``j``'s ``M`` samples in its own ``T`` rows,
    half of them piled on its first 8; ``ragged`` drops one sample, so that
    ``N % n_levels != 0``."""
    idx = np.concatenate([
        (level_base + j) * T + np.concatenate([rng.integers(0, 8, M // 2), rng.integers(0, T, M - M // 2)])
        for j in range(n_levels)
    ]).astype(np.int32)
    return idx[:-1] if ragged else idx


def _counting(monkeypatch, name):
    """Record the row count of every call of the wrapper ``name`` (its plain
    version runs, on the CPU)."""
    calls, real = [], getattr(tg, name)
    monkeypatch.setattr(tg, name, lambda *a: calls.append(a[-1]) or real(*a))
    return calls


SPLITS = {
    # (table rows, n_levels, level_base, ragged): the rows K5/K4 run on a call
    "level-major": ((4 * T, 4, 0, False), [T] * 4),
    "base1-padded": ((4 * T, 2, 1, False), [T] * 2),
    "ragged-fallback": ((4 * T, 3, 0, True), [4 * T]),
}


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("split", list(SPLITS))
def test_hash_table_lookup_sized_matches_jax_level_split(split, cdt, monkeypatch):
    (n_rows, n_levels, base, ragged), want_calls = SPLITS[split]
    rng = np.random.default_rng(10)
    table = rng.standard_normal((n_rows, 128)).astype(np.float32)
    idx = _level_major(rng, n_levels, base, ragged)
    r = rng.standard_normal((idx.size, 128)).astype(np.float32)
    split_kw = dict(level_span=T, n_levels=n_levels, level_base=base)

    def jloss(t):
        g = jtg.hash_table_lookup_sized(t, jnp.asarray(idx), _jdtype(cdt), interpret=True, **split_kw)
        return jnp.sum(g.astype(jnp.float32) * r)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(table)))
    calls = _counting(monkeypatch, "table_grad_sorted")
    tt = torch.from_numpy(table).requires_grad_(True)
    g = hash_table_lookup_sized(tt, torch.from_numpy(idx).long(), compute_dtype=cdt, **split_kw)
    (g.float() * torch.from_numpy(r)).sum().backward()
    assert calls == want_calls
    got = tt.grad.numpy()
    # The same terms (bf16: the cotangent rounded to bf16 on both sides),
    # float32 sums in another order: atol 1e-5 of the largest row sum.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    lo = base * T if not ragged else 0
    hi = lo + (n_levels * T if not ragged else n_rows)
    assert not got[:lo].any() and not got[hi:].any() and got[lo:hi].any()


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("split", ["level-major", "base1-padded"])
def test_hash_lookup_combine_takes_any_weights_and_matches_jax(split, cdt, monkeypatch):
    (n_rows, n_levels, base, _), want_calls = SPLITS[split]
    rng = np.random.default_rng(11)
    table = rng.standard_normal((n_rows, 128)).astype(np.float32)
    idx = _level_major(rng, n_levels, base)
    # Corner weights that no trilinear cell gives: of either sign, not
    # summing to one.
    w = rng.standard_normal((idx.size, 8)).astype(np.float32)
    r = rng.standard_normal((idx.size, 16)).astype(np.float32)
    split_kw = dict(level_span=T, n_levels=n_levels, level_base=base)

    def jloss(t, ww):
        out = jtg.hash_lookup_combine(t, jnp.asarray(idx), ww, _jdtype(cdt), interpret=True, **split_kw)
        return jnp.sum(out.astype(jnp.float32) * r), out

    (_, jout), (jg_t, jg_w) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(table), jnp.asarray(w))
    jout, jg_t = np.asarray(jout.astype(jnp.float32)), np.asarray(jg_t)
    assert not np.asarray(jg_w).any()

    calls = _counting(monkeypatch, "table_grad_w8")
    tt, wt = torch.from_numpy(table).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    out = hash_lookup_combine(tt, torch.from_numpy(idx).long(), wt, compute_dtype=cdt, **split_kw)
    (out.float() * torch.from_numpy(r)).sum().backward()
    assert calls == want_calls
    if cdt is None:
        np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-6, atol=1e-6 * np.abs(jout).max())
    else:
        # tests/test_torch_table_grad.py's bf16 combine: 2e-2 of the largest.
        np.testing.assert_allclose(out.detach().float().numpy(), jout, rtol=0, atol=2e-2 * np.abs(jout).max())
    # K4-w8's terms are the JAX kernel's roundings (tests/test_torch_table_grad.py):
    # atol 1e-6 of the largest row sum.
    np.testing.assert_allclose(tt.grad.numpy(), jg_t, rtol=0, atol=1e-6 * np.abs(jg_t).max())
    assert wt.grad is not None and not wt.grad.any()  # zero gradient to w by contract
    assert not tt.grad.numpy()[: base * T].any() and not tt.grad.numpy()[(base + n_levels) * T :].any()


@pytest.mark.parametrize("cdt,wrapper", [(None, "table_grad_w3"), (torch.bfloat16, "table_grad_u10")],
                         ids=["f32-K4-w3", "bf16-K2"])
def test_hash_lookup_combine3_level_split_matches_jax(cdt, wrapper, monkeypatch):
    (n_rows, n_levels, base, _), want_calls = SPLITS["base1-padded"]
    rng = np.random.default_rng(12)
    table = rng.standard_normal((n_rows, 128)).astype(np.float32)
    idx = _level_major(rng, n_levels, base)
    ws = rng.random((3, idx.size), dtype=np.float32)
    r = rng.standard_normal((idx.size, 16)).astype(np.float32)
    split_kw = dict(level_span=T, n_levels=n_levels, level_base=base)

    def jloss(t):
        out = jtg.hash_lookup_combine3(t, jnp.asarray(idx), *map(jnp.asarray, ws), _jdtype(cdt), interpret=True,
                                       **split_kw)
        return jnp.sum(out.astype(jnp.float32) * r)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(table)))
    calls = _counting(monkeypatch, wrapper)
    tt = torch.from_numpy(table).requires_grad_(True)
    out = hash_lookup_combine3(tt, torch.from_numpy(idx).long(), *map(torch.from_numpy, ws), compute_dtype=cdt,
                               **split_kw)
    (out.float() * torch.from_numpy(r)).sum().backward()
    assert calls == want_calls
    # tests/test_torch_table_grad.py's encoder routes: the same roundings,
    # float32 sums in another order, atol 1e-5 of the largest entry.
    np.testing.assert_allclose(tt.grad.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert not tt.grad.numpy()[: base * T].any() and not tt.grad.numpy()[(base + n_levels) * T :].any()


# tests/test_torch_grouped.py's settings: 16 levels x 2 features, T = 2^9.
GROUPED = dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=9, max_resolution=256)


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_scatter_route_gives_positions_their_gradient_as_jax(cdt, monkeypatch):
    rng = np.random.default_rng(13)
    n = 1500
    x = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    r = rng.standard_normal((n, 32)).astype(np.float32)
    jenc = JGrouped(**GROUPED, compute_dtype=_jdtype(cdt), table_grad="scatter")
    params = jax.jit(jenc.init)(jax.random.PRNGKey(4), jnp.asarray(x[:4]))

    def jloss(p, xx):
        out = jenc.apply(p, xx)
        return jnp.sum(out.astype(jnp.float32) * r), out

    # Jitted: the positions go into the encoder as they are, so no
    # multiply-add moves a sample.
    (_, jout), (jg_t, jg_x) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    jout, jg_t, jg_x = np.asarray(jout.astype(jnp.float32)), np.asarray(jg_t["params"]["table"]), np.asarray(jg_x)

    tenc = TGrouped(**GROUPED, compute_dtype=cdt, table_grad="scatter", device="cpu")
    assert tenc.grad_mode == "scatter"
    tenc.load_state_dict({"table": torch.from_numpy(np.array(params["params"]["table"]))})
    calls = _counting(monkeypatch, "table_grad_pos")
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tenc(xt)
    (out.float() * torch.from_numpy(r)).sum().backward()
    assert calls == []  # autograd's gather backward, no K6
    tol = 1e-5 if cdt is None else 2e-2
    for got, want in ((out.detach().float().numpy(), jout), (tenc.table.grad.numpy(), jg_t),
                      (xt.grad.numpy(), jg_x)):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    assert np.abs(jg_x).max() > 0


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_scatter_field_builds_and_differentiates_as_jax(cdt):
    # The unit box: the field's normalisation (x - 0) / 1 is exact, so the
    # jitted JAX step moves no sample (at +-1.5 XLA's fused arithmetic
    # moved some across a cell face).
    aabb = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]
    cfg = dict(encoder_type="grouped", table_grad="scatter", n_levels=16, n_features_per_level=2,
               log2_hashmap_size=12, mlp_width=16)
    rng = np.random.default_rng(14)
    pos = rng.uniform(0.02, 0.98, size=(800, 3)).astype(np.float32)
    dirs = rng.normal(size=(800, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    r_rgb, r_sigma = rng.standard_normal((800, 3)).astype(np.float32), rng.standard_normal((800, 1)).astype(np.float32)
    jfield = JField(aabb=aabb, compute_dtype=_jdtype(cdt), **cfg)
    params = jax.jit(jfield.init)(jax.random.PRNGKey(5), jnp.zeros((8, 3)), jnp.zeros((8, 3)))

    def jloss(p, xx):
        rgb, sigma = jfield.apply(p, xx, jnp.asarray(dirs))
        return jnp.sum(rgb.astype(jnp.float32) * r_rgb) + jnp.sum(sigma.astype(jnp.float32) * r_sigma)

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(pos))
    tfield = TField(aabb=aabb, compute_dtype=cdt, device="cpu", **cfg)
    tfield.load_state_dict(field_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    xt = torch.from_numpy(pos).requires_grad_(True)
    rgb, sigma = tfield(xt, torch.from_numpy(dirs))
    ((rgb.float() * torch.from_numpy(r_rgb)).sum() + (sigma.float() * torch.from_numpy(r_sigma)).sum()).backward()
    want_t, want_x = np.asarray(jg_p["params"]["encoder"]["table"]), np.asarray(jg_x)
    # float32 1e-5 of the largest entry, bf16 2e-2 (tests/test_models.py:549).
    tol = 1e-5 if cdt is None else 2e-2
    np.testing.assert_allclose(tfield.encoder.table.grad.numpy(), want_t, rtol=0, atol=tol * np.abs(want_t).max())
    np.testing.assert_allclose(xt.grad.numpy(), want_x, rtol=0, atol=tol * np.abs(want_x).max())
    assert np.abs(want_x).max() > 0


@pytest.mark.parametrize("ord", [1, 2, np.inf], ids=["ord1", "ord2", "ordinf"])
def test_contract_to_unisphere_ord_matches_jax(ord):
    aabb = np.array([-8.0] * 3 + [8.0] * 3, np.float32)
    x = (np.random.default_rng(15).normal(size=(50_000, 3)) * 20).astype(np.float32)
    got = contract_to_unisphere(torch.from_numpy(x), torch.from_numpy(aabb), ord=ord).numpy()
    want = np.asarray(j_unisphere(jnp.asarray(x), jnp.asarray(aabb), ord=ord))
    if ord == 2:  # _norm3, XLA's rounding of the 2-norm, bit for bit
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _shell(res):
    g = (np.arange(res) + 0.5) / res * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    return (np.abs(np.sqrt(gx**2 + gy**2 + gz**2) - 0.45) < 0.12)[None]


@pytest.mark.parametrize("lattice_per_round", [16, 64])
def test_test_renderer_lattice_per_round_matches_jax(lattice_per_round):
    # tests/test_torch_render.py's scene at 16 x 16 rays: the traversal is
    # exact, so sample counts are equal; rgb, opacity and depth atol 1e-5.
    aabb, side = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], 16
    cfg = dict(n_levels=2, n_features_per_level=16, log2_hashmap_size=14, mlp_width=16)
    jfield = JField(aabb=aabb, encoder_type="fused", **cfg)
    params = jax.jit(jfield.init)(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    tfield = TField(aabb=aabb, device="cpu", **cfg)
    tfield.load_state_dict(field_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    je = JEstimator(roi_aabb=aabb, resolution=32, levels=1)
    js = je.set_binaries(je.init(), jnp.asarray(_shell(32)))
    te = TEstimator(roi_aabb=aabb, resolution=32, levels=1)
    ts = occ_state_from_jax(te, js, device="cpu")
    c2w = _pose_spherical(np.radians(-30.0), np.radians(-30.0), 4.0)[:3, :4]
    focal = 0.5 * side / np.tan(0.5 * 0.6911112)
    K = np.array([[focal, 0, side / 2], [0, focal, side / 2], [0, 0, 1]], np.float32)
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="xy")
    jrays, trays = j_generate_rays(xs, ys, K, c2w), t_generate_rays(xs, ys, K, c2w, device="cpu")

    def j_builder(ro, rd):
        def fn(t0, t1, ri):
            o, d = j_gather(ro, rd, ri)
            rgb, sigma = jfield.apply(params, o + ((t0 + t1) / 2)[:, None] * d, d)
            return rgb, sigma[..., 0]

        return fn

    def t_builder(ro, rd):
        def fn(t0, t1, ri):
            o, d = t_gather(ro, rd, ri)
            rgb, sigma = tfield(o + ((t0 + t1) / 2)[:, None] * d, d)
            return rgb, sigma[..., 0]

        return fn

    # From 2.0 on: 32 rounds of 16 lattice steps reach 2.56 further, past
    # the shell (about 3.4 to 4.6 from the camera).
    kw = dict(max_samples=1024, samples_per_round=32, render_step_size=5e-3, near_plane=2.0,
              lattice_per_round=lattice_per_round)
    # capacity_buckets=1: one compiled round, the same samples.
    want = j_render(j_builder, je, js, jrays.origins.reshape(-1, 3), jrays.viewdirs.reshape(-1, 3),
                    render_bkgd=jnp.ones(3), capacity_buckets=1, **kw)
    got = t_render(t_builder, te, ts, trays.origins.reshape(-1, 3), trays.viewdirs.reshape(-1, 3),
                   render_bkgd=torch.ones(3), **kw)
    assert got[3] == want[3] > 0
    for a, b in zip(want[:3], got[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)
