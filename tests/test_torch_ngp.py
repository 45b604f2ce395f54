"""NGP field and fused hash encoder: port against ``nerfacc_tpu.models``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerfacc_tpu.models.encoding import spherical_harmonics_deg4 as j_sh
from nerfacc_tpu.models.hash_soa import HashGridEncoderFused as JEncoder
from nerfacc_tpu.models.ngp import NGPRadianceField as JField
from nerfacc_tpu_torch.convert import field_from_jax
from nerfacc_tpu_torch.models.encoding import spherical_harmonics_deg4 as t_sh
from nerfacc_tpu_torch.models.hash_soa import (
    HashGridEncoderFused as TEncoder,
    dense_level,
    grid_resolutions,
)
from nerfacc_tpu_torch.models.ngp import NGPRadianceField as TField


def _points(rng, n, lo=-0.1, hi=1.1):
    return rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)


def test_dense_level_reproduces_the_int32_wrap():
    T = 1 << 15  # render.py's fused default: log2_hashmap_size 18 - 3
    res = grid_resolutions(8, 16, 4096)
    assert res == [16, 35, 78, 172, 380, 840, 1854, 4095]
    # 4095**3 wraps to -50319361 in int32, so JAX indexes that level densely.
    assert [dense_level(r, T) for r in res] == [True] + [False] * 6 + [True]
    assert dense_level(32, T) and not dense_level(33, T)


def test_encoder_rows_match_jax_exactly_including_the_wrapped_level():
    """A table whose row r holds the value r makes the encoder return the
    row it gathered (the 8 corner weights sum to 1), so JAX's rows can be
    read off its output and compared with the port's."""
    L, log2_t = 8, 15
    T = 1 << log2_t
    enc = JEncoder(n_levels=L, n_features_per_level=1, log2_hashmap_size=log2_t)
    x = _points(np.random.default_rng(0), 2000)
    rows_table = np.repeat(np.arange(L * T, dtype=np.float32)[:, None], 8, axis=1) + 1e-4
    out = enc.apply({"params": {"table": jnp.asarray(rows_table)}}, jnp.asarray(x))
    want = np.rint(np.asarray(out)).astype(np.int64)  # (n, L)

    tenc = TEncoder(n_levels=L, n_features_per_level=1, log2_hashmap_size=log2_t, device="cpu")
    rows, _ = tenc.cell_indices(torch.from_numpy(x))
    np.testing.assert_array_equal(rows.T.numpy(), want)
    assert tenc.resolutions[-1] == 4095


def test_encoder_features_match_jax():
    L, F, log2_t = 4, 16, 11
    enc = JEncoder(n_levels=L, n_features_per_level=F, log2_hashmap_size=log2_t)
    x = _points(np.random.default_rng(1), 3000)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(enc.apply(params, jnp.asarray(x)))
    tenc = TEncoder(n_levels=L, n_features_per_level=F, log2_hashmap_size=log2_t, device="cpu")
    tenc.load_state_dict({"table": torch.from_numpy(np.array(params["params"]["table"]))})
    with torch.no_grad():
        got = tenc(torch.from_numpy(x)).numpy()
    # rtol 1e-6 on features of size ~1e-4; atol 1e-10 covers a sum of 8
    # products that cancels, where one float32 rounding of a 1e-4 term is ~1e-11.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10)


def test_spherical_harmonics_match_jax():
    d = np.random.default_rng(2).normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # rtol 1e-6, atol 1e-7: the same polynomials in float32.
    np.testing.assert_allclose(
        t_sh(torch.from_numpy(d)).numpy(), np.asarray(j_sh(jnp.asarray(d))), rtol=1e-6, atol=1e-7
    )


def test_field_forward_through_converted_weights_matches_jax():
    aabb = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
    cfg = dict(n_levels=2, n_features_per_level=16, log2_hashmap_size=14, mlp_width=16)
    rng = np.random.default_rng(3)
    pos = rng.uniform(-1.7, 1.7, size=(4000, 3)).astype(np.float32)
    dirs = rng.normal(size=(4000, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for unbounded in (False, True):
        jfield = JField(aabb=aabb, encoder_type="fused", unbounded=unbounded, **cfg)
        params = jfield.init(jax.random.PRNGKey(1), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
        want_rgb, want_sigma = jfield.apply(params, jnp.asarray(pos), jnp.asarray(dirs))
        tfield = TField(aabb=aabb, unbounded=unbounded, device="cpu", **cfg)
        tfield.load_state_dict(field_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        with torch.no_grad():
            rgb, sigma = tfield(torch.from_numpy(pos), torch.from_numpy(dirs))
        # rtol 1e-5, atol 1e-6: float32 MLPs, products summed in another order.
        np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), rtol=1e-5, atol=1e-6)
        if not unbounded:  # zero outside the box, positive inside
            assert float(sigma.min()) == 0.0 and float(sigma.max()) > 0.0


def test_random_init_is_seeded_and_shaped_like_flax():
    aabb = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
    cfg = dict(n_levels=2, n_features_per_level=16, log2_hashmap_size=12, mlp_width=16)
    a = TField(aabb=aabb, device="cpu", generator=torch.Generator().manual_seed(0), **cfg)
    b = TField(aabb=aabb, device="cpu", generator=torch.Generator().manual_seed(0), **cfg)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    jfield = JField(aabb=aabb, encoder_type="fused", **cfg)
    jparams = jfield.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    converted = field_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert {k: tuple(v.shape) for k, v in converted.items()} == {
        k: tuple(v.shape) for k, v in a.state_dict().items()
    }
    table = a.encoder.table.detach()
    assert 0.0 <= float(table.min()) and float(table.max()) < 2e-4
    w = a.mlp_base[0].weight.detach()
    std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    assert float(a.mlp_base[0].bias.detach().abs().max()) == 0.0
