"""The grouped (tcnn-shape) hash encoder and its table gradient (K6): the
port against ``nerfacc_tpu.models.hash_soa.HashGridEncoderGrouped`` and
``nerfacc_tpu.ops.table_grad.table_grad_factors_sorted_pos`` (Pallas in
interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.models.hash_soa import HashGridEncoderGrouped as JEncoder
from nerfacc_tpu.models.ngp import NGPRadianceField as JField
from nerfacc_tpu.ops.table_grad import hash_lookup_combine_pos as j_lookup_pos
from nerfacc_tpu.ops.table_grad import table_grad_factors_sorted_pos
from nerfacc_tpu_torch.convert import field_from_jax
from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderGrouped as TEncoder
from nerfacc_tpu_torch.models.hash_soa import _hash_rows, grid_resolutions
from nerfacc_tpu_torch.models.ngp import NGPRadianceField as TField
from nerfacc_tpu_torch.ops.table_grad import (
    Fetch,
    _grouped_corner_weights,
    fetch_consts,
    shared_windows,
    table_grad_pos,
)

L, F = 16, 2
# tests/test_models.py:816-851's settings: T = 2^9, resolutions to 256.
SMALL = dict(n_levels=L, n_features_per_level=F, log2_hashmap_size=9, max_resolution=256)


def _encoders(cdt, **kw):
    cfg = dict(SMALL, **kw)
    jenc = JEncoder(**cfg, compute_dtype=None if cdt is None else jnp.bfloat16, table_grad="factor")
    tenc = TEncoder(**cfg, compute_dtype=cdt, device="cpu")
    return jenc, tenc


def _load(tenc, params):
    tenc.load_state_dict({"table": torch.from_numpy(np.array(params["params"]["table"]))})


def _points(rng, n):
    x = rng.uniform(-0.05, 1.05, size=(n, 3)).astype(np.float32)
    x[:4] = [[0.0, 0.0, 0.0], [0.5, 0.25, 1.0], [1.0 / 3, 2.0 / 3, 0.999], [1e-7, 0.5, 0.5]]
    return x


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_forward_matches_jax(cdt):
    rng = np.random.default_rng(0)
    x = _points(rng, 3000)
    jenc, tenc = _encoders(cdt)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x[:4]))
    want = np.asarray(jenc.apply(params, jnp.asarray(x)).astype(jnp.float32))
    _load(tenc, params)
    assert tenc.fetch_key_levels() == jenc.fetch_key_levels()
    with torch.no_grad():
        got = tenc(torch.from_numpy(x)).float().numpy()
    assert got.shape == (3000, L * F)
    if cdt is None:
        # rtol 1e-6, atol 1e-10: the same float32 weights and products, the
        # 8 corners summed in float32 (a cancelling sum rounds at ~1e-11).
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10)
    else:
        # One bf16 step of the output: the corner sum is taken in float32
        # and rounded once, and a last-bit difference of that sum may round
        # the other way.
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= step).all()


def test_dense_decision_is_jax_wrapped_int32_one_at_log2t_16():
    # The reference's tcnn shape: 2^19 entries, 2^16 rows a span.
    T = 1 << 16
    tenc = TEncoder(n_levels=L, n_features_per_level=F, log2_hashmap_size=16, device="cpu")
    res = grid_resolutions(L, 16, 4096)
    assert res == [16, 23, 33, 48, 70, 101, 147, 212, 307, 445, 645, 933, 1351, 1955, 2830, 4095]
    assert tenc.fetch_key_levels() == [1, 3, 4, 7, 9, 11, 13, 15]
    key_res = [res[k] for k in tenc.fetch_key_levels()]
    # 1955^3 and 4095^3 wrap in int32 and index densely, as in JAX;
    # Python ints would hash both.
    assert tenc._dense.flatten().tolist() == [True, False, False, False, False, False, True, True]
    assert [r**3 <= T for r in key_res] == [True] + [False] * 7

    # A table whose every lane of row r holds r (plus the 1e-4 offset) makes
    # the encoder return the row each fetch gathered (the corner weights of
    # every sub-level sum to 1), so JAX's rows can be read off its output.
    jenc = JEncoder(n_levels=L, n_features_per_level=F, log2_hashmap_size=16, table_grad="factor")
    rows_table = np.repeat(np.arange(2 * T, dtype=np.float32)[:, None], 128, axis=1) + 1e-4
    x = _points(np.random.default_rng(1), 2000)
    out = np.asarray(jenc.apply({"params": {"table": jnp.asarray(rows_table)}}, jnp.asarray(x)))
    want = np.rint(out[:, ::4]).astype(np.int64).T  # (8 fetches, n): feature 0 of each fetch
    xt = [torch.from_numpy(x[:, i].copy()) for i in range(3)]
    got = tenc.fetch_rows(*xt).numpy()
    np.testing.assert_array_equal(got, want)
    # The two wrapped fetches, hashed as Python ints would, name other rows.
    cells = [torch.floor(c[None, :] * tenc._key_res_f).long() for c in xt]
    hashed = (_hash_rows(*cells, tenc._key_res_i, torch.zeros_like(tenc._dense), T) + tenc._span_offset).numpy()
    assert (hashed[6:] != want[6:]).mean() > 0.9
    np.testing.assert_array_equal(hashed[1:6], want[1:6])


@pytest.mark.parametrize("key", [0, 1])
def test_grouped_weights_match_jax_bit_for_bit(key):
    """The weights of the finest window at the tcnn shape (resolutions 1955
    and 4095), read off JAX's float32 forward and its K6 in interpret mode,
    against the port's: XLA on the CPU rounds ``x * r`` before subtracting
    its floor (no fused multiply-add), and so does the port."""
    rng = np.random.default_rng(6)
    m, n_rows, J = 512, 512, 8
    pos = rng.random((3, m), dtype=np.float32)
    fe = Fetch(span=0, j_lo=2, res=(1955, 4095), key=key)
    spec = ((0, fe.j_lo, 2, tuple(float(r) for r in fe.res), key),)
    consts = fetch_consts([fe], "cpu")
    want = _grouped_corner_weights(
        *(torch.from_numpy(c)[:, None] for c in pos), consts.res, consts.is_key
    ).numpy()  # (m, 8 corners, 2 sub-levels)
    # Forward: row c holds 1 on corner c's lanes of the window (feature 0),
    # so the output is that corner's weight.
    table = np.zeros((n_rows, 128), np.float32)
    for c in range(8):
        table[c, [c * J * F + (fe.j_lo + k) * F for k in range(2)]] = 1.0
    got = np.stack([
        np.asarray(j_lookup_pos(
            jnp.asarray(table), jnp.full((m,), c, jnp.int32), *(jnp.asarray(a) for a in pos), spec,
            F=F, interpret=True, level_span=n_rows,
        ))[:, [0, F]]
        for c in range(8)
    ], axis=1)
    np.testing.assert_array_equal(got, want)
    # K6 with one sample a row and a unit cotangent writes bf16(w).
    for k in range(2):
        dout = np.zeros((2 * F, m), np.float32)
        dout[k * F] = 1.0
        dT = np.asarray(table_grad_factors_sorted_pos(
            jnp.arange(m, dtype=jnp.int32), jnp.asarray(pos), jnp.asarray(dout).astype(jnp.bfloat16),
            n_rows=n_rows, RES=spec[0][3], F=F, J=J, J_LO=fe.j_lo, JG=2, KEY_K=key, W=256, interpret=True,
        ))
        w_bf16 = torch.from_numpy(want[:, :, k]).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(dT[:, [c * J * F + (fe.j_lo + k) * F for c in range(8)]], w_bf16)


def _pairs(rng, tenc, n):
    """The encoder's (row, fetch) pairs for n points, their cotangents in
    bf16, and the sorted keys."""
    x = _points(rng, n)
    xs, ys, zs = (torch.from_numpy(x[:, i].copy()) for i in range(3))
    rows = tenc.fetch_rows(xs, ys, zs)  # (nf, n) absolute
    nf = rows.shape[0]
    dout = torch.from_numpy(
        (rng.standard_normal((nf * n, 4)) * rng.choice([1e-3, 1.0], (nf * n, 1))).astype(np.float32)
    ).to(torch.bfloat16)
    key = (rows * nf + torch.arange(nf)[:, None]).reshape(-1).to(torch.int32)
    sorted_key, perm = torch.sort(key)
    return (xs, ys, zs), rows, dout, sorted_key, perm


def test_k6_plain_matches_jax_pos_kernel_for_every_fetch():
    rng = np.random.default_rng(2)
    n = 1500
    _, tenc = _encoders(torch.bfloat16)
    T = tenc.table_size
    pos, rows, dout, sorted_key, perm = _pairs(rng, tenc, n)
    got = table_grad_pos(sorted_key, perm, *pos, dout, tenc.table.shape[0], tenc.fetches, F).numpy()

    want = np.zeros_like(got)
    p3 = np.stack([c.numpy() for c in pos])
    d = dout.float().numpy()
    for g, fe in enumerate(tenc.fetches):
        rel = rows[g].numpy() - fe.span * T
        order = np.argsort(rel, kind="stable")
        want[fe.span * T : (fe.span + 1) * T] += np.asarray(table_grad_factors_sorted_pos(
            jnp.asarray(rel[order].astype(np.int32)), jnp.asarray(p3[:, order]),
            jnp.asarray(d[g * n : (g + 1) * n][order].T).astype(jnp.bfloat16),
            n_rows=T, RES=tuple(float(r) for r in fe.res), F=F, J=8, J_LO=fe.j_lo, JG=2,
            KEY_K=fe.key, W=256, interpret=True,
        ))
    # The same bf16 terms summed in float32 in another order: atol 1e-6 of
    # the largest row sum.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    # A fetch writes only its window's 32 columns of the rows it names: the
    # columns of every (row, window) that no fetch names stay zero.
    owned = np.zeros(got.shape, bool)
    for g, fe in enumerate(tenc.fetches):
        cols = [c * 16 + (fe.j_lo + k) * F + f for c in range(8) for k in range(2) for f in range(F)]
        owned[np.ix_(np.unique(rows[g].numpy()), cols)] = True
    assert (~owned).sum() > 1000 and not got[~owned].any() and got[owned].any()


# Every (F, keys_per_row) the grouped encoder builds: F in 1, 2, 4, 8, 16 and
# keys_per_row dividing J = 16 / F, so windows of jg * F = 16 / keys_per_row
# columns a corner.
EVERY_SPLIT = [(F_, k) for F_ in (1, 2, 4, 8, 16) for k in (1, 2, 4, 8, 16) if (16 // F_) % k == 0]


@pytest.mark.parametrize("F_,keys_per_row", EVERY_SPLIT, ids=[f"F{f}-split{k}" for f, k in EVERY_SPLIT])
def test_k6_plain_matches_jax_pos_kernel_at_every_split(F_, keys_per_row):
    """K6's plain version at every window width against JAX's kernel (in
    interpret mode) on the last fetch, the one with the last span and the
    last window of the row; the other fetches of its span write other
    columns of its rows, which JAX's call of that one fetch leaves zero."""
    rng = np.random.default_rng(11)
    n = 256
    tenc = TEncoder(**dict(SMALL, n_features_per_level=F_), keys_per_row=keys_per_row,
                    compute_dtype=torch.bfloat16, device="cpu")
    J, T = 16 // F_, tenc.table_size
    assert tenc.split == keys_per_row and len(tenc.fetches) == (16 // J) * keys_per_row
    x = _points(rng, n)
    pos = [torch.from_numpy(x[:, i].copy()) for i in range(3)]
    rows = tenc.fetch_rows(*pos)
    nf, jg = rows.shape[0], J // keys_per_row
    dout = torch.from_numpy(rng.standard_normal((nf * n, jg * F_)).astype(np.float32)).to(torch.bfloat16)
    key = (rows * nf + torch.arange(nf)[:, None]).reshape(-1).to(torch.int32)
    sorted_key, perm = torch.sort(key)
    got = table_grad_pos(sorted_key, perm, *pos, dout, tenc.table.shape[0], tenc.fetches, F_).numpy()

    g, fe = nf - 1, tenc.fetches[-1]
    rel = rows[g].numpy() - fe.span * T
    order = np.argsort(rel, kind="stable")
    want = np.asarray(table_grad_factors_sorted_pos(
        jnp.asarray(rel[order].astype(np.int32)), jnp.asarray(np.stack(x.T)[:, order]),
        jnp.asarray(dout[g * n : (g + 1) * n].float().numpy()[order].T).astype(jnp.bfloat16),
        n_rows=T, RES=tuple(float(r) for r in fe.res), F=F_, J=J, J_LO=fe.j_lo, JG=jg,
        KEY_K=fe.key, W=128, CH=128, interpret=True,
    ))
    cols = np.array([c * 16 + fe.j_lo * F_ + k for c in range(8) for k in range(jg * F_)])
    window = got[fe.span * T : (fe.span + 1) * T][:, cols]
    # The same bf16 terms summed in float32 in another order: atol 1e-6 of
    # the largest row sum; JAX's call writes nothing outside the window.
    np.testing.assert_allclose(window, want[:, cols], rtol=0, atol=1e-6 * np.abs(want).max())
    assert np.abs(want).max() > 0 and not np.delete(want, cols, axis=1).any()


@pytest.mark.parametrize("keys_per_row", [4, 2])
def test_k6_refuses_only_fetches_that_share_a_window(keys_per_row):
    """K6 stores each run that no other warp holds part of, so on the card it
    refuses fetches that name the same columns of a row (a repeated span and
    window); the encoder never makes them, and the CPU path sums them."""
    tenc = TEncoder(**SMALL, keys_per_row=keys_per_row, device="cpu")
    assert len(tenc.fetches) == 2 * keys_per_row
    assert shared_windows(tenc.fetches) == []
    fe = tenc.fetches[-1]
    assert shared_windows(tenc.fetches + (fe,)) == [(fe.span, fe.j_lo)]
    assert shared_windows((fe, tenc.fetches[0], fe, tenc.fetches[0])) == sorted(
        {(fe.span, fe.j_lo), (tenc.fetches[0].span, tenc.fetches[0].j_lo)})
    # The plain version sums a repeated fetch: twice the terms of one.
    rng = np.random.default_rng(7)
    n, T = 300, tenc.table_size
    x = _points(rng, n)
    pos = [torch.from_numpy(x[:, i].copy()) for i in range(3)]
    rows = rng.integers(0, 50, n) + fe.span * T
    dout = torch.from_numpy(rng.standard_normal((n, len(fe.res) * F)).astype(np.float32)).to(torch.bfloat16)
    one_key, one_perm = torch.sort(torch.from_numpy(rows.astype(np.int32)))
    once = table_grad_pos(one_key, one_perm, *pos, dout, 2 * T, (fe,), F)
    key = torch.from_numpy((np.concatenate([rows, rows]) * 2 + np.repeat([0, 1], n)).astype(np.int32))
    two_key, two_perm = torch.sort(key)
    twice = table_grad_pos(two_key, two_perm, *pos, torch.cat([dout, dout]), 2 * T, (fe, fe), F)
    assert once.abs().max() > 0
    torch.testing.assert_close(twice, 2 * once, rtol=0, atol=1e-6 * float(once.abs().max()))


def test_grouped_bf16_table_gradient_matches_jax_grad_and_positions_get_none():
    rng = np.random.default_rng(3)
    n = 2000
    x = _points(rng, n)
    r = rng.standard_normal((n, L * F)).astype(np.float32)
    jenc, tenc = _encoders(torch.bfloat16)
    params = jenc.init(jax.random.PRNGKey(1), jnp.asarray(x[:4]))

    def jloss(p, xx):
        return jnp.sum(jenc.apply(p, xx).astype(jnp.float32) * r)

    jg_table, jg_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    jg_table = np.asarray(jg_table["params"]["table"])
    _load(tenc, params)
    xt = torch.from_numpy(x).requires_grad_(True)
    before = table_grad_pos.launches
    (tenc(xt).float() * torch.from_numpy(r)).sum().backward()
    assert table_grad_pos.launches == before  # a CPU tensor takes the plain version
    # The cotangent rounds to bf16 on both sides and K6's terms are the JAX
    # kernel's roundings; float32 sums in another order: atol 1e-6 of the
    # largest entry.
    np.testing.assert_allclose(
        tenc.table.grad.numpy(), jg_table, rtol=0, atol=1e-6 * np.abs(jg_table).max()
    )
    assert not np.asarray(jg_x).any()
    assert xt.grad is not None and not xt.grad.any()


def test_grouped_float32_table_gradient_is_autograd_of_the_gather():
    rng = np.random.default_rng(4)
    n = 1000
    x = _points(rng, n)
    r = rng.standard_normal((n, L * F)).astype(np.float32)
    jenc, tenc = _encoders(None)
    params = jenc.init(jax.random.PRNGKey(2), jnp.asarray(x[:4]))
    jg = np.asarray(jax.grad(lambda p: jnp.sum(jenc.apply(p, jnp.asarray(x)) * r))(params)["params"]["table"])
    _load(tenc, params)
    before = table_grad_pos.launches
    (tenc(torch.from_numpy(x)) * torch.from_numpy(r)).sum().backward()
    assert table_grad_pos.launches == before
    # float32 products w * r, summed in another order.
    np.testing.assert_allclose(tenc.table.grad.numpy(), jg, rtol=0, atol=1e-6 * np.abs(jg).max())


def test_grouped_field_has_the_tcnn_parameter_budget_and_trains():
    # tests/test_models.py:886-902: 16 levels x 2 features x 2^15 entries.
    aabb = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]
    field = TField(
        aabb=aabb, encoder_type="grouped", n_levels=16, n_features_per_level=2,
        log2_hashmap_size=15, compute_dtype=torch.bfloat16, device="cpu",
        generator=torch.Generator().manual_seed(0),
    )
    assert field.encoder.table.numel() == 16 * 2 * 2**15
    assert tuple(field.encoder.table.shape) == (2 * 2**12, 128)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.random((128, 3), dtype=np.float32))
    d = torch.from_numpy(rng.standard_normal((128, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    rgb, dens = field(x, d)
    ((rgb.float() ** 2).sum() + (dens**2).sum()).backward()
    g = field.encoder.table.grad
    assert bool(torch.isfinite(g).all()) and bool((g.abs() > 0).any())


def test_field_from_jax_loads_a_grouped_field():
    aabb = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
    cfg = dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=12, mlp_width=16)
    rng = np.random.default_rng(5)
    pos = rng.uniform(-1.6, 1.6, size=(2000, 3)).astype(np.float32)
    dirs = rng.normal(size=(2000, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    jfield = JField(aabb=aabb, encoder_type="grouped", **cfg)
    params = jfield.init(jax.random.PRNGKey(3), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    want_rgb, want_sigma = jfield.apply(params, jnp.asarray(pos), jnp.asarray(dirs))
    tfield = TField(aabb=aabb, encoder_type="grouped", device="cpu", **cfg)
    state = field_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in tfield.state_dict().items()
    }
    tfield.load_state_dict(state)
    with torch.no_grad():
        rgb, sigma = tfield(torch.from_numpy(pos), torch.from_numpy(dirs))
    # rtol 1e-5, atol 1e-6: float32 MLPs, products summed in another order
    # (test_torch_ngp.py's field tolerance).
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), rtol=1e-5, atol=1e-6)
    assert float(sigma.max()) > 0.0
