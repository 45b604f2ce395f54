"""The port's hash encoders against the JAX package's: the tcnn-parity
``HashGridEncoder`` and ``HashGridEncoderSoA``, ``HashGridEncoderFolded``,
and what the fused encoder gained (chunk-paired levels, the ``scatter``
route), each on the same seeded inputs and the
same table, forward and table gradient.  (One whole train step with each
new encoder is in ``tests/test_torch_train.py``, whose process has JAX's
traversal compiled already.)

The JAX side runs jitted on the CPU (Pallas in interpret mode): the inputs
are positions, so XLA's multiply-adds move no sample across a cell face.  Each test
states its tolerance; the tests of ``tests/test_models.py`` they mirror are
named beside them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.models import encoding as jenc_mod
from nerfacc_tpu.models import hash_soa as jsoa
from nerfacc_tpu_torch.models import encoding as tenc_mod
from nerfacc_tpu_torch.models import hash_soa as tsoa
from nerfacc_tpu_torch.ops import table_grad as tg

ENCODERS = {
    "hash": (jenc_mod.HashGridEncoder, tenc_mod.HashGridEncoder),
    "soa": (jsoa.HashGridEncoderSoA, tsoa.HashGridEncoderSoA),
    "folded": (jsoa.HashGridEncoderFolded, tsoa.HashGridEncoderFolded),
    "fused": (jsoa.HashGridEncoderFused, tsoa.HashGridEncoderFused),
}


def _pair(name, **kw):
    """The JAX encoder, its parameters and the port's encoder holding the
    same table: the port's, drawn as flax draws it (``U(0, 2e-4)``) from
    seed 0.  (Building it through JAX's ``init`` costs a compile a test.)"""
    jcls, tcls = ENCODERS[name]
    tenc = tcls(**kw, device="cpu", generator=torch.Generator().manual_seed(0))
    params = {"params": {"table": jnp.asarray(tenc.table.detach().numpy())}}
    return jcls(**kw), params, tenc


def _points(seed, n):
    return np.random.default_rng(seed).random((n, 3), dtype=np.float32)


@pytest.mark.parametrize(
    "name,kw",
    [
        ("hash", dict(n_levels=4, log2_hashmap_size=12, max_resolution=128)),
        ("soa", dict(n_levels=4, log2_hashmap_size=12, max_resolution=128)),
        ("folded", dict(n_levels=3, n_features_per_level=4, log2_hashmap_size=11, max_resolution=128)),
    ],
)
def test_new_encoder_matches_jax_forward_and_table_gradient(name, kw):
    jenc, params, tenc = _pair(name, **kw)
    x = _points(1, 257)
    r = np.random.default_rng(2).standard_normal((257, tenc.latent_dim)).astype(np.float32)
    want = np.asarray(jax.jit(jenc.apply)(params, jnp.asarray(x)))
    g_want = np.asarray(
        jax.jit(jax.grad(lambda p: jnp.sum(jenc.apply(p, jnp.asarray(x)) * r)))(params)["params"]["table"]
    )
    out = tenc(torch.from_numpy(x))
    (out * torch.from_numpy(r)).sum().backward()
    # rtol 1e-5 / atol 1e-9, tests/test_models.py:29: the same float32
    # products; the corner sums may add in another order.
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-9)
    # The table gradient is a scatter-add on both sides, in another order:
    # atol 1e-6 of the largest entry.
    np.testing.assert_allclose(tenc.table.grad.numpy(), g_want, rtol=0, atol=1e-6 * np.abs(g_want).max())
    assert np.abs(g_want).max() > 0


def test_hash_encoders_agree_aos_vs_soa():
    # tests/test_models.py:29 on the port: the SoA table is the AoS one
    # transposed; rtol 1e-5.
    kw = dict(n_levels=4, log2_hashmap_size=12, max_resolution=128, device="cpu")
    a, s = tenc_mod.HashGridEncoder(**kw), tsoa.HashGridEncoderSoA(**kw)
    s.load_state_dict({"table": a.table.detach().T.contiguous()})
    x = torch.from_numpy(_points(0, 257))
    np.testing.assert_allclose(s(x).detach().numpy(), a(x).detach().numpy(), rtol=1e-5, atol=1e-9)


def test_folded_ties_to_fused():
    # tests/test_models.py:46: a level's 8 corner blocks sum to the fused
    # features on the same table; rtol 1e-5, atol 1e-7.
    L, F = 3, 4
    kw = dict(n_levels=L, n_features_per_level=F, log2_hashmap_size=11, max_resolution=128, device="cpu")
    fused, folded = tsoa.HashGridEncoderFused(**kw), tsoa.HashGridEncoderFolded(**kw)
    folded.load_state_dict(fused.state_dict())
    x = torch.from_numpy(_points(5, 193))
    tied = folded(x).reshape(193, L, 8, F).sum(dim=2).reshape(193, L * F)
    np.testing.assert_allclose(tied.detach().numpy(), fused(x).detach().numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["hash", "soa", "fused", "folded"])
def test_encoder_grads_flow(name):
    # tests/test_models.py:74: table and position gradients, finite.
    enc = ENCODERS[name][1](n_levels=3, log2_hashmap_size=10, max_resolution=64, device="cpu")
    x = torch.from_numpy(_points(1, 65)).requires_grad_(True)
    out = enc(x)
    assert out.shape == (65, enc.latent_dim)
    (out**2).sum().backward()
    assert float(enc.table.grad.abs().sum()) > 0
    assert torch.isfinite(x.grad).all() and float(x.grad.abs().sum()) > 0


def test_encoder_continuity_soa():
    # tests/test_models.py:88: vertex-shared levels are continuous across a
    # cell face (difference below 1e-3 at 1e-5 either side).
    enc = tsoa.HashGridEncoderSoA(n_levels=2, log2_hashmap_size=14, max_resolution=32, device="cpu")
    eps = 1e-5
    x0 = torch.tensor([[0.5 - eps, 0.3, 0.7]])
    x1 = torch.tensor([[0.5 + eps, 0.3, 0.7]])
    assert float((enc(x0) - enc(x1)).abs().max()) < 1e-3


@pytest.mark.parametrize("name", ["hash", "soa"])
def test_full_resolutions_index_the_rows_of_the_wrapped_dense_decision(name):
    # 16 levels from 16 to 4096 (the reference's), T = 2^10: (res + 1)^3
    # wraps in int32 for 1351, 1955 and 4095, which JAX then indexes densely
    # although no such level fits the table.  The port must read the same
    # rows: forward within rtol 1e-5, and the true decision reads others.
    T = 1 << 10
    res = tsoa.grid_resolutions(16, 16, 4096)
    wrapped = [tsoa.dense_vertex_level(r, T) for r in res]
    true = [(r + 1) ** 3 <= T for r in res]
    assert [r for r, w, t in zip(res, wrapped, true) if w != t] == [1351, 1955, 4095]
    jenc, params, tenc = _pair(name, n_levels=16, log2_hashmap_size=10)
    assert tenc._dense.flatten().tolist() == wrapped
    x = _points(3, 64)
    want = np.asarray(jax.jit(jenc.apply)(params, jnp.asarray(x)))
    got = tenc(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    tenc._dense.copy_(torch.tensor(true)[:, None])
    other = tenc(torch.from_numpy(x)).detach().numpy()
    moved = [lvl for lvl in range(16) if not np.allclose(other[:, 2 * lvl : 2 * lvl + 2], want[:, 2 * lvl : 2 * lvl + 2])]
    assert moved == [12, 13, 15]


def _chunked_points(seed, n_chunks, C=4, step=1e-3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.3, 0.7, (n_chunks, 3)).astype(np.float32)
    d = rng.normal(size=(n_chunks, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = step * np.arange(C, dtype=np.float32)
    return (o[:, None, :] + t[None, :, None] * d[:, None, :]).reshape(-1, 3)


def test_fused_paired_levels_match_jax():
    # tests/test_models.py:280 on the port and against JAX at F = 8 (no
    # kernel; autograd on both sides).  Forward and table gradient within
    # atol 1e-7 / 1e-6 of the largest entry; unpaired levels bit-equal to
    # the unpaired encoding, chunk endpoints within 1e-7, a misaligned batch
    # falls back to the exact path.
    F, C, step = 8, 4, 1e-3
    kw = dict(n_levels=4, n_features_per_level=F, log2_hashmap_size=12, max_resolution=1024)
    jenc, params, tenc = _pair("fused", **kw)
    x = _chunked_points(3, 256, C, step)
    P = tsoa.paired_safe_level_count(tsoa.grid_resolutions(4, 16, 1024), step * C, chunk=1, margin=2.0)
    assert P == jsoa.paired_safe_level_count(jsoa.grid_resolutions(4, 16, 1024), step * C, chunk=1) >= 1
    r = np.random.default_rng(4).standard_normal((x.shape[0], 4 * F)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p: jenc.apply(p, jnp.asarray(x), paired_levels=P))(params))
    g_want = np.asarray(jax.jit(jax.grad(
        lambda p: jnp.sum(jenc.apply(p, jnp.asarray(x), paired_levels=P) * r)))(params)["params"]["table"])
    xt = torch.from_numpy(x)
    yp = tenc(xt, paired_levels=P)
    (yp * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(yp.detach().numpy(), want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(tenc.table.grad.numpy(), g_want, rtol=0, atol=1e-6 * np.abs(g_want).max())

    y0 = tenc(xt).detach().numpy()
    yp = yp.detach().numpy()
    np.testing.assert_array_equal(y0[:, P * F:], yp[:, P * F:])
    ends = np.zeros(x.shape[0], bool)
    ends[0::C] = ends[C - 1 :: C] = True
    np.testing.assert_allclose(y0[ends, : P * F], yp[ends, : P * F], atol=1e-7)
    np.testing.assert_array_equal(tenc(xt[:-1], paired_levels=P).detach().numpy(), y0[:-1])
    # The same through a component tuple.
    comps = tuple(xt[:, i].contiguous() for i in range(3))
    np.testing.assert_array_equal(tenc(comps, paired_levels=P).detach().numpy(), yp)


PALLAS_KW = dict(n_levels=4, n_features_per_level=16, log2_hashmap_size=9, max_resolution=1024)


def _scatter_case(paired):
    x = _chunked_points(1, 64) if paired else _points(0, 256)
    return x, np.random.default_rng(1).standard_normal((x.shape[0], 64)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_scatter_grads(paired):
    """JAX's scatter-route table and position gradients of one case (the
    same for both compute dtypes of the port)."""
    jenc, params, _ = _pair("fused", table_grad="scatter", **PALLAS_KW)
    x, r = _scatter_case(paired)
    g, gx = jax.jit(jax.grad(
        lambda p, xx: jnp.sum(jenc.apply(p, xx, paired_levels=paired) * r), argnums=(0, 1)
    ))(params, jnp.asarray(x))
    return np.asarray(g["params"]["table"]), np.asarray(gx)


@pytest.mark.parametrize("paired", [0, 2], ids=["unpaired", "paired2"])
@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_pallas_and_scatter_routes_match_jax_scatter(paired, cdt):
    # tests/test_models.py:431 and :472: the port's pallas route (K5's plain
    # version, once a level, the paired endpoints' levels included) and
    # its scatter route (autograd) against JAX's scatter, whose autodiff
    # also gives the positions a gradient.  float32: forward bit-equal to
    # each other, rtol 1e-5 / atol 1e-5 against JAX's gradient; bf16: 2e-2
    # of the largest entry against JAX's float32 gradient.
    _, _, t_scatter = _pair("fused", table_grad="scatter", **PALLAS_KW)
    t_pallas = tsoa.HashGridEncoderFused(**PALLAS_KW, table_grad="pallas", compute_dtype=cdt, device="cpu")
    t_pallas.load_state_dict(t_scatter.state_dict())
    x, r = _scatter_case(paired)

    g_j, gx_j = _jax_scatter_grads(paired)
    calls, real = [], tg.table_grad_sorted
    tg.table_grad_sorted = lambda *a: calls.append(1) or real(*a)
    try:
        xt = torch.from_numpy(x).requires_grad_(True)
        ys = t_scatter(xt, paired_levels=paired)
        (ys * torch.from_numpy(r)).sum().backward()
        yp = t_pallas(torch.from_numpy(x), paired_levels=paired)
        (yp.float() * torch.from_numpy(r)).sum().backward()
    finally:
        tg.table_grad_sorted = real
    assert len(calls) == PALLAS_KW["n_levels"]
    scale = np.abs(g_j).max()
    np.testing.assert_allclose(t_scatter.table.grad.numpy(), g_j, rtol=1e-5, atol=1e-5 * scale)
    # The scatter route is the only one that gives positions a gradient.
    np.testing.assert_allclose(xt.grad.numpy(), gx_j, rtol=1e-4, atol=1e-5 * np.abs(gx_j).max())
    if cdt is None:
        np.testing.assert_array_equal(yp.detach().numpy(), ys.detach().numpy())
        np.testing.assert_allclose(t_pallas.table.grad.numpy(), g_j, rtol=1e-5, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(t_pallas.table.grad.numpy(), g_j, rtol=0, atol=2e-2 * scale)
