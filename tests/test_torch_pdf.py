"""The port's ``pdf.py`` and ``data_specs.py`` against the JAX package:
searchsorted (batched and flat), importance sampling (batched, per-ray
counts, flat; the cases of ``tests/test_pdf.py:23-204``), the reference
oracle ``_sample_from_weighted``, and rows whose CDF is degenerate.

Tolerances: the JAX suite's atol 1e-4 against ``_sample_from_weighted`` and
1e-6 between layouts; port against JAX, indices exactly and sample values
within atol 1e-6 (the same float32 formulas; the inputs lie in [0, 4]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu import pdf as jpdf
from nerfacc_tpu.data_specs import RayIntervals as JIntervals
from nerfacc_tpu_torch import pdf as tpdf
from nerfacc_tpu_torch.data_specs import RayIntervals, RaySamples
from nerfacc_tpu_torch.volrend import render_transmittance_from_density


def _vals(n_rays, n_samples, seed=42):
    rng = np.random.default_rng(seed)
    return np.sort(rng.random((n_rays, n_samples + 1), dtype=np.float32), -1)


def _cdfs(shape, seed):
    return np.sort(np.random.default_rng(seed).random(shape, dtype=np.float32), -1)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_data_specs_layouts():
    assert RayIntervals(vals=torch.zeros(3, 4)).is_batched
    assert not RaySamples(vals=torch.zeros(12), packed_info=torch.zeros(3, 2, dtype=torch.int32)).is_batched


def test_searchsorted_matches_jax():
    query, key = _vals(10, 100, seed=42), _vals(10, 100, seed=7)
    ids_l, ids_r = tpdf.searchsorted(RayIntervals(vals=_t(key)), RayIntervals(vals=_t(query)))
    j_l, j_r = jpdf.searchsorted(JIntervals(vals=jnp.asarray(key)), JIntervals(vals=jnp.asarray(query)))
    np.testing.assert_array_equal(ids_l.numpy(), np.asarray(j_l))
    np.testing.assert_array_equal(ids_r.numpy(), np.asarray(j_r))
    # The library's upper bound, clamped to the row (tests/test_pdf.py:23-38).
    want = np.stack([np.searchsorted(k, q, side="right") for k, q in zip(key, query)]).clip(0, 100)
    np.testing.assert_array_equal(ids_r.numpy(), want)


def test_searchsorted_flat_matches_jax():
    # The reference's docstring example (nerfacc/pdf.py:39-56), then random
    # chunks with an empty and a one-edge ray.
    sorted_seq = RayIntervals(vals=torch.tensor([0.0, 1.0, 0.0, 1.0, 2.0]),
                              packed_info=torch.tensor([[0, 2], [2, 3]], dtype=torch.int32))
    values = RayIntervals(vals=torch.tensor([0.5, 1.5, 2.5]),
                          packed_info=torch.tensor([[0, 1], [1, 2]], dtype=torch.int32))
    ids_l, ids_r = tpdf.searchsorted(sorted_seq, values)
    assert ids_l.tolist() == [0, 3, 3] and ids_r.tolist() == [1, 4, 4]

    rng = np.random.default_rng(3)
    k_cnt, q_cnt = np.array([5, 0, 1, 9, 3]), np.array([4, 2, 3, 6, 1])
    k_vals = np.concatenate([np.sort(rng.uniform(0, 4, c)) for c in k_cnt]).astype(np.float32)
    q_vals = rng.uniform(-1, 5, q_cnt.sum()).astype(np.float32)
    pk = np.stack([np.concatenate([[0], np.cumsum(k_cnt)[:-1]]), k_cnt], -1).astype(np.int32)
    pq = np.stack([np.concatenate([[0], np.cumsum(q_cnt)[:-1]]), q_cnt], -1).astype(np.int32)
    got = tpdf.searchsorted(RayIntervals(vals=_t(k_vals), packed_info=_t(pk)),
                            RayIntervals(vals=_t(q_vals), packed_info=_t(pq)))
    want = jpdf.searchsorted(JIntervals(vals=jnp.asarray(k_vals), packed_info=jnp.asarray(pk)),
                             JIntervals(vals=jnp.asarray(q_vals), packed_info=jnp.asarray(pq)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _bias(seed, n_rays):
    """The stratified offsets the JAX package draws from ``key``
    (``pdf.py:217-221``)."""
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), (n_rays, 1), jnp.float32))


@pytest.mark.parametrize("stratified", [False, True], ids=["midpoints", "stratified"])
def test_importance_sampling_matches_jax_and_the_oracle(stratified):
    vals = _vals(5, 100)
    cdfs = _cdfs(vals.shape, 1)
    bias = _bias(4, 5) if stratified else None
    iv, s = tpdf.importance_sampling(RayIntervals(vals=_t(vals)), _t(cdfs), 100, stratified,
                                     jitter=None if bias is None else _t(bias))
    j_iv, j_s = jpdf.importance_sampling(JIntervals(vals=jnp.asarray(vals)), jnp.asarray(cdfs), 100, stratified,
                                         key=jax.random.PRNGKey(4) if stratified else None)
    np.testing.assert_allclose(iv.vals.numpy(), np.asarray(j_iv.vals), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.vals.numpy(), np.asarray(j_s.vals), rtol=0, atol=1e-6)
    if not stratified:  # tests/test_pdf.py:41-60
        o_vals, o_mids = tpdf._sample_from_weighted(
            _t(vals), _t(cdfs[:, 1:] - cdfs[:, :-1]), 100, False,
            _t(vals.min(-1, keepdims=True)), _t(vals.max(-1, keepdims=True)),
        )
        np.testing.assert_allclose(iv.vals.numpy(), o_vals.numpy(), atol=1e-4)
        np.testing.assert_allclose(s.vals.numpy(), o_mids.numpy(), atol=1e-4)


@pytest.mark.parametrize("stratified", [False, True], ids=["midpoints", "stratified"])
def test_sample_from_weighted_matches_jax(stratified):
    vals = _vals(6, 40, seed=9)
    w = np.random.default_rng(2).random((6, 40), dtype=np.float32)
    key = jax.random.PRNGKey(8)
    jitter = np.array(jax.random.uniform(key, (6, 1), jnp.float32))
    got = tpdf._sample_from_weighted(_t(vals), _t(w), 24, stratified, 0.0, 1.0, jitter=_t(jitter))
    want = jpdf._sample_from_weighted(jnp.asarray(vals), jnp.asarray(w), 24, stratified, 0.0, 1.0,
                                      key=key if stratified else None)
    # The reference oracle builds u with torch.linspace, JAX's with
    # jnp.linspace, which round some points an ulp apart (6e-8); a bin's
    # slope (b1 - b0) / (cdf1 - cdf0) scales that: 1.01e-6 measured, so
    # atol 2e-6.
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=0, atol=2e-6)


def test_importance_sampling_per_ray_counts_matches_jax():
    vals = _vals(4, 32)
    cdfs = _cdfs(vals.shape, 5)
    counts = np.array([8, 16, 1, 12], np.int32)
    iv, s = tpdf.importance_sampling(RayIntervals(vals=_t(vals)), _t(cdfs), _t(counts), False,
                                     max_intervals_per_ray=16)
    j_iv, j_s = jpdf.importance_sampling(JIntervals(vals=jnp.asarray(vals)), jnp.asarray(cdfs),
                                         jnp.asarray(counts), False, max_intervals_per_ray=16)
    assert s.vals.shape == (4, 16) and s.is_valid.sum(-1).tolist() == [8, 16, 1, 12]
    for got, want in ((iv.vals, j_iv.vals), (s.vals, j_s.vals)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    for got, want in ((s.is_valid, j_s.is_valid), (iv.is_left, j_iv.is_left), (iv.is_right, j_iv.is_right)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Each ray against the one-count form at its count, every edge included
    # (the last-edge rule, pdf.cu:230-238); a count of 1 has no reference
    # edge (tests/test_pdf.py:124-152).
    for r, c in enumerate(counts.tolist()):
        i1, s1 = tpdf.importance_sampling(RayIntervals(vals=_t(vals[r : r + 1])), _t(cdfs[r : r + 1]), c)
        np.testing.assert_allclose(s.vals[r, :c].numpy(), s1.vals[0].numpy(), atol=1e-6)
        if c >= 2:
            np.testing.assert_allclose(iv.vals[r, : c + 1].numpy(), i1.vals[0].numpy(), atol=1e-6)


def test_importance_sampling_flat_matches_jax_and_batched():
    # tests/test_pdf.py:155-204: the flat layout against the batched one on
    # edges padded by repeating each ray's last, and against JAX's flat.
    rng = np.random.default_rng(11)
    n_rays, n = 5, 8
    counts = np.array([6, 2, 9, 4, 7], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    E = int(counts.max())
    vs, cs, bv, bc = [], [], [], []
    for c in counts:
        v = np.sort(rng.uniform(0, 4, c)).astype(np.float32)
        cd = np.sort(rng.uniform(0, 1, c)).astype(np.float32)
        cd[0], cd[-1] = 0.0, 1.0
        vs.append(v)
        cs.append(cd)
        bv.append(np.concatenate([v, np.full(E - c, v[-1], np.float32)]))
        bc.append(np.concatenate([cd, np.full(E - c, cd[-1], np.float32)]))
    packed = np.stack([starts, counts], -1)
    flat_v, flat_c = np.concatenate(vs), np.concatenate(cs)
    iv_f, s_f = tpdf.importance_sampling(RayIntervals(vals=_t(flat_v), packed_info=_t(packed)), _t(flat_c), n,
                                         max_edges_per_ray=E)
    iv_b, s_b = tpdf.importance_sampling(RayIntervals(vals=_t(np.stack(bv))), _t(np.stack(bc)), n)
    j_iv, j_s = jpdf.importance_sampling(JIntervals(vals=jnp.asarray(flat_v), packed_info=jnp.asarray(packed)),
                                         jnp.asarray(flat_c), n, max_edges_per_ray=E)
    assert iv_f.vals.shape == (n_rays * (n + 1),) and s_f.vals.shape == (n_rays * n,)
    np.testing.assert_allclose(s_f.vals.reshape(n_rays, n).numpy(), s_b.vals.numpy(), rtol=1e-6)
    np.testing.assert_allclose(iv_f.vals.reshape(n_rays, n + 1).numpy(), iv_b.vals.numpy(), rtol=1e-6)
    np.testing.assert_allclose(s_f.vals.numpy(), np.asarray(j_s.vals), rtol=0, atol=1e-6)
    np.testing.assert_allclose(iv_f.vals.numpy(), np.asarray(j_iv.vals), rtol=0, atol=1e-6)
    for f in ("packed_info", "ray_indices", "is_left", "is_right"):
        np.testing.assert_array_equal(getattr(iv_f, f).numpy(), np.asarray(getattr(j_iv, f)), err_msg=f)
    for f in ("packed_info", "ray_indices", "is_valid"):
        np.testing.assert_array_equal(getattr(s_f, f).numpy(), np.asarray(getattr(j_s, f)), err_msg=f)


def _degenerate_rows():
    """Interval edges in s and their CDFs as a proposal level computes them
    (``1 - [trans, 0]``), for three kinds of row: empty (density 0, a flat
    CDF up to its last edge), opaque at the first interval, and a CDF whose
    whole span is under 1e-10."""
    n_edges = 17
    s = np.linspace(0.0, 1.0, n_edges, dtype=np.float32)[None].repeat(3, 0)
    sigmas = np.zeros((3, n_edges - 1), np.float32)
    sigmas[1, 0] = 1e4
    sigmas[2] = 1e-10
    ts, te = _t(s[:, :-1]), _t(s[:, 1:])
    trans, _ = render_transmittance_from_density(ts, te, _t(sigmas))
    cdfs = (1.0 - torch.cat([trans, torch.zeros_like(trans[:, :1])], -1)).numpy()
    # The third row: a span of 1e-11 from 0 (trans rounds to 1 in float32).
    cdfs[2] = np.linspace(0.0, 1e-11, n_edges, dtype=np.float32)
    return s, cdfs


@pytest.mark.parametrize("stratified", [False, True], ids=["midpoints", "stratified"])
def test_degenerate_rows_match_jax(stratified):
    s, cdfs = _degenerate_rows()
    assert (cdfs[0, :-1] == 0).all() and cdfs[0, -1] == 1
    assert (cdfs[1, 1:] == 1).all()
    n = 8
    bias = _bias(6, 3) if stratified else None
    iv, smp = tpdf.importance_sampling(RayIntervals(vals=_t(s)), _t(cdfs), n, stratified,
                                       jitter=None if bias is None else _t(bias))
    j_iv, j_smp = jpdf.importance_sampling(JIntervals(vals=jnp.asarray(s)), jnp.asarray(cdfs), n, stratified,
                                           key=jax.random.PRNGKey(6) if stratified else None)
    np.testing.assert_allclose(smp.vals.numpy(), np.asarray(j_smp.vals), rtol=0, atol=1e-6)
    np.testing.assert_allclose(iv.vals.numpy(), np.asarray(j_iv.vals), rtol=0, atol=1e-6)
    t = smp.vals.numpy()
    # Empty: every u lands in the last bin (side="right" with the clamps).
    assert ((t[0] >= s[0, -2]) & (t[0] <= s[0, -1])).all()
    # Opaque at the first interval: every sample in the first bin.
    assert ((t[1] >= 0.0) & (t[1] <= s[1, 1])).all()
    # Spans under 1e-10: each sample is the midpoint of its bin.
    assert np.isin(t[2], (s[2, :-1] + s[2, 1:]) * np.float32(0.5)).all()
