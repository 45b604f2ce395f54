"""Segmented scans and volume rendering: port against ``nerfacc_tpu``.

Tolerance rtol 1e-5, atol 1e-6 (float32): the JAX package scans with a
blocked associative scan and the port with float64 prefix sums or a
Hillis-Steele product scan, so the two round at different places.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerfacc_tpu import pack as jpack
from nerfacc_tpu import scan as jscan
from nerfacc_tpu import volrend as jvol
from nerfacc_tpu_torch import pack as tpack
from nerfacc_tpu_torch import scan as tscan
from nerfacc_tpu_torch import volrend as tvol

RTOL, ATOL = 1e-5, 1e-6


def _segments(lengths):
    """Sorted ray indices with ``lengths[r]`` samples for ray ``r``."""
    return np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=atol)


def test_segmented_scans_match_jax():
    rng = np.random.default_rng(0)
    lengths = rng.integers(0, 40, size=64)  # includes empty rays
    ri = _segments(lengths)
    x = rng.random(ri.shape[0]).astype(np.float32)
    x[rng.random(x.shape[0]) < 0.05] = 0.0  # zeros inside products
    rj, rt = jnp.asarray(ri), torch.from_numpy(ri)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for name in ("inclusive_sum", "exclusive_sum", "inclusive_prod", "exclusive_prod"):
        want = jax.jit(getattr(jscan, name))(xj, ray_indices=rj)
        _close(want, getattr(tscan, name)(xt, ray_indices=rt))
    # packed_info describes the same segments as ray_indices.
    pj = jpack.pack_info(rj, n_rays=64)
    pt = tpack.pack_info(rt, n_rays=64)
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    _close(jscan.exclusive_sum(xj, packed_info=pj), tscan.exclusive_sum(xt, packed_info=pt))
    # Batched (n_rays, S) layout.
    xb = rng.random((8, 16)).astype(np.float32)
    for name in ("inclusive_sum", "exclusive_sum", "inclusive_prod", "exclusive_prod"):
        _close(getattr(jscan, name)(jnp.asarray(xb)), getattr(tscan, name)(torch.from_numpy(xb)))


def test_long_segment_does_not_leak_cancellation_into_later_ones():
    """A 200k-sample segment makes the flat running total ~1e5; a float32
    cumsum-minus-start would then be off by ~1e-2 in every later segment."""
    rng = np.random.default_rng(1)
    lengths = np.concatenate([[200_000], rng.integers(1, 40, size=50)])
    ri = _segments(lengths)
    x = rng.random(ri.shape[0]).astype(np.float32)
    want = jax.jit(jscan.exclusive_sum)(jnp.asarray(x), ray_indices=jnp.asarray(ri))
    got = tscan.exclusive_sum(torch.from_numpy(x), ray_indices=torch.from_numpy(ri))
    tail = slice(200_000, None)  # the small segments after the long one
    np.testing.assert_allclose(got.numpy()[tail], np.asarray(want)[tail], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    inc = tscan.inclusive_sum(torch.from_numpy(x), ray_indices=torch.from_numpy(ri))
    np.testing.assert_allclose(inc.numpy()[-5:], (np.asarray(want) + x)[-5:], rtol=RTOL, atol=ATOL)


def test_render_weight_from_density_with_prefix_trans_matches_jax():
    rng = np.random.default_rng(2)
    lengths = rng.integers(0, 32, size=48)
    ri = _segments(lengths)
    n = ri.shape[0]
    t0 = np.sort(rng.random(n)).astype(np.float32)
    t1 = (t0 + rng.random(n).astype(np.float32) * 0.05).astype(np.float32)
    sig = (rng.random(n) * 20.0).astype(np.float32)
    prefix = rng.random(n).astype(np.float32)
    j = jax.jit(functools.partial(jvol.render_weight_from_density, n_rays=48))(
        jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(sig),
        ray_indices=jnp.asarray(ri), prefix_trans=jnp.asarray(prefix),
    )
    t = tvol.render_weight_from_density(
        torch.from_numpy(t0), torch.from_numpy(t1), torch.from_numpy(sig),
        ray_indices=torch.from_numpy(ri), n_rays=48, prefix_trans=torch.from_numpy(prefix),
    )
    for a, b in zip(j, t):
        _close(a, b)


def test_rendering_and_accumulation_match_jax():
    rng = np.random.default_rng(3)
    lengths = rng.integers(0, 24, size=32)
    ri = _segments(lengths)
    n = ri.shape[0]
    t0 = np.sort(rng.random(n)).astype(np.float32)
    t1 = (t0 + 0.02).astype(np.float32)
    valid = rng.random(n) < 0.9
    rgb = rng.random((n, 3)).astype(np.float32)
    sig = (rng.random(n) * 30.0).astype(np.float32)
    bkgd = np.array([1.0, 0.5, 0.0], np.float32)

    def jfn(ts, te, r):
        return jnp.asarray(rgb), jnp.asarray(sig)

    def tfn(ts, te, r):
        return torch.from_numpy(rgb), torch.from_numpy(sig)

    j = jvol.rendering(
        jnp.asarray(t0), jnp.asarray(t1), ray_indices=jnp.asarray(ri), n_rays=32,
        rgb_sigma_fn=jfn, render_bkgd=jnp.asarray(bkgd), is_valid=jnp.asarray(valid),
    )
    t = tvol.rendering(
        torch.from_numpy(t0), torch.from_numpy(t1), ray_indices=torch.from_numpy(ri),
        n_rays=32, rgb_sigma_fn=tfn, render_bkgd=torch.from_numpy(bkgd),
        is_valid=torch.from_numpy(valid),
    )
    for a, b in zip(j[:3], t[:3]):
        _close(a, b)
    for key in ("weights", "trans", "alphas"):
        _close(j[3][key], t[3][key])

    # The alpha path goes through the segmented product.
    alphas = rng.random(n).astype(np.float32)
    ja = jvol.rendering(
        jnp.asarray(t0), jnp.asarray(t1), ray_indices=jnp.asarray(ri), n_rays=32,
        rgb_alpha_fn=lambda *a: (jnp.asarray(rgb), jnp.asarray(alphas)),
    )
    ta = tvol.rendering(
        torch.from_numpy(t0), torch.from_numpy(t1), ray_indices=torch.from_numpy(ri),
        n_rays=32, rgb_alpha_fn=lambda *a: (torch.from_numpy(rgb), torch.from_numpy(alphas)),
    )
    for a, b in zip(ja[:3], ta[:3]):
        _close(a, b)


def test_compact_indices_from_counts_matches_jax():
    rng = np.random.default_rng(4)
    num_valid = rng.integers(0, 9, size=40).astype(np.int32)
    num_valid[-3:] = 0  # padding must still decode to the last row
    for capacity in (int(num_valid.sum()), int(num_valid.sum()) + 37):
        j = jpack.compact_indices_from_counts(jnp.asarray(num_valid), 8, capacity)
        t = tpack.compact_indices_from_counts(torch.from_numpy(num_valid), 8, capacity)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
