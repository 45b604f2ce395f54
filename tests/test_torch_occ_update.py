"""The occupancy EMA update: the port's ``_update`` against
``nerfacc_tpu.estimators.occ_grid``, fed the same draws.

The JAX draws are rebuilt with ``jax.random`` in the split order of
``occ_grid.py:423,492,559`` and handed to the port.  The probed values come
from one numpy function on both sides, so ``occs`` agree exactly where both
take a scatter max; where both take the per-cell max kernel (K3 in the port,
``cell_max_sorted`` in JAX, at >= 2^19 draws) JAX's kernel rounds by up to
~6e-8 (``max + 1 - 1``), so there ``occs`` agree to 1e-6.  ``binaries``
agree exactly away from the threshold: cells within 1e-6 of it may fall on
either side, since the mean that sets it is summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.estimators.occ_grid import OccGridEstimator as JEstimator
from nerfacc_tpu_torch.estimators import occ_grid as t_occ_grid
from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator as TEstimator

ROI = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]


def _density(x: np.ndarray) -> np.ndarray:
    """A shell of density in float64 numpy, the same on both sides."""
    r = np.linalg.norm(np.asarray(x, np.float64), axis=-1)
    return (0.03 * np.exp(-(((r - 0.5) / 0.12) ** 2)))[:, None].astype(np.float32)


def _j_eval(x):
    return jnp.asarray(_density(np.asarray(x)))


def _t_eval(x):
    return torch.from_numpy(_density(x.numpy()))


def _setup(res, levels, seed=0):
    je, te = JEstimator(ROI, res, levels), TEstimator(ROI, res, levels)
    rng = np.random.default_rng(seed)
    cells = levels * res**3
    occs = (rng.random(cells, dtype=np.float32) * 0.02).astype(np.float32)
    occs[rng.random(cells) < 0.05] = -1.0  # camera-invisible cells stay at -1
    binaries = (occs > 0.012).reshape((levels,) + (res,) * 3)
    js = je.set_binaries(je.init(), jnp.asarray(binaries)).replace(occs=jnp.asarray(occs))
    ts = te.set_binaries(te.init("cpu"), torch.from_numpy(binaries)).replace(occs=torch.from_numpy(occs))
    return je, te, js, ts


def _jax_draws(est, key, step, mode, binaries, warmup_steps=256):
    """The draws of JAX's _update for ``key``, as the port takes them."""
    cells, n_cells = est.cells_per_lvl, est.cells_per_lvl // 4
    draws = [{} for _ in range(est.levels)]
    if step >= warmup_steps:
        for lvl in range(est.levels):
            key, k_uni, k_occ = jax.random.split(key, 3)
            d = draws[lvl]
            d["uniform"] = torch.from_numpy(np.array(
                jax.random.randint(k_uni, (n_cells,), 0, cells, jnp.int32)
            )).long()
            if mode == "uniform":
                total = max(int(np.asarray(binaries[lvl]).sum()), 1)
                d["ranks"] = torch.from_numpy(np.array(
                    jax.random.randint(k_occ, (n_cells,), 0, total, jnp.int32)
                ))
            else:
                d["offset"] = torch.tensor(float(jax.random.uniform(k_occ, ())))
    n = cells if step < warmup_steps else 2 * n_cells
    for lvl in range(est.levels):
        key, k_jit = jax.random.split(key)
        draws[lvl]["jitter"] = torch.from_numpy(np.array(jax.random.uniform(k_jit, (n, 3), jnp.float32)))
    return draws


def _compare(got, want, atol_occ):
    occ_g, occ_w = got.occs.numpy(), np.asarray(want.occs)
    if atol_occ == 0:
        np.testing.assert_array_equal(occ_g, occ_w)
    else:
        np.testing.assert_allclose(occ_g, occ_w, rtol=0, atol=atol_occ)
    vis = occ_w >= 0
    thre = min(float(occ_w[vis].mean()), 1e-2)
    b_g, b_w = got.binaries.numpy().reshape(-1), np.asarray(want.binaries).reshape(-1)
    far = np.abs(occ_w - thre) > 1e-6
    np.testing.assert_array_equal(b_g[far], b_w[far])
    assert 0 < b_w.sum() < b_w.size
    if np.array_equal(b_g, b_w):
        np.testing.assert_array_equal(got.skip_grid.numpy(), np.asarray(want.skip_grid))
    return b_g


# (res, levels, step, draw mode, EMA path of both packages)
CASES = {
    "warmup-2-levels": (32, 2, 0, "sysrow", "scatter"),
    "sysrow": (64, 1, 10**9, "sysrow", "scatter"),
    "sys": (64, 1, 10**9, "sys", "scatter"),
    "uniform": (64, 1, 10**9, "uniform", "scatter"),
    "sysrow-cell-max-2^20-draws": (128, 1, 10**9, "sysrow", "cell_max"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_jax(case, monkeypatch):
    res, levels, step, mode, path = CASES[case]
    je, te, js, ts = _setup(res, levels)
    monkeypatch.setenv("NERFACC_OCC_DRAW", mode)
    key = jax.random.PRNGKey(11)
    want = je._update(js, step=step, occ_eval_fn=_j_eval, key=key)
    calls = []
    real = t_occ_grid.cell_max
    monkeypatch.setattr(t_occ_grid, "cell_max", lambda *a: calls.append(1) or real(*a))
    draws = _jax_draws(je, key, step, mode, js.binaries)
    got = te._update(ts, step=step, occ_eval_fn=_t_eval, draws=draws, draw_mode=mode)
    # K3 (here its plain version) at >= 2^19 draws per level, the scatter below.
    assert len(calls) == (levels if path == "cell_max" else 0)
    _compare(got, want, 1e-6 if path == "cell_max" else 0.0)
    # Invisible cells are never revived.
    assert (got.occs.numpy()[np.asarray(js.occs) < 0] == -1.0).all()
    np.testing.assert_array_equal(got.binaries_packed.numpy(), te._grids(got.binaries)["binaries_packed"].numpy())


def test_sysrow_falls_back_to_sys_where_rows_do_not_tile(monkeypatch):
    """At resolution 50 (125,000 cells, not a multiple of 512) the sysrow
    draw cannot take whole rows of 128; the JAX package fails there
    (occ_grid.py:487-503), the port draws as ``sys`` does."""
    te = TEstimator(ROI, 50, 1)
    rng = np.random.default_rng(4)
    binaries = torch.from_numpy(rng.random((1, 50, 50, 50)) < 0.1)
    ts = te.set_binaries(te.init("cpu"), binaries).replace(
        occs=torch.from_numpy(rng.random(125000, dtype=np.float32) * 0.02)
    )
    gen = torch.Generator().manual_seed(0)
    draws = te.make_draws(10**9, gen, device="cpu")
    a = te._update(ts, 10**9, _t_eval, draws=draws, draw_mode="sysrow")
    b = te._update(ts, 10**9, _t_eval, draws=draws, draw_mode="sys")
    assert torch.equal(a.occs, b.occs) and torch.equal(a.binaries, b.binaries)
    # And the sys draw itself is JAX's, on the same draws.
    je = JEstimator(ROI, 50, 1)
    js = je.set_binaries(je.init(), jnp.asarray(binaries.numpy())).replace(occs=jnp.asarray(ts.occs.numpy()))
    key = jax.random.PRNGKey(8)
    monkeypatch.setenv("NERFACC_OCC_DRAW", "sys")
    want = je._update(js, step=10**9, occ_eval_fn=_j_eval, key=key)
    got = te._update(ts, 10**9, _t_eval, draws=_jax_draws(je, key, 10**9, "sys", js.binaries), draw_mode="sysrow")
    _compare(got, want, 0.0)


def test_update_every_n_steps_and_generator_draws():
    te = TEstimator(ROI, 16, 1)
    ts = te.init("cpu")
    assert te.update_every_n_steps(ts, 3, _t_eval, n=16) is ts
    gen = torch.Generator().manual_seed(1)
    warm = te.update_every_n_steps(ts, 0, _t_eval, generator=gen)
    assert (warm.occs > 0).any() and warm.binaries.any()
    again = te._update(warm, 10**9, _t_eval, generator=torch.Generator().manual_seed(1))
    same = te._update(warm, 10**9, _t_eval, generator=torch.Generator().manual_seed(1))
    assert torch.equal(again.occs, same.occs)
