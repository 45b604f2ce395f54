"""Table gradient (K2, K4-w3), per-cell max (K3) and the fused encoder's
backward: the port's plain versions against ``nerfacc_tpu.ops.table_grad``
(Pallas kernels in interpret mode) and ``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.models.hash_soa import HashGridEncoderFused as JEncoder
from nerfacc_tpu.models.ngp import trunc_exp as j_trunc_exp
from nerfacc_tpu.ops.table_grad import (
    cell_max_sorted,
    table_grad_factors_sorted,
    table_grad_factors_sorted_u10,
)
from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderFused as TEncoder
from nerfacc_tpu_torch.models.ngp import trunc_exp as t_trunc_exp
from nerfacc_tpu_torch.ops.table_grad import (
    cell_max,
    cell_max_plain,
    quantize_u10,
    table_grad_u10,
    table_grad_w3,
)

F = 16


def _factors(rng, n, n_rows):
    """Rows with a dense pile-up on the first 16 rows, weights in [0, 1]
    (the ends included), and cotangents of mixed sign and scale."""
    idx = np.concatenate(
        [rng.integers(0, 16, n // 2), rng.integers(0, n_rows, n - n // 2)]
    ).astype(np.int32)
    rng.shuffle(idx)
    w = rng.random((3, n), dtype=np.float32)
    w[:, :8] = [[0.0], [1.0], [0.5]]
    dout = (rng.standard_normal((n, F)) * rng.choice([1e-3, 1.0], (n, 1))).astype(np.float32)
    perm = np.argsort(idx, kind="stable")
    return idx, perm, w, dout


def test_k2_plain_matches_jax_u10_kernel():
    rng = np.random.default_rng(0)
    n, n_rows = 5000, 512
    idx, perm, w, dout = _factors(rng, n, n_rows)
    wq = quantize_u10(*torch.from_numpy(w))
    dout_bf = torch.from_numpy(dout).to(torch.bfloat16)
    want = table_grad_factors_sorted_u10(
        jnp.asarray(idx[perm]),
        jnp.asarray(wq.numpy()[perm]),
        jnp.asarray(dout_bf.float().numpy()[perm].T).astype(jnp.bfloat16),
        n_rows=n_rows, F=F, W=256, interpret=True,
    )
    got = table_grad_u10(
        torch.from_numpy(idx[perm]), torch.from_numpy(perm), wq, dout_bf, n_rows
    )
    want = np.asarray(want)
    # Both sum the same bf16-rounded terms in float32, in another order:
    # atol 1e-6 of the largest row sum (a 2500-term pile-up) covers it.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert np.count_nonzero(want[16:]) > 0 and np.abs(want[:16]).max() > 1.0


def test_k2_weight_quantisation_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.random((3, 4096), dtype=np.float32)
    w[:, :6] = [[0.0, 1.0, 0.5 / 1023, 1.5 / 1023, 1.0 + 1e-7, -1e-7]] * 3
    wj = [jnp.asarray(a) for a in w]

    def q10(a):  # the JAX package's packing, table_grad.py:1153-1158
        return jnp.clip(jnp.round(a * 1023.0), 0.0, 1023.0).astype(jnp.int32)

    want = (q10(wj[0]) << 20) | (q10(wj[1]) << 10) | q10(wj[2])
    np.testing.assert_array_equal(quantize_u10(*torch.from_numpy(w)).numpy(), np.asarray(want))


def test_k4_w3_plain_matches_jax_w3_kernel():
    rng = np.random.default_rng(2)
    n, n_rows = 5000, 512
    idx, perm, w, dout = _factors(rng, n, n_rows)
    packed = np.concatenate([w, dout.T, np.zeros((32 - 3 - F, n), np.float32)])  # (32, N)
    want = np.asarray(table_grad_factors_sorted(
        jnp.asarray(idx[perm]), jnp.asarray(packed[:, perm]),
        n_rows=n_rows, F=F, W=256, interpret=True, wpack="w3",
    ))
    wt = [torch.from_numpy(a) for a in w]
    got = table_grad_w3(
        torch.from_numpy(idx[perm]), torch.from_numpy(perm), *wt, torch.from_numpy(dout), n_rows
    )
    # float32 sums of the same float32 products in another order.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_k3_plain_matches_jax_cell_max_and_the_library_call():
    rng = np.random.default_rng(3)
    n_cells = 1 << 15
    ids = rng.integers(0, n_cells, 50000).astype(np.int32)
    vals = rng.random(50000, dtype=np.float32) * 4e-3
    vals[:5] = [0.0, -0.0, 1e-30, 4e-3, 1e-3]
    got = cell_max(torch.from_numpy(ids), torch.from_numpy(vals), n_cells)
    library = torch.full((n_cells,), -1.0).scatter_reduce_(
        0, torch.from_numpy(ids).long(), torch.from_numpy(vals), reduce="amax"
    )
    # Exact against the float max, untouched cells at -1.
    assert torch.equal(got, library) and float(got.min()) == -1.0
    assert torch.equal(cell_max_plain(torch.from_numpy(ids), torch.from_numpy(vals), n_cells), got)
    want = np.asarray(cell_max_sorted(
        jnp.asarray(ids), jnp.asarray(vals), n_cells=n_cells, WC=4096, interpret=True
    ))
    # The JAX kernel places max + 1 and subtracts 1, rounding values near
    # 1e-3 by up to ~6e-8; atol 1e-6 is tests/test_ops.py:257-279's bound.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _encoders(L, log2_t, cdt):
    jenc = JEncoder(
        n_levels=L, n_features_per_level=F, log2_hashmap_size=log2_t,
        compute_dtype=None if cdt is None else jnp.bfloat16, table_grad="factor",
    )
    tenc = TEncoder(
        n_levels=L, n_features_per_level=F, log2_hashmap_size=log2_t,
        compute_dtype=cdt, device="cpu",
    )
    return jenc, tenc


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["f32-w3", "bf16-u10"])
def test_encoder_table_gradient_matches_jax_grad(cdt):
    L, log2_t, n = 3, 10, 3000
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.05, 1.05, size=(n, 3)).astype(np.float32)
    r = rng.standard_normal((n, L * F)).astype(np.float32)
    jenc, tenc = _encoders(L, log2_t, cdt)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def jloss(p, xx):
        return jnp.sum(jenc.apply(p, xx).astype(jnp.float32) * r)

    jout = np.asarray(jenc.apply(params, jnp.asarray(x)).astype(jnp.float32))
    jg_table, jg_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    jg_table = np.asarray(jg_table["params"]["table"])

    tenc.load_state_dict({"table": torch.from_numpy(np.array(params["params"]["table"]))})
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tenc(xt)
    (out.float() * torch.from_numpy(r)).sum().backward()
    scale = np.abs(jg_table).max()
    if cdt is None:
        # rtol 1e-6 / atol 1e-10 as test_torch_ngp.py's forward; the table
        # gradient differs from JAX's only in the order of float32 sums.
        np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-6, atol=1e-10)
        np.testing.assert_allclose(tenc.table.grad.numpy(), jg_table, rtol=0, atol=1e-6 * scale)
    else:
        # bf16 combine: XLA and PyTorch round the bf16 products at other
        # places (tests/test_models.py:549's 2e-2 of the largest value).
        np.testing.assert_allclose(
            out.detach().float().numpy(), jout, rtol=0, atol=2e-2 * np.abs(jout).max()
        )
        # The backward's terms are the same bf16 roundings of the same
        # inputs (the cotangent r rounds to bf16 on both sides).
        np.testing.assert_allclose(tenc.table.grad.numpy(), jg_table, rtol=0, atol=1e-5 * scale)
    # Zero gradient to the positions, as the JAX factor path gives.
    assert not np.asarray(jg_x).any()
    assert xt.grad is not None and not xt.grad.any()


def test_trunc_exp_gradient_clamps_at_15():
    x = np.array([-3.0, 0.0, 2.5, 14.9, 15.0, 15.1, 40.0], np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(j_trunc_exp(a)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = t_trunc_exp(xt)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.exp(x), rtol=1e-6)
    # rtol 1e-6: float32 exp on both sides.
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6)
    assert float(xt.grad[-1]) == float(xt.grad[-3]) == pytest.approx(np.exp(15.0), rel=1e-6)
