"""Occupancy query (kernel K1's plain version) against ``nerfacc_tpu``.

Exact equality throughout: the query is integer-valued, and the port does
the JAX package's float arithmetic step for step.  The kernel itself is held
against the plain version on the card, in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.grid import _query_soa as j_query_soa
from nerfacc_tpu.ops.occ_query import bitpack_grid as j_bitpack
from nerfacc_tpu.ops.occ_query import occupancy_query_pallas
from nerfacc_tpu_torch.ops.occ_query import (
    _query_soa,
    bitpack_grid,
    occupancy_query,
    occupancy_query_plain,
)

AABB = np.array([-1.5, -1.0, -2.0, 1.5, 1.0, 2.0], np.float32)


def unpack_grid(packed, rz):
    """Inverse of ``bitpack_grid``: ``(levels, rx, ry, rz)`` bool."""
    shifts = torch.arange(32, dtype=torch.int32)
    bits = (packed[..., None] >> shifts) & 1  # arithmetic shift; & 1 keeps bit b
    return bits.reshape(packed.shape[:-1] + (-1,))[..., :rz].to(torch.bool)


def adversarial_points(levels, res, rng, n_random=3000):
    """Points on every level's cell faces, at +-0.5 of the normalised box,
    just inside and outside it, in z cells that are a word's last bit, and
    random points over all levels."""
    faces = np.concatenate(
        [(np.arange(res + 1, dtype=np.float32) / res - 0.5) * 2.0**l for l in range(levels)]
    )
    special = np.array([-0.5, 0.5, -0.5000001, 0.4999999, 0.0, 0.75, -3.0], np.float32)
    z31 = ((np.arange(31, res, 32) + 0.5) / res - 0.5).astype(np.float32)
    coords = np.concatenate([faces, special, z31])
    pick = rng.integers(0, coords.shape[0], size=(n_random, 3))
    scale = 2.0 ** (levels + 1)
    nrm = np.concatenate(
        [
            coords[pick],
            np.stack(np.meshgrid(special, special, z31, indexing="ij"), -1).reshape(-1, 3),
            rng.uniform(-scale, scale, size=(n_random, 3)).astype(np.float32),
        ]
    ).astype(np.float32)
    return (AABB[:3] + (nrm + 0.5) * (AABB[3:] - AABB[:3])).astype(np.float32)


@pytest.mark.parametrize("levels,res,mip_pad", [(1, 64, 0), (1, 64, 1), (4, 32, 0), (4, 32, 1)])
def test_plain_query_matches_query_soa_exactly(levels, res, mip_pad):
    rng = np.random.default_rng(levels * 10 + mip_pad)
    grid = rng.random((levels, res, res, res)) < 0.3
    p = adversarial_points(levels, res, rng)
    want, want_sel = j_query_soa(
        *(jnp.asarray(p[:, i]) for i in range(3)), jnp.asarray(grid), jnp.asarray(AABB),
        mip_pad=mip_pad,
    )
    pt = [torch.from_numpy(np.ascontiguousarray(p[:, i])) for i in range(3)]
    gt = torch.from_numpy(grid)
    got, got_sel = _query_soa(*pt, gt, torch.from_numpy(AABB), mip_pad=mip_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(want_sel))
    packed = bitpack_grid(gt)
    plain = occupancy_query_plain(packed, torch.from_numpy(AABB), *pt, rz=res, mip_pad=mip_pad)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want))
    # On a CPU tensor the wrapper is the plain version.
    wrapped = occupancy_query(packed, torch.from_numpy(AABB), *pt, rz=res, mip_pad=mip_pad)
    np.testing.assert_array_equal(wrapped.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("res", [(32, 32, 32), (32, 16, 48)])
def test_plain_query_matches_pallas_interpret(res):
    rng = np.random.default_rng(5)
    grid = rng.random(res) < 0.1
    p = rng.uniform(-2.2, 2.2, size=(1500, 3)).astype(np.float32)
    pj = [jnp.asarray(p[:, i]) for i in range(3)]
    want = occupancy_query_pallas(
        j_bitpack(jnp.asarray(grid)), jnp.asarray(AABB), *pj,
        resolution=res, tm=8, interpret=True,
    )
    pt = [torch.from_numpy(np.ascontiguousarray(p[:, i])) for i in range(3)]
    got = occupancy_query_plain(
        bitpack_grid(torch.from_numpy(grid)[None]), torch.from_numpy(AABB), *pt, rz=res[2]
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_packing_round_trips_and_matches_the_tpu_word_values():
    rng = np.random.default_rng(6)
    for shape in [(2, 8, 4, 32), (1, 5, 3, 70), (3, 4, 4, 31)]:
        grid = torch.from_numpy(rng.random(shape) < 0.5)
        packed = bitpack_grid(grid)
        assert packed.dtype == torch.int32
        assert packed.shape == shape[:3] + (-(-shape[3] // 32),)
        assert torch.equal(unpack_grid(packed, shape[3]), grid)
        # Same 32-bit words as the JAX package's packing (which lays them
        # out as (rx, ry * words) padded to 128 lanes).
        rx, ry, words = packed.shape[1:]
        for lvl in range(shape[0]):
            tpu = np.asarray(j_bitpack(jnp.asarray(grid[lvl].numpy())))[:, : ry * words]
            np.testing.assert_array_equal(
                packed[lvl].reshape(rx, ry * words).numpy().view(np.uint32), tpu
            )
    # Bit 31 of a word (z cell 31) is the int32 sign bit.
    g = torch.zeros((1, 1, 1, 32), dtype=torch.bool)
    g[..., 31] = True
    assert int(bitpack_grid(g)) == -(2**31)
