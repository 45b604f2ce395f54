"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Needs an NVIDIA GPU and the CUDA toolkit, and not JAX (``tests/conftest.py``
imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
from nerfacc_tpu_torch.grid import traverse_grids
from nerfacc_tpu_torch.ops.occ_query import (
    bitpack_grid,
    occupancy_query,
    occupancy_query_plain,
)

AABB = np.array([-1.5, -1.0, -2.0, 1.5, 1.0, 2.0], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _points(levels, res, rng, n=20000):
    """Every level's cell faces, the box's +-0.5 faces and just inside them,
    z cells that are a word's last bit, and random points over all levels."""
    faces = np.concatenate(
        [(np.arange(res + 1, dtype=np.float32) / res - 0.5) * 2.0**l for l in range(levels)]
    )
    special = np.array([-0.5, 0.5, -0.5000001, 0.4999999, 0.0], np.float32)
    z31 = ((np.arange(31, res, 32) + 0.5) / res - 0.5).astype(np.float32)
    coords = np.concatenate([faces, special, z31])
    scale = 2.0 ** (levels + 1)
    nrm = np.concatenate(
        [
            coords[rng.integers(0, coords.shape[0], size=(n, 3))],
            rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32),
        ]
    )
    return (AABB[:3] + (nrm + 0.5) * (AABB[3:] - AABB[:3])).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("levels,res", [(1, 64), (1, 128), (4, 32)])
def test_kernel_matches_plain_version_on_the_card(cuda, levels, res):
    rng = np.random.default_rng(levels * 1000 + res)
    grid = torch.from_numpy(rng.random((levels, res, res, res)) < 0.3).to(cuda)
    packed = bitpack_grid(grid)
    p = torch.from_numpy(_points(levels, res, rng)).to(cuda)
    pt = [p[:, i].contiguous() for i in range(3)]
    aabb = torch.from_numpy(AABB).to(cuda)
    for mip_pad in (0, 1):
        before = occupancy_query.launches
        out = occupancy_query(packed, aabb, *pt, rz=res, mip_pad=mip_pad)
        assert occupancy_query.launches == before + 1
        plain = occupancy_query_plain(packed, aabb, *pt, rz=res, mip_pad=mip_pad)
        torch.cuda.synchronize()
        # Exact: the kernel does the plain version's float arithmetic.
        assert torch.equal(out, plain)
        assert 0 < int(out.sum()) < out.numel()


@pytest.mark.cuda
def test_traversal_queries_through_the_kernel(cuda):
    est = OccGridEstimator(roi_aabb=[-1.0] * 3 + [1.0] * 3, resolution=32, levels=2)
    rng = np.random.default_rng(3)
    binaries = torch.from_numpy(rng.random((2, 32, 32, 32)) < 0.2)
    gpu = est.set_binaries(est.init(cuda), binaries)
    cpu = est.set_binaries(est.init("cpu"), binaries)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = -2.5 * d
    kw = dict(step_size=1e-2, traverse_steps_limit=32, max_lattice_steps=256)
    before = occupancy_query.launches
    got = traverse_grids(
        torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda), gpu.binaries,
        gpu.aabbs, packed_grids=gpu.binaries_packed, **kw,
    )
    assert occupancy_query.launches == before + 1
    want = traverse_grids(
        torch.from_numpy(o), torch.from_numpy(d), cpu.binaries, cpu.aabbs,
        packed_grids=cpu.binaries_packed, **kw,
    )
    # Exact: the query is bit-exact and the rest is the same float32 math.
    assert torch.equal(got.num_valid.cpu(), want.num_valid)
    assert 0 < int(want.num_valid.sum())


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    grid = torch.ones((1, 32, 32, 32), dtype=torch.bool, device=cuda)
    packed = bitpack_grid(grid)
    aabb = torch.from_numpy(AABB).to(cuda)
    p = torch.zeros((3, 64), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        occupancy_query(packed, aabb, p[0].double(), p[1], p[2], rz=32)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.zeros(128, device=cuda)[::2]
        occupancy_query(packed, aabb, strided, p[1], p[2], rz=32)
    with pytest.raises(ValueError, match="words per row"):
        occupancy_query(packed, aabb, p[0], p[1], p[2], rz=64)
    with pytest.raises(ValueError, match="one device"):
        occupancy_query(packed.cpu(), aabb, p[0], p[1], p[2], rz=32)
