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


def _sorted_factors(rng, n, n_rows, device):
    """Rows with a dense pile-up (a quarter of the samples on 64 rows, like
    the coarse level at the training shape), weights in [0, 1] and mixed-scale
    cotangents, sorted by row."""
    idx = np.concatenate([rng.integers(0, 64, n // 4), rng.integers(0, n_rows, n - n // 4)])
    idx = torch.from_numpy(idx.astype(np.int32)).to(device)
    sorted_idx, perm = torch.sort(idx)
    w = torch.from_numpy(rng.random((3, n), dtype=np.float32)).to(device)
    scale = torch.from_numpy(rng.choice([1e-3, 1.0], (n, 1)).astype(np.float32)).to(device)
    dout = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32)).to(device) * scale
    return sorted_idx, perm, w, dout


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_rows", [(1, 64), (1000, 4096), (300_000, 16384)])
def test_table_grad_kernels_match_plain_versions_on_the_card(cuda, n, n_rows):
    from nerfacc_tpu_torch.ops.table_grad import (
        quantize_u10,
        table_grad_u10,
        table_grad_u10_plain,
        table_grad_w3,
        table_grad_w3_plain,
    )

    rng = np.random.default_rng(n)
    sorted_idx, perm, w, dout = _sorted_factors(rng, n, n_rows, cuda)
    wq = quantize_u10(*w)
    dout_bf = dout.to(torch.bfloat16)
    before = table_grad_u10.launches, table_grad_w3.launches
    k2 = table_grad_u10(sorted_idx, perm, wq, dout_bf, n_rows)
    k4 = table_grad_w3(sorted_idx, perm, *w, dout, n_rows)
    assert (table_grad_u10.launches, table_grad_w3.launches) == (before[0] + 1, before[1] + 1)
    p2 = table_grad_u10_plain(sorted_idx, perm, wq, dout_bf, n_rows)
    p4 = table_grad_w3_plain(sorted_idx, perm, *w, dout, n_rows)
    torch.cuda.synchronize()
    # The same terms summed in float32 in another order (atomics in both);
    # rows that no sample names stay zero.
    untouched = torch.bincount(sorted_idx.long(), minlength=n_rows) == 0
    for got, want in ((k2, p2), (k4, p4)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale
        assert not got[untouched].any()


@pytest.mark.cuda
def test_cell_max_kernel_is_exact_on_the_card(cuda):
    from nerfacc_tpu_torch.ops.table_grad import cell_max, cell_max_plain

    rng = np.random.default_rng(5)
    n_cells = 1 << 21
    ids = torch.from_numpy(rng.integers(0, n_cells, 1 << 20).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.random(1 << 20, dtype=np.float32) * 4e-3).to(cuda)
    vals[:3] = torch.tensor([0.0, -0.0, 1e-30])
    before = cell_max.launches
    got = cell_max(ids, vals, n_cells)
    assert cell_max.launches == before + 1
    library = torch.full((n_cells,), -1.0, device=cuda).scatter_reduce_(0, ids.long(), vals, "amax")
    torch.cuda.synchronize()
    assert torch.equal(got, cell_max_plain(ids, vals, n_cells))
    assert torch.equal(got, library)
