"""The port's CUDA kernels on the card, against their plain PyTorch versions.

K1, K2, K3, K4 (w3 and w8, float32 and bf16), K5 and K6, the wrappers'
refusals, the visibility filter (the volrend functions and the
training renderer) and the proposal-network step (its t ladder, and one
step through K4-w3 and through K2) against the CPU, the procedural views
and the occupancy CLI's checkpoint round trip on the card, and the plug-in
fields' and BARF's steps (K1 and K3 launched as their paths say, each step
against the CPU; BARF's rays and ``se3_exp`` on the card and the CPU).  Needs an NVIDIA
GPU and the CUDA toolkit, and not JAX (``tests/conftest.py``
imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a card every test here skips.
"""

import dataclasses

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
    z cells that are a word's last bit, +-inf and NaN coordinates, and random
    points over all levels."""
    faces = np.concatenate(
        [(np.arange(res + 1, dtype=np.float32) / res - 0.5) * 2.0**l for l in range(levels)]
    )
    special = np.array([-0.5, 0.5, -0.5000001, 0.4999999, 0.0, np.inf, -np.inf, np.nan], np.float32)
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
        # Points with a non-finite coordinate: inside the selector (and some
        # occupied) at 4 levels, never at 1.
        bad = ~torch.isfinite(p).all(dim=1)
        assert int(bad.sum()) > 0 and bool(out[bad].any()) == (levels > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4097, 4098, 4099, 3_000_001])
def test_k1_takes_counts_that_are_not_a_multiple_of_four(cuda, n):
    # The kernel takes four queries a thread and the last n % 4 one a
    # thread; 3,000,001 queries are more than one wave of resident threads
    # takes, so the grid-stride loop turns.
    rng = np.random.default_rng(n)
    levels, res = 4, 32
    grid = torch.from_numpy(rng.random((levels, res, res, res)) < 0.3).to(cuda)
    packed = bitpack_grid(grid)
    p = _points(levels, res, rng, n=max(1, n // 2))
    p = np.resize(p, (n, 3))  # repeats the points to n rows
    pt = [torch.from_numpy(np.ascontiguousarray(p[:, i])).to(cuda) for i in range(3)]
    aabb = torch.from_numpy(AABB).to(cuda)
    for mip_pad in (0, 1):
        before = occupancy_query.launches
        out = occupancy_query(packed, aabb, *pt, rz=res, mip_pad=mip_pad)
        assert occupancy_query.launches == before + 1
        plain = occupancy_query_plain(packed, aabb, *pt, rz=res, mip_pad=mip_pad)
        torch.cuda.synchronize()
        assert out.shape == (n,) and torch.equal(out, plain)


@pytest.mark.cuda
def test_k1_on_a_skip_grid_with_mip_pad(cuda):
    # The macro-skip probes: mip_pad=1 on the 64^3 skip grid of a 128^3
    # estimator with skip_factor 2, against _query_soa on the unpacked grid.
    from nerfacc_tpu_torch.ops.occ_query import _query_soa

    est = OccGridEstimator(roi_aabb=AABB.tolist(), resolution=128, levels=1, skip_factor=2)
    rng = np.random.default_rng(11)
    state = est.set_binaries(est.init(cuda), torch.from_numpy(rng.random((1, 128, 128, 128)) < 0.05))
    assert tuple(state.skip_grid.shape) == (1, 64, 64, 64)
    p = torch.from_numpy(_points(1, 64, rng, n=100_000)).to(cuda)
    pt = [p[:, i].contiguous() for i in range(3)]
    aabb = state.aabbs[0].contiguous()
    before = occupancy_query.launches
    out = occupancy_query(state.skip_packed, aabb, *pt, rz=64, mip_pad=1)
    assert occupancy_query.launches == before + 1
    plain = occupancy_query_plain(state.skip_packed, aabb, *pt, rz=64, mip_pad=1)
    ref, _ = _query_soa(*pt, state.skip_grid, aabb, mip_pad=1)
    torch.cuda.synchronize()
    assert torch.equal(out, plain) and torch.equal(out, ref)
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
    # A view 4 bytes into a tensor: the kernel reads 16 bytes at a time.
    q = torch.zeros(65, device=cuda)
    with pytest.raises(ValueError, match="py must be 16-byte aligned"):
        occupancy_query(packed, aabb, p[0], q[1:], p[2], rz=32)
    with pytest.raises(ValueError, match="at most two levels"):
        occupancy_query(packed, aabb, p[0], p[1], p[2], rz=32, mip_pad=2)


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


K2_CASES = (
    "pileup-1", "pileup-1000", "pileup-300000",  # a quarter of the samples on 64 rows
    "encoder-1", "encoder-5000", "encoder-200000",  # the fused encoder's own rows
    "one-row",    # every sample on one row: one run over many tiles and blocks
    "tile-runs",  # runs that start and end exactly on the block tiles' edges
    "warp-runs",  # ... and on the edges of each warp's samples within a tile
    "ragged",     # a sample count that is not a multiple of the tile, pile-ups
    "u10-ends",   # weights of exactly 0 and 1 on each axis: q in {0, 1023}
)


def _k2_inputs(case, device):
    """K2's (and K4-w3's) arguments for one case of the card test: rows
    sorted ascending with their permutation, the float32 fractions ``(3,
    n)``, float32 cotangents ``(n, 16)`` of mixed scale and the row count."""
    from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderFused
    from nerfacc_tpu_torch.ops.table_grad import K2_TILE

    rng = np.random.default_rng(K2_CASES.index(case))
    kind, _, size = case.partition("-")
    if kind == "pileup":
        n = int(size)
        n_rows = {1: 64, 1000: 4096}.get(n, 16384)
        return (*_sorted_factors(rng, n, n_rows, device), n_rows)
    if kind == "encoder":
        # Points around a shell through 4 levels of 2^12 rows; the coarsest
        # level (16^3 cells) is indexed densely.
        n = int(size)
        enc = HashGridEncoderFused(n_levels=4, n_features_per_level=16, log2_hashmap_size=12, device=device)
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        u = (0.5 + 0.225 * (1.0 + rng.uniform(-0.18, 0.18, (n, 1))) * d).astype(np.float32)
        rows, ws = enc.cell_indices(torch.from_numpy(u).to(device))
        idx, n_rows = rows.reshape(-1).to(torch.int32), enc.table.shape[0]
        w = torch.stack([c.reshape(-1) for c in ws])
        n = idx.numel()
    else:
        n = {"one": 5000, "tile": 8 * K2_TILE, "warp": 8 * K2_TILE, "ragged": 333, "u10": 3000}[kind]
        n_rows = 4096
        if kind == "one":
            idx = np.full(n, 1234)
        elif kind in ("tile", "warp"):  # a warp walks half a tile
            idx = np.arange(n) // (K2_TILE if kind == "tile" else K2_TILE // 2) * 3
        elif kind == "ragged":  # a third of the samples on three rows
            idx = np.concatenate([rng.integers(0, 3, n // 3) * 977, rng.integers(0, n_rows, n - n // 3)])
        else:
            idx = rng.integers(0, 64, n)
        idx = torch.from_numpy(idx.astype(np.int32)).to(device)
        w = rng.random((3, n), dtype=np.float32)
        if kind == "u10":
            # Every sample has one axis at 0 or 1, every other sample all three.
            at_end = np.zeros((3, n), bool)
            at_end[rng.integers(0, 3, n), np.arange(n)] = True
            at_end[:, ::2] = True
            w = np.where(at_end, rng.integers(0, 2, (3, n)), w).astype(np.float32)
        w = torch.from_numpy(w).to(device)
    sorted_idx, perm = torch.sort(idx)
    scale = rng.choice([1e-3, 1.0], (n, 1))
    dout = torch.from_numpy((rng.standard_normal((n, 16)) * scale).astype(np.float32)).to(device)
    return sorted_idx, perm, w, dout, n_rows


@pytest.mark.cuda
@pytest.mark.parametrize("case", K2_CASES)
def test_table_grad_kernels_match_plain_versions_on_the_card(cuda, case):
    from nerfacc_tpu_torch.ops.table_grad import (
        quantize_u10,
        table_grad_u10,
        table_grad_u10_plain,
        table_grad_w3,
        table_grad_w3_plain,
    )

    sorted_idx, perm, w, dout, n_rows = _k2_inputs(case, cuda)
    wq = quantize_u10(*w)
    if case == "u10-ends":
        q = torch.stack([(wq >> b) & 1023 for b in (20, 10, 0)])
        assert bool((q == 0).any(dim=1).all()) and bool((q == 1023).any(dim=1).all())
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
    assert bool(k2[~untouched].any(dim=1).all())  # every named row received its terms


@pytest.mark.cuda
@pytest.mark.parametrize("case", K2_CASES)
def test_k4_modes_match_plain_versions_on_the_card(cuda, case):
    from nerfacc_tpu_torch.ops.table_grad import (
        corner_weights,
        table_grad_w3,
        table_grad_w3_plain,
        table_grad_w8,
        table_grad_w8_plain,
    )

    sorted_idx, perm, w, dout, n_rows = _k2_inputs(case, cuda)
    w8 = corner_weights(*w).contiguous()
    untouched = torch.bincount(sorted_idx.long(), minlength=n_rows) == 0
    for dtype in (torch.float32, torch.bfloat16):
        d = dout.to(dtype)
        for kernel, plain, args in (
            (table_grad_w3, table_grad_w3_plain, (sorted_idx, perm, *(c.to(dtype) for c in w), d, n_rows)),
            (table_grad_w8, table_grad_w8_plain, (sorted_idx, perm, w8.to(dtype), d, n_rows)),
        ):
            before = kernel.launches
            got = kernel(*args)
            assert kernel.launches == before + 1
            want = plain(*args)
            torch.cuda.synchronize()
            # The same terms summed in float32 in another order (atomics in
            # both); rows that no sample names stay zero, every named row
            # receives its terms.
            err = float((got - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), (kernel.__name__, dtype, err)
            assert not got[untouched].any()
            assert bool(got[~untouched].any(dim=1).all())


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


K3_CASES = (
    "ragged-1", "ragged-3", "ragged-1001", "ragged-1048579",  # counts that are not a multiple of the tile
    "out-of-range",  # ids below 0 and at or above n_cells, which are skipped
    "one-id",        # one id drawn 65,536 times
    "distinct",      # 2^20 distinct ids
    "sysrow",        # a uniform half and rows of 128 ascending occupied ids, as the update draws
    "zeros",         # 0.0, -0.0 (which counts as 0.0) and subnormal values
    "odd-cells",     # a cell count that is not a multiple of 4 or of a window
    "empty",         # no draws: every cell -1
    "sysrow-4-levels",  # the update's draws in level 1 of four levels of 2^21 cells
    "wide",          # 2^23 cells drawn all over: more windows than clusters fit at once
    "cells-1", "cells-5", "cells-134217731",  # part of one window's sectors; 147 windows
)


def _k3_inputs(case, device):
    """K3's ``(ids, vals, n_cells)`` for one case of the card test."""
    rng = np.random.default_rng(K3_CASES.index(case))
    kind, _, size = case.partition("-")
    level = 1 << 21  # one grid level of 128^3 cells
    four = size == "4-levels"  # the draws in level 1, the output four levels
    n_cells = (int(size) if kind == "cells" else level - 3 if kind == "odd"
               else 4 * level if kind == "wide" or four else level)
    n = int(size) if kind == "ragged" else 65_536 if kind == "one" else 0 if kind == "empty" else (
        4096 if kind == "cells" else 1 << 20)
    ids = rng.integers(0, level if four else n_cells, n)
    vals = rng.random(n, dtype=np.float32) * 4e-3
    if kind == "out":
        bad = rng.random(n) < 0.2
        ids[bad] = rng.choice([-1, -(2**31), n_cells, n_cells + 5, 2**31 - 1], int(bad.sum()))
    elif kind == "one":
        ids[:] = 777
    elif kind == "distinct":
        ids = rng.permutation(n_cells)[:n]
    elif kind == "sysrow":
        occupied = np.flatnonzero(rng.random(level) < 0.08)
        rows = occupied[: occupied.size // 128 * 128].reshape(-1, 128)
        pick = np.minimum(((np.arange(n // 256) + rng.random()) * (len(rows) / (n // 256))).astype(int), len(rows) - 1)
        ids[n // 2 :] = rows[pick].reshape(-1)
        ids += level if four else 0
    elif kind == "zeros":
        ids = rng.integers(0, 1 << 20, n)  # about one draw a cell: many hold only -0.0
        vals = rng.choice(np.array([0.0, -0.0, 1e-45, 3e-45, 1e-39, 1.2e-38], np.float32), n)
    return (torch.from_numpy(ids.astype(np.int32)).to(device), torch.from_numpy(vals.astype(np.float32)).to(device),
            n_cells)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_CASES)
def test_k3_matches_its_plain_version_on_the_card(cuda, case):
    from nerfacc_tpu_torch.ops.table_grad import cell_max, cell_max_plain

    ids, vals, n_cells = _k3_inputs(case, cuda)
    before = cell_max.launches
    got = cell_max(ids, vals, n_cells)
    assert cell_max.launches == before + 1
    # The kernel skips ids outside [0, n_cells); the plain version and the
    # library call take only the others.
    keep = (ids >= 0) & (ids < n_cells)
    want = cell_max_plain(ids[keep], vals[keep], n_cells)
    library = torch.full((n_cells,), -1.0, device=cuda).scatter_reduce_(0, ids[keep].long(), vals[keep], "amax")
    torch.cuda.synchronize()
    # Exact, bit for bit: -0.0 is taken as +0.0, untouched cells are -1.
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got, library)
    assert int((got >= 0).sum()) == int(torch.unique(ids[keep]).numel())


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_rows", [(1, 64), (1000, 4096), (300_000, 16384)])
def test_k4_modes_and_k5_match_plain_versions_on_the_card(cuda, n, n_rows):
    from nerfacc_tpu_torch.ops.table_grad import (
        corner_weights,
        table_grad_sorted,
        table_grad_sorted_plain,
        table_grad_w3,
        table_grad_w3_plain,
        table_grad_w8,
        table_grad_w8_plain,
    )

    rng = np.random.default_rng(n + 1)
    sorted_idx, perm, w, dout = _sorted_factors(rng, n, n_rows, cuda)
    bf = torch.bfloat16
    w8 = corner_weights(*w)
    dg = torch.from_numpy(rng.standard_normal((n, 128)).astype(np.float32)).to(cuda)
    runs = [
        (table_grad_w3, table_grad_w3_plain, (sorted_idx, perm, *(c.to(bf) for c in w), dout.to(bf), n_rows)),
        (table_grad_w8, table_grad_w8_plain, (sorted_idx, perm, w8.to(bf), dout.to(bf), n_rows)),
        (table_grad_w8, table_grad_w8_plain, (sorted_idx, perm, w8, dout, n_rows)),
        (table_grad_sorted, table_grad_sorted_plain, (sorted_idx, perm, dg.to(bf), n_rows)),
        (table_grad_sorted, table_grad_sorted_plain, (sorted_idx, perm, dg, n_rows)),
    ]
    untouched = torch.bincount(sorted_idx.long(), minlength=n_rows) == 0
    for kernel, plain, args in runs:
        before = kernel.launches
        got = kernel(*args)
        assert kernel.launches == before + 1
        want = plain(*args)
        torch.cuda.synchronize()
        # The same terms summed in float32 in another order; rows that no
        # sample names stay zero.
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        assert not got[untouched].any()


# K6's tile at the default split (jg * F = 4; csrc/table_grad_pos.cu,
# tile_pairs): 512 pairs a block, 64 a warp.
K6_TILE = 512
K6_CASES = (
    "encoder-1", "encoder-5000", "encoder-200000",  # the encoder's own pairs
    "one-key",      # every pair on one key: one run over many tiles and blocks
    "tile-runs",    # runs that start and end exactly on the block tiles' edges
    "warp-runs",    # ... and on the edges of each warp's pairs within a tile
    "ragged",       # a pair count that is not a multiple of the tile, pile-ups
    "lattice",      # positions where x * r is an integer (floor on its edge)
    "empty-fetch",  # the encoder's pairs without those of one fetch
)


def _k6_inputs(case, device):
    """K6's arguments for one case of the card test, on ``device``: the
    sorted keys and their permutation into the fetch-major pairs, the
    positions, bf16 cotangents, the row count and the fetches (a grouped
    encoder of 2 x 2^12 rows, 8 fetches).  The kernel takes any sorted keys
    whose fetches keep to their spans and any permutation entries in range,
    whether or not they agree on the fetch, so the edge cases are built
    directly."""
    from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderGrouped

    enc = HashGridEncoderGrouped(log2_hashmap_size=12, device=device)
    nf, n_rows = len(enc.fetches), enc.table.shape[0]
    rng = np.random.default_rng(K6_CASES.index(case))
    kind, _, size = case.partition("-")
    n = int(size) if kind == "encoder" else {
        "one": 700, "tile": 8 * K6_TILE // nf, "warp": 8 * K6_TILE // nf, "ragged": 333, "lattice": 4000,
        "empty": 5000,
    }[kind]
    x = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    if kind == "lattice":
        # x = m / r at the fetches' resolutions (x * r within an ulp of m),
        # and multiples of 1/16 (x * r exactly m at the base resolution 16).
        res = np.array([r for f in enc.fetches for r in f.res])
        r = res[rng.integers(0, res.size, (n, 3))]
        x = (rng.integers(0, r + 1) / r).astype(np.float32)
        x[::2] = rng.integers(0, 17, (len(x[::2]), 3)) / np.float32(16)
    pos = torch.from_numpy(x).to(device)
    xs, ys, zs = (pos[:, i].contiguous() for i in range(3))
    if kind in ("encoder", "lattice", "empty"):
        rows = enc.fetch_rows(xs, ys, zs)
        key = (rows * nf + torch.arange(nf, device=device)[:, None]).reshape(-1).to(torch.int32)
        sorted_key, perm = torch.sort(key)
        if kind == "empty":
            keep = sorted_key % nf != 5
            sorted_key, perm = sorted_key[keep].contiguous(), perm[keep].contiguous()
    else:
        # Fetch g's rows lie in its span, as the encoder's do: no two keys
        # name the same columns of a row.
        m, T = nf * n, enc.table_size
        span = np.array([f.span for f in enc.fetches])
        if kind == "one":
            g, r = np.full(m, 3), np.full(m, 1234)
        elif kind in ("tile", "warp"):
            run = K6_TILE if kind == "tile" else K6_TILE // 8
            q = np.arange(m) // run
            g, r = q % nf, q * 3
        else:  # ragged: a third of the pairs on three rows, the rest anywhere
            g = rng.integers(0, nf, m)
            r = np.concatenate([rng.integers(0, 3, m // 3) * 977, rng.integers(0, T, m - m // 3)])
        key = (span[g] * T + r) * nf + g
        sorted_key = torch.from_numpy(np.sort(key).astype(np.int32)).to(device)
        perm = torch.from_numpy(rng.permutation(m)).to(device)
    scale = rng.choice([1e-3, 1.0], (nf * n, 1))
    dout = torch.from_numpy((rng.standard_normal((nf * n, 4)) * scale).astype(np.float32)).to(device)
    return sorted_key, perm, xs, ys, zs, dout.to(torch.bfloat16), n_rows, enc.fetches


@pytest.mark.cuda
@pytest.mark.parametrize("case", K6_CASES)
def test_k6_matches_its_plain_version_on_the_card(cuda, case):
    from nerfacc_tpu_torch.ops.table_grad import table_grad_pos, table_grad_pos_plain

    sorted_key, perm, xs, ys, zs, dout, n_rows, fetches = _k6_inputs(case, cuda)
    args = (sorted_key, perm, xs, ys, zs, dout, n_rows, fetches, 2)
    before = table_grad_pos.launches
    got = table_grad_pos(*args)
    assert table_grad_pos.launches == before + 1
    want = table_grad_pos_plain(*args)
    torch.cuda.synchronize()
    # Equal weights (the same float32 steps, --fmad=false), the same bf16
    # terms summed in float32 in another order.
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    _only_named_columns(got, sorted_key, n_rows, fetches, 2)


def _only_named_columns(got, sorted_key, n_rows, fetches, F):
    """A (row, fetch) key writes its row's ``8 jg F`` window columns and
    nothing else: every other column, and every row no key names, stays
    zero."""
    nf, jg = len(fetches), len(fetches[0].res)
    keys = torch.unique(sorted_key).long().cpu()
    j_lo = torch.tensor([f.j_lo for f in fetches])
    cols = (torch.arange(8)[:, None] * 16 + torch.arange(jg * F)).reshape(-1)
    named = torch.zeros((n_rows, 128), dtype=torch.bool)
    named[(keys // nf)[:, None], cols + F * j_lo[keys % nf][:, None]] = True
    got = got.cpu()
    assert not got[~named].any() and got[named].any()


# Every (F, keys_per_row) the grouped encoder builds (keys_per_row dividing
# J = 16 / F): windows of 1 to 16 columns a corner.
EVERY_SPLIT = [(F, k) for F in (1, 2, 4, 8, 16) for k in (1, 2, 4, 8, 16) if (16 // F) % k == 0]


@pytest.mark.cuda
@pytest.mark.parametrize("F,keys_per_row", EVERY_SPLIT, ids=[f"F{f}-split{k}" for f, k in EVERY_SPLIT])
def test_k6_matches_its_plain_version_at_every_split(cuda, F, keys_per_row):
    from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderGrouped
    from nerfacc_tpu_torch.ops.table_grad import table_grad_pos, table_grad_pos_plain

    enc = HashGridEncoderGrouped(n_features_per_level=F, log2_hashmap_size=12, keys_per_row=keys_per_row,
                                 device=cuda)
    nf, jg, n_rows = len(enc.fetches), len(enc.fetches[0].res), enc.table.shape[0]
    assert enc.split == keys_per_row and jg * F == 16 // keys_per_row
    rng = np.random.default_rng(EVERY_SPLIT.index((F, keys_per_row)))
    n = 30011  # not a multiple of any tile
    pos = torch.from_numpy(rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)).to(cuda)
    xs, ys, zs = (pos[:, i].contiguous() for i in range(3))
    rows = enc.fetch_rows(xs, ys, zs)
    key = (rows * nf + torch.arange(nf, device=cuda)[:, None]).reshape(-1).to(torch.int32)
    sorted_key, perm = torch.sort(key)
    scale = rng.choice([1e-3, 1.0], (nf * n, 1))
    dout = torch.from_numpy((rng.standard_normal((nf * n, jg * F)) * scale).astype(np.float32)).to(cuda)
    args = (sorted_key, perm, xs, ys, zs, dout.to(torch.bfloat16), n_rows, enc.fetches, F)
    before = table_grad_pos.launches
    got = table_grad_pos(*args)
    assert table_grad_pos.launches == before + 1
    want = table_grad_pos_plain(*args)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    _only_named_columns(got, sorted_key, n_rows, enc.fetches, F)


@pytest.mark.cuda
def test_new_wrappers_refuse_what_their_kernels_do_not_take(cuda):
    from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderGrouped
    from nerfacc_tpu_torch.ops import table_grad as tg
    from nerfacc_tpu_torch.ops.table_grad import (
        table_grad_pos,
        table_grad_sorted,
        table_grad_u10,
        table_grad_w3,
        table_grad_w8,
    )

    idx = torch.zeros(8, dtype=torch.int32, device=cuda)
    perm = torch.arange(8, device=cuda)
    with pytest.raises(ValueError, match="dg"):
        table_grad_sorted(idx, perm, torch.zeros((8, 64), device=cuda), 16)
    with pytest.raises(ValueError, match="w8"):
        table_grad_w8(idx, perm, torch.zeros((8, 8), device=cuda), torch.zeros((8, 16), device=cuda, dtype=torch.bfloat16), 16)
    # A window of three sub-levels (jg * F = 6): no encoder builds one, and
    # the kernel has no instance for it.
    p = torch.zeros(1, device=cuda)
    three = (tg.Fetch(span=0, j_lo=0, res=(16, 23, 33), key=0),)
    with pytest.raises(ValueError, match=r"jg \* F in \(1, 2, 4, 8, 16\)"):
        table_grad_pos(idx, perm, p, p, p, torch.zeros((8, 6), device=cuda, dtype=torch.bfloat16), 1024, three, 2)
    enc = HashGridEncoderGrouped(log2_hashmap_size=9, device=cuda)
    misaligned = torch.zeros(33, device=cuda, dtype=torch.bfloat16)[1:].view(8, 4)
    with pytest.raises(ValueError, match="8-byte aligned"):
        table_grad_pos(idx, perm, p, p, p, misaligned, 1024, enc.fetches, 2)
    # Two fetches on one span and window: the plain version sums them, the
    # kernel would store one over the other.
    dout = torch.zeros((9, 4), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"share the \(span, j_lo\) windows \[\(0, 2\)\]"):
        table_grad_pos(idx, perm, p, p, p, dout, 1024, enc.fetches + (enc.fetches[1],), 2)
    wq = torch.zeros(8, dtype=torch.int32, device=cuda)
    dout = torch.zeros(8 * 16 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(8, 16)
    with pytest.raises(ValueError, match="dout must be 16-byte aligned"):
        table_grad_u10(idx, perm, wq, dout, 16)
    # K4 reads sorted_idx, perm, w8 and dout 16 bytes at a time, and takes
    # only the tile it was built with for each type.
    w, d32 = torch.zeros(8, device=cuda), torch.zeros((8, 16), device=cuda)
    with pytest.raises(ValueError, match="dout must be 16-byte aligned"):
        table_grad_w3(idx, perm, w, w, w, torch.zeros(8 * 16 + 1, device=cuda)[1:].view(8, 16), 16)
    with pytest.raises(ValueError, match="perm must be 16-byte aligned"):
        table_grad_w3(idx, torch.arange(9, device=cuda)[1:], w, w, w, d32, 16)
    with pytest.raises(ValueError, match="w8 must be 16-byte aligned"):
        table_grad_w8(idx, perm, torch.zeros(8 * 8 + 1, device=cuda)[1:].view(8, 8), d32, 16)
    with pytest.raises(ValueError, match="sorted_idx must be 16-byte aligned"):
        table_grad_w8(torch.zeros(9, dtype=torch.int32, device=cuda)[1:], perm, torch.zeros((8, 8), device=cuda), d32, 16)
    for dtype in (torch.float32, torch.bfloat16):
        bf = int(dtype == torch.bfloat16)
        wd, dd = w.to(dtype), d32.to(dtype)
        with pytest.raises(RuntimeError, match="table_grad_w3_launch: CUDA error"):
            tg._launch(tg._table_grad_lib(), "table_grad_w3_launch", (idx, perm, wd, wd, wd, dd), 16, bf,
                       span=2 * tg.K4_TILE[dtype])
        with pytest.raises(RuntimeError, match="table_grad_w8_launch: CUDA error"):
            tg._launch(tg._table_grad_lib(), "table_grad_w8_launch", (idx, perm, torch.zeros((8, 8), device=cuda,
                       dtype=dtype), dd), 16, bf, span=tg.K4_TILE[dtype] // 2)


# The visibility filter on the card (the unbounded train step and its eval
# render): visibility masks may differ from the CPU's only where the CPU's
# alpha lies within 1e-5 (relative) and two alpha steps of the threshold, or
# its transmittance within 1e-5 of early_stop_eps, since exp and the sums
# differ in their last bits.  alpha = 1 - exp(-sigma dt) moves in steps of
# 2^-24, the spacing of float32 values just below 1.


def _flip_allowed(trans, alphas, thre, eps):
    return ((alphas - thre).abs() <= 1e-5 * thre + 2 * 2.0**-24) | ((trans - eps).abs() <= 1e-5)


@pytest.mark.cuda
def test_visibility_functions_on_the_card_match_the_cpu(cuda):
    from nerfacc_tpu_torch import volrend

    rng = np.random.default_rng(21)
    counts = rng.integers(0, 200, 2000)
    ri = torch.from_numpy(np.repeat(np.arange(2000), counts).astype(np.int32))
    n = ri.shape[0]
    t0 = torch.from_numpy(np.sort(rng.random(n, dtype=np.float32)))
    t1 = t0 + torch.from_numpy(rng.random(n, dtype=np.float32) * 0.02)
    sigmas = torch.from_numpy(rng.random(n, dtype=np.float32) * 20.0)
    thre, eps = 0.05, 1e-3
    want = volrend.render_visibility_from_density(t0, t1, sigmas, ray_indices=ri, early_stop_eps=eps, alpha_thre=thre)
    got = volrend.render_visibility_from_density(
        t0.to(cuda), t1.to(cuda), sigmas.to(cuda), ray_indices=ri.to(cuda), early_stop_eps=eps,
        alpha_thre=torch.tensor(thre, device=cuda),
    ).cpu()
    trans, alphas = volrend.render_transmittance_from_density(t0, t1, sigmas, ray_indices=ri)
    differ = got != want
    assert not (differ & ~_flip_allowed(trans, alphas, thre, eps)).any()
    assert 0 < int(want.sum()) < n
    alphas = alphas.clamp(max=0.99)
    want = volrend.render_visibility_from_alpha(alphas, ray_indices=ri, early_stop_eps=eps, alpha_thre=thre)
    got = volrend.render_visibility_from_alpha(alphas.to(cuda), ray_indices=ri.to(cuda), early_stop_eps=eps,
                                               alpha_thre=thre).cpu()
    trans = volrend.render_transmittance_from_alpha(alphas, ray_indices=ri)
    assert not ((got != want) & ~_flip_allowed(trans, alphas, thre, eps)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("refilter", [None, 1 << 13], ids=["mask", "refilter"])
def test_render_with_visibility_filter_on_the_card_matches_the_cpu(cuda, refilter):
    from nerfacc_tpu_torch.rendering import gather_ray_od, occgrid_render_rays

    est = OccGridEstimator(roi_aabb=[-1.0] * 3 + [1.0] * 3, resolution=32, levels=1)
    rng = np.random.default_rng(22)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = torch.from_numpy(-2.0 * d), torch.from_numpy(d)

    def density(x):
        return 40.0 * torch.sigmoid((0.5 - x.norm(dim=-1)) * 40.0)

    state_cpu = est._update(est.init("cpu"), 0, lambda x: density(x)[:, None] * 0.02,
                            generator=torch.Generator().manual_seed(0))
    out = []
    for device in (cuda, torch.device("cpu")):
        ro, rd = o.to(device), d.to(device)
        st = state_cpu.replace(**{k: getattr(state_cpu, k).to(device) for k in
                                  ("aabbs", "occs", "binaries", "binaries_packed", "skip_grid", "skip_packed")})
        passes = []

        def points(ts, te, ri):
            oo, dd = gather_ray_od(ro, rd, ri)
            return oo + ((ts + te) / 2)[:, None] * dd

        def sigma_fn(ts, te, ri):
            s = density(points(ts, te, ri))
            passes.append((ts.cpu(), te.cpu(), ri.cpu(), s.cpu()))
            return s

        def rgb_sigma_fn(ts, te, ri):
            x = points(ts, te, ri)
            return torch.sigmoid(3.0 * x), density(x)

        c, op, _, n, extras = occgrid_render_rays(
            rgb_sigma_fn, sigma_fn, est, st, ro, rd, near_plane=0.5, far_plane=4.0, render_step_size=1e-2,
            alpha_thre=1e-3, early_stop_eps=1e-2, sample_capacity=512 * 128, refilter_capacity=refilter,
            render_bkgd=torch.ones(3, device=device),
        )
        out.append((c.cpu(), op.cpu(), int(n), extras["kept"].cpu(), passes[0]))
    (c_g, op_g, n_g, k_g, p_g), (c_c, op_c, n_c, k_c, p_c) = out
    assert torch.equal(p_g[2], p_c[2]) and torch.equal(p_g[1] > p_g[0], p_c[1] > p_c[0])
    from nerfacc_tpu_torch.volrend import render_transmittance_from_density

    ts, te, ri, s = p_c
    assert 0 < n_c < int((te > ts).sum())
    if refilter:
        # The survivors, compacted again: the same count and layout.
        assert n_g == n_c and torch.equal(k_g, k_c)
    else:
        trans, alphas = render_transmittance_from_density(ts, te, torch.where(te > ts, s, 0.0), ray_indices=ri)
        thre = min(1e-3, float(state_cpu.occs.mean()))
        differ = k_g != k_c
        assert not (differ & ~_flip_allowed(trans, alphas, thre, 1e-2)).any()
        if differ.any():
            return
    # atol 1e-4: the card sums in another order (phase 4 of chip_smoke.py).
    assert float((c_g - c_c).abs().max()) <= 1e-4 and float((op_g - op_c).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_k1_on_four_level_cone_traversal(cuda, monkeypatch):
    # The unbounded configuration's queries: 4 levels of 128^3, the
    # geometric ladder at cone 0.004 with its four skip probes a segment.
    import nerfacc_tpu_torch.grid as grid_mod
    from nerfacc_tpu_torch.ops.occ_query import _query_soa

    est = OccGridEstimator(roi_aabb=[-1.0] * 3 + [1.0] * 3, resolution=128, levels=4, skip_factor=2)
    rng = np.random.default_rng(23)
    state = est.set_binaries(est.init(cuda), torch.from_numpy(rng.random((4, 128, 128, 128)) < 0.1))
    o = rng.normal(size=(2048, 3))
    o /= np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, (2048, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    calls = []

    def recording(packed, aabb, px, py, pz, rz, mip_pad=0):
        calls.append((packed, aabb, (px, py, pz), rz, mip_pad))
        return occupancy_query(packed, aabb, px, py, pz, rz=rz, mip_pad=mip_pad)

    monkeypatch.setattr(grid_mod, "occupancy_query", recording)
    cs = est.compact_samples(
        state, torch.from_numpy(o.astype(np.float32)).to(cuda), torch.from_numpy(d.astype(np.float32)).to(cuda),
        near_plane=0.2, render_step_size=1e-3, cone_angle=0.004, sample_capacity=1 << 18,
    )
    assert int(cs.kept.sum()) > 0
    assert [(c[0] is state.skip_packed, c[4]) for c in calls] == [(True, 1), (False, 0)]
    for packed, aabb, pts, rz, mip_pad in calls:
        out = occupancy_query(packed, aabb, *pts, rz=rz, mip_pad=mip_pad)
        grid = state.skip_grid if mip_pad else state.binaries
        ref, _ = _query_soa(*pts, grid, aabb, mip_pad=mip_pad)
        torch.cuda.synchronize()
        assert torch.equal(out, occupancy_query_plain(packed, aabb, *pts, rz=rz, mip_pad=mip_pad))
        assert torch.equal(out, ref)
        assert 0 < int(out.sum()) < out.numel()


@pytest.mark.cuda
def test_k3_at_four_levels_of_128_cubed(cuda):
    # One post-warm-up update of a 4-level 128^3 grid: 2^20 draws a level
    # into 2^23 cells, K3 once a level, bit for bit the CPU's update.
    from nerfacc_tpu_torch.ops.table_grad import cell_max, cell_max_plain

    est = OccGridEstimator(roi_aabb=[-1.0] * 3 + [1.0] * 3, resolution=128, levels=4)
    rng = np.random.default_rng(24)
    binaries = torch.from_numpy(rng.random((4, 128, 128, 128)) < 0.08)
    occs = torch.from_numpy(rng.random(1 << 23, dtype=np.float32) * 0.02)
    draws = est.make_draws(10**9, torch.Generator().manual_seed(4), device="cpu")

    def occ_eval_fn(x):
        return x[:, :1].abs() * 1e-3

    res = []
    for device in (cuda, torch.device("cpu")):
        st = est.set_binaries(est.init(device), binaries.to(device)).replace(occs=occs.to(device))
        before = cell_max.launches
        new = est._update(st, 10**9, occ_eval_fn, draws=draws)
        res.append((new.occs.cpu(), new.binaries.cpu(), cell_max.launches - before))
    (occ_g, bin_g, launched), (occ_c, bin_c, _) = res
    assert launched == 4
    assert torch.equal(occ_g, occ_c) and torch.equal(bin_g, bin_c)
    ids = torch.from_numpy(rng.integers(0, 1 << 23, 1 << 20).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.random(1 << 20, dtype=np.float32) * 4e-3).to(cuda)
    got = cell_max(ids, vals, 1 << 23)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), cell_max_plain(ids, vals, 1 << 23).view(torch.int32))


@pytest.mark.cuda
def test_geometric_ladder_is_the_same_on_the_card_and_the_cpu(cuda):
    # The cone ladder of the unbounded configuration: the card must march
    # the CPU's t values bit for bit, or a sample can cross a cell face on
    # one side only.
    from nerfacc_tpu_torch.grid import _ladder_at, _march_ladder

    rng = np.random.default_rng(25)
    near = torch.from_numpy((0.2 + rng.random((4096, 1)) * 1e-3).astype(np.float32))
    k = torch.arange(1235, dtype=torch.int32)[None]
    want = _ladder_at(near, k, 1e-3, 0.004)
    got = _ladder_at(near.to(cuda), k.to(cuda), 1e-3, 0.004).cpu()
    assert torch.equal(got, want)
    assert torch.equal(_march_ladder(near[:, 0].to(cuda), 1235, 1e-3, 0.004).cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("sampling_type", ["uniform", "lindisp"])
def test_prop_t_ladder_is_the_same_on_the_card_and_the_cpu(cuda, sampling_type):
    # s to t, 1 / (s s_max + (1 - s) s_min) for lindisp: each operation is
    # its own kernel, one float32 rounding each on both devices, so the
    # card's t values are the CPU's to 0 ulps (and a position on the ray
    # cannot cross a cell face on one side only).
    from nerfacc_tpu_torch.estimators.prop_net import _transform_stot

    s = torch.from_numpy(np.random.default_rng(26).random((4096, 257), dtype=np.float32))
    s[:, 0], s[:, -1] = 0.0, 1.0
    want = _transform_stot(sampling_type, s, 0.2, 1e3)
    got = _transform_stot(sampling_type, s.to(cuda), 0.2, 1e3).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_contraction_is_the_same_on_the_card_and_the_cpu(cuda):
    # The card's norm reduction rounds otherwise than the CPU's; the port's
    # explicit one must give the CPU's contracted positions bit for bit.
    from nerfacc_tpu_torch.models.ngp import contract_to_unisphere

    aabb = torch.tensor([-8.0] * 3 + [8.0] * 3)
    x = torch.from_numpy((np.random.default_rng(28).normal(size=(1 << 20, 3)) * 20).astype(np.float32))
    want = contract_to_unisphere(x, aabb)
    got = contract_to_unisphere(x.to(cuda), aabb.to(cuda)).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _prop_models(device, cdt):
    """A small prop configuration: the contracted radiance field with
    128-wide rows (its table gradient through K4-w3 in float32, K2 in bf16)
    and two proposal nets, one seed for both devices."""
    from nerfacc_tpu_torch.models.ngp import NGPDensityField, NGPRadianceField

    gen = torch.Generator().manual_seed(0)
    roi = [-1.0] * 3 + [1.0] * 3
    field = NGPRadianceField(aabb=roi, unbounded=True, compute_dtype=cdt, device=device, generator=gen,
                             n_levels=4, n_features_per_level=16, log2_hashmap_size=16)
    nets = [NGPDensityField(aabb=roi, unbounded=True, max_resolution=mr, compute_dtype=cdt, device=device,
                            generator=gen, log2_hashmap_size=14) for mr in (128, 256)]
    return field, nets


def _prop_step(device, cdt, rays, jitter, record, replay=None):
    """One prop train step (render, Huber loss plus the proposal loss,
    backward, both Adams) on ``device``; ``record`` collects each
    resampling's s edges and each level's densities, ``replay`` forces the
    s edges.  Returns the losses, the t values and every gradient and
    parameter after Adam, on the CPU."""
    import nerfacc_tpu_torch.estimators.prop_net as prop_mod
    from nerfacc_tpu_torch.data_specs import RayIntervals, RaySamples
    from nerfacc_tpu_torch.rendering import propnet_render_rays

    field, nets = _prop_models(device, cdt)
    o, d, pixels = (x.to(device) for x in rays)
    sampling = prop_mod.importance_sampling

    def resample(*a, **k):
        if replay is None:
            iv, smp = sampling(*a, **k)
        else:
            s = replay[len(record["s"])].to(device)
            iv, smp = RayIntervals(vals=s), RaySamples(vals=(s[:, 1:] + s[:, :-1]) / 2)
        record["s"].append(iv.vals.detach().cpu())
        return iv, smp

    def points(ts, te):
        return o[:, None] + ((ts + te) / 2)[..., None] * d[:, None]

    def rgb_sigma_fn(ts, te):
        x = points(ts, te)
        rgb, sigma = field(x, d[:, None].expand(x.shape))
        return rgb, sigma[..., 0]

    def prop_fn(net):
        def fn(ts, te):
            sigma = net(points(ts, te))[..., 0]
            record["sigma"].append(sigma.detach().cpu())
            return sigma

        return fn

    prop_mod.importance_sampling = resample
    try:
        colors, _, _, extras = propnet_render_rays(
            rgb_sigma_fn, [prop_fn(net) for net in nets], prop_mod.PropNetEstimator(), o, d, num_samples=32,
            prop_samples=(64, 32), render_bkgd=torch.ones(3, device=device), stratified=True,
            requires_grad=True, jitter=[j.to(device) for j in jitter],
        )
    finally:
        prop_mod.importance_sampling = sampling
    loss = torch.nn.functional.huber_loss(colors, pixels, delta=1.0)
    prop_loss = prop_mod.PropNetEstimator().compute_loss(extras["prop_cache"], extras["trans"])
    named = list(field.named_parameters())
    named += [(f"prop{i}.{k}", v) for i, net in enumerate(nets) for k, v in net.named_parameters()]
    opt = torch.optim.Adam([v for _, v in named], lr=1e-2, eps=1e-15)
    (loss + prop_loss).backward()
    grads = {k: v.grad.detach().cpu() for k, v in named}
    opt.step()
    return dict(loss=float(loss.detach()), prop_loss=float(prop_loss.detach()), t=extras["t_starts"].cpu(),
                grads=grads, params={k: v.detach().cpu() for k, v in named})


@pytest.mark.cuda
@pytest.mark.parametrize("cdt,kernel", [(None, "table_grad_w3"), (torch.bfloat16, "table_grad_u10")],
                         ids=["f32-K4-w3", "bf16-K2"])
def test_prop_step_on_the_card_matches_the_cpu(cuda, cdt, kernel):
    from nerfacc_tpu_torch.estimators.prop_net import PropNetEstimator
    from nerfacc_tpu_torch.ops import table_grad as tg

    rng = np.random.default_rng(27)
    n = 256
    o = rng.normal(size=(n, 3))
    o /= np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in (o, d, rng.random((n, 3))))
    jitter = [torch.from_numpy(rng.random((n, 1), dtype=np.float32)) for _ in range(3)]
    wrappers = ("table_grad_u10", "table_grad_w3", "table_grad_w8", "table_grad_sorted", "table_grad_pos")
    before = {w: getattr(tg, w).launches for w in wrappers}
    card = {"s": [], "sigma": []}
    a = _prop_step(cuda, cdt, rays, jitter, card)
    torch.cuda.synchronize()
    assert {w: getattr(tg, w).launches - before[w] for w in wrappers} == {w: int(w == kernel) for w in wrappers}

    # The CPU's sampling given the card's densities: the card's exp and
    # cumsum put a cdf an ulp or two from the CPU's, and resampling scales
    # that by a bin's width over its mass (1.01e-6 measured): atol 1e-5.
    fed = iter(card["sigma"])
    _, _, cache = PropNetEstimator().sampling(
        [lambda ts, te: next(fed)] * 2, [64, 32], 32, n, 0.2, 1e3, "lindisp", stratified=True,
        requires_grad=True, jitter=jitter, device="cpu",
    )
    for got, want in zip(cache, card["s"]):
        assert float((got[0] - want).abs().max()) <= 1e-5
    # The step on the card's samples: float32 1e-4 of the largest gradient
    # for the radiance field's table, 3e-4 for the MLPs (phase 8 of
    # chip_smoke.py) and the proposal nets' tables, whose gradients come
    # through the proposal loss, whose terms cancel, and autograd's scatter
    # (1.39e-4 measured); bf16 2e-2 for all (tests/test_models.py:549).
    b = _prop_step(torch.device("cpu"), cdt, rays, jitter, {"s": [], "sigma": []}, replay=card["s"])
    assert torch.equal(a["t"], b["t"])
    rel = 1e-4 if cdt is None else 2e-2
    assert abs(a["loss"] - b["loss"]) <= rel * abs(b["loss"])
    assert abs(a["prop_loss"] - b["prop_loss"]) <= rel * abs(b["prop_loss"])
    for k, g_cpu in b["grads"].items():
        tol = (rel if k == "encoder.table" or cdt is not None else 3e-4) * float(g_cpu.abs().max())
        g_gpu = a["grads"][k]
        assert float((g_gpu - g_cpu).abs().max()) <= tol, k
        agree = torch.sign(g_gpu) == torch.sign(g_cpu)
        assert bool((g_cpu[~agree].abs() <= tol).all()), k
        held = agree & (g_cpu.abs() > 1e-9)
        assert float(torch.where(held, a["params"][k] - b["params"][k], 0.0).abs().max()) <= 1e-6, k


@pytest.mark.cuda
@pytest.mark.parametrize("detail", [0.0, 1.0])
def test_procedural_views_on_the_card_match_the_cpu(cuda, detail):
    # The card's exp, sin and cumsum round in their own ways: a uint8 value
    # may land one step from the CPU's where it sits on a rounding edge.
    from nerfacc_tpu_torch.datasets.procedural import generate_dataset

    kw = dict(width=48, height=40, n_train=2, n_test=1, detail=detail)
    card, cpu = generate_dataset(**kw, device=cuda), generate_dataset(**kw, device="cpu")
    for a, b in zip(card, cpu):
        if isinstance(a, float):
            assert a == b
        elif a.dtype == np.uint8:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            print(f"detail {detail}: {100 * (diff > 0).mean():.3f}% of uint8 values differ")
            assert diff.max() <= 1
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    # The occupancy CLI's checkpoint: saved from the card, restored into new
    # models on the card, the same parameters, Adam state and grid bit for
    # bit, and the render CLI's view of the restored models the same.
    from nerfacc_tpu_torch.datasets.procedural import make_loaders
    from nerfacc_tpu_torch.examples import render as render_cli
    from nerfacc_tpu_torch.examples import train_ngp_nerf_occ as occ_cli

    argv = ["--smoke", "--device", "cuda", "--num_rays", "512", "--levels", "2", "--log2t", "14",
            "--dtype", "bf16"]
    run, train_ds, _, _ = occ_cli.setup(occ_cli.parse_args(argv))
    occ_cli.train(run, train_ds, 20)
    ckpt = str(tmp_path / "ckpt")
    occ_cli.save(run, ckpt, run.step)

    again, _, _, _ = occ_cli.setup(occ_cli.parse_args(argv))
    occ_cli.resume(again, ckpt)
    assert again.step == 20
    for (k, a), b in zip(run.field.state_dict().items(), again.field.state_dict().values()):
        assert b.is_cuda and torch.equal(a, b), k
    for a, b in zip(run.opt.state_dict()["state"].values(), again.opt.state_dict()["state"].values()):
        assert all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)
    for name in ("occs", "binaries", "binaries_packed", "skip_grid", "skip_packed"):
        assert torch.equal(getattr(run.occ_state, name), getattr(again.occ_state, name)), name

    field, est, occ_state, step = render_cli.load_model(ckpt, levels=2, log2t=14, dtype="bf16", device=cuda)
    _, test_ds = make_loaders(num_rays=1, width=32, height=32, n_test=1, device=cuda)
    rays = test_ds[0]["rays"]
    kw = dict(near=test_ds.near, far=test_ds.far, render_step_size=1e-2, max_samples=256)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a, _ = render_cli.render_view(run.field, run.estimator, run.occ_state, rays, **kw)
        b, _ = render_cli.render_view(field, est, occ_state, rays, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    assert step == 20 and bool(torch.isfinite(a).all())
    assert float((a - b).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_mlp_nerf_step_launches_k1_and_its_update_k3(cuda):
    """train_mlp_nerf's occupancy update and train step at its NeRF-Synthetic
    grid (res 128 over +-1.5): the warm-up update probes 2^21 cells through
    K3 once, the post-warm-up one 2^20, and the step's traversal queries K1;
    the step agrees with the same step on the CPU."""
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.examples import train_mlp_nerf as cli
    from nerfacc_tpu_torch.models.mlp import VanillaNeRFRadianceField
    from nerfacc_tpu_torch.ops.table_grad import cell_max

    rng = np.random.default_rng(0)
    n = 256
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, pixels, jitter = -3.0 * d, rng.random((n, 3), dtype=np.float32), rng.random(n, dtype=np.float32)
    cfg = dict(cli.build_config(procedural=False, smoke=False), samples_per_ray=64, sample_capacity=n * 64)
    est = OccGridEstimator(roi_aabb=cfg["aabb"], resolution=cfg["grid_resolution"], levels=1)
    results, state = [], None
    for device in (cuda, torch.device("cpu")):
        field = VanillaNeRFRadianceField(net_depth=2, net_width=32, device=device,
                                         generator=torch.Generator().manual_seed(0))
        run = cli.Run(cfg=cfg, field=field, estimator=est, occ_state=est.init(device),
                      opt=torch.optim.Adam(field.parameters(), lr=cli.LR), generator=torch.Generator())
        if device.type == "cuda":
            occupancy_query.launches = cell_max.launches = 0
            for s, warmup in ((0, True), (1, False)):
                draws = est.make_draws(s, torch.Generator().manual_seed(s), warmup_steps=1, device=device)
                cli.occ_update(run, warmup=warmup, draws=draws)
            state = run.occ_state
        else:
            # The CPU steps on the card's grid: the two updates' densities
            # differ in their last bits, which may flip a cell at the
            # threshold.
            run.occ_state = state.replace(**{f.name: getattr(state, f.name).cpu() for f in dataclasses.fields(state)})
        loss, n_samp = cli.train_step(run, *(torch.from_numpy(a).to(device) for a in (o, d, pixels)),
                                      torch.ones(3, device=device), torch.from_numpy(jitter).to(device))
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert cell_max.launches == 2 and occupancy_query.launches >= 1
        results.append((float(loss), int(n_samp)))
    (loss_c, n_c), (loss_h, n_h) = results
    assert n_c == n_h > 0 and int(state.binaries.sum()) > 0
    assert loss_c == pytest.approx(loss_h, rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cone", [0.0, 0.008], ids=["uniform", "cone"])
def test_traverse_grids_skip_probes_launch_k1_and_match_the_plain_query(cuda, cone, monkeypatch):
    # traverse_grids' macro-skip branch: its skip probes go through K1 on
    # the packed skip grid (mip_pad=1), exact against the plain query, and
    # the traversal keeps the dense branch's samples (within 1e-5).
    import nerfacc_tpu_torch.grid as grid_mod

    rng = np.random.default_rng(5)
    g = (np.arange(64) + 0.5) / 64 * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    shell = np.abs(np.sqrt(gx**2 + gy**2 + gz**2) - 0.5) < 0.1
    binaries = torch.from_numpy(np.stack([shell, shell]) if cone else shell[None]).to(cuda)
    skip = grid_mod.build_skip_grid(binaries, 4)
    base = torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], device=cuda)
    aabbs = torch.stack([grid_mod._enlarge_aabb(base, 2**i) for i in range(binaries.shape[0])])
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = torch.from_numpy(-3.0 * d).to(cuda)
    d = torch.from_numpy(d).to(cuda)
    kw = dict(step_size=0.01, cone_angle=cone, max_lattice_steps=640, traverse_steps_limit=256,
              packed_grids=bitpack_grid(binaries))
    calls = []
    real = grid_mod.occupancy_query

    def recording(packed, aabb, px, py, pz, rz, mip_pad=0):
        calls.append((packed, aabb, (px, py, pz), rz, mip_pad))
        return real(packed, aabb, px, py, pz, rz=rz, mip_pad=mip_pad)

    dense = traverse_grids(o, d, binaries, aabbs, **kw)
    monkeypatch.setattr(grid_mod, "occupancy_query", recording)
    before = real.launches
    macro = traverse_grids(o, d, binaries, aabbs, skip_grid=skip, packed_skip=bitpack_grid(skip),
                           macro_stride=16, max_macro_segments=24, **kw)
    assert real.launches == before + 2
    (probe,) = [c for c in calls if c[4] == 1]
    packed, aabb, pts, rz, _ = probe
    assert torch.equal(real(packed, aabb, *pts, rz=rz, mip_pad=1), occupancy_query_plain(packed, aabb, *pts, rz=rz, mip_pad=1))
    assert torch.equal(dense.num_valid, macro.num_valid) and int(dense.num_valid.sum()) > 0
    for a, b in ((dense.t_starts, macro.t_starts), (dense.t_ends, macro.t_ends)):
        torch.testing.assert_close(torch.where(dense.is_valid, a, 0.0), torch.where(macro.is_valid, b, 0.0),
                                   rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_soa_route_launches_k2_and_k3_as_the_array_route(cuda):
    # The SoA route (carried ray components, the field on tuples, the
    # update's tuple probes) launches K2 once a step and K3 once an update,
    # as the array route does, with the same loss and table gradient.
    from nerfacc_tpu_torch.models.ngp import NGPRadianceField
    from nerfacc_tpu_torch.ops import table_grad as tg
    from nerfacc_tpu_torch.rendering import gather_ray_od, occgrid_render_rays

    est = OccGridEstimator(roi_aabb=[-1.5] * 3 + [1.5] * 3, resolution=128, levels=1, skip_factor=2)
    g = (np.arange(128) + 0.5) / 128 * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    state = est.set_binaries(est.init(cuda), torch.from_numpy(np.abs(np.sqrt(gx**2 + gy**2 + gz**2) - 0.45) < 0.08)[None])
    rng = np.random.default_rng(0)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o, rays_d = torch.from_numpy(-3.0 * d).to(cuda), torch.from_numpy(d).to(cuda)
    pixels = torch.from_numpy(rng.random((1024, 3), dtype=np.float32)).to(cuda)
    jitter = torch.from_numpy(rng.random(1024, dtype=np.float32)).to(cuda)
    draws = est.make_draws(10**9, torch.Generator().manual_seed(3), device=cuda)
    out = {}
    for soa in (False, True):
        field = NGPRadianceField(aabb=[-1.5] * 3 + [1.5] * 3, n_levels=4, n_features_per_level=16, log2_hashmap_size=18,
                                 compute_dtype=torch.bfloat16, device=cuda, generator=torch.Generator().manual_seed(0))

        def rgb_sigma_fn(ts, te, ri):
            o, dd = gather_ray_od(rays_o, rays_d, ri)
            rgb, sigma = field(o + ((ts + te) / 2)[:, None] * dd, dd)
            return rgb, sigma[..., 0]

        def soa_fn(o, dd, ts, te):
            mid = (ts + te) / 2
            rgb, sigma = field(tuple(o[k] + mid * dd[k] for k in range(3)), dd)
            return rgb, sigma[..., 0]

        tg.table_grad_u10.launches = tg.cell_max.launches = 0
        colors, *_ = occgrid_render_rays(
            rgb_sigma_fn, None, est, state, rays_o, rays_d, render_step_size=5e-3, render_bkgd=torch.ones(3, device=cuda),
            stratified=True, jitter=jitter, sample_capacity=1 << 15, max_macro_segments=4,
            rgb_sigma_soa_fn=soa_fn if soa else None,
        )
        loss = torch.nn.functional.huber_loss(colors, pixels, delta=1.0)
        loss.backward()
        new = est._update(state, 10**9, lambda x: field.query_density(x) * 5e-3, draws=draws, soa_positions=soa)
        torch.cuda.synchronize()
        out[soa] = (tg.table_grad_u10.launches, tg.cell_max.launches, float(loss), field.encoder.table.grad.cpu(),
                    new.occs.cpu())
    (k2a, k3a, la, ga, oa), (k2s, k3s, ls, gs, os_) = out[False], out[True]
    assert (k2s, k3s) == (k2a, k3a) == (1, 1)
    assert ls == pytest.approx(la, rel=1e-6)
    torch.testing.assert_close(gs, ga, rtol=0, atol=1e-6 * float(ga.abs().max()))
    assert torch.equal(os_, oa)


@pytest.mark.cuda
def test_hash_encoder_index_add_backward_matches_the_cpu(cuda):
    # The tcnn-parity encoder at the reference's 16 levels: forward equal to
    # the CPU's, and the table gradient (index_select's backward, one
    # index_add_ of float32 atomics on the card) within 1e-5 of its largest
    # entry (the atomics add in another order).
    from nerfacc_tpu_torch.models.encoding import HashGridEncoder

    rng = np.random.default_rng(1)
    x = rng.random((1 << 15, 3), dtype=np.float32)
    r = rng.standard_normal((1 << 15, 32)).astype(np.float32)
    res = {}
    for device in (cuda, torch.device("cpu")):
        enc = HashGridEncoder(n_levels=16, log2_hashmap_size=15, device=device, generator=torch.Generator().manual_seed(0))
        out = enc(torch.from_numpy(x).to(device))
        (out * torch.from_numpy(r).to(device)).sum().backward()
        res[device.type] = (out.detach().cpu(), enc.table.grad.cpu())
    (oa, ga), (ob, gb) = res["cuda"], res["cpu"]
    torch.testing.assert_close(oa, ob, rtol=1e-6, atol=1e-10)
    torch.testing.assert_close(ga, gb, rtol=0, atol=1e-5 * float(gb.abs().max()))
    assert float(gb.abs().max()) > 0


def _plugin_step_on_both(cuda, make_field, run_for, update, step_fn, inputs):
    """``step_fn(run, *inputs)`` on the card and on the CPU from the same
    weights, the CPU on the card's grid: two ``update(run, warmup, draws)``
    on the card, warm-up and post-warm-up, each with its draws.  Returns the
    card's K1 and K3 launches, and each device's loss, kept count and
    gradients."""
    from nerfacc_tpu_torch.ops.table_grad import cell_max

    results, state, weights, launches = [], None, None, None
    for device in (cuda, torch.device("cpu")):
        field = make_field(device)
        if weights is None:
            weights = {k: v.detach().cpu().clone() for k, v in field.state_dict().items()}
        field.load_state_dict(weights)
        run = run_for(field, device)
        if device.type == "cuda":
            occupancy_query.launches = cell_max.launches = 0
            for s, warmup in ((0, True), (1, False)):
                update(run, warmup, run.estimator.make_draws(s, torch.Generator().manual_seed(s), warmup_steps=1,
                                                             device=device))
            state = run.occ_state
        else:
            run.occ_state = state.replace(**{f.name: getattr(state, f.name).cpu() for f in dataclasses.fields(state)})
        out = step_fn(run, *(a.to(device) if isinstance(a, torch.Tensor) else a for a in inputs))
        if device.type == "cuda":
            torch.cuda.synchronize()
            launches = (occupancy_query.launches, cell_max.launches)
        results.append((float(out[0]), int(out[1]), {k: p.grad.detach().cpu() for k, p in field.named_parameters()
                                                      if p.grad is not None}))
    return launches, results


def _hold(results, grad_tol=3e-4):
    (loss_c, n_c, g_c), (loss_h, n_h, g_h) = results
    assert n_c == n_h > 0
    assert loss_c == pytest.approx(loss_h, rel=1e-5)
    assert set(g_c) == set(g_h)
    for k in g_h:
        scale = float(g_h[k].abs().max())
        assert float((g_c[k] - g_h[k]).abs().max()) <= grad_tol * scale, k


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.from_numpy(-3.0 * d), torch.from_numpy(d), torch.from_numpy(rng.random((n, 3), dtype=np.float32)),
            torch.from_numpy(rng.random(n, dtype=np.float32)), torch.from_numpy(rng.random((n, 1), dtype=np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tensorf", "kplanes"])
def test_plugin_field_step_launches_k1_and_its_update_k3(cuda, name):
    """train_ngp_nerf_occ --field tensorf|kplanes at the CLI's synthetic
    block (a 128^3 grid over +-1.5): each update's 2^21 and 2^20 draws go
    through K3 once, the step's traversal through K1; the step agrees with
    the CPU (loss rtol 1e-5, gradients 3e-4 of their largest entry)."""
    from nerfacc_tpu_torch.examples import train_ngp_nerf_occ as cli

    cfg = dict(cli.build_config("lego"), target_sample_batch_size=256 * 64)
    est = OccGridEstimator(roi_aabb=cfg["aabb"], resolution=cfg["grid_resolution"], levels=1)

    def make_field(device):
        return cli.make_field(cfg, est, field=name, device=device, generator=torch.Generator().manual_seed(0))

    def run_for(field, device):
        return cli.Run(cfg=cfg, field=field, estimator=est, occ_state=est.init(device),
                       opt=cli.make_optimizer(field, cfg["weight_decay"]), schedule=cli.lr_schedule(20000),
                       generator=torch.Generator())

    o, d, pixels, jitter, _ = _rays(256, 0)
    launches, results = _plugin_step_on_both(
        cuda, make_field, run_for, lambda run, warmup, draws: cli.occ_update(run, warmup, draws), cli.train_step,
        (o, d, pixels, torch.ones(3), jitter))
    assert launches[1] == 2 and launches[0] >= 1
    _hold(results)


@pytest.mark.cuda
def test_tineuvox_step_launches_k1_and_its_update_k3(cuda):
    """train_mlp_tnerf --field tineuvox at the D-NeRF block (a 128^3 grid):
    K3 once an update, K1 in the step; the step agrees with the CPU."""
    from nerfacc_tpu_torch.examples import train_mlp_nerf as mlp_cli
    from nerfacc_tpu_torch.examples import train_mlp_tnerf as cli

    cfg = dict(mlp_cli.build_config(procedural=False, smoke=False), sample_capacity=256 * 48)
    est = OccGridEstimator(roi_aabb=cfg["aabb"], resolution=cfg["grid_resolution"], levels=1)

    def make_field(device):
        return cli.make_field("tineuvox", cfg, smoke=True, device=device, generator=torch.Generator().manual_seed(0))

    def run_for(field, device):
        return mlp_cli.Run(cfg=cfg, field=field, estimator=est, occ_state=est.init(device),
                           opt=torch.optim.Adam(field.parameters(), lr=mlp_cli.LR), generator=torch.Generator())

    o, d, pixels, jitter, times = _rays(256, 1)

    def update(run, warmup, draws):
        probe_times = torch.full((draws[0]["jitter"].shape[0], 1), 0.5, device=cuda)
        cli.occ_update(run, warmup, torch.tensor([0.5], device=cuda), draws, probe_times)

    launches, results = _plugin_step_on_both(cuda, make_field, run_for, update, cli.train_step,
                                             (o, d, times, pixels, torch.ones(3), jitter))
    assert launches[1] == 2 and launches[0] >= 1
    _hold(results)


@pytest.mark.cuda
def test_barf_rays_and_se3_are_the_same_on_the_card_and_the_cpu(cuda):
    from nerfacc_tpu_torch.datasets.procedural import pose_spherical
    from nerfacc_tpu_torch.examples import train_barf as cli
    from nerfacc_tpu_torch.models.barf import rays_from_pixels, se3_exp

    rng = np.random.default_rng(2)
    c2w = np.stack([pose_spherical(t, -0.6, 2.5)[:3] for t in rng.uniform(0, 6.3, 4096)]).astype(np.float32)
    c2w = torch.from_numpy(cli.apply_deltas(rng.normal(0, 0.1, (4096, 6)).astype(np.float32), c2w))
    x, y = (torch.from_numpy(rng.integers(0, 160, 4096).astype(np.float32)) for _ in range(2))
    K = torch.tensor([[144.0, 0, 80], [0, 144.0, 80], [0, 0, 1]])
    on_card = rays_from_pixels(x.to(cuda), y.to(cuda), K.to(cuda), c2w.to(cuda))
    on_cpu = rays_from_pixels(x, y, K, c2w)
    for a, b in zip(on_card, on_cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0)
    xi = torch.from_numpy(rng.normal(0, 0.1, (64, 6)).astype(np.float32))
    torch.testing.assert_close(se3_exp(xi.to(cuda)).cpu(), se3_exp(xi), rtol=0, atol=2e-7)


@pytest.mark.cuda
def test_barf_step_launches_k1_and_matches_the_cpu(cuda):
    """One train_barf step at a small width on a 64^3 grid (its update takes
    the scatter max: 2^18 draws are under K3's 2^19), on the card and the
    CPU: the loss, and the field's and the poses' gradients (the rays'
    gradient through gather_ray_od's index_add_) within 3e-4 of their
    largest entry."""
    from nerfacc_tpu_torch.datasets.procedural import pose_spherical
    from nerfacc_tpu_torch.examples import train_barf as cli
    from nerfacc_tpu_torch.models.barf import BARFRadianceField, PoseRefine
    from nerfacc_tpu_torch.ops.table_grad import cell_max

    rng = np.random.default_rng(3)
    n, n_cams = 256, 6
    gt = np.stack([pose_spherical(t, -0.6, 2.5)[:3] for t in np.linspace(0, 6, n_cams)]).astype(np.float32)
    nominal = torch.from_numpy(cli.noisy_poses(gt, 0.1))
    K = torch.tensor([[144.0, 0, 80], [0, 144.0, 80], [0, 0, 1]])
    cfg = dict(max_steps=100, num_rays=n, samples_per_ray=64, sample_capacity=n * 64, render_step_size=5e-3,
               near_plane=1.3, far_plane=3.7, aabb=np.array([-1, -1, -1, 1, 1, 1], np.float32))
    est = OccGridEstimator(roi_aabb=cfg["aabb"], resolution=64, levels=1)
    batch = (torch.from_numpy(rng.integers(0, n_cams, n)), torch.from_numpy(rng.integers(0, 160, n).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 160, n).astype(np.float32)),
             torch.from_numpy(rng.random((n, 3), dtype=np.float32)), torch.from_numpy(rng.random(3, dtype=np.float32)))
    alpha, jitter = torch.tensor(0.4), torch.from_numpy(rng.random(n, dtype=np.float32))
    results, state = [], None
    for device in (cuda, torch.device("cpu")):
        field = BARFRadianceField(net_depth=2, net_width=64, device=device, generator=torch.Generator().manual_seed(0))
        poser = PoseRefine(n_cams, device=device)
        run = cli.Run(cfg=cfg, field=field, poser=poser, estimator=est, occ_state=est.init(device),
                      opt=cli.make_optimizer(field, poser), nominal=nominal.to(device), K=K.to(device),
                      generator=torch.Generator(), pixel_rng=np.random.default_rng(1))
        if device.type == "cuda":
            occupancy_query.launches = cell_max.launches = 0
            cli.occ_update(run, alpha.to(device), warmup=True,
                           draws=est.make_draws(0, torch.Generator().manual_seed(0), warmup_steps=1, device=device))
            state = run.occ_state
        else:
            run.occ_state = state.replace(**{f.name: getattr(state, f.name).cpu() for f in dataclasses.fields(state)})
        loss, n_samp = cli.train_step(run, *(t.to(device) for t in batch), alpha.to(device), jitter.to(device))
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert cell_max.launches == 0 and occupancy_query.launches >= 1
        grads = {k: p.grad.detach().cpu() for k, p in field.named_parameters()}
        grads["pose_deltas"] = poser.pose_deltas.grad.detach().cpu()
        results.append((float(loss), int(n_samp), grads))
    assert float(results[1][2]["pose_deltas"].abs().max()) > 0
    _hold(results)


@pytest.fixture
def nccl_world_of_one(cuda):
    """A process group of one rank over NCCL, left after the test."""
    import socket

    import torch.distributed as dist

    from nerfacc_tpu_torch.parallel import initialize_distributed, make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert initialize_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl") == (0, 1)
    assert dist.get_backend() == "nccl"
    yield make_mesh(device=cuda)
    dist.destroy_process_group()


def _parallel_setup(cuda):
    """A 1024-ray bf16 step at bench.py's field width on a res-128 shell."""
    from nerfacc_tpu_torch.models.ngp import NGPRadianceField

    est = OccGridEstimator(roi_aabb=[-1.5] * 3 + [1.5] * 3, resolution=128, levels=1, skip_factor=2)
    g = (np.arange(128) + 0.5) / 128 * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    state = est.set_binaries(est.init(cuda), torch.from_numpy(np.abs(np.sqrt(gx**2 + gy**2 + gz**2) - 0.45) < 0.08)[None])
    rng = np.random.default_rng(0)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = [torch.from_numpy(a).to(cuda) for a in (-3.0 * d, d, rng.random((1024, 3), dtype=np.float32),
                                                  rng.random(1024, dtype=np.float32))]

    def make_field():
        field = NGPRadianceField(aabb=[-1.5] * 3 + [1.5] * 3, n_levels=4, n_features_per_level=16, log2_hashmap_size=18,
                                 compute_dtype=torch.bfloat16, device=cuda, generator=torch.Generator().manual_seed(0))
        return field, torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)

    return est, state, batch, make_field


@pytest.mark.cuda
def test_parallel_step_over_nccl_equals_the_plain_step(nccl_world_of_one):
    # A world of one over NCCL: the flattened gradients go through one
    # all-reduce and come back divided by 1, so the step is the plain one's
    # (K1, K2 launched on both), up to the kernels' atomics.
    from nerfacc_tpu_torch.ops import table_grad as tg
    from nerfacc_tpu_torch.parallel import make_parallel_train_step
    from nerfacc_tpu_torch.rendering import gather_ray_od, occgrid_render_rays

    mesh = nccl_world_of_one
    cuda = mesh.device
    est, state, (rays_o, rays_d, pixels, jitter), make_field = _parallel_setup(cuda)
    kw = dict(render_step_size=5e-3, near_plane=0.0, max_macro_segments=4)
    out = []
    for parallel in (True, False):
        field, opt = make_field()
        tg.table_grad_u10.launches = 0
        if parallel:
            step = make_parallel_train_step(field, est, opt, mesh, sample_capacity_per_shard=1 << 15, **kw)
            loss, n = step(state, rays_o, rays_d, pixels, torch.ones(3, device=cuda), jitter=jitter)
        else:
            def rgb_sigma_fn(ts, te, ri):
                o, dd = gather_ray_od(rays_o, rays_d, ri)
                rgb, sigma = field(o + ((ts + te) / 2)[:, None] * dd, dd)
                return rgb, sigma[..., 0]

            colors, _, _, n, _ = occgrid_render_rays(
                rgb_sigma_fn, None, est, state, rays_o, rays_d, render_bkgd=torch.ones(3, device=cuda),
                stratified=True, jitter=jitter, sample_capacity=1 << 15, **kw,
            )
            loss = torch.nn.functional.huber_loss(colors, pixels, delta=1.0)
            opt.zero_grad()
            loss.backward()
            opt.step()
        torch.cuda.synchronize()
        assert tg.table_grad_u10.launches == 1
        out.append((int(n), float(loss), {k: p.grad.cpu() for k, p in field.named_parameters()},
                    {k: p.detach().cpu() for k, p in field.named_parameters()}))
    (n_p, l_p, g_p, p_p), (n_s, l_s, g_s, p_s) = out
    assert n_p == n_s > 0
    assert l_p == pytest.approx(l_s, rel=1e-6)
    for k, g in g_s.items():
        torch.testing.assert_close(g_p[k], g, rtol=0, atol=1e-5 * float(g.abs().max()), msg=k)
        held = (torch.sign(g_p[k]) == torch.sign(g)) & (g.abs() > 1e-9)
        assert float((p_p[k] - p_s[k]).abs()[held].max()) <= 1e-6, k


@pytest.mark.cuda
def test_parallel_update_over_nccl_equals_update(nccl_world_of_one):
    # The max-merge of one rank is the rank's own update (K3 on both), and
    # the derived grids are rebuilt from the merged binaries.
    from nerfacc_tpu_torch.ops import table_grad as tg
    from nerfacc_tpu_torch.parallel import make_parallel_occ_update

    mesh = nccl_world_of_one
    cuda = mesh.device
    est, state, _, make_field = _parallel_setup(cuda)
    field, _ = make_field()
    draws = est.make_draws(10**9, torch.Generator().manual_seed(3), device=cuda)
    tg.cell_max.launches = 0
    got = make_parallel_occ_update(field, est, mesh, render_step_size=5e-3)(state, draws=draws)
    want = est._update(state, 10**9, lambda x: field.query_density(x) * 5e-3, draws=draws)
    torch.cuda.synchronize()
    assert tg.cell_max.launches == 2
    for k in ("occs", "binaries", "binaries_packed", "skip_grid", "skip_packed"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_level_split_lookups_on_the_card_match_the_cpu(cuda, cdt):
    # hash_table_lookup_sized (K5), hash_lookup_combine (K4-w8) and
    # hash_lookup_combine3 (K2 in bf16, K4-w3 in float32) over levels 1 and
    # 2 of a 4-level table: one kernel launch a level on the level's rows,
    # the other levels' rows zero, the table gradient within 1e-5 of the
    # largest entry of the CPU's (the plain versions, float32 sums in
    # another order).
    from nerfacc_tpu_torch.ops import table_grad as tg

    T, m, base, n_levels = 4096, 20000, 1, 2
    rng = np.random.default_rng(30)
    idx = np.concatenate([(base + j) * T + np.concatenate([rng.integers(0, 16, m // 2), rng.integers(0, T, m // 2)])
                          for j in range(n_levels)])
    table = rng.standard_normal((4 * T, 128)).astype(np.float32)
    w8 = rng.standard_normal((idx.size, 8)).astype(np.float32)
    ws = rng.random((3, idx.size), dtype=np.float32)
    split = dict(level_span=T, n_levels=n_levels, level_base=base)
    lookups = (
        ("table_grad_sorted", lambda t, i, d: tg.hash_table_lookup_sized(t, i, 1e-4, cdt, **split), 128, ()),
        ("table_grad_w8", lambda t, i, d, w: tg.hash_lookup_combine(t, i, w, 1e-4, cdt, **split), 16, (w8,)),
        ("table_grad_u10" if cdt else "table_grad_w3",
         lambda t, i, d, *w: tg.hash_lookup_combine3(t, i, *w, 1e-4, cdt, **split), 16, tuple(ws)),
    )
    for wrapper, fn, width, weights in lookups:
        r = rng.standard_normal((idx.size, width)).astype(np.float32)
        grads = []
        for dev in (cuda, torch.device("cpu")):
            t = torch.from_numpy(table).to(dev).requires_grad_(True)
            before = getattr(tg, wrapper).launches
            out = fn(t, torch.from_numpy(idx).to(dev), None, *(torch.from_numpy(w).to(dev) for w in weights))
            (out.float() * torch.from_numpy(r).to(dev)).sum().backward()
            if dev.type == "cuda":
                torch.cuda.synchronize()
                assert getattr(tg, wrapper).launches - before == n_levels, wrapper
            grads.append(t.grad.cpu())
        got, want = grads
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), wrapper
        assert not got[: base * T].any() and not got[(base + n_levels) * T :].any(), wrapper


@pytest.mark.cuda
def test_grouped_scatter_route_on_the_card_matches_the_cpu(cuda):
    # table_grad="scatter" in bf16: autograd's gather backward, no K6, and
    # the positions get their gradient; the card against the CPU within
    # 2e-2 of the largest entry (phase 8's bf16 gate).
    from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderGrouped
    from nerfacc_tpu_torch.ops import table_grad as tg

    rng = np.random.default_rng(31)
    x = rng.uniform(0.0, 1.0, (20000, 3)).astype(np.float32)
    r = rng.standard_normal((20000, 32)).astype(np.float32)
    state = HashGridEncoderGrouped(log2_hashmap_size=12, device="cpu",
                                   generator=torch.Generator().manual_seed(0)).state_dict()
    grads = []
    for dev in (cuda, torch.device("cpu")):
        enc = HashGridEncoderGrouped(log2_hashmap_size=12, compute_dtype=torch.bfloat16, table_grad="scatter",
                                     device=dev)
        enc.load_state_dict(state)
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        before = tg.table_grad_pos.launches
        (enc(xt).float() * torch.from_numpy(r).to(dev)).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert tg.table_grad_pos.launches == before
        grads.append((enc.table.grad.cpu(), xt.grad.cpu()))
    for got, want in zip(*grads):
        assert float(want.abs().max()) > 0
        assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
