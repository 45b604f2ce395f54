"""The PyTorch port stands alone: no JAX, no JAX package, card-first entry
points."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "nerfacc_tpu_torch"
# The card's machine has no imageio and no PIL either.
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "nerfacc_tpu", "imageio", "PIL"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    # test_torch_cuda.py runs on the card's machine, which has no JAX.
    files = sorted(PKG.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "kernel_variants.py", REPO / "tests" / "test_torch_cuda.py",
    ]
    assert len(files) > 10
    names = {str(f.relative_to(REPO)) for f in files}
    for new in ("datasets/colmap.py", "datasets/jpeg.py", "datasets/nerf_360_v2.py", "datasets/_native.py",
                "utils/profiler.py", "scripts/run_profiler.py", "scripts/capture_trace.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/multihost.py", "parallel/train.py", "scripts/bench_scaling.py"):
        assert f"nerfacc_tpu_torch/{new}" in names, new
    bad = {
        str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & FORBIDDEN)
        for f in files
    }
    assert {k: v for k, v in bad.items() if v} == {}


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import nerfacc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "loaded = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "print(loaded)\n"
        "sys.exit(1 if loaded else 0)\n"
    )
    # -I: no PYTHONPATH or site hooks that could import JAX on their own.
    r = subprocess.run(
        [sys.executable, "-I", "-c", code], capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the CUDA default is valid here")
    from nerfacc_tpu_torch.datasets.utils import generate_rays
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderFused, HashGridEncoderGrouped
    from nerfacc_tpu_torch.estimators.prop_net import PropNetEstimator
    from nerfacc_tpu_torch.models.ngp import NGPDensityField, NGPRadianceField

    aabb = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NGPRadianceField(aabb=aabb, n_levels=2, log2_hashmap_size=12)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NGPDensityField(aabb=aabb, log2_hashmap_size=12)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PropNetEstimator().sampling([], [], 8, 4, 0.2, 1e3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HashGridEncoderFused(n_levels=2, log2_hashmap_size=9)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HashGridEncoderGrouped(log2_hashmap_size=9)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OccGridEstimator(roi_aabb=aabb, resolution=8).init()
    K = np.array([[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]], np.float32)
    xs, ys = np.meshgrid(np.arange(8), np.arange(8), indexing="xy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_rays(xs, ys, K, np.eye(4, dtype=np.float32)[:3])
    # The same calls run on the CPU when asked.
    assert OccGridEstimator(roi_aabb=aabb, resolution=8).init("cpu").binaries.device.type == "cpu"


def _all_names(path: Path) -> list:
    """The string list assigned to ``__all__`` in ``path``, read with ast."""
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


def test_the_port_exports_the_jax_package_public_names():
    # The JAX package's list is read from its source, so that this test
    # imports nothing of JAX.
    want = _all_names(REPO / "nerfacc_tpu" / "__init__.py")
    assert len(want) == 27
    import nerfacc_tpu_torch

    assert nerfacc_tpu_torch.__all__ == want
    missing = [n for n in want if not hasattr(nerfacc_tpu_torch, n)]
    assert missing == []
    assert nerfacc_tpu_torch.inclusive_sum.__module__ == "nerfacc_tpu_torch.scan"


def test_the_port_utils_export_the_jax_package_utils_names():
    want = _all_names(REPO / "nerfacc_tpu" / "utils" / "__init__.py")
    assert "time_jitted" in want and "trace" in want
    import nerfacc_tpu_torch.utils as utils

    assert utils.__all__ == want
    assert [n for n in want if not hasattr(utils, n)] == []
    assert utils.trace.__module__ == utils.time_jitted.__module__ == "nerfacc_tpu_torch.utils.profiler"


def _variants_match_their_source(monkeypatch, kernel, n_variants):
    # kernel_variants.py changes a kernel by text substitutions: each must
    # still find its text, or the script times something else.
    monkeypatch.syspath_prepend(str(REPO))
    import kernel_variants

    source, variants = kernel_variants.VARIANTS[kernel]
    src = (PKG / "csrc" / f"{source}.cu").read_text()
    assert len(variants) == n_variants
    for name, _, subs in variants:
        text = src
        for old, new in subs:
            if old is None:  # the whole source replaced
                text = new
                continue
            assert old in text, (name, old)
            text = text.replace(old, new)


def test_k6_variant_substitutions_match_the_kernel_source(monkeypatch):
    _variants_match_their_source(monkeypatch, "k6", 5)


def test_k2_variant_substitutions_match_the_kernel_source(monkeypatch):
    _variants_match_their_source(monkeypatch, "k2", 8)


def test_k4_variant_substitutions_match_the_kernel_source(monkeypatch):
    _variants_match_their_source(monkeypatch, "k4", 6)


def test_k1_variant_substitutions_match_the_kernel_source(monkeypatch):
    _variants_match_their_source(monkeypatch, "k1", 6)


def test_k3_variant_substitutions_match_the_kernel_source(monkeypatch):
    _variants_match_their_source(monkeypatch, "k3", 19)


def test_the_port_parallel_exports_the_jax_package_parallel_names():
    # The 13 names of nerfacc_tpu/parallel/__init__.py, each documented with
    # its JAX counterpart's file and lines.
    want = _all_names(REPO / "nerfacc_tpu" / "parallel" / "__init__.py")
    assert len(want) == 13
    import nerfacc_tpu_torch.parallel as parallel

    assert parallel.__all__ == want
    for name in want:
        doc = getattr(parallel, name).__doc__
        assert doc and any(f"{m}.py:" in doc for m in ("mesh", "multihost", "train")), name
