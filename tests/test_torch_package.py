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
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "nerfacc_tpu"}


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
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py"]
    assert len(files) > 10
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
    from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderFused
    from nerfacc_tpu_torch.models.ngp import NGPRadianceField

    aabb = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NGPRadianceField(aabb=aabb, n_levels=2, log2_hashmap_size=12)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HashGridEncoderFused(n_levels=2, log2_hashmap_size=9)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OccGridEstimator(roi_aabb=aabb, resolution=8).init()
    K = np.array([[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]], np.float32)
    xs, ys = np.meshgrid(np.arange(8), np.arange(8), indexing="xy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_rays(xs, ys, K, np.eye(4, dtype=np.float32)[:3])
    # The same calls run on the CPU when asked.
    assert OccGridEstimator(roi_aabb=aabb, resolution=8).init("cpu").binaries.device.type == "cpu"
