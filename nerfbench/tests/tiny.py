"""A copy of the benchmark's data files under a temporary root, with the
configurations cut to a size the CPU runs in seconds (widths of the hash
tables and views cut; the macro stride kept at 18 ladder steps by a
coarser grid and step)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DATA = ("configs", "traffic", "limits", "metrics")


def make_root(tmp: Path) -> Path:
    root = Path(tmp)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for d in DATA:
        shutil.copytree(REPO / "nerfbench" / d, root / "nerfbench" / d)
    for name in ("ngp_occ_synthetic", "ngp_prop_synthetic"):
        path = root / "nerfbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["field"]["encoding"].update(n_levels=4, log2_hashmap_size=12)
        cfg["scene"].update(width=32, height=32, n_train_views=4, n_test_views=1)
        if "prop_field" in cfg:
            cfg["prop_field"]["encoding"].update(n_levels=2, log2_hashmap_size=10, max_resolution=32)
            cfg.update(num_rays=64, num_samples=16, prop_samples=[32])
        else:
            cfg.update(init_num_rays=64, num_rays=512, target_sample_batch_size=8192, traversal_capacity=1 << 14,
                       grid_resolution=16, render_step_size=0.04)
        path.write_text(json.dumps(cfg))
    tpath = root / "nerfbench" / "traffic" / "train_from_scratch.json"
    traffic = json.loads(tpath.read_text())
    traffic.update(eval_chunk=256, trace_steps=4)
    tpath.write_text(json.dumps(traffic))
    for lpath in (root / "nerfbench" / "limits").glob("*.json"):
        limits = json.loads(lpath.read_text())
        # The cells' limits hold at their own sizes; at this size the
        # checks hold the tiny cells to 1e-3.
        limits["limits"] = {k: 1e-3 for k in limits["limits"]}
        lpath.write_text(json.dumps(limits))
    return root
