"""A new cell added from new files alone: a configuration, a traffic mix,
a per-layer metric, its limits and a pipeline, each a new file, and new
entries in ``BENCHMARK.json``; no existing file of the harness changes.
The cell runs once on the CPU at a tiny size, traced."""

from __future__ import annotations

import json
import time

import torch

from nerfbench.registry import Benchmark
from nerfbench.run import run_cell
from nerfbench.tests.tiny import make_root

PIPELINE = '''
from nerfbench.pipelines.occ import Cell as OccCell


class Cell(OccCell):
    """The occupancy pipeline, counting its segments."""

    def segment(self):
        self.segments = getattr(self, "segments", 0) + 1
        return super().segment()
'''

READER = '''
def read(ctx):
    return ctx["steps"] * 1.0
'''


def test_a_cell_made_of_new_files_runs(tmp_path):
    root = make_root(tmp_path)
    nb = root / "nerfbench"
    cfg = json.loads((nb / "configs" / "ngp_occ_synthetic.json").read_text())
    cfg.update(pipeline="occ_counted", init_num_rays=32)
    (nb / "configs" / "ngp_occ_dummy.json").write_text(json.dumps(cfg))
    (nb / "traffic" / "train_short.json").write_text(json.dumps(
        {"task": "train", "background": "white", "checked_steps": 2, "trace_steps": 2, "eval_chunk": 128}))
    (nb / "metrics" / "traced_steps.dummy.py").write_text(READER)
    (nb / "limits" / "ngp_occ.dummy.json").write_text(json.dumps(
        {"limits": {"colour_gap": 1e-3, "loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-3}}))
    (nb / "pipelines").mkdir()
    (nb / "pipelines" / "occ_counted.py").write_text(PIPELINE)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "ngp_occ_dummy", "source": "a test", "file": "nerfbench/configs/ngp_occ_dummy.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "ngp_occ.dummy", "config": "ngp_occ_dummy", "traffic": "train_short",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("train_samples_per_s.occ", "eval_psnr_db.occ"):
            m["workloads"].append("ngp_occ.dummy")
    spec["per_layer"].append({"name": "traced_steps.dummy", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "CLI loop", "moves": "train_samples_per_s.occ",
                              "workloads": ["ngp_occ.dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Benchmark(root)
    wl = bench.workload("ngp_occ.dummy")
    out = run_cell(bench, wl, 2**31 + 77, 0.5, 1, torch.device("cpu"), time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["metrics"]["traced_steps.dummy"]["value"] == 2.0
    assert "train_samples_per_s.occ" not in out["metrics"]  # a traced run reports the per-layer metrics
    assert out["attempted"] > 0 and out["failed"] == 0
    out = run_cell(bench, wl, 2**31 + 78, 0.5, 0, torch.device("cpu"), time.perf_counter())
    assert set(out["metrics"]) == {"train_samples_per_s.occ", "eval_psnr_db.occ", "setup_s"}
    assert list(out)[-1] == "checks"
