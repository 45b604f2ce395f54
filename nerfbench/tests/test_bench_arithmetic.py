"""The harness's own arithmetic on a small recorded trace (device time by
range, the unattributed share, the idle share, host time in a span), the
model-FLOP count, and finding a cell's pieces by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from nerfbench.flops import field_flops
from nerfbench.registry import Benchmark
from nerfbench.traceread import TraceStats, load

REPO = Path(__file__).resolve().parents[2]


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def _launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2, "pid": 1,
            "tid": tid, "args": {"correlation": corr}}


def _kernel(corr, ts, dur, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


EVENTS = [
    _span("nerfbench.window", 0, 1000),
    _span("traverse_and_compact", 10, 100), _launch(1, 20), _kernel(1, 50, 30, "occ_query"),
    _launch(7, 25), _kernel(7, 55, 10, "cumsum"),
    _span("field_forward", 150, 100), _launch(2, 160), _kernel(2, 200, 40, "gemm"),
    _span("fetch", 300, 50),
    _launch(3, 400, tid=2), _kernel(3, 420, 100, "index_add"),
    _span("optimizer", 600, 50), _span("Optimizer.step#Adam.step", 605, 40), _launch(4, 610), _kernel(4, 620, 10),
    _span("Optimizer.step#Adam.step", 690, 30), _launch(5, 700), _kernel(5, 710, 20),
    _launch(6, 1500), _kernel(6, 1510, 500),
]


@pytest.fixture
def stats(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return TraceStats(load(str(path)))


def test_device_time_by_range(stats):
    assert stats.device_ms("traverse_and_compact") == pytest.approx(0.040)
    assert stats.device_ms("field_forward") == pytest.approx(0.040)
    assert stats.device_ms("optimizer") == pytest.approx(0.010)
    assert stats.device_ms("prop_sampling") is None  # no such span: nothing to read


def test_unattributed_is_autograd_thread_and_torch_ranges_alone(stats):
    assert stats.unattributed_ms() == pytest.approx(0.120)


def test_busy_and_idle_share(stats):
    assert stats.window_s == pytest.approx(1e-3)
    assert stats.busy_s == pytest.approx(200e-6)  # 30 + 40 + 100 + 10 + 20 us, overlap counted once


def test_idle_share_and_mfu_against_the_untraced_window(stats):
    from nerfbench.metrics_common import idle_share, window_mfu

    # 200 us busy over 4 traced steps against 80 us a step untraced: the
    # traced slice's own wall time (1 ms) does not enter.
    ctx = {"trace": stats, "steps": 4, "late_step_s": 80e-6, "window_flops": 6.7e12, "window_s": 10.0,
           "peaks": {"float32_flops": 67e12}}
    assert idle_share(ctx) == pytest.approx(37.5)
    assert window_mfu(ctx) == pytest.approx(1.0)
    assert idle_share({**ctx, "late_step_s": None}) is None and window_mfu({**ctx, "window_flops": None}) is None


def test_late_step_time_from_the_window_marks(monkeypatch):
    from nerfbench import pipelines

    cell = pipelines.TrainingCell()
    cell.marks = [(float(t), 16 * t) for t in range(20)]  # a segment of 16 steps a second
    monkeypatch.setattr(pipelines.time, "perf_counter", lambda: 21.0)
    assert cell.late_step_s(320) == pytest.approx((21.0 - 4.0) / (320 - 64))


def test_host_time_in_a_span(stats):
    assert stats.host_ms("fetch") == pytest.approx(0.050)
    assert stats.host_ms("nothing") is None


def test_breakdown_lists(stats):
    assert stats.top_kernels(1) == [["index_add", pytest.approx(100e-6)]]
    gaps = stats.idle_gaps(2)
    assert gaps[0][1] == pytest.approx(270e-6) and len(gaps) == 2


def test_model_flops_of_the_ngp_fields():
    bench = Benchmark(REPO)
    occ = bench.config("ngp_occ_synthetic")
    prop = bench.config("ngp_prop_synthetic")
    # 16 levels x 8 corners x 2 features x 2; 32 -> 64 -> 16; 31 -> 64 -> 64 -> 3.
    assert field_flops(occ["field"]) == 512 + 6144 + 12544
    assert field_flops(occ["field"], colour=False) == 512 + 6144
    assert field_flops(prop["prop_field"]) == 160 + 2 * (10 * 64 + 64)


def test_every_piece_of_every_cell_is_found_by_name():
    bench = Benchmark(REPO)
    for wl in bench.spec["workloads"]:
        cfg = bench.config(wl["config"])
        assert bench.traffic(wl["traffic"])["task"] == "train"
        early = {"colour_gap", "loss_gap", "grad_gap", "change_gap"}
        late = {"late_" + k for k in ("occs_gap", "flip_share", "colour_gap", "loss_gap", "grad_gap", "change_gap")}
        assert set(bench.limits(wl["name"])["limits"]) == (early | late if cfg["pipeline"] == "occ" else early)
        from nerfbench.registry import pipeline

        assert hasattr(pipeline(cfg["pipeline"]), "Cell")
        for m in bench.metrics("per_layer", wl["name"]):
            assert callable(bench.reader(m["name"]))
    with pytest.raises(KeyError):
        bench.workload("no_such.cell")


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_file_keeps_to_its_form():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in spec["end_to_end"])
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in spec["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
