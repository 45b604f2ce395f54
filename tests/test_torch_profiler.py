"""The port's profiler helpers (``utils/profiler.py``) and scripts
(``scripts/run_profiler.py``, ``scripts/capture_trace.py``) on the CPU.

``parse`` is held on a minimal Chrome trace of ``torch.profiler``'s layout,
as ``tests/test_utils.py:97`` holds the JAX script's on the XLA layout: the
device events (kernels, copies, sets) are summed by name a step, the host
events and the ranges' annotation spans are left out.
"""

import json

import pytest
import torch

from nerfacc_tpu_torch.scripts import capture_trace, run_profiler
from nerfacc_tpu_torch.utils import profiler


def test_time_jitted_returns_a_positive_time(capsys):
    x = torch.ones(128)
    dt = profiler.time_jitted(lambda v: v * 2 + 1, x, warmup=1, iters=3, name="axpy")
    assert dt > 0
    assert "axpy:" in capsys.readouterr().out


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiler.trace(str(tmp_path / "t")) as logdir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert logdir == str(tmp_path / "t")
    assert any(e.get("name") == "aten::mm" for e in events)


def _event(name, cat, dur, ts=0):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur}


def test_parse_sums_device_events_and_leaves_host_events_out(tmp_path, capsys):
    trace = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python"}},
        _event("occ_query_kernel", "kernel", 3000.0, 0),
        _event("occ_query_kernel", "kernel", 3000.0, 10),
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1000.0, 20),
        _event("Memset (Device)", "gpu_memset", 500.0, 30),
        # host events and range labels
        _event("aten::add", "cpu_op", 9999.0),
        _event("cudaLaunchKernel", "cuda_runtime", 9999.0),
        _event("backward", "gpu_user_annotation", 9999.0),
        _event("ProfilerStep#1", "user_annotation", 9999.0),
        {"ph": "f", "cat": "ac2g", "name": "launch", "id": 1},
    ]}
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "trace.json").write_text(json.dumps(trace))
    table = capture_trace.parse(str(tmp_path), top=5, steps=3)
    out = capsys.readouterr().out
    assert "total device kernel time: 2.50 ms/step" in out  # (6000 + 1000 + 500) us / 1e3 / 3
    assert "occ_query_kernel" in out and "aten::add" not in out and "backward" not in out
    assert table == pytest.approx({"occ_query_kernel": 2.0, "Memcpy HtoD (Pageable -> Device)": 1 / 3,
                                   "Memset (Device)": 0.5 / 3})
    assert capture_trace.parse(str(tmp_path / "none"), top=5, steps=3) == {}


def test_run_profiler_times_every_stage_on_the_cpu(capsys):
    times = run_profiler.main(["--device", "cpu", "--rays", "64", "--capacity", "1024", "--grid_res", "16",
                               "--log2t", "10", "--levels", "2", "--iters", "1"])
    assert set(times) == set(run_profiler.STAGES)
    assert all(t > 0 for t in times.values())
    out = capsys.readouterr().out
    assert all(name in out for name in run_profiler.STAGES) and "samples/s" in out


def test_capture_trace_on_the_cpu_records_no_device_time(tmp_path, capsys):
    table = capture_trace.main(["--device", "cpu", "--rays", "64", "--capacity", "1024", "--grid_res", "16",
                                "--log2t", "10", "--levels", "2", "--steps", "1", "--occ-update",
                                "--out", str(tmp_path)])
    assert table == {}
    assert (tmp_path / "trace.json").exists()
    assert "total device kernel time: 0.00 ms/step" in capsys.readouterr().out


def test_the_scripts_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for script in (run_profiler, capture_trace):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            script.main(["--rays", "8", "--capacity", "64"])
