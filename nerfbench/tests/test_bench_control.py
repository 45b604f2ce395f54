"""The control on the card, at a size a test run holds: the program with
its TF32 path switched on reads well above the same seeds' sound runs on
at least one compared number.  The cells' own limits come from
``python3 -m nerfbench.calibrate`` at their full size (see PERF.md).

    python -m pytest nerfbench/tests/test_bench_control.py -m cuda   # on the card
"""

from __future__ import annotations

import pytest
import torch

from nerfbench.calibrate import reading
from nerfbench.registry import Benchmark
from nerfbench.tests.tiny import make_root


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ngp_occ.train", "ngp_prop.train"])
def test_tf32_control_reads_above_sound_runs(tmp_path, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control is TF32 matmuls, which the CPU does not have")
    bench = Benchmark(make_root(tmp_path))
    device = torch.device("cuda", 0)
    seeds = [2**31 + 301, 2**31 + 302, 2**31 + 303]
    views = None
    sound, control = [], []
    for seed in seeds:
        numbers, views, _ = reading(bench, workload, seed, "sound", device, views)
        sound.append(numbers)
        numbers, views, _ = reading(bench, workload, seed, "tf32", device, views)
        control.append(numbers)
    for s, c in zip(sound, control):
        assert any(c[k] > 3 * max(x[k] for x in sound) for k in c), (s, c)
