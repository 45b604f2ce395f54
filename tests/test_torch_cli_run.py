"""Checkpoints, and the port's CLIs run end to end on the CPU.

- ``utils/checkpoint.py``: the round trip, the newest step winning and the
  error without a checkpoint (``tests/test_utils.py:19,45`` on the port),
  and restoring into a target's devices and shapes.
- The save-and-resume scenario of ``tests/test_utils.py:54`` in process:
  ``train_ngp_nerf_occ --smoke --device cpu --num_rays 256`` for 20 steps,
  then resumed to 25; the render CLI on that checkpoint; a few steps of
  ``train_ngp_nerf_prop --smoke``.

The procedural views are rendered once per size for the whole file (each
CLI run would render the same views from the same seed).
"""

import os

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch.datasets import procedural as tproc
from nerfacc_tpu_torch.datasets.png import read_png
from nerfacc_tpu_torch.examples import render as render_cli
from nerfacc_tpu_torch.examples import train_ngp_nerf_occ as occ_cli
from nerfacc_tpu_torch.examples import train_ngp_nerf_prop as prop_cli
from nerfacc_tpu_torch.utils import latest_step, restore_checkpoint, save_checkpoint

_VIEWS = {}


@pytest.fixture
def views_once(monkeypatch):
    generate = tproc.generate_dataset

    def cached(**kw):
        key = tuple(sorted(kw.items(), key=lambda kv: kv[0]))
        if key not in _VIEWS:
            _VIEWS[key] = generate(**kw)
        return _VIEWS[key]

    monkeypatch.setattr(tproc, "generate_dataset", cached)


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)},
        "step_stats": torch.tensor([1, 2, 3]),
        "opt": {"lr": 0.01, "betas": (0.9, 0.999), "state": {0: {"step": torch.tensor(5.0)}}},
    }
    d = str(tmp_path)
    save_checkpoint(d, state, step=120)
    assert latest_step(d) == 120
    restored, step = restore_checkpoint(d, state)
    assert step == 120
    torch.testing.assert_close(restored["params"]["w"], state["params"]["w"])
    torch.testing.assert_close(restored["step_stats"], state["step_stats"])
    assert restored["opt"]["betas"] == (0.9, 0.999) and float(restored["opt"]["state"][0]["step"]) == 5.0
    # The newer checkpoint wins.
    state2 = {**state, "params": {k: v + 1 for k, v in state["params"].items()}}
    save_checkpoint(d, state2, step=240)
    restored2, step2 = restore_checkpoint(d, state2)
    assert step2 == 240
    torch.testing.assert_close(restored2["params"]["b"], state["params"]["b"] + 1)
    assert sorted(os.listdir(d)) == ["latest", "step_120.pt", "step_240.pt"]
    # Restored into the target's dtype; a shape that differs is refused.
    as_f64, _ = restore_checkpoint(d, {**state2, "params": {k: v.double() for k, v in state2["params"].items()}})
    assert as_f64["params"]["w"].dtype == torch.float64
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, {**state2, "params": {"w": torch.zeros(4, 3), "b": torch.zeros(4)}})


def test_checkpoint_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), {})


def test_cli_save_resume_render(tmp_path, views_once, capsys):
    ckpt = str(tmp_path / "ckpt")
    base = ["--smoke", "--device", "cpu", "--model_path", ckpt, "--num_rays", "256"]
    psnr_20 = occ_cli.main(base + ["--max_steps", "20"])
    assert latest_step(ckpt) == 20
    assert np.isfinite(psnr_20)
    saved, _ = restore_checkpoint(ckpt, None)
    assert set(saved) == {"params", "opt_state", "occ_state"}
    assert int(saved["opt_state"]["state"][0]["step"]) == 21  # steps 0 to 20
    capsys.readouterr()

    psnr_25 = occ_cli.main(base + ["--max_steps", "25", "--resume"])
    out = capsys.readouterr().out
    assert f"resumed from {ckpt} at step 20" in out
    assert latest_step(ckpt) == 25
    assert np.isfinite(psnr_25)
    resumed, _ = restore_checkpoint(ckpt, None)
    # The resumed run went on from the saved optimizer state: steps 20 to 25.
    assert int(resumed["opt_state"]["state"][0]["step"]) == 27
    torch.testing.assert_close(resumed["occ_state"]["aabbs"], saved["occ_state"]["aabbs"])

    out_dir = str(tmp_path / "views")
    psnr_r = render_cli.main(["--model_path", ckpt, "--device", "cpu", "--max_samples", "256", "--out", out_dir])
    out = capsys.readouterr().out
    assert "restored step 25" in out and "rays/s" in out
    assert np.isfinite(psnr_r) and psnr_r > 10.0
    for i in range(2):
        img = read_png(os.path.join(out_dir, f"view_{i}.png"))
        assert img.shape == (96, 96, 3) and img.dtype == np.uint8


def test_prop_cli_smoke(views_once, capsys):
    psnr = prop_cli.main(["--smoke", "--device", "cpu", "--max_steps", "3"])
    out = capsys.readouterr().out
    assert np.isfinite(psnr) and psnr > 10.0
    assert "lpips(rnd)" in out and "prop_loss=" in out
