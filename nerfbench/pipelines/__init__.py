"""One module a pipeline, named by a configuration's ``pipeline`` key.

A module defines ``Cell(cfg, traffic, seed, device)`` with ``setup()``
(the checked first steps and the warm-up), ``segment()`` (a stretch of the
timed work; returns the work units it completed), ``window_context()``
(the window's counts, for the per-layer readers), ``after_window()`` (what
the pipeline checks past the window, before any trace), ``trace_slice()``
(the traced steps; returns what the per-layer readers need),
``evaluate()``, ``release()`` (frees the program's state) and
``reference()`` (the compared numbers, named as the cell's limits file
names them); ``work_metric`` names the end-to-end rate, and ``attempted``
and ``failed`` count the window's work.
"""

import gc
import time

import torch

LATE_SEGMENTS = 16  # the window's last segments that time an untraced step


def ngp_kwargs(f: dict) -> dict:
    """A configuration's field block as the program's NGP field
    constructors take it."""
    enc = f["encoding"]
    kw = dict(encoder_type=f["encoder_type"], n_levels=enc["n_levels"],
              n_features_per_level=enc["n_features_per_level"], log2_hashmap_size=enc["log2_hashmap_size"],
              base_resolution=enc["base_resolution"], max_resolution=enc["max_resolution"], mlp_width=f["mlp_width"])
    if f["geo_feat_dim"]:
        kw["geo_feat_dim"] = f["geo_feat_dim"]
    return kw


class TrainingCell:
    """What the training pipelines share: the window's losses, and freeing
    the program's run and loader before the reference runs."""

    losses: list
    marks: list  # (host time, step) as each of the window's segments starts

    def mark(self, step: int) -> None:
        self.marks.append((time.perf_counter(), step))

    def late_step_s(self, step: int):
        """Wall seconds a step over the window's last segments, up to now
        (called as the window closes, after its synchronize)."""
        self.mark(step)
        if len(self.marks) < 2:
            return None
        (t0, s0), (t1, s1) = self.marks[-1 - min(LATE_SEGMENTS, len(self.marks) - 1)], self.marks[-1]
        return (t1 - t0) / (s1 - s0)

    @property
    def attempted(self) -> int:
        return len(self.losses)

    @property
    def failed(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def after_window(self) -> None:
        pass

    def release(self) -> None:
        del self.run, self.train_ds
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
