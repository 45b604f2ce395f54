"""D-NeRF (dynamic Blender) dataset loader.

Port of ``nerfacc_tpu/datasets/dnerf_synthetic.py``: the NeRF-Synthetic
format plus a per-frame ``time`` in ``[0, 1]`` (``i / (n - 1)`` for a frame
without one), threaded through each ray batch as ``timestamps``: ``(n, 1)``
for a training batch, ``(H, W, 1)`` for an eval image; a batch from the
native sampler takes each ray's view from the sampler's seed
(``_native_image_ids``), as the JAX loader does.  PNGs are read by the
port's own decoder, through the static loader.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from .nerf_synthetic import SubjectLoader as _StaticLoader


def _load_timestamps(root_fp: str, subject_id: str, split: str) -> np.ndarray:
    """Each frame's time in ``transforms_<split>.json``, or ``i / (n - 1)``
    where a frame has none (``dnerf_synthetic.py:20-40``)."""
    with open(os.path.join(root_fp, subject_id, f"transforms_{split}.json")) as fp:
        frames = json.load(fp)["frames"]
    n = len(frames)
    return np.asarray([f["time"] if "time" in f else float(i) / (n - 1) for i, f in enumerate(frames)], np.float32)


class SubjectLoader(_StaticLoader):
    """D-NeRF subject loader: the static loader plus per-frame timestamps
    (``dnerf_synthetic.py:43-82``), read from disk with the frames, or given
    with ``images=`` as ``timestamps=``."""

    def __init__(
        self,
        subject_id: str = "",
        root_fp: str = "",
        split: str = "train",
        timestamps: Optional[np.ndarray] = None,
        **kwargs,
    ):
        if kwargs.get("images") is None and root_fp:
            splits = ["train", "val"] if split == "trainval" else [split]
            timestamps = np.concatenate([_load_timestamps(root_fp, subject_id, s) for s in splits])
        super().__init__(subject_id=subject_id, root_fp=root_fp, split=split, **kwargs)
        if timestamps is None:
            raise ValueError("the dynamic loader needs timestamps")
        self.timestamps = np.asarray(timestamps, np.float32)

    def fetch_data(self, index: int) -> dict:
        batch = super().fetch_data(index)
        ts = self.timestamps[self._last_image_id][:, None]
        if not self.training:
            ts = ts.reshape(self.HEIGHT, self.WIDTH, 1)
        batch["timestamps"] = torch.from_numpy(ts).to(self.device)
        return batch
