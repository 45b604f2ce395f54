"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is no card.

    Entry points default to ``device="cuda"``; without a card they raise here
    instead of silently running on the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device
