"""Checkpoint and resume for train states (parameters, optimizer state,
occupancy state, step).

Port of ``nerfacc_tpu/utils/checkpoint.py`` on ``torch.save``/``torch.load``,
with the same layout: a directory holding one file a step
(``step_{step}.pt``) and a ``latest`` marker naming the newest step.  A
state is a nest of dicts, lists and tuples whose leaves are tensors and
Python numbers (a ``state_dict``, for instance); it is read back with
``weights_only=True``, so loading runs no pickled code.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch


def _to_cpu(state: Any) -> Any:
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, dict):
        return {k: _to_cpu(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_cpu(v) for v in state)
    return state


def save_checkpoint(path: str, state: Any, step: int) -> None:
    """Save ``state`` at ``step`` under the directory ``path``; the file is
    written whole before ``latest`` names it."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step}.pt")
    tmp = final + ".tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, final)
    marker = os.path.join(path, "latest")
    with open(marker + ".tmp", "w") as f:
        f.write(str(step))
    os.replace(marker + ".tmp", marker)


def latest_step(path: str) -> Optional[int]:
    """The newest saved step under ``path``, or None."""
    marker = os.path.join(path, "latest")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return int(f.read().strip())


def _like(saved: Any, target: Any, where: str) -> Any:
    """``saved`` with each tensor moved to the device and dtype of the
    tensor at the same place in ``target``, whose structure it must have."""
    if target is None:
        return saved
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != target.shape:
            got = tuple(saved.shape) if isinstance(saved, torch.Tensor) else type(saved).__name__
            raise ValueError(f"checkpoint {where}: {got}, expected shape {tuple(target.shape)}")
        return saved.to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            raise ValueError(f"checkpoint {where}: keys differ from the target's")
        return {k: _like(saved[k], target[k], f"{where}/{k}") for k in target}
    if isinstance(target, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(target):
            raise ValueError(f"checkpoint {where}: length differs from the target's")
        return type(target)(_like(s, t, f"{where}/{i}") for i, (s, t) in enumerate(zip(saved, target)))
    return saved


def restore_checkpoint(path: str, target: Any) -> Tuple[Any, int]:
    """Restore the newest checkpoint under ``path`` into the structure of
    ``target`` (tensors on the target's devices and dtypes; ``None`` returns
    the saved state on the CPU).  Returns ``(state, step)``.

    Raises FileNotFoundError if nothing has been saved.
    """
    step = latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    saved = torch.load(os.path.join(path, f"step_{step}.pt"), map_location="cpu", weights_only=True)
    return _like(saved, target, ""), step
