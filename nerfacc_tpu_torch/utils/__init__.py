"""Checkpoints and image metrics (the profiler helpers are not ported yet)."""

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .lpips import lpips
from .metrics import lpips_or_none, ms_ssim, psnr, ssim

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "psnr",
    "ssim",
    "ms_ssim",
    "lpips",
    "lpips_or_none",
]
