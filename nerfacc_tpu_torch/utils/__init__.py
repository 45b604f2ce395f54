"""Checkpoints, image metrics and the profiler helpers."""

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .lpips import lpips
from .metrics import lpips_or_none, ms_ssim, psnr, ssim
from .profiler import time_jitted, trace

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "time_jitted",
    "trace",
    "psnr",
    "ssim",
    "ms_ssim",
    "lpips",
    "lpips_or_none",
]
