"""Datasets: camera rays, the NeRF-Synthetic loader and the procedural scene."""

from .utils import Rays, generate_rays, namedtuple_map

__all__ = ["Rays", "generate_rays", "namedtuple_map"]
