"""Datasets: camera rays, the NeRF-Synthetic and D-NeRF loaders and the procedural scenes."""

from .utils import Rays, generate_rays, namedtuple_map

__all__ = ["Rays", "generate_rays", "namedtuple_map"]
