"""Datasets: camera rays, the NeRF-Synthetic, D-NeRF and Mip-NeRF 360 loaders, the
COLMAP, PNG and JPEG readers, the native ray sampler and the procedural scenes."""

from .utils import Rays, generate_rays, namedtuple_map

__all__ = ["Rays", "generate_rays", "namedtuple_map"]
