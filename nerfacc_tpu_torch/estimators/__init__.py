from .occ_grid import OccGridEstimator, OccGridState

__all__ = ["OccGridEstimator", "OccGridState"]
