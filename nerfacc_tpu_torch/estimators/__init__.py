from .base import AbstractEstimator
from .occ_grid import OccGridEstimator, OccGridState
from .prop_net import PropNetEstimator, get_proposal_requires_grad_fn

__all__ = ["OccGridEstimator", "OccGridState", "PropNetEstimator", "get_proposal_requires_grad_fn"]
