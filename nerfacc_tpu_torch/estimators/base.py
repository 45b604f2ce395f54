"""Estimator base (port of ``nerfacc_tpu/estimators/base.py``).

As in the JAX package, an estimator is a static configuration object and
its state is a separate value that methods take and return.
"""

from __future__ import annotations


class AbstractEstimator:
    """Base class for sampling-policy estimators."""

    def init(self, device="cuda"):
        """Build the initial estimator state on ``device``."""
        raise NotImplementedError
