"""PyTorch + CUDA port of ``nerfacc_tpu`` for NVIDIA Hopper (H100).

Module names mirror the JAX package, so ``nerfacc_tpu_torch.grid`` is the
counterpart of ``nerfacc_tpu.grid``.  The port imports ``torch`` and numpy
only.  Entry points take an explicit ``device=`` (default ``"cuda"``) and
raise when no card is present; pass ``device="cpu"`` to run on the CPU,
where every kernel wrapper uses its plain PyTorch version.  On a CUDA
tensor a wrapper launches its hand-written kernel (``csrc/``), built with
``nvcc`` at first use into ``build/nerfacc_tpu_torch/``.

Ported so far: the occupancy-grid inference renderer
(:func:`~nerfacc_tpu_torch.rendering.occgrid_render_rays_test`) and the
NGP-occ train step (:func:`~nerfacc_tpu_torch.rendering.occgrid_render_rays`
with the NGP field's backward and the occupancy update
:meth:`~nerfacc_tpu_torch.estimators.occ_grid.OccGridEstimator._update`).
"""

__version__ = "0.1.0"
