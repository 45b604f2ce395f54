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
:meth:`~nerfacc_tpu_torch.estimators.occ_grid.OccGridEstimator._update`),
with the fused encoder (every table-gradient route) or the grouped
tcnn-shape encoder
(:class:`~nerfacc_tpu_torch.models.hash_soa.HashGridEncoderGrouped`), and
the visibility filter that the unbounded (Mip-NeRF 360) configuration turns
on (``alpha_thre``, ``refilter_capacity``, ``sampling(sigma_fn=)``,
``mark_invisible_cells``); and the proposal-network path
(:mod:`~nerfacc_tpu_torch.data_specs`, :mod:`~nerfacc_tpu_torch.pdf`,
:class:`~nerfacc_tpu_torch.estimators.prop_net.PropNetEstimator`,
:class:`~nerfacc_tpu_torch.models.ngp.NGPDensityField` and
:func:`~nerfacc_tpu_torch.rendering.propnet_render_rays`), whose train step
takes the radiance field's table gradient through the same kernels; and
what a user trains and evaluates with: the procedural scene and the
NeRF-Synthetic loader (:mod:`~nerfacc_tpu_torch.datasets`), image metrics
and checkpoints (:mod:`~nerfacc_tpu_torch.utils`), and the NGP train and
render CLIs (``python -m nerfacc_tpu_torch.examples.<name>``).
"""

__version__ = "0.1.0"
