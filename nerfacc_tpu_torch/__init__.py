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
(:class:`~nerfacc_tpu_torch.models.hash_soa.HashGridEncoderGrouped`), or
any of the other encoders (the tcnn-parity ``hash`` and ``soa``,
``folded``), on arrays or on ``(xs, ys, zs)`` component tuples, and
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
render CLIs (``python -m nerfacc_tpu_torch.examples.<name>``); the
vanilla-NeRF MLP family (:mod:`~nerfacc_tpu_torch.models.mlp`, with T-NeRF
and NDR on the dynamic procedural scene and the D-NeRF loader) and its two
CLIs; and the OpenCV lens undistortion (:mod:`~nerfacc_tpu_torch.cameras`).

The names below are the JAX package's public surface
(``nerfacc_tpu/__init__.py``), under the same names.
"""

from .cameras import opencv_lens_undistortion, opencv_lens_undistortion_fisheye
from .data_specs import RayIntervals, RaySamples
from .estimators.occ_grid import OccGridEstimator, OccGridState
from .estimators.prop_net import PropNetEstimator, get_proposal_requires_grad_fn
from .grid import TraversalResults, ray_aabb_intersect, traverse_grids
from .pack import pack_info
from .pdf import importance_sampling, searchsorted
from .scan import (
    exclusive_prod,
    exclusive_sum,
    inclusive_prod,
    inclusive_sum,
    seg_exclusive_prod,
    seg_exclusive_sum,
    seg_inclusive_prod,
    seg_inclusive_sum,
)
from .version import __version__
from .volrend import (
    accumulate_along_rays,
    render_transmittance_from_alpha,
    render_transmittance_from_density,
    render_visibility_from_alpha,
    render_visibility_from_density,
    render_weight_from_alpha,
    render_weight_from_density,
    rendering,
)

# Also importable from the root, outside the JAX package's list below: the
# encoders (``nerfacc_tpu.models``) and the flag-form scans
# (``nerfacc_tpu.scan``).
from .models import HashGridEncoder, HashGridEncoderFolded, HashGridEncoderFused, HashGridEncoderSoA

__all__ = [
    "__version__",
    "inclusive_prod",
    "exclusive_prod",
    "inclusive_sum",
    "exclusive_sum",
    "pack_info",
    "render_visibility_from_alpha",
    "render_visibility_from_density",
    "render_weight_from_alpha",
    "render_weight_from_density",
    "render_transmittance_from_alpha",
    "render_transmittance_from_density",
    "accumulate_along_rays",
    "rendering",
    "importance_sampling",
    "searchsorted",
    "RayIntervals",
    "RaySamples",
    "ray_aabb_intersect",
    "traverse_grids",
    "TraversalResults",
    "OccGridEstimator",
    "OccGridState",
    "PropNetEstimator",
    "get_proposal_requires_grad_fn",
    "opencv_lens_undistortion",
    "opencv_lens_undistortion_fisheye",
]
