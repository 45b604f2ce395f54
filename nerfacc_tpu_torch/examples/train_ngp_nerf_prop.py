"""Train Instant-NGP with proposal-network (PDF) resampling.

Port of ``examples/train_ngp_nerf_prop.py``: proposal ``NGPDensityField``
levels and the NGP radiance field, the annealed proposal cadence, two Adams
(lr 1e-2, eps 1e-15), Huber loss plus the proposal loss, and an eval in
chunks with PSNR and LPIPS.  It saves no checkpoint, as the JAX example.
A Mip-NeRF 360 scene is read from its COLMAP folder by
``nerf_360_v2.SubjectLoader``.

    python -m nerfacc_tpu_torch.examples.train_ngp_nerf_prop --smoke --device cpu
    python -m nerfacc_tpu_torch.examples.train_ngp_nerf_prop --scene garden --data_root <360_v2>
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, List, Sequence

import numpy as np
import torch

from ..datasets.nerf_synthetic import SubjectLoader
from ..datasets.procedural import make_loaders
from ..device import resolve_device
from ..estimators.prop_net import PropNetEstimator, get_proposal_requires_grad_fn
from ..models.ngp import NGPDensityField, NGPRadianceField
from ..rendering import propnet_render_rays
from ..utils.lpips import lpips
from .common import (
    MIPNERF360_UNBOUNDED_SCENES,
    NERF_SYNTHETIC_SCENES,
    Timer,
    psnr,
    render_image_chunked,
    scene_loaders,
)

Tensor = torch.Tensor


@dataclasses.dataclass
class PropRun:
    """The models, optimizers and rendering settings of one run."""

    field: NGPRadianceField
    prop_nets: List[NGPDensityField]
    opt_field: torch.optim.Optimizer
    opt_prop: torch.optim.Optimizer
    render_kw: dict  # propnet_render_rays' sampling settings
    requires_grad_fn: Callable[[int], bool]
    generator: torch.Generator  # the stratified offsets


def render(run: PropRun, rays_o: Tensor, rays_d: Tensor, bkgd: Tensor, *, requires_grad: bool,
           stratified: bool, generator=None):
    """``propnet_render_rays`` with the example's field callbacks
    (``train_ngp_nerf_prop.py:133-159``)."""

    def points(ts, te):
        return rays_o[:, None] + ((ts + te) / 2.0)[..., None] * rays_d[:, None]

    def rgb_sigma_fn(ts, te):
        x = points(ts, te)
        rgb, sigma = run.field(x, rays_d[:, None].expand(x.shape))
        return rgb, sigma[..., 0]

    prop_fns = [lambda ts, te, net=net: net(points(ts, te))[..., 0] for net in run.prop_nets]
    return propnet_render_rays(
        rgb_sigma_fn, prop_fns, PropNetEstimator(), rays_o, rays_d, render_bkgd=bkgd,
        stratified=stratified, requires_grad=requires_grad, generator=generator, **run.render_kw,
    )


def train_step(run: PropRun, rays_o, rays_d, pixels, bkgd, requires_grad: bool):
    """One step (``train_ngp_nerf_prop.py:161-188``): render, Huber loss plus
    the proposal loss, one backward, the field's Adam, and the proposal nets'
    Adam when ``requires_grad``.  Returns ``(loss, mse, prop_loss)`` on the
    device."""
    colors, _, _, extras = render(run, rays_o, rays_d, bkgd, requires_grad=requires_grad, stratified=True,
                                  generator=run.generator)
    loss = torch.nn.functional.huber_loss(colors, pixels, delta=1.0)
    prop_loss = PropNetEstimator().compute_loss(extras["prop_cache"], extras["trans"], loss_scaler=1.0)
    run.opt_field.zero_grad(set_to_none=True)
    run.opt_prop.zero_grad(set_to_none=True)
    (loss + prop_loss).backward()
    run.opt_field.step()
    if requires_grad:
        run.opt_prop.step()
    mse = torch.mean((colors.detach() - pixels) ** 2)
    return (loss + prop_loss).detach(), mse, prop_loss.detach()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--train_split", type=str, default="train")
    p.add_argument("--scene", type=str, default="lego",
                   choices=NERF_SYNTHETIC_SCENES + MIPNERF360_UNBOUNDED_SCENES + ["procedural"])
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--encoder", type=str, default="fused", choices=["hash", "soa", "fused", "folded"],
                   help="the radiance field's and the proposal nets' encoder")
    p.add_argument("--dtype", type=str, default="f32", choices=["f32", "bf16"],
                   help="field compute precision (parameters and Adam stay float32)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def setup(args: argparse.Namespace):
    """``(run, train_ds, test_ds, max_steps, eval_chunk)`` for the parsed
    arguments (``train_ngp_nerf_prop.py:60-131``)."""
    device = resolve_device(args.device)
    unbounded = args.scene in MIPNERF360_UNBOUNDED_SCENES
    procedural = args.smoke or args.data_root is None or args.scene == "procedural"
    if unbounded:
        aabb = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
        near_plane, far_plane = 0.2, 1e3
        sampling_type = "lindisp"
        num_samples, prop_samples = 48, (256, 96)
        max_res_prop = (128, 256)
        opaque_bkgd = True
    else:
        aabb = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
        near_plane, far_plane = 2.0, 6.0
        sampling_type = "uniform"
        num_samples, prop_samples = 64, (128,)
        max_res_prop = (128,)
        opaque_bkgd = False
    if procedural:
        aabb = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
        num_rays = 256 if args.smoke else 4096
        train_ds, test_ds = make_loaders(
            num_rays=num_rays,
            width=96 if args.smoke else 160,
            height=96 if args.smoke else 160,
            n_train=12 if args.smoke else 36,
            n_test=1 if args.smoke else 2,
            device=device,
        )
        near_plane, far_plane = train_ds.near, train_ds.far
        max_steps = args.max_steps or (200 if args.smoke else 4000)
        num_samples, prop_samples = (32, (64,)) if args.smoke else (48, (128,))
    else:
        train_ds, test_ds = scene_loaders(args.scene, args.data_root, args.train_split, 4096, device)
        max_steps = args.max_steps or 20000

    gen = torch.Generator().manual_seed(42)
    cdt = torch.bfloat16 if args.dtype == "bf16" else None
    # The fused and folded encoders' 128-wide rows (8 corners x 16 features);
    # hash and soa at tcnn's shape (:107-125).
    fused = args.encoder in ("fused", "folded")
    field = NGPRadianceField(aabb=tuple(aabb), unbounded=unbounded, encoder_type=args.encoder,
                             n_levels=8 if fused else 16, n_features_per_level=16 if fused else 2,
                             log2_hashmap_size=18 if fused else 19, compute_dtype=cdt, device=device,
                             generator=gen)
    prop_nets = [
        NGPDensityField(aabb=tuple(aabb), unbounded=unbounded, n_levels=5, max_resolution=mr,
                        encoder_type=args.encoder, compute_dtype=cdt, device=device, generator=gen)
        for mr in max_res_prop
    ]
    run = PropRun(
        field=field,
        prop_nets=prop_nets,
        opt_field=torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15),
        opt_prop=torch.optim.Adam([p for net in prop_nets for p in net.parameters()], lr=1e-2, eps=1e-15),
        render_kw=dict(num_samples=num_samples, prop_samples=prop_samples, near_plane=near_plane,
                       far_plane=far_plane, sampling_type=sampling_type, opaque_bkgd=opaque_bkgd),
        requires_grad_fn=get_proposal_requires_grad_fn(),
        generator=torch.Generator(device=device).manual_seed(42),
    )
    return run, train_ds, test_ds, max_steps, 2048 if args.smoke else 8192


def train(run: PropRun, train_ds: SubjectLoader, steps: Sequence[int], log_every: int = 0) -> List[Tensor]:
    """The example's loop over ``steps``; returns each step's loss on the
    device."""
    losses = []
    timer = Timer()
    for step in steps:
        batch = train_ds[step % len(train_ds)]
        rays = batch["rays"]
        loss, mse, prop_loss = train_step(run, rays.origins, rays.viewdirs, batch["pixels"],
                                          batch["color_bkgd"], run.requires_grad_fn(step))
        losses.append(loss)
        if log_every and step % log_every == 0:
            print(f"elapsed={timer.elapsed():.1f}s step={step} loss={float(loss):.5f} "
                  f"psnr={-10 * np.log10(max(float(mse), 1e-10)):.2f} prop_loss={float(prop_loss):.5f}",
                  flush=True)
    return losses


@torch.no_grad()
def evaluate(run: PropRun, test_ds: SubjectLoader, chunk: int) -> List[float]:
    """Every test view in chunks (``train_ngp_nerf_prop.py:216-241``): PSNR
    and LPIPS."""
    psnrs = []
    for i in range(len(test_ds)):
        batch = test_ds[i]
        white = torch.ones(3, device=batch["pixels"].device)

        def render_fn(o, d):
            return render(run, o, d, white, requires_grad=False, stratified=False)[0]

        img = render_image_chunked(render_fn, batch["rays"], chunk=chunk)
        p_ = psnr(img, batch["pixels"])
        lp, lp_src = lpips(img, batch["pixels"])
        psnrs.append(p_)
        print(f"  eval img {i}: PSNR {p_:.2f} lpips({lp_src}) {lp:.4f}", flush=True)
    return psnrs


def main(argv=None) -> float:
    args = parse_args(argv)
    run, train_ds, test_ds, max_steps, chunk = setup(args)
    timer = Timer()
    train(run, train_ds, range(max_steps + 1), log_every=max(1, max_steps // 10))
    print(f"training done in {timer.elapsed():.1f}s", flush=True)
    psnrs = evaluate(run, test_ds, chunk)
    print(f"FINAL mean PSNR {np.mean(psnrs):.2f} dB", flush=True)
    return float(np.mean(psnrs))


if __name__ == "__main__":
    main()
