"""Train a time-conditioned T-NeRF (or NDR) on dynamic scenes.

Port of ``examples/train_mlp_tnerf.py``: the dynamic procedural scene (the
default when no ``--data_root`` is given) or a D-NeRF scene (aabb +-1.5, a
res-128 single-level grid, step 5e-3), ``--field tnerf`` (a 4 x 64 warp in
front of the 8 x 256 vanilla field), ``ndr`` (three invertible warp
blocks) or ``tineuvox`` (a deformation net in front of a res-96 voxel grid,
32 with ``--smoke``), 48 sample slots a ray, Adam at 5e-4, Huber loss, and an occupancy
update every 16 steps whose probes each take a random training timestamp.

    python -m nerfacc_tpu_torch.examples.train_mlp_tnerf --smoke --device cpu
    python -m nerfacc_tpu_torch.examples.train_mlp_tnerf --field tineuvox   # on the card

:func:`train_step`, :func:`occ_update`, :func:`eval_render` and
:func:`train` are the loop's own pieces, which other programs call.
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..datasets.dnerf_synthetic import SubjectLoader
from ..datasets.procedural import make_dynamic_loaders
from ..device import resolve_device
from ..estimators.occ_grid import OccGridEstimator
from ..models.mlp import NDRTNeRFRadianceField, TNeRFRadianceField
from ..models.tineuvox import TiNeuVoxRadianceField
from ..rendering import gather_ray_od, occgrid_render_rays
from .common import Timer, eval_metrics, render_image_chunked
from .train_mlp_nerf import LR, OCC_EVERY, WARMUP_STEPS, Run

Tensor = torch.Tensor

DNERF_SCENES = [
    "bouncingballs", "hellwarrior", "hook", "jumpingjacks", "lego", "mutant", "standup", "trex",
]
SAMPLES_PER_RAY = 48
FIELDS = ("tnerf", "ndr", "tineuvox")


def make_field(name: str, cfg: dict, smoke: bool, *, device, generator: Optional[torch.Generator] = None):
    """The example's dynamic field (``train_mlp_tnerf.py:85-96``): TiNeuVox
    on the configuration's box at resolution 96 (32 with ``--smoke``)."""
    if name == "tineuvox":
        return TiNeuVoxRadianceField(aabb=tuple(float(v) for v in cfg["aabb"]), resolution=32 if smoke else 96,
                                     device=device, generator=generator)
    cls = {"tnerf": TNeRFRadianceField, "ndr": NDRTNeRFRadianceField}[name]
    return cls(device=device, generator=generator)


def make_fns(field: torch.nn.Module, rays_o: Tensor, rays_d: Tensor, timestamps: Tensor):
    """The example's ``sigma_fn`` and ``rgb_sigma_fn``: each sample takes its
    ray's timestamp (``timestamps (n_rays, 1)``)."""

    def sigma_fn(t_starts, t_ends, ray_indices):
        o, d = gather_ray_od(rays_o, rays_d, ray_indices)
        return field.query_density(o + ((t_starts + t_ends) / 2.0)[:, None] * d, timestamps[ray_indices])[..., 0]

    def rgb_sigma_fn(t_starts, t_ends, ray_indices):
        o, d = gather_ray_od(rays_o, rays_d, ray_indices)
        rgb, sigma = field(o + ((t_starts + t_ends) / 2.0)[:, None] * d, timestamps[ray_indices], d)
        return rgb, sigma[..., 0]

    return sigma_fn, rgb_sigma_fn


def train_step(run: Run, rays_o: Tensor, rays_d: Tensor, timestamps: Tensor, pixels: Tensor, bkgd: Tensor,
               jitter: Tensor):
    """One step (``train_mlp_tnerf.py:133-151``): render with the stratified
    ``jitter`` into ``num_rays * 48`` slots, Huber loss, backward, Adam.
    Returns ``(loss, n_samples)``, 0-d tensors on the device."""
    sigma_fn, rgb_sigma_fn = make_fns(run.field, rays_o, rays_d, timestamps)
    colors, _, _, n_samp, _ = occgrid_render_rays(
        rgb_sigma_fn, sigma_fn, run.estimator, run.occ_state, rays_o, rays_d,
        render_bkgd=bkgd, stratified=True, jitter=jitter, sample_capacity=run.cfg["sample_capacity"],
        **run.render_kwargs,
    )
    loss = torch.nn.functional.huber_loss(colors, pixels, delta=1.0)
    run.opt.zero_grad(set_to_none=True)
    with record_function("backward"):
        loss.backward()
    with record_function("optimizer"):
        run.opt.step()
    return loss.detach(), n_samp


def occ_update(run: Run, warmup: bool, train_times: Tensor, draws=None, probe_times: Optional[Tensor] = None):
    """The occupancy EMA update (``train_mlp_tnerf.py:153-168``): the field's
    density times the step size at each probe, each probe at a training
    timestamp drawn uniformly from ``train_times`` with the run's generator,
    or at ``probe_times`` ``(n_probes, 1)`` when given."""
    step_size = run.cfg["render_step_size"]

    def occ_eval_fn(x):
        t = probe_times
        if t is None:
            idx = torch.randint(0, train_times.shape[0], (x.shape[0],), generator=run.generator,
                                device=run.generator.device).to(x.device)
            t = train_times[idx][:, None]
        return run.field.query_density(x, t) * step_size

    with record_function("occ_update"):
        run.occ_state = run.estimator._update(
            run.occ_state, 0 if warmup else 10**9, occ_eval_fn, warmup_steps=1, draws=draws,
            generator=run.generator,
        )


def train(run: Run, train_ds: SubjectLoader, until: int, *, log_every: int = 0,
          jitter: Optional[Callable[[int], Tensor]] = None,
          draws: Optional[Callable[[int], Sequence[dict]]] = None,
          probe_times: Optional[Callable[[int], Tensor]] = None):
    """Train from ``run.step`` up to step ``until`` (exclusive), as the JAX
    example's loop (``train_mlp_tnerf.py:183-197``); ``jitter(step)``,
    ``draws(step)`` and ``probe_times(step)`` replace the run generator's
    draws.  Returns the steps' losses and kept-sample counts (lists of 0-d
    device tensors)."""
    losses: List[Tensor] = []
    n_samples: List[Tensor] = []
    timer = Timer()
    dev = run.occ_state.occs.device
    train_times = torch.from_numpy(train_ds.timestamps).to(dev)
    while run.step < until:
        step = run.step
        if step % OCC_EVERY == 0:
            occ_update(run, step < WARMUP_STEPS, train_times, None if draws is None else draws(step),
                       None if probe_times is None else probe_times(step))
        batch = train_ds[step % len(train_ds)]
        rays = batch["rays"]
        u = (jitter(step) if jitter is not None
             else torch.rand((rays.origins.shape[0],), generator=run.generator, device=run.generator.device)).to(dev)
        loss, n_samp = train_step(run, rays.origins, rays.viewdirs, batch["timestamps"], batch["pixels"],
                                  batch["color_bkgd"], u)
        losses.append(loss)
        n_samples.append(n_samp)
        if log_every and step % log_every == 0:
            print(f"step {step} loss {float(loss):.5f} n_samples {int(n_samp)} elapsed {timer.elapsed():.1f}s",
                  flush=True)
        run.step += 1
    return losses, n_samples


@torch.no_grad()
def eval_render(run: Run, rays_o: Tensor, rays_d: Tensor, timestamps: Tensor) -> Tensor:
    """The colours of one eval chunk at ``timestamps (n, 1)``: white
    background, no jitter, 48 slots a ray."""
    sigma_fn, rgb_sigma_fn = make_fns(run.field, rays_o, rays_d, timestamps)
    colors, _, _, _, _ = occgrid_render_rays(
        rgb_sigma_fn, sigma_fn, run.estimator, run.occ_state, rays_o, rays_d,
        render_bkgd=torch.ones(3, device=rays_o.device), sample_capacity=rays_o.shape[0] * SAMPLES_PER_RAY,
        **run.render_kwargs,
    )
    return colors


def evaluate(run: Run, test_ds: SubjectLoader, chunk: int) -> List[dict]:
    """Every test view's metrics, each view at its own timestamp
    (``train_mlp_tnerf.py:200-219``)."""
    out = []
    for i in range(len(test_ds)):
        batch = test_ds[i]
        t = batch["timestamps"].reshape(-1, 1)[:1]  # one time a view

        def render(o, d):
            return eval_render(run, o, d, t.expand(o.shape[0], 1))

        m = eval_metrics(render_image_chunked(render, batch["rays"], chunk=chunk), batch["pixels"])
        out.append(m)
        print(f"  eval img {i}: PSNR {m['psnr']:.2f} ssim {m['ssim']:.4f} lpips({m['lpips_src']}) "
              f"{m['lpips']:.4f}", flush=True)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--scene", type=str, default="lego", choices=DNERF_SCENES + ["procedural"])
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--num_rays", type=int, default=1024)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--field", type=str, default="tnerf", choices=FIELDS,
                   help="dynamic field family (tineuvox: the reference's benchmark plug-in)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def setup(args: argparse.Namespace):
    """``(run, train_ds, test_ds, eval_chunk)`` for the parsed arguments."""
    device = resolve_device(args.device)
    procedural = args.smoke or args.data_root is None or args.scene == "procedural"
    num_rays = min(args.num_rays, 256) if procedural and args.smoke else args.num_rays
    if procedural:
        train_ds, test_ds = make_dynamic_loaders(
            num_rays=num_rays, width=96 if args.smoke else 128, height=96 if args.smoke else 128,
            n_train=12 if args.smoke else 24, n_test=1 if args.smoke else 2, device=device,
        )
        cfg = dict(aabb=np.array([-1, -1, -1, 1, 1, 1], np.float32), max_steps=150 if args.smoke else 4000,
                   grid_resolution=32 if args.smoke else 64, render_step_size=1e-2 if args.smoke else 5e-3,
                   near_plane=train_ds.near, far_plane=train_ds.far)
    else:
        train_ds = SubjectLoader(subject_id=args.scene, root_fp=args.data_root, split="train", num_rays=num_rays,
                                 device=device)
        test_ds = SubjectLoader(subject_id=args.scene, root_fp=args.data_root, split="test", device=device)
        cfg = dict(aabb=np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32), max_steps=30000,
                   grid_resolution=128, render_step_size=5e-3, near_plane=0.0, far_plane=1e10)
    cfg.update(max_steps=args.max_steps or cfg["max_steps"], sample_capacity=num_rays * SAMPLES_PER_RAY)
    estimator = OccGridEstimator(roi_aabb=cfg["aabb"], resolution=cfg["grid_resolution"], levels=1)
    field = make_field(args.field, cfg, args.smoke, device=device, generator=torch.Generator().manual_seed(42))
    run = Run(
        cfg=cfg, field=field, estimator=estimator, occ_state=estimator.init(device),
        opt=torch.optim.Adam(field.parameters(), lr=LR), generator=torch.Generator(device=device).manual_seed(42),
    )
    return run, train_ds, test_ds, 2048 if args.smoke else 8192


def main(argv=None) -> float:
    args = parse_args(argv)
    run, train_ds, test_ds, eval_chunk = setup(args)
    max_steps = run.cfg["max_steps"]
    timer = Timer()
    train(run, train_ds, max_steps + 1, log_every=max(1, max_steps // 10))
    print(f"training done in {timer.elapsed():.1f}s", flush=True)
    psnrs = [m["psnr"] for m in evaluate(run, test_ds, eval_chunk)]
    print(f"FINAL mean PSNR {np.mean(psnrs):.2f} dB", flush=True)
    return float(np.mean(psnrs))


if __name__ == "__main__":
    main()
