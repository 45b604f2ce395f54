"""Train a vanilla-NeRF MLP with occupancy-grid sampling.

Port of ``examples/train_mlp_nerf.py``: the procedural block (the default
when no ``--data_root`` is given) and the NeRF-Synthetic block (aabb +-1.5,
a res-128 single-level grid, step 5e-3), the 8 x 256 vanilla field, Adam at
5e-4, Huber loss, an occupancy update every 16 steps (every cell below step
256), eval in 8192-ray chunks with PSNR, SSIM, MS-SSIM and LPIPS, and
checkpoints.

    python -m nerfacc_tpu_torch.examples.train_mlp_nerf --smoke --device cpu
    python -m nerfacc_tpu_torch.examples.train_mlp_nerf --data_root <nerf_synthetic> --scene lego

:func:`train_step`, :func:`occ_update`, :func:`eval_render` and
:func:`train` are the loop's own pieces, which other programs call.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..datasets.nerf_synthetic import SubjectLoader
from ..datasets.procedural import make_loaders
from ..device import resolve_device
from ..estimators.occ_grid import OccGridEstimator, OccGridState
from ..models.mlp import VanillaNeRFRadianceField
from ..rendering import occgrid_render_rays
from ..utils.checkpoint import latest_step
from .common import NERF_SYNTHETIC_SCENES, Timer, eval_metrics, render_image_chunked
from .train_ngp_nerf_occ import make_fns, resume, save

Tensor = torch.Tensor

LR = 5e-4
OCC_EVERY = 16  # steps between occupancy updates
WARMUP_STEPS = 256  # updates before this step probe every cell


@dataclasses.dataclass
class Run:
    """What the loop carries from step to step."""

    cfg: dict
    field: torch.nn.Module
    estimator: OccGridEstimator
    occ_state: OccGridState
    opt: torch.optim.Optimizer
    generator: torch.Generator  # the stratified jitter and the update draws
    step: int = 0

    @property
    def render_kwargs(self) -> dict:
        cfg = self.cfg
        return dict(near_plane=cfg["near_plane"], far_plane=cfg["far_plane"],
                    render_step_size=cfg["render_step_size"])


def build_config(procedural: bool, smoke: bool) -> dict:
    """The example's settings (``train_mlp_nerf.py:59-97``): the procedural
    block, or the NeRF-Synthetic block."""
    if procedural:
        return dict(
            aabb=np.array([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], np.float32),
            max_steps=150 if smoke else 5000, grid_resolution=32 if smoke else 64,
            render_step_size=8e-3 if smoke else 5e-3,
        )
    return dict(
        aabb=np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32),
        max_steps=50000, grid_resolution=128, render_step_size=5e-3, near_plane=0.0, far_plane=1e10,
    )


def train_step(run: Run, rays_o: Tensor, rays_d: Tensor, pixels: Tensor, bkgd: Tensor, jitter: Tensor):
    """One step: render with the stratified ``jitter`` (``(n_rays,)`` in
    ``[0, 1)``) into ``num_rays * samples_per_ray`` slots, Huber loss
    (delta 1), backward, Adam.  Returns ``(loss, n_samples)``, 0-d tensors
    on the device (no host read)."""
    sigma_fn, rgb_sigma_fn = make_fns(run.field, rays_o, rays_d)
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


def occ_update(run: Run, warmup: bool, draws=None) -> None:
    """The occupancy EMA update (``train_mlp_nerf.py:163-174``): the field's
    ``query_opacity`` at every cell during warm-up, else at the post-warm-up
    draws; ``draws`` (see ``OccGridEstimator.make_draws``) default to draws
    from the run's generator."""
    step_size = run.cfg["render_step_size"]
    with record_function("occ_update"):
        run.occ_state = run.estimator._update(
            run.occ_state, 0 if warmup else 10**9, lambda x: run.field.query_opacity(x, step_size),
            warmup_steps=1, draws=draws, generator=run.generator,
        )


def train(run: Run, train_ds: SubjectLoader, until: int, *, log_every: int = 0,
          ckpt_every: int = 0, model_path: Optional[str] = None,
          jitter: Optional[Callable[[int], Tensor]] = None,
          draws: Optional[Callable[[int], Sequence[dict]]] = None):
    """Train from ``run.step`` up to step ``until`` (exclusive), as the JAX
    example's loop (``train_mlp_nerf.py:195-213``): an occupancy update every
    16 steps (warm-up below step 256) before the step.  ``jitter(step)`` and
    ``draws(step)`` replace the run generator's draws.  Returns the steps'
    losses and kept-sample counts (lists of 0-d device tensors)."""
    losses: List[Tensor] = []
    n_samples: List[Tensor] = []
    timer = Timer()
    dev = run.occ_state.occs.device
    while run.step < until:
        step = run.step
        if step % OCC_EVERY == 0:
            occ_update(run, warmup=step < WARMUP_STEPS, draws=None if draws is None else draws(step))
        batch = train_ds[step % len(train_ds)]
        rays = batch["rays"]
        u = (jitter(step) if jitter is not None
             else torch.rand((rays.origins.shape[0],), generator=run.generator, device=run.generator.device)).to(dev)
        loss, n_samp = train_step(run, rays.origins, rays.viewdirs, batch["pixels"], batch["color_bkgd"], u)
        losses.append(loss)
        n_samples.append(n_samp)
        if log_every and step % log_every == 0:
            print(f"step {step} loss {float(loss):.5f} n_samples {int(n_samp)} elapsed {timer.elapsed():.1f}s",
                  flush=True)
        if model_path and ckpt_every and step and step % ckpt_every == 0:
            save(run, model_path, step)
        run.step += 1
    return losses, n_samples


@torch.no_grad()
def eval_render(run: Run, rays_o: Tensor, rays_d: Tensor) -> Tensor:
    """The colours of one eval chunk (``train_mlp_nerf.py:176-192``): white
    background, no jitter, ``samples_per_ray`` slots a ray."""
    sigma_fn, rgb_sigma_fn = make_fns(run.field, rays_o, rays_d)
    colors, _, _, _, _ = occgrid_render_rays(
        rgb_sigma_fn, sigma_fn, run.estimator, run.occ_state, rays_o, rays_d,
        render_bkgd=torch.ones(3, device=rays_o.device),
        sample_capacity=rays_o.shape[0] * run.cfg["samples_per_ray"], **run.render_kwargs,
    )
    return colors


def evaluate(run: Run, test_ds: SubjectLoader, chunk: int, limit: Optional[int] = None) -> List[dict]:
    """The first ``limit`` (default: every) test views' metrics, each view
    rendered in chunks of ``chunk`` rays."""
    out = []
    for i in range(len(test_ds) if limit is None else min(limit, len(test_ds))):
        batch = test_ds[i]
        img = render_image_chunked(lambda o, d: eval_render(run, o, d), batch["rays"], chunk=chunk)
        m = eval_metrics(img, batch["pixels"])
        out.append(m)
        print(f"  eval img {i}: PSNR {m['psnr']:.2f} ssim {m['ssim']:.4f} lpips({m['lpips_src']}) "
              f"{m['lpips']:.4f}", flush=True)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--train_split", type=str, default="train")
    p.add_argument("--scene", type=str, default="lego", choices=NERF_SYNTHETIC_SCENES + ["procedural"])
    p.add_argument("--model_path", type=str, default=None,
                   help="checkpoint directory (saved at the end and every --ckpt_every steps)")
    p.add_argument("--resume", action="store_true", help="restore params/opt/occ/step from --model_path")
    p.add_argument("--ckpt_every", type=int, default=0, help="0 = only at the end")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--num_rays", type=int, default=1024)
    p.add_argument("--samples_per_ray", type=int, default=64)
    p.add_argument("--smoke", action="store_true", help="tiny procedural run")
    p.add_argument("--eval_every", type=int, default=0, help="0 = only at the end")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def setup(args: argparse.Namespace):
    """``(run, train_ds, test_ds, eval_chunk)`` for the parsed arguments."""
    device = resolve_device(args.device)
    procedural = args.smoke or args.data_root is None or args.scene == "procedural"
    cfg = build_config(procedural, args.smoke)
    num_rays = min(args.num_rays, 256) if procedural and args.smoke else args.num_rays
    if procedural:
        train_ds, test_ds = make_loaders(
            num_rays=num_rays, width=96 if args.smoke else 160, height=96 if args.smoke else 160,
            n_train=12 if args.smoke else 36, n_test=1 if args.smoke else 2, device=device,
        )
        cfg["near_plane"], cfg["far_plane"] = train_ds.near, train_ds.far
    else:
        train_ds = SubjectLoader(subject_id=args.scene, root_fp=args.data_root, split=args.train_split,
                                 num_rays=num_rays, device=device)
        test_ds = SubjectLoader(subject_id=args.scene, root_fp=args.data_root, split="test", device=device)
    cfg.update(max_steps=args.max_steps or cfg["max_steps"], samples_per_ray=args.samples_per_ray,
               sample_capacity=num_rays * args.samples_per_ray)
    estimator = OccGridEstimator(roi_aabb=cfg["aabb"], resolution=cfg["grid_resolution"], levels=1)
    field = VanillaNeRFRadianceField(device=device, generator=torch.Generator().manual_seed(42))
    run = Run(
        cfg=cfg, field=field, estimator=estimator, occ_state=estimator.init(device),
        opt=torch.optim.Adam(field.parameters(), lr=LR), generator=torch.Generator(device=device).manual_seed(42),
    )
    return run, train_ds, test_ds, 2048 if args.smoke else 8192


def main(argv=None) -> float:
    args = parse_args(argv)
    run, train_ds, test_ds, eval_chunk = setup(args)
    if args.resume and args.model_path and latest_step(args.model_path):
        resume(run, args.model_path)
        print(f"resumed from {args.model_path} at step {run.step}", flush=True)

    max_steps = run.cfg["max_steps"]
    timer = Timer()
    every = args.eval_every
    while run.step <= max_steps:
        # With --eval_every, one test view after each step that is a multiple
        # of it (not step 0), as the JAX example does.
        until = max_steps + 1 if not every else min(max_steps + 1, (run.step // every + 1) * every + 1)
        train(run, train_ds, until, log_every=max(1, max_steps // 10), ckpt_every=args.ckpt_every,
              model_path=args.model_path)
        if every and (run.step - 1) % every == 0:
            evaluate(run, test_ds, eval_chunk, limit=1)
    print(f"training done in {timer.elapsed():.1f}s", flush=True)
    psnrs = [m["psnr"] for m in evaluate(run, test_ds, eval_chunk)]
    print(f"FINAL mean PSNR {np.mean(psnrs):.2f} dB", flush=True)
    if args.model_path:
        save(run, args.model_path, max_steps)
    return float(np.mean(psnrs))


if __name__ == "__main__":
    main()
