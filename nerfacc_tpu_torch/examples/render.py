"""Render test views from a trained checkpoint with the iterative alive-ray
renderer (the Instant-NGP-style inference path).

Port of ``examples/render.py``: restore a checkpoint that
``train_ngp_nerf_occ`` saved, render the procedural test split through
:func:`~nerfacc_tpu_torch.rendering.occgrid_render_rays_test`, and report
PSNR and rays/s; ``--out`` writes ``view_{i}.png``.

    python -m nerfacc_tpu_torch.examples.train_ngp_nerf_occ --smoke --device cpu --model_path ckpt
    python -m nerfacc_tpu_torch.examples.render --model_path ckpt --device cpu --out views
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..datasets.png import write_png
from ..datasets.procedural import make_loaders
from ..device import resolve_device
from ..estimators.occ_grid import OccGridEstimator, OccGridState
from ..models.ngp import NGPRadianceField
from ..rendering import gather_ray_od, occgrid_render_rays_test
from ..utils.checkpoint import restore_checkpoint
from .common import Timer, psnr
from .train_ngp_nerf_occ import make_field, restore_occ_state

Tensor = torch.Tensor


def load_model(model_path: str, encoder: str = "fused", levels: Optional[int] = None,
               feats: Optional[int] = None, log2t: Optional[int] = None, dtype: str = "f32", *,
               device) -> Tuple[NGPRadianceField, OccGridEstimator, OccGridState, int]:
    """The field, estimator and occupancy state of the newest checkpoint
    under ``model_path``, on ``device``, and its step.  The grid's levels
    and resolution come from the checkpoint; the field's shape from the
    arguments, which must be those it was trained with."""
    device = resolve_device(device)
    ckpt, step = restore_checkpoint(model_path, None)
    occ = {k: v.to(device) for k, v in ckpt["occ_state"].items()}
    levels_grid, res = occ["binaries"].shape[0], occ["binaries"].shape[1]
    estimator = OccGridEstimator(roi_aabb=[-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], resolution=res, levels=levels_grid)
    field = make_field(dict(unbounded=False), estimator, encoder, "ngp", levels, feats, log2t, dtype, device=device)
    field.load_state_dict(ckpt["params"])
    return field, estimator, restore_occ_state(estimator, occ), step


@torch.no_grad()
def render_view(field: NGPRadianceField, estimator: OccGridEstimator, occ_state: OccGridState, rays, *,
                near: float, far: float, chunk: int = 4096, max_samples: int = 1024,
                render_step_size: float = 5e-3) -> Tuple[Tensor, int]:
    """One ``(H, W, 3)`` view through the alive-ray renderer in chunks of
    ``chunk`` rays (the last padded with its last ray), 32 samples a round,
    a white background; returns the image and the samples it took."""
    h, w = rays.origins.shape[:2]
    o = rays.origins.reshape(-1, 3)
    d = rays.viewdirs.reshape(-1, 3)
    white = torch.ones(3, device=o.device)

    def builder(rays_o, rays_d):
        def rgb_sigma_fn(ts, te, ri):
            ro, rd = gather_ray_od(rays_o, rays_d, ri)
            rgb, sigma = field(ro + ((ts + te) / 2)[:, None] * rd, rd)
            return rgb, sigma[..., 0]

        return rgb_sigma_fn

    imgs, total = [], 0
    for j in range(0, o.shape[0], chunk):
        oc, dc = o[j : j + chunk], d[j : j + chunk]
        n = oc.shape[0]
        if n < chunk:
            oc = torch.cat([oc, oc[-1:].expand(chunk - n, 3)])
            dc = torch.cat([dc, dc[-1:].expand(chunk - n, 3)])
        rgb, _, _, n_s = occgrid_render_rays_test(
            builder, estimator, occ_state, oc, dc, max_samples=max_samples, samples_per_round=32,
            near_plane=near, far_plane=far, render_step_size=render_step_size, render_bkgd=white,
        )
        total += n_s
        imgs.append(rgb[:n])
    return torch.cat(imgs).reshape(h, w, 3), total


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--chunk", type=int, default=4096)
    p.add_argument("--max_samples", type=int, default=1024, help="per-ray sample budget of the renderer")
    p.add_argument("--encoder", type=str, default="fused")
    p.add_argument("--levels", type=int, default=None)
    p.add_argument("--feats", type=int, default=None)
    p.add_argument("--log2t", type=int, default=None)
    p.add_argument("--dtype", type=str, default="f32", choices=["f32", "bf16"],
                   help="field compute precision for inference")
    p.add_argument("--repeat", type=int, default=1,
                   help="render the test set N times; the last pass is timed alone")
    return p.parse_args(argv)


def main(argv=None) -> float:
    args = parse_args(argv)
    device = resolve_device(args.device)
    field, estimator, occ_state, step = load_model(
        args.model_path, args.encoder, args.levels, args.feats, args.log2t, args.dtype, device=device
    )
    print(f"restored step {step} from {args.model_path}", flush=True)
    # The procedural test split (the smoke and procedural training settings).
    _, test_ds = make_loaders(num_rays=1, width=96, height=96, n_test=2, device=device)
    psnrs, n_pix, dt = [], 0, 0.0
    for rep in range(args.repeat):
        last = rep == args.repeat - 1
        if last:
            psnrs, n_pix = [], 0
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timer = Timer()
        for i in range(len(test_ds)):
            batch = test_ds[i]
            img, total = render_view(field, estimator, occ_state, batch["rays"], near=test_ds.near,
                                     far=test_ds.far, chunk=args.chunk, max_samples=args.max_samples)
            p_ = psnr(img, batch["pixels"])
            psnrs.append(p_)
            n_pix += img.shape[0] * img.shape[1]
            print(f"view {i}: PSNR {p_:.2f}, {total} samples", flush=True)
            if args.out and last:
                Path(args.out).mkdir(parents=True, exist_ok=True)
                write_png(f"{args.out}/view_{i}.png", (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8))
        if last:
            dt = timer.elapsed()
    print(f"mean PSNR {np.mean(psnrs):.2f} in {dt:.1f}s ({n_pix / max(dt, 1e-9):.0f} rays/s"
          f"{' steady-state' if args.repeat > 1 else ''})", flush=True)
    return float(np.mean(psnrs))


if __name__ == "__main__":
    main()
