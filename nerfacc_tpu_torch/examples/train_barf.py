"""Bundle-adjusting NeRF (BARF) with occupancy-grid sampling: a vanilla-NeRF
field and per-camera SE(3) pose corrections optimised together from noisy
training poses.

Port of ``examples/train_barf.py``: the procedural scene (24 views of
160x160; 12 of 96x96 with ``--smoke``), training poses perturbed by twists
of std ``--pose_noise`` (numpy ``default_rng(7)``, translation at half the
rotation's scale), the 8 x 256 field (4 x 128 with ``--smoke``), a 64^3
grid (32^3), two Adams with exponential decay (field 5e-4 to 1e-4, poses
1e-3 to 1e-5 over ``max_steps``), the coarse-to-fine encoding annealed over
[10%, 50%] of the steps, 1024 pixels a step drawn by numpy
``default_rng(1)``, Huber loss, an occupancy update every 16 steps, and the
BARF protocol's errors after a Procrustes alignment of the camera centres;
eval maps the test poses through that alignment.

    python -m nerfacc_tpu_torch.examples.train_barf --smoke --device cpu
    python -m nerfacc_tpu_torch.examples.train_barf          # on the card

Rays are made inside the step from the refined poses
(:func:`~nerfacc_tpu_torch.models.barf.rays_from_pixels`), so the poses
get a gradient through the renderer's per-sample ray gather.
:func:`train_step`, :func:`occ_update`, :func:`eval_render` and
:func:`train` are the loop's own pieces, which other programs call.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..datasets.procedural import generate_dataset
from ..datasets.utils import generate_rays
from ..device import resolve_device
from ..estimators.occ_grid import OccGridEstimator, OccGridState
from ..models.barf import BARFRadianceField, PoseRefine, rays_from_pixels, se3_exp
from ..rendering import gather_ray_od, occgrid_render_rays
from .common import Timer, psnr, render_image_chunked

Tensor = torch.Tensor

OCC_EVERY = 16  # steps between occupancy updates
WARMUP_STEPS = 256  # updates before this step probe every cell
# (initial rate, rate at max_steps): field 5e-4 -> 1e-4, poses 1e-3 -> 1e-5.
FIELD_LR, POSE_LR = (5e-4, 0.2), (1e-3, 0.01)
EVAL_CHUNK = 2048


def rotation_geodesic_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """The angle of ``Ra^T Rb`` in degrees, per pair."""
    cos = (np.trace(Ra.transpose(0, 2, 1) @ Rb, axis1=1, axis2=2) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def align_poses(pred: np.ndarray, gt: np.ndarray):
    """SE(3) Procrustes on the camera centres (Umeyama, no scale): ``(R,
    t)`` mapping the ground-truth frame into the predicted one, and each
    camera's rotation error (degrees) and translation error after the
    alignment (``train_barf.py:46-63``)."""
    cp, cg = pred[:, :3, 3], gt[:, :3, 3]
    mp, mg = cp.mean(0), cg.mean(0)
    H = (cg - mg).T @ (cp - mp)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    t = mp - R @ mg
    gt_aligned_R = np.einsum("ij,njk->nik", R, gt[:, :3, :3])
    gt_aligned_c = cg @ R.T + t
    rot_err = rotation_geodesic_deg(pred[:, :3, :3], gt_aligned_R)
    trans_err = np.linalg.norm(cp - gt_aligned_c, axis=-1)
    return (R, t), rot_err, trans_err


def apply_deltas(xi: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    """``exp(xi) @ c2w`` for twists ``(n, 6)`` and poses ``(n, 3, 4)``, the
    products in numpy float32 as the example makes them."""
    delta = se3_exp(torch.from_numpy(np.asarray(xi, np.float32))).numpy()
    R = np.einsum("nij,njk->nik", delta[:, :, :3], c2w[:, :, :3])
    t = np.einsum("nij,nj->ni", delta[:, :, :3], c2w[:, :, 3]) + delta[:, :, 3]
    return np.concatenate([R, t[:, :, None]], axis=-1).astype(np.float32)


def noisy_poses(gt_c2w: np.ndarray, noise_std: float) -> np.ndarray:
    """The BARF synthetic protocol (``train_barf.py:103-116``): every pose
    moved by a twist of std ``noise_std`` (translation at half of it)."""
    rng = np.random.default_rng(7)
    noise = rng.normal(0.0, noise_std, size=(gt_c2w.shape[0], 6)).astype(np.float32)
    noise[:, 3:] *= 0.5
    return apply_deltas(noise, gt_c2w)


def decayed_lr(lr0: float, rate: float, count: int, max_steps: int) -> float:
    """``optax.exponential_decay(lr0, max_steps, rate)`` at update ``count``
    (not staircase), in float32 as optax computes it."""
    f32 = np.float32
    if count <= 0:
        return float(f32(lr0))
    return float(f32(lr0) * np.power(f32(rate), f32(count) / f32(max_steps)))


def alpha_at(step: int, max_steps: int, anneal: bool = True) -> float:
    """The annealing progress: 0 until 10% of the steps, 1 from 50%."""
    if not anneal:
        return 1.0
    return float(np.float32(np.clip((step / max_steps - 0.1) / 0.4, 0.0, 1.0)))


@dataclasses.dataclass
class Run:
    """What the loop carries from step to step."""

    cfg: dict
    field: BARFRadianceField
    poser: PoseRefine
    estimator: OccGridEstimator
    occ_state: OccGridState
    opt: torch.optim.Adam  # two groups: the field's, the poses'
    nominal: Tensor  # (n_train, 3, 4) noisy training poses, on the device
    K: Tensor  # (3, 3) intrinsics, on the device
    generator: torch.Generator  # the stratified jitter and the update draws
    pixel_rng: np.random.Generator  # the pixel draws
    step: int = 0

    @property
    def render_kwargs(self) -> dict:
        cfg = self.cfg
        return dict(near_plane=cfg["near_plane"], far_plane=cfg["far_plane"],
                    render_step_size=cfg["render_step_size"])


def make_optimizer(field: torch.nn.Module, poser: torch.nn.Module) -> torch.optim.Adam:
    """``optax.multi_transform`` of two Adams (b1 0.9, b2 0.999, eps 1e-8):
    one group each, their rates set every step by :func:`train_step`."""
    return torch.optim.Adam([
        {"params": list(field.parameters()), "lr": FIELD_LR[0]},
        {"params": list(poser.parameters()), "lr": POSE_LR[0]},
    ])


def updates_done(opt: torch.optim.Optimizer) -> int:
    state = opt.state.get(opt.param_groups[1]["params"][0])
    return int(state["step"]) if state and "step" in state else 0


def make_fns(field: BARFRadianceField, rays_o: Tensor, rays_d: Tensor, alpha):
    """The example's ``sigma_fn`` and ``rgb_sigma_fn`` at annealing
    progress ``alpha``."""

    def sigma_fn(t_starts, t_ends, ray_indices):
        o, d = gather_ray_od(rays_o, rays_d, ray_indices)
        return field.query_density(o + ((t_starts + t_ends) / 2.0)[:, None] * d, alpha)[..., 0]

    def rgb_sigma_fn(t_starts, t_ends, ray_indices):
        o, d = gather_ray_od(rays_o, rays_d, ray_indices)
        rgb, sigma = field(o + ((t_starts + t_ends) / 2.0)[:, None] * d, d, alpha)
        return rgb, sigma[..., 0]

    return sigma_fn, rgb_sigma_fn


def train_step(run: Run, cam_ids: Tensor, px: Tensor, py: Tensor, pixels: Tensor, bkgd: Tensor, alpha,
               jitter: Tensor):
    """One step (``train_barf.py:177-203``): rays from the refined poses of
    ``cam_ids`` at pixels ``(px, py)`` (float32), render with the stratified
    ``jitter`` into ``num_rays * samples_per_ray`` slots, Huber loss,
    backward, both Adams at their decayed rates.  Returns ``(loss,
    n_samples)``, 0-d tensors on the device."""
    count, max_steps = updates_done(run.opt), run.cfg["max_steps"]
    for group, (lr0, rate) in zip(run.opt.param_groups, (FIELD_LR, POSE_LR)):
        group["lr"] = decayed_lr(lr0, rate, count, max_steps)
    with record_function("pose_rays"):
        c2w = run.poser(cam_ids, run.nominal[cam_ids.long()])
        rays_o, rays_d = rays_from_pixels(px, py, run.K, c2w)
    sigma_fn, rgb_sigma_fn = make_fns(run.field, rays_o, rays_d, alpha)
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


def occ_update(run: Run, alpha, warmup: bool, draws=None) -> None:
    """The occupancy EMA update (``train_barf.py:205-216``): the field's
    ``query_opacity`` at ``alpha``; ``draws`` (see
    ``OccGridEstimator.make_draws``) default to the run generator's."""
    step_size = run.cfg["render_step_size"]
    with record_function("occ_update"):
        run.occ_state = run.estimator._update(
            run.occ_state, 0 if warmup else 10**9, lambda x: run.field.query_opacity(x, step_size, alpha),
            warmup_steps=1, draws=draws, generator=run.generator,
        )


def draw_batch(run: Run, train_rgba: Tensor) -> Tuple[Tensor, ...]:
    """One step's ``(cam_ids, px, py, pixels, bkgd)`` from ``run.pixel_rng``
    (``train_barf.py:239-244``): pixels of random training views over a
    random background."""
    n, (n_train, height, width) = run.cfg["num_rays"], train_rgba.shape[:3]
    cam_ids = run.pixel_rng.integers(0, n_train, n)
    px = run.pixel_rng.integers(0, width, n)
    py = run.pixel_rng.integers(0, height, n)
    bkgd = run.pixel_rng.random(3).astype(np.float32)
    dev = train_rgba.device
    cam_ids, px, py = (torch.from_numpy(a).to(dev) for a in (cam_ids, px, py))
    rgba = train_rgba[cam_ids, py, px]
    bkgd = torch.from_numpy(bkgd).to(dev)
    pixels = rgba[:, :3] * rgba[:, 3:] + bkgd * (1 - rgba[:, 3:])
    return cam_ids, px.to(torch.float32), py.to(torch.float32), pixels, bkgd


def train(run: Run, train_rgba: Tensor, until: int, *, log_every: int = 0, anneal: bool = True,
          jitter: Optional[Callable[[int], Tensor]] = None,
          draws: Optional[Callable[[int], Sequence[dict]]] = None):
    """Train from ``run.step`` up to step ``until`` (exclusive), as the
    example's loop (``train_barf.py:232-259``): the annealing progress of
    the step, an occupancy update every 16 steps (warm-up below step 256),
    a pixel batch, a step.  ``jitter(step)`` and ``draws(step)`` replace the
    run generator's draws.  Returns the steps' losses and kept-sample
    counts (lists of 0-d device tensors)."""
    losses: List[Tensor] = []
    n_samples: List[Tensor] = []
    timer = Timer()
    dev = run.occ_state.occs.device
    while run.step < until:
        step = run.step
        a = alpha_at(step, run.cfg["max_steps"], anneal)
        alpha = torch.tensor(a, dtype=torch.float32).to(dev, non_blocking=True)
        if step % OCC_EVERY == 0:
            occ_update(run, alpha, step < WARMUP_STEPS, None if draws is None else draws(step))
        with record_function("fetch"):
            batch = draw_batch(run, train_rgba)
        u = (jitter(step) if jitter is not None
             else torch.rand((run.cfg["num_rays"],), generator=run.generator, device=run.generator.device)).to(dev)
        loss, n_samp = train_step(run, *batch, alpha, u)
        losses.append(loss)
        n_samples.append(n_samp)
        if log_every and step % log_every == 0:
            print(f"step {step} loss {float(loss):.5f} alpha {a:.2f} n_samples {int(n_samp)} "
                  f"elapsed {timer.elapsed():.1f}s", flush=True)
        run.step += 1
    return losses, n_samples


def refined_poses(run: Run) -> np.ndarray:
    """The training poses after the learnt deltas, ``(n_train, 3, 4)``."""
    return apply_deltas(run.poser.pose_deltas.detach().cpu().numpy(), run.nominal.cpu().numpy())


@torch.no_grad()
def eval_render(run: Run, rays_o: Tensor, rays_d: Tensor) -> Tensor:
    """The colours of one eval chunk: the field at alpha 1, white
    background, no jitter, ``samples_per_ray`` slots a ray of an
    ``EVAL_CHUNK``-ray chunk."""
    alpha = torch.ones((), device=rays_o.device)
    sigma_fn, rgb_sigma_fn = make_fns(run.field, rays_o, rays_d, alpha)
    colors, _, _, _, _ = occgrid_render_rays(
        rgb_sigma_fn, sigma_fn, run.estimator, run.occ_state, rays_o, rays_d,
        render_bkgd=torch.ones(3, device=rays_o.device),
        sample_capacity=EVAL_CHUNK * run.cfg["samples_per_ray"], **run.render_kwargs,
    )
    return colors


def evaluate(run: Run, test_images: np.ndarray, test_c2w: np.ndarray, align: Tuple[np.ndarray, np.ndarray]
             ) -> List[float]:
    """Each held-out view's PSNR, its ground-truth pose mapped into the
    reconstruction's frame by the fitted alignment ``(R, t)``
    (``train_barf.py:275-302``)."""
    Ra, ta = align
    height, width = test_images.shape[1:3]
    K = run.K.cpu().numpy()
    dev = run.occ_state.occs.device
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    psnrs = []
    for i in range(test_images.shape[0]):
        c2w = test_c2w[i, :3, :4]
        c2w = np.concatenate([Ra @ c2w[:, :3], (Ra @ c2w[:, 3] + ta)[:, None]], axis=-1).astype(np.float32)
        rays = generate_rays(xx.astype(np.float32), yy.astype(np.float32), K, c2w, device=dev)
        img = render_image_chunked(lambda o, d: eval_render(run, o, d), rays, chunk=EVAL_CHUNK)
        rgba = torch.from_numpy(test_images[i].astype(np.float32) / 255.0).to(dev)
        gt = rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:])
        psnrs.append(psnr(img, gt))
        print(f"  eval img {i}: PSNR {psnrs[-1]:.2f}", flush=True)
    return psnrs


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--num_rays", type=int, default=1024)
    p.add_argument("--samples_per_ray", type=int, default=64)
    p.add_argument("--pose_noise", type=float, default=0.10, help="std of the SE(3) twist noise on train poses")
    p.add_argument("--no_anneal", action="store_true", help="disable coarse-to-fine PE (naive joint opt)")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> dict:
    """The example's settings (``train_barf.py:80-100``)."""
    smoke = args.smoke
    num_rays = min(args.num_rays, 256) if smoke else args.num_rays
    return dict(
        smoke=smoke, width=96 if smoke else 160, n_train=12 if smoke else 24,
        max_steps=args.max_steps or (200 if smoke else 6000), num_rays=num_rays,
        samples_per_ray=args.samples_per_ray, sample_capacity=num_rays * args.samples_per_ray,
        grid_resolution=32 if smoke else 64, render_step_size=8e-3 if smoke else 5e-3,
        aabb=np.array([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], np.float32),
        near_plane=2.5 - 1.2, far_plane=2.5 + 1.2, pose_noise=args.pose_noise,
    )


def load_data(cfg: dict, device) -> dict:
    """The procedural views (``train_rgba`` on the device), the intrinsics,
    the ground-truth and noisy training poses and the test views."""
    width = cfg["width"]
    train_images, train_c2w, test_images, test_c2w, focal = generate_dataset(
        n_train=cfg["n_train"], n_test=2, width=width, height=width, radius=2.5, device=device
    )
    height, width = train_images.shape[1:3]
    gt_c2w = train_c2w[:, :3, :4].copy()
    return dict(
        train_rgba=torch.from_numpy(train_images.astype(np.float32) / 255.0).to(device), gt_c2w=gt_c2w,
        noisy_c2w=noisy_poses(gt_c2w, cfg["pose_noise"]), test_images=test_images, test_c2w=test_c2w,
        K=np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]], np.float32),
    )


def make_run(cfg: dict, data: dict, device, seed: int = 0) -> Run:
    """A fresh run: the field (8 x 256, 4 x 128 with ``--smoke``) from
    ``seed``, zero pose deltas, an empty grid."""
    smoke = cfg["smoke"]
    field = BARFRadianceField(net_depth=4 if smoke else 8, net_width=128 if smoke else 256, device=device,
                              generator=torch.Generator().manual_seed(seed))
    poser = PoseRefine(data["noisy_c2w"].shape[0], device=device)
    estimator = OccGridEstimator(roi_aabb=cfg["aabb"], resolution=cfg["grid_resolution"], levels=1)
    return Run(
        cfg=cfg, field=field, poser=poser, estimator=estimator, occ_state=estimator.init(device),
        opt=make_optimizer(field, poser), nominal=torch.from_numpy(data["noisy_c2w"]).to(device),
        K=torch.from_numpy(data["K"]).to(device), generator=torch.Generator(device=device).manual_seed(seed),
        pixel_rng=np.random.default_rng(1),
    )


def setup(args: argparse.Namespace):
    """``(run, data)`` for the parsed arguments (see :func:`load_data`)."""
    device = resolve_device(args.device)
    cfg = build_config(args)
    data = load_data(cfg, device)
    return make_run(cfg, data, device), data


def main(argv=None) -> Tuple[float, float, float]:
    args = parse_args(argv)
    run, data = setup(args)
    _, rot0, tr0 = align_poses(data["noisy_c2w"], data["gt_c2w"])
    print(f"initial pose error: rot {rot0.mean():.3f} deg, trans {tr0.mean():.4f}", flush=True)
    max_steps = run.cfg["max_steps"]
    timer = Timer()
    train(run, data["train_rgba"], max_steps + 1, log_every=max(1, max_steps // 10), anneal=not args.no_anneal)
    align, rot1, tr1 = align_poses(refined_poses(run), data["gt_c2w"])
    print(f"refined pose error: rot {rot1.mean():.3f} deg (was {rot0.mean():.3f}), trans {tr1.mean():.4f} "
          f"(was {tr0.mean():.4f})", flush=True)
    psnrs = evaluate(run, data["test_images"], data["test_c2w"], align)
    print(f"training done in {timer.elapsed():.1f}s", flush=True)
    print(f"FINAL mean PSNR {np.mean(psnrs):.2f} dB", flush=True)
    print(f"FINAL pose errors rot {rot1.mean():.3f} deg trans {tr1.mean():.4f}", flush=True)
    return float(np.mean(psnrs)), float(rot1.mean()), float(tr1.mean())


if __name__ == "__main__":
    main()
