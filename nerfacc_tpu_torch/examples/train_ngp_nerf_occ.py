"""Train Instant-NGP (hash grid) with occupancy-grid sampling.

Port of ``examples/train_ngp_nerf_occ.py``: the per-scene configuration
(NeRF-Synthetic, Mip-NeRF 360 unbounded, and the procedural scene when no
``--data_root`` is given; a Mip-NeRF 360 scene is read from its COLMAP
folder by ``nerf_360_v2.SubjectLoader``), the NGP field or ``--field tensorf|kplanes``, Adam (eps 1e-15, coupled weight decay) with the
JAX example's warm-up and step schedule, Huber loss, the occupancy update
every 16 steps, the macro-budget escalation, eval with PSNR, SSIM, MS-SSIM
and LPIPS, and checkpoints.

    python -m nerfacc_tpu_torch.examples.train_ngp_nerf_occ --smoke --device cpu
    python -m nerfacc_tpu_torch.examples.train_ngp_nerf_occ --dtype bf16   # on the card
    python -m nerfacc_tpu_torch.examples.train_ngp_nerf_occ --field tensorf
    python -m nerfacc_tpu_torch.examples.train_ngp_nerf_occ --scene garden --data_root <360_v2>

As in the JAX example, the ray count is fixed and the sample capacity is a
fixed budget (``target_sample_batch_size``), but for the Mip-NeRF 360
block, whose traversal those fixed shapes starve: there the ray count
follows upstream nerfacc's dynamic batch (:func:`fit_num_rays`).
:func:`train_step` and :func:`train` are the loop's own pieces, which other
programs call.
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
from ..models.ngp import NGPRadianceField
from ..models.tensorf import KPlanesRadianceField, TensoRFRadianceField
from ..rendering import gather_ray_od, occgrid_render_rays
from ..utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .common import (
    MIPNERF360_UNBOUNDED_SCENES,
    NERF_SYNTHETIC_SCENES,
    Timer,
    eval_metrics,
    render_image_chunked,
    scene_loaders,
)

Tensor = torch.Tensor

OCC_EVERY = 16  # steps between occupancy updates
WARMUP_STEPS = 256  # updates before this step probe every cell
MACRO_START, MACRO_CAP = 24, 64  # the macro budget and its escalation cap
TRUNC_LIMIT = 1e-3  # share of truncated rays that doubles the budget
INIT_RAYS = 1024  # the dynamic ray count's first (upstream nerfacc's init_batch_size)
MIN_RAYS = 64  # the fewest rays a step of the dynamic ray count takes
FILL = 0.8  # the share of the sample capacities the dynamic ray count aims at


def build_config(scene: str) -> dict:
    """The example's per-scene settings (``train_ngp_nerf_occ.py:45-74``),
    and for the Mip-NeRF 360 scenes upstream nerfacc's dynamic ray count
    (``dynamic_rays``, from :data:`INIT_RAYS` up to ``num_rays``; see
    :func:`fit_num_rays`) with up to ``traversal_capacity`` slots for the
    traversal and ``target_sample_batch_size`` for the filter's
    survivors."""
    cfg = dict(
        max_steps=20000,
        num_rays=8192,
        target_sample_batch_size=1 << 18,
        weight_decay=1e-6,
        aabb=np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32),
        near_plane=0.0,
        far_plane=1e10,
        grid_resolution=128,
        grid_nlvl=1,
        render_step_size=5e-3,
        alpha_thre=0.0,
        cone_angle=0.0,
        unbounded=False,
    )
    if scene in MIPNERF360_UNBOUNDED_SCENES:
        cfg.update(
            weight_decay=0.0,
            aabb=np.array([-1, -1, -1, 1, 1, 1], np.float32),
            near_plane=0.2,
            grid_nlvl=4,
            render_step_size=1e-3,
            alpha_thre=1e-2,
            cone_angle=0.004,
            unbounded=True,
            # Upstream nerfacc's dynamic ray count, up to num_rays: the JAX
            # example's fixed 8192 rays ask the traversal for ~500 samples
            # a ray at the start, and its 2^18 slots then hold the first
            # ~500 rays' only (ROADMAP Queue 3).  The traversal gets room
            # for all its samples (at most 2^21 slots) and the filter's
            # survivors are compacted into the 2^18 slots of the
            # differentiable pass.
            dynamic_rays=True,
            traversal_capacity=1 << 21,
        )
    elif scene in ["materials", "ficus", "drums"]:
        cfg.update(weight_decay=1e-5)
    return cfg


def lr_schedule(max_steps: int) -> Callable[[int], float]:
    """The learning rate of the ``count``-th update, as the JAX example's
    optax schedule computes it in float32 (``train_ngp_nerf_occ.py:188-201``):
    a linear warm-up from 1e-4 to 1e-2 over 100 updates, then 1e-2 times
    0.33 from each boundary on.  ``optax.join_schedules`` calls the second
    schedule with ``count - 100``, so the drops land at ``100 + max_steps //
    2``, ``100 + 3 max_steps // 4`` and ``100 + 9 max_steps // 10``, not at
    the unshifted milestones of upstream nerfacc's ``MultiStepLR``."""
    f32 = np.float32
    # A dict, as optax takes them: equal boundaries count once.
    drops = {max_steps // 2: 0.33, max_steps * 3 // 4: 0.33, max_steps * 9 // 10: 0.33}

    def schedule(count: int) -> float:
        if count < 100:
            frac = f32(1.0) - f32(min(max(count, 0), 100)) / f32(100)
            return float(f32(0.01 / 100 - 0.01) * frac + f32(0.01))
        v = f32(0.01)
        for boundary, scale in drops.items():
            if count - 100 >= boundary:
                v = f32(scale) * v
        return float(v)

    return schedule


def make_optimizer(field: torch.nn.Module, weight_decay: float) -> torch.optim.Adam:
    """Adam with eps 1e-15 and coupled weight decay: optax's
    ``add_decayed_weights`` ahead of ``scale_by_adam``."""
    return torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15, weight_decay=weight_decay)


def updates_done(opt: torch.optim.Optimizer) -> int:
    """The optimizer's update count (optax's ``count``), kept in its state."""
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state.get(p)
            if state and "step" in state:
                return int(state["step"])
    return 0


@dataclasses.dataclass
class Run:
    """What the loop carries from step to step."""

    cfg: dict
    field: torch.nn.Module  # NGPRadianceField, TensoRFRadianceField or KPlanesRadianceField
    estimator: OccGridEstimator
    occ_state: OccGridState
    opt: torch.optim.Optimizer
    schedule: Callable[[int], float]
    generator: torch.Generator  # the stratified jitter and the update draws
    step: int = 0
    max_macro: int = MACRO_START
    max_macro_cap: int = MACRO_CAP
    trunc: Optional[Tensor] = None  # the last step's truncated share, on the device
    sample_counts: Optional[Tensor] = None  # the last step's traversed, visible and unslotted samples, on the device
    traversal_slots: Optional[int] = None  # the dynamic ray count's traversal capacity

    @property
    def render_kwargs(self) -> dict:
        cfg = self.cfg
        return dict(
            near_plane=cfg["near_plane"], far_plane=cfg["far_plane"],
            render_step_size=cfg["render_step_size"], cone_angle=cfg["cone_angle"],
            alpha_thre=cfg["alpha_thre"],
        )


def make_fns(field: torch.nn.Module, rays_o: Tensor, rays_d: Tensor):
    """The example's ``sigma_fn`` and ``rgb_sigma_fn`` on flat samples."""

    def sigma_fn(t_starts, t_ends, ray_indices):
        o, d = gather_ray_od(rays_o, rays_d, ray_indices)
        return field.query_density(o + ((t_starts + t_ends) / 2.0)[:, None] * d)[..., 0]

    def rgb_sigma_fn(t_starts, t_ends, ray_indices):
        o, d = gather_ray_od(rays_o, rays_d, ray_indices)
        rgb, sigma = field(o + ((t_starts + t_ends) / 2.0)[:, None] * d, d)
        return rgb, sigma[..., 0]

    return sigma_fn, rgb_sigma_fn


def train_step(run: Run, rays_o: Tensor, rays_d: Tensor, pixels: Tensor, bkgd: Tensor,
               jitter: Tensor):
    """One step: render with the stratified ``jitter`` (``(n_rays,)`` in
    ``[0, 1)``), Huber loss, backward, Adam at the schedule's rate.  Returns
    ``(loss, n_samples, mse, truncated share)``, 0-d tensors on the device
    (no host read), and keeps the traversal's and the filter's sample counts
    and the traversal's samples that found no slot in ``run.sample_counts``.  With ``cfg["dynamic_rays"]`` the traversal
    has ``cfg["traversal_capacity"]`` slots (``run.traversal_slots`` once
    :func:`fit_num_rays` has set them) and the filter's survivors are
    compacted into ``target_sample_batch_size`` (``refilter_capacity``)."""
    lr = run.schedule(updates_done(run.opt))
    for group in run.opt.param_groups:
        group["lr"] = lr
    sigma_fn, rgb_sigma_fn = make_fns(run.field, rays_o, rays_d)
    cfg = run.cfg
    slots = cfg["target_sample_batch_size"]
    colors, _, _, n_samp, extras = occgrid_render_rays(
        rgb_sigma_fn, sigma_fn, run.estimator, run.occ_state, rays_o, rays_d,
        render_bkgd=bkgd, stratified=True, jitter=jitter,
        sample_capacity=(run.traversal_slots or cfg["traversal_capacity"]) if cfg.get("dynamic_rays") else slots,
        refilter_capacity=slots if cfg.get("dynamic_rays") else None,
        max_macro_segments=run.max_macro, **run.render_kwargs,
    )
    loss = torch.nn.functional.huber_loss(colors, pixels, delta=1.0)
    run.opt.zero_grad(set_to_none=True)
    with record_function("backward"):
        loss.backward()
    with record_function("optimizer"):
        run.opt.step()
    mse = torch.mean((colors.detach() - pixels) ** 2)
    run.sample_counts = torch.stack([extras["n_traversed"], extras["n_visible"], extras["n_over_capacity"]])
    return loss.detach(), n_samp, mse, extras["macro_truncated_frac"]


def fit_num_rays(run: Run, train_ds) -> None:
    """Upstream nerfacc's dynamic batch on the last step's counts: the ray
    count whose filter survivors fill :data:`FILL` of
    ``target_sample_batch_size`` (upstream's ``num_rays *
    target_sample_batch_size / n_samples``, ``n_samples`` the survivors),
    between :data:`MIN_RAYS` and ``cfg["num_rays"]``, and fewer where their
    traversal would pass :data:`FILL` of ``traversal_capacity`` slots;
    then ``run.traversal_slots``, room for those rays' traversal with the
    same margin (the traversal of upstream nerfacc has no capacity).  The
    loop calls it at the occupancy-update cadence, where it reads the
    device anyway."""
    cfg = run.cfg
    traversed, visible = (max(float(v), 1.0) for v in run.sample_counts[:2])
    n = train_ds.num_rays
    per_ray = traversed / n
    slots_max = cfg["traversal_capacity"]
    rays = min(FILL * cfg["target_sample_batch_size"] / visible * n, FILL * slots_max / per_ray)
    rays = max(MIN_RAYS, min(cfg["num_rays"], int(rays)))
    slots = -(-int(per_ray * rays / FILL) // 1024) * 1024
    run.traversal_slots = max(cfg["target_sample_batch_size"], min(slots_max, slots))
    train_ds.update_num_rays(rays)


def occ_update(run: Run, warmup: bool, draws=None) -> None:
    """The occupancy EMA update (``train_ngp_nerf_occ.py:290-302``): every
    cell during warm-up, else the post-warm-up draws; ``draws`` (see
    ``OccGridEstimator.make_draws``) default to draws from the run's
    generator."""
    step_size = run.cfg["render_step_size"]
    with record_function("occ_update"):
        run.occ_state = run.estimator._update(
            run.occ_state, 0 if warmup else 10**9,
            lambda x: run.field.query_density(x) * step_size,
            warmup_steps=1, draws=draws, generator=run.generator,
        )


def train(run: Run, train_ds: SubjectLoader, until: int, *, log_every: int = 0,
          ckpt_every: int = 0, model_path: Optional[str] = None,
          jitter: Optional[Callable[[int], Tensor]] = None,
          draws: Optional[Callable[[int], Sequence[dict]]] = None):
    """Train from ``run.step`` up to step ``until`` (exclusive), as the JAX
    example's loop (``train_ngp_nerf_occ.py:336-380``): an occupancy update
    every 16 steps (warm-up below step 256), and at that cadence, the only
    host read of the loop, the previous step's truncated share, which
    doubles the macro budget up to ``run.max_macro_cap`` when it passes
    0.1%; with ``cfg["dynamic_rays"]``, :func:`fit_num_rays` there too.
    ``jitter(step)`` and ``draws(step)`` replace the run generator's draws.
    Returns the steps' losses and kept-sample counts (lists of 0-d device
    tensors)."""
    losses: List[Tensor] = []
    n_samples: List[Tensor] = []
    timer = Timer()
    dev = run.occ_state.occs.device
    while run.step < until:
        step = run.step
        if step % OCC_EVERY == 0:
            occ_update(run, warmup=step < WARMUP_STEPS, draws=None if draws is None else draws(step))
            if run.trunc is not None and run.max_macro < run.max_macro_cap:
                trunc_frac = float(run.trunc)
                if trunc_frac > TRUNC_LIMIT:
                    run.max_macro = min(run.max_macro_cap, run.max_macro * 2)
                    print(f"step={step}: {trunc_frac:.1%} of rays macro-truncated; raising "
                          f"max_macro_segments to {run.max_macro}", flush=True)
            if run.cfg.get("dynamic_rays") and run.sample_counts is not None:
                fit_num_rays(run, train_ds)
        with record_function("fetch"):
            batch = train_ds[step % len(train_ds)]
        rays = batch["rays"]
        n_rays = rays.origins.shape[0]
        u = (jitter(step) if jitter is not None
             else torch.rand((n_rays,), generator=run.generator, device=run.generator.device)).to(dev)
        loss, n_samp, mse, run.trunc = train_step(
            run, rays.origins, rays.viewdirs, batch["pixels"], batch["color_bkgd"], u
        )
        losses.append(loss)
        n_samples.append(n_samp)
        if log_every and step % log_every == 0:
            train_psnr = -10.0 * np.log10(max(float(mse), 1e-10))
            print(f"elapsed={timer.elapsed():.1f}s step={step} loss={float(loss):.5f} "
                  f"psnr={train_psnr:.2f} n_samples={int(n_samp)} rays={n_rays}", flush=True)
        if model_path and ckpt_every and step and step % ckpt_every == 0:
            save(run, model_path, step)
        run.step += 1
    return losses, n_samples


@torch.no_grad()
def render_image(run: Run, rays, chunk: int) -> Tensor:
    """An eval image (``train_ngp_nerf_occ.py:304-322``): white background,
    ``chunk * 64`` sample slots a chunk, no jitter, the run's macro budget
    (the JAX example's eval keeps the initial 24 segments after training
    raised it, and cuts the rays the training traversed further).  With
    ``cfg["dynamic_rays"]`` every sample is rendered, as upstream nerfacc's
    eval, which has no capacity, renders them: a chunk whose traversal finds
    more samples than its slots hold renders again with room for 1.25 times
    them (or twice the slots, if more), and the filter's survivors are
    compacted into ``chunk * 64`` slots for the field's colour pass (more
    where more survive); past ``cfg["traversal_capacity"]`` slots the chunk
    is rendered in parts instead, and the next chunks start with the slots
    and parts that sufficed."""
    white = torch.ones(3, device=rays.origins.device)
    dynamic = run.cfg.get("dynamic_rays")
    capacity = refilter = chunk * 64
    parts = 1

    def render_part(o, d):
        """The colours of rays ``o, d``, or None where they need more than
        the traversal's most slots."""
        nonlocal capacity, refilter
        sigma_fn, rgb_sigma_fn = make_fns(run.field, o, d)
        while True:
            colors, _, _, _, extras = occgrid_render_rays(
                rgb_sigma_fn, sigma_fn, run.estimator, run.occ_state, o, d, render_bkgd=white,
                sample_capacity=capacity, refilter_capacity=refilter if dynamic else None,
                max_macro_segments=run.max_macro, **run.render_kwargs,
            )
            if not dynamic:
                return colors
            over, visible = int(extras["n_over_capacity"]), int(extras["n_visible"])
            if over == 0 and visible <= refilter:
                return colors
            if over:
                capacity = max(2 * capacity, -(-int(1.25 * int(extras["n_traversed"])) // 1024) * 1024)
            if visible > refilter:
                refilter = -(-int(1.25 * visible) // 1024) * 1024
            most = run.cfg["traversal_capacity"]
            if capacity > most or refilter > most:
                capacity, refilter = min(capacity, most), min(refilter, most)
                return None

    def render(o, d):
        nonlocal parts
        while True:
            pieces = [render_part(oo, dd) for oo, dd in zip(o.chunk(parts), d.chunk(parts))]
            if all(p is not None for p in pieces):
                return torch.cat(pieces)
            parts *= 2

    return render_image_chunked(render, rays, chunk=chunk)


def evaluate(run: Run, test_ds: SubjectLoader, chunk: int) -> List[dict]:
    """Every test view's :func:`~nerfacc_tpu_torch.examples.common.eval_metrics`."""
    out = []
    for i in range(len(test_ds)):
        batch = test_ds[i]
        m = eval_metrics(render_image(run, batch["rays"], chunk), batch["pixels"])
        out.append(m)
        print(f"  eval img {i}: PSNR {m['psnr']:.2f} ssim {m['ssim']:.4f} ms-ssim {m['ms_ssim']:.4f} "
              f"lpips({m['lpips_src']}) {m['lpips']:.4f}", flush=True)
    return out


def checkpoint_state(run: Run) -> dict:
    """What the JAX example saves: field parameters, optimizer state and
    occupancy state (the skip and packed grids are rebuilt from the
    binaries)."""
    s = run.occ_state
    return {
        "params": run.field.state_dict(),
        "opt_state": run.opt.state_dict(),
        "occ_state": {"aabbs": s.aabbs, "occs": s.occs, "binaries": s.binaries},
    }


def save(run: Run, model_path: str, step: int) -> None:
    save_checkpoint(model_path, checkpoint_state(run), step)
    print(f"saved checkpoint at step {step} -> {model_path}", flush=True)


def restore_occ_state(estimator: OccGridEstimator, occ: dict) -> OccGridState:
    """An :class:`OccGridState` from a checkpoint's ``occ_state``."""
    base = estimator.init(occ["occs"].device)
    return estimator.set_binaries(base, occ["binaries"]).replace(aabbs=occ["aabbs"], occs=occ["occs"])


def resume(run: Run, model_path: str) -> None:
    """Restore parameters, optimizer state, occupancy state and step."""
    target = checkpoint_state(run)
    target["opt_state"] = None  # an optimizer that has not stepped has no state to match
    state, step = restore_checkpoint(model_path, target)
    run.field.load_state_dict(state["params"])
    run.opt.load_state_dict(state["opt_state"])
    run.occ_state = restore_occ_state(run.estimator, state["occ_state"])
    run.step = step


def make_field(cfg: dict, estimator: OccGridEstimator, encoder: str = "fused", field: str = "ngp",
               levels: Optional[int] = None, feats: Optional[int] = None, log2t: Optional[int] = None,
               dtype: str = "f32", *, device, generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """The example's radiance field (``train_ngp_nerf_occ.py:162-185``) on
    the estimator's last-level box: for ``ngp`` the fused and folded
    encoders at L8 x F16 with 2^18 entries by default, the others
    (``hash``, ``soa``, the grouped tcnn shape) at L16 x F2 with 2^19;
    ``tensorf`` and ``kplanes`` at their defaults.  The example calls every
    field as ``(x, d)``, which puts ``d`` in K-Planes' ``t``: its colour is
    view-independent, from an MLP of 32 inputs (``use_viewdirs=False``)."""
    aabb = tuple(float(v) for v in estimator._aabbs_np[-1])
    if field == "tensorf":
        return TensoRFRadianceField(aabb=aabb, device=device, generator=generator)
    if field == "kplanes":
        return KPlanesRadianceField(aabb=aabb, use_viewdirs=False, device=device, generator=generator)
    fused = encoder in ("fused", "folded")
    return NGPRadianceField(
        aabb=aabb,
        unbounded=cfg["unbounded"],
        encoder_type=encoder,
        n_levels=levels or (8 if fused else 16),
        n_features_per_level=feats or (16 if fused else 2),
        log2_hashmap_size=log2t or (18 if fused else 19),
        compute_dtype=torch.bfloat16 if dtype == "bf16" else None,
        device=device,
        generator=generator,
    )


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--train_split", type=str, default="train")
    p.add_argument("--scene", type=str, default="lego",
                   choices=NERF_SYNTHETIC_SCENES + MIPNERF360_UNBOUNDED_SCENES + ["procedural"])
    p.add_argument("--model_path", type=str, default=None,
                   help="checkpoint directory (saved at the end and every --ckpt_every steps)")
    p.add_argument("--resume", action="store_true", help="restore params/opt/occ/step from --model_path")
    p.add_argument("--ckpt_every", type=int, default=0, help="0 = only at the end")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--num_rays", type=int, default=None)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--encoder", type=str, default="fused", choices=["hash", "soa", "fused", "folded", "grouped"],
                   help="'hash' and 'soa' = tcnn's parametrisation; 'grouped' = its 16L x 2F shape in 128-wide rows")
    p.add_argument("--field", type=str, default="ngp", choices=["ngp", "tensorf", "kplanes"],
                   help="radiance field family (tensorf and kplanes: the reference's benchmark plug-ins)")
    p.add_argument("--levels", type=int, default=None, help="hash-grid levels (default 8 fused/folded, else 16)")
    p.add_argument("--feats", type=int, default=None)
    p.add_argument("--log2t", type=int, default=None)
    p.add_argument("--dtype", type=str, default="f32", choices=["f32", "bf16"],
                   help="field compute precision (parameters and Adam stay float32)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def setup(args: argparse.Namespace):
    """``(run, train_ds, test_ds, eval_chunk)`` for the parsed arguments."""
    device = resolve_device(args.device)
    cfg = build_config(args.scene)
    procedural = args.smoke or args.data_root is None or args.scene == "procedural"
    if procedural:
        cfg["aabb"] = np.array([-1, -1, -1, 1, 1, 1], np.float32)
        cfg["grid_resolution"] = 64 if not args.smoke else 32
        cfg["render_step_size"] = 5e-3 if not args.smoke else 1e-2
        cfg["num_rays"] = 1024 if args.smoke else 4096
        cfg["target_sample_batch_size"] = cfg["num_rays"] * (16 if args.smoke else 32)
        cfg["max_steps"] = args.max_steps or (200 if args.smoke else 4000)
        train_ds, test_ds = make_loaders(
            num_rays=cfg["num_rays"],
            width=96 if args.smoke else 160,
            height=96 if args.smoke else 160,
            n_train=12 if args.smoke else 36,
            n_test=1 if args.smoke else 2,
            device=device,
        )
        cfg["near_plane"], cfg["far_plane"] = train_ds.near, train_ds.far
    else:
        first_rays = min(INIT_RAYS, cfg["num_rays"]) if cfg.get("dynamic_rays") else cfg["num_rays"]
        train_ds, test_ds = scene_loaders(args.scene, args.data_root, args.train_split, first_rays, device)
        if args.max_steps:
            cfg["max_steps"] = args.max_steps
    if args.num_rays:
        cfg["num_rays"] = args.num_rays
        train_ds.update_num_rays(min(args.num_rays, INIT_RAYS) if cfg.get("dynamic_rays") else args.num_rays)

    estimator = OccGridEstimator(roi_aabb=cfg["aabb"], resolution=cfg["grid_resolution"], levels=cfg["grid_nlvl"])
    field = make_field(cfg, estimator, args.encoder, args.field, args.levels, args.feats, args.log2t, args.dtype,
                       device=device, generator=torch.Generator().manual_seed(42))
    run = Run(
        cfg=cfg, field=field, estimator=estimator, occ_state=estimator.init(device),
        opt=make_optimizer(field, cfg["weight_decay"]), schedule=lr_schedule(cfg["max_steps"]),
        generator=torch.Generator(device=device).manual_seed(42),
    )
    return run, train_ds, test_ds, 2048 if args.smoke else 8192


def main(argv=None) -> float:
    args = parse_args(argv)
    run, train_ds, test_ds, eval_chunk = setup(args)
    n_params = sum(p.numel() for p in run.field.parameters())
    print(f"NGP field params: {n_params / 1e6:.2f} M", flush=True)
    if args.resume and args.model_path and latest_step(args.model_path):
        resume(run, args.model_path)
        print(f"resumed from {args.model_path} at step {run.step}", flush=True)

    max_steps = run.cfg["max_steps"]
    timer = Timer()
    train(run, train_ds, max_steps + 1, log_every=max(1, max_steps // 10),
          ckpt_every=args.ckpt_every, model_path=args.model_path)
    total = timer.elapsed()
    print(f"training done in {total:.1f}s", flush=True)
    metrics = evaluate(run, test_ds, eval_chunk)
    psnrs = [m["psnr"] for m in metrics]
    print(f"FINAL mean PSNR {np.mean(psnrs):.2f} dB ms-ssim {np.mean([m['ms_ssim'] for m in metrics]):.4f} "
          f"in {total:.1f}s", flush=True)
    if args.model_path:
        save(run, args.model_path, max_steps)
    return float(np.mean(psnrs))


if __name__ == "__main__":
    main()
