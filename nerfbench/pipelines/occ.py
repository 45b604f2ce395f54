"""Instant-NGP trained through the occupancy grid, as the port's
``examples/train_ngp_nerf_occ.py`` trains it: the window calls its
``train`` (``train_step`` and ``occ_update``) on the program's
``SubjectLoader`` batches, in segments of one update cycle.

With ``dynamic_rays`` the ray count is upstream nerfacc's dynamic batch as
the program computes it (``fit_num_rays`` at the update cadence, from
``init_num_rays`` up to ``num_rays``), and the traversal's samples pass
the visibility filter before the differentiable pass.

Set-up makes the views, loads the seeded weights, and trains the first
``checked_steps`` steps through that same ``train`` while recording what
the reference needs (the batches; the draws come from per-step seeds) and
what it compares (each step's loss, the first gradient as Adam holds it,
each leaf's change).  The reference follows those steps from the same
weights and draws once the window has closed and the program is freed.

The pruned regime, which holds most of the window, is checked on the step
after the window: an update step past warm-up.  Its parameters, Adam's
moments and the occupancy state before it are kept, and the program's
update, colours, loss, gradients and change after it; the reference works
that update and step out again from the kept state.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from nerfacc_tpu_torch.datasets.nerf_synthetic import SubjectLoader
from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
from nerfacc_tpu_torch.examples import train_ngp_nerf_occ as occ_cli
from nerfacc_tpu_torch.examples.train_ngp_nerf_occ import updates_done
from nerfacc_tpu_torch.models.ngp import NGPRadianceField

from .. import checks, scene
from ..flops import TRAIN_FACTOR, field_flops, update_points
from ..reference import field as ref_field
from ..reference import occgrid as ref_occ
from ..reference import render as ref_render
from ..weights import load_into, seeded_weights
from . import TrainingCell, ngp_kwargs

Tensor = torch.Tensor
JITTER, DRAWS, WEIGHTS, LOADER = 1, 2, 3, 4
BETA1 = 0.9


def lr_at(count: int, max_steps: int) -> float:
    """The CLI's schedule: a linear warm-up from 1e-4 to 1e-2 over 100
    updates, then 0.33x from ``100 + max_steps * (1/2, 3/4, 9/10)`` on."""
    if count < 100:
        return 1e-4 + (1e-2 - 1e-4) * count / 100
    return 1e-2 * 0.33 ** sum(count - 100 >= b for b in {max_steps // 2, max_steps * 3 // 4, max_steps * 9 // 10})


class Cell(TrainingCell):
    # The dynamic ray count holds a step's samples, not its rays: the rays
    # a step takes follow the samples a ray that the seed's field grows.
    work_metric = "train_samples_per_s"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, views=None):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.dynamic = bool(cfg.get("dynamic_rays"))
        sc = cfg["scene"]
        self.views = views or scene.make_views(sc, sc["pose_seed"], device)
        train_im, train_c2w, _, _, focal = self.views
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()  # the program's peak, not the views'
        self.train_ds = checks.RecordingLoader(SubjectLoader(
            split="train", num_rays=cfg["init_num_rays"] if self.dynamic else cfg["num_rays"], images=train_im,
            camtoworlds=train_c2w, focal=focal, color_bkgd_aug=traffic["background"],
            seed=checks.step_seed(seed, 0, LOADER), device=device))
        ocfg = dict(
            max_steps=cfg["max_steps"], num_rays=cfg["num_rays"],
            target_sample_batch_size=cfg["target_sample_batch_size"], weight_decay=cfg["optimizer"]["weight_decay"],
            aabb=np.array(cfg["aabb"], np.float32), near_plane=cfg["near_plane"], far_plane=cfg["far_plane"],
            grid_resolution=cfg["grid_resolution"], grid_nlvl=cfg["grid_nlvl"],
            render_step_size=cfg["render_step_size"], alpha_thre=cfg["alpha_thre"], cone_angle=cfg["cone_angle"],
            unbounded=False,
        )
        if self.dynamic:
            ocfg.update(dynamic_rays=True, traversal_capacity=cfg["traversal_capacity"])
        est = OccGridEstimator(roi_aabb=ocfg["aabb"], resolution=cfg["grid_resolution"], levels=cfg["grid_nlvl"])
        # The field on the estimator's box, as the CLI's make_field builds it.
        field = NGPRadianceField(aabb=tuple(float(v) for v in est._aabbs_np[-1]), **ngp_kwargs(cfg["field"]),
                                 device=device, generator=torch.Generator().manual_seed(0))
        load_into(field, seeded_weights(cfg["field"], checks.step_seed(seed, 0, WEIGHTS), device))
        self.run = occ_cli.Run(
            cfg=ocfg, field=field, estimator=est, occ_state=est.init(device),
            opt=occ_cli.make_optimizer(field, ocfg["weight_decay"]), schedule=occ_cli.lr_schedule(cfg["max_steps"]),
            generator=torch.Generator(device=device).manual_seed(checks.step_seed(seed, 0, JITTER)),
        )
        self.cells = cfg["grid_resolution"] ** 3
        self.losses: List[Tensor] = []
        self.samples: List[Tensor] = []
        self.readings: Dict[str, object] = {}
        self.rays = 0  # rays the loop has drawn
        self.counts = None  # while a list: each step's sample counts, kept as the loop reads its jitter
        self.window = None

    @property
    def step(self) -> int:
        return self.run.step

    # Draws, from per-step seeds, so that the reference draws them again.
    def jitter(self, step: int, n: int = None) -> Tensor:
        """The stratified jitter of ``step``'s ``n`` rays; without ``n`` the
        loop's call, for the loader's current ray count, which also counts
        the rays and, in the window, keeps the previous step's sample
        counts and marks the time at each update step."""
        if n is None:
            n = self.train_ds.num_rays
            self.rays += n
            if self.counts is not None:
                self.counts.append(self.run.sample_counts)
                if step % self.cfg["occ_every"] == 0:
                    # The loop has just read the device (fit_num_rays):
                    # every earlier step's work is done.
                    self.mark(step)
        g = torch.Generator(device=self.device).manual_seed(checks.step_seed(self.seed, step, JITTER))
        return torch.rand((n,), generator=g, device=self.device)

    def draws(self, step: int) -> List[dict]:
        g = torch.Generator(device=self.device).manual_seed(checks.step_seed(self.seed, step, DRAWS))
        if step < self.cfg["warmup_steps"]:
            return [{"jitter": torch.rand((self.cells, 3), generator=g, device=self.device)}]
        n = self.cells // 4
        return [{
            "uniform": torch.randint(0, self.cells, (n,), generator=g, device=self.device),
            "offset": torch.rand((), generator=g, device=self.device),
            "jitter": torch.rand((2 * n, 3), generator=g, device=self.device),
        }]

    def _train(self, until: int):
        return occ_cli.train(self.run, self.train_ds, until, jitter=self.jitter, draws=self.draws)

    def setup(self) -> None:
        run, k = self.run, self.traffic["checked_steps"]
        start = {n: p.detach().clone() for n, p in run.field.named_parameters()}
        self.train_ds.batches = []
        colours: List[Tensor] = []
        with checks.recording_colours(occ_cli, "occgrid_render_rays", colours):
            losses, _ = self._train(1)
        self.readings["colours"] = colours[0]
        # Adam's first moment after one step is (1 - beta1) times the
        # gradient it was given; a parameter that never stepped has none.
        self.readings["first_grad"] = {
            n: float((run.opt.state[p]["exp_avg"] / (1 - BETA1)).double().norm()) if p in run.opt.state else 0.0
            for n, p in run.field.named_parameters()}
        more, _ = self._train(k)
        self.readings["losses"] = [float(v) for v in losses + more]
        self.readings["change"] = checks.norms({n: p.detach() - start[n] for n, p in run.field.named_parameters()})
        self.batches = [(b["rays"].origins, b["rays"].viewdirs, b["color_bkgd"]) for b in self.train_ds.batches]
        self.train_ds.batches = None
        del start
        # The post-warm-up update (its draw, K3) on a state that is thrown
        # away, so that the window loads nothing.
        saved = run.occ_state
        occ_cli.occ_update(run, warmup=False, draws=self.draws(1 << 30))
        run.occ_state = saved

    def segment(self) -> int:
        if self.window is None:
            self.window = dict(step=self.run.step, rays=self.rays)
            self.counts, self.marks = [], []
        every = self.cfg["occ_every"]
        until = (self.run.step // every + 1) * every
        losses, samples = self._train(until)
        self.losses += losses
        self.samples += samples
        return torch.stack(samples).sum()  # on the device: no host read

    def window_context(self) -> dict:
        """The window's steps, rays and kept samples, the model FLOPs of
        its work (each kept sample trained, each sample of the visibility
        filter's density pass, each probe of the updates), and the wall
        time a step of its last segments, past warm-up."""
        if self.window is None:
            return {}
        first, steps = self.window["step"], len(self.losses)
        # The first kept counts are the step's before the window's.
        counts = torch.stack(self.counts[1:] + [self.run.sample_counts]).double().sum(0)
        self.counts = None
        kept = float(torch.stack(self.samples).double().sum())
        fcfg = self.cfg["field"]
        probes = update_points(range(first, first + steps), self.cfg["occ_every"], self.cfg["warmup_steps"],
                               self.cells)
        filtered = float(counts[0] - counts[2]) if self.dynamic or self.cfg["alpha_thre"] > 0 else 0.0
        flops = (TRAIN_FACTOR * kept * field_flops(fcfg)
                 + (filtered + probes) * field_flops(fcfg, colour=False))
        return dict(window_samples=kept, window_rays=self.rays - self.window["rays"], window_steps=steps,
                    window_flops=flops, late_step_s=self.late_step_s(self.run.step))

    def after_window(self) -> None:
        """The step after the window, with what the reference needs to work
        it out again; then the rest of its update cycle, so that a trace
        starts at an update step."""
        run, every = self.run, self.cfg["occ_every"]
        if run.step < self.cfg["warmup_steps"]:
            self._train(self.cfg["warmup_steps"])
        s = run.step
        assert s % every == 0, s
        leaves = dict(run.field.named_parameters())
        before = {n: p.detach().clone() for n, p in leaves.items()}
        # A parameter that never stepped has no moments yet (zeros).
        moments = tuple({n: run.opt.state[p][k].clone() for n, p in leaves.items() if k in run.opt.state.get(p, {})}
                        for k in ("exp_avg", "exp_avg_sq"))
        count = updates_done(run.opt)
        occs, binaries = run.occ_state.occs.clone(), run.occ_state.binaries.clone()
        self.train_ds.batches = []
        colours: List[Tensor] = []
        with checks.recording_colours(occ_cli, "occgrid_render_rays", colours):
            losses, _ = self._train(s + 1)
        b = self.train_ds.batches[0]
        self.train_ds.batches = None
        self.late = dict(step=s, params=before, moments=moments, count=count, occs=occs, binaries=binaries,
                         batch=(b["rays"].origins, b["rays"].viewdirs, b["color_bkgd"]),
                         slots=run.traversal_slots or self.cfg.get("traversal_capacity"), max_macro=run.max_macro)
        self.readings["late"] = dict(
            loss=float(losses[0]), colours=colours[0], occs=run.occ_state.occs.clone(),
            binaries=run.occ_state.binaries.clone(),
            grad=checks.norms({n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in leaves.items()}),
            change=checks.norms({n: p.detach() - before[n] for n, p in leaves.items()}))
        self._train(s + every)

    def trace_slice(self, steps: int) -> dict:
        """``steps`` steps from an update step on."""
        every = self.cfg["occ_every"]
        start = self.run.step
        assert start % every == 0
        self._train(start + steps)
        return dict(steps=steps, updates=len(range(start, start + steps, every)))

    @torch.no_grad()
    def evaluate(self) -> float:
        _, _, test_im, test_c2w, focal = self.views
        test = SubjectLoader(split="test", images=test_im, camtoworlds=test_c2w, focal=focal, device=self.device)
        out = []
        for i in range(len(test)):
            img = occ_cli.render_image(self.run, test[i]["rays"], self.traffic["eval_chunk"])
            out.append(checks.psnr(img, checks.composite_white(test_im[i], self.device)))
        return float(np.mean(out))

    # The reference.
    def _ref_render(self, o: Tensor, d: Tensor, bkgd: Tensor, step: int, binaries: Tensor, occs: Tensor,
                    params: Dict[str, Tensor], capacity: int, max_macro: int):
        """Step ``step``'s colours of rays ``o, d`` on the grid ``binaries``
        (``occs`` its EMA), and the rays that have samples."""
        cfg = self.cfg
        fcfg, rs = cfg["field"], cfg["render_step_size"]
        aabb = torch.tensor(cfg["aabb"], dtype=torch.float32, device=o.device)
        lattice = int(np.ceil(float(np.linalg.norm(np.subtract(cfg["aabb"][3:], cfg["aabb"][:3]))) / rs))
        stride = max(4, min(64, int(2 * 2 * (cfg["aabb"][3] - cfg["aabb"][0]) / cfg["grid_resolution"] / rs)))
        near = cfg["near_plane"] + self.jitter(step, o.shape[0]) * rs
        ray, t0, t1 = ref_occ.march(o, d, near, binaries, aabb, rs, lattice, stride, max_macro, capacity,
                                    far_plane=cfg["far_plane"])
        if self.dynamic or cfg["alpha_thre"] > 0:
            frozen = {k: v.detach() for k, v in params.items()}
            x = o[ray] + ((t0 + t1) / 2.0)[:, None] * d[ray]
            with torch.no_grad():
                sigma = ref_field.in_chunks(
                    lambda a, b: ref_field.density_and_features(x[a:b], frozen, fcfg, aabb)[0], x.shape[0],
                    cfg["target_sample_batch_size"])
            keep = ref_occ.visible(ray, t0, t1, sigma, o.shape[0], min(float(occs.mean()), cfg["alpha_thre"]),
                                   cfg["target_sample_batch_size"])
            ray, t0, t1 = ray[keep], t0[keep], t1[keep]
        x = o[ray] + ((t0 + t1) / 2.0)[:, None] * d[ray]
        rgb, sigma = ref_field.radiance(x, d[ray], params, fcfg, aabb)
        return ref_render.composite_flat(ray, t0, t1, rgb, sigma, o.shape[0], bkgd), torch.unique(ray)

    def _ref_update(self, occs: Tensor, binaries: Tensor, params: Dict[str, Tensor], step: int):
        cfg = self.cfg
        aabb = torch.tensor(cfg["aabb"], dtype=torch.float32, device=occs.device)
        frozen = {k: v.detach() for k, v in params.items()}
        with torch.no_grad():
            dens = lambda x: ref_field.in_chunks(  # noqa: E731
                lambda a, b: ref_field.density_and_features(x[a:b], frozen, cfg["field"], aabb)[0], x.shape[0],
                cfg["target_sample_batch_size"])
            return ref_occ.update(occs, binaries, dens, aabb, cfg["grid_resolution"], cfg["render_step_size"],
                                  step < cfg["warmup_steps"], self.draws(step)[0])

    def reference(self) -> Dict[str, float]:
        cfg, dev = self.cfg, self.device
        opt = cfg["optimizer"]
        train_im, train_c2w, _, _, focal = self.views
        images = torch.from_numpy(train_im).to(dev)
        c2w = torch.from_numpy(train_c2w).to(dev)
        start = seeded_weights(cfg["field"], checks.step_seed(self.seed, 0, WEIGHTS), dev)
        params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
        adam = ref_render.Adam(params, eps=opt["eps"], weight_decay=opt["weight_decay"])
        res = cfg["grid_resolution"]
        occs = torch.zeros(res**3, device=dev)
        binaries = torch.zeros((1, res, res, res), dtype=torch.bool, device=dev)
        capacity = cfg["traversal_capacity"] if self.dynamic else cfg["target_sample_batch_size"]
        losses = []
        for s, (o_p, d_p, bkgd) in enumerate(self.batches):
            o, d, pixels = checks.rays_from_batch(o_p, d_p, bkgd, images, c2w, focal)
            if s % cfg["occ_every"] == 0:
                occs, binaries = self._ref_update(occs, binaries, params, s)
            colors, sampled = self._ref_render(o, d, bkgd, s, binaries, occs, params, capacity,
                                               cfg["max_macro_segments"])
            if s == 0:
                ref_colours, first_sampled = colors.detach(), sampled
            loss = ref_render.huber(colors, pixels)
            losses.append(float(loss.detach()))
            adam.step(ref_render.grads_of(loss, params), lr_at(s, cfg["max_steps"]))
        ref_grad = checks.norms(adam.first_grad)
        ref_change = checks.norms({k: params[k].detach() - start[k] for k in params})
        moving = checks.moving_leaves(ref_grad)
        r = self.readings
        self.detail = dict(losses=(r["losses"], losses),
                           grad=checks.leaf_gaps(r["first_grad"], ref_grad, list(ref_grad)),
                           change=checks.leaf_gaps(r["change"], ref_change, moving),
                           ref_grad=ref_grad, ref_change=ref_change)
        out = {
            "colour_gap": checks.colour_gap(r["colours"], ref_colours, first_sampled),
            "loss_gap": checks.loss_gap(r["losses"], losses),
            "grad_gap": max(self.detail["grad"].values()),
            "change_gap": max(self.detail["change"].values()),
        }
        del params, adam, start
        out.update(self._late_reference(images, c2w, focal))
        return out

    def _late_reference(self, images: Tensor, c2w: Tensor, focal: float) -> Dict[str, float]:
        """The step after the window worked out again from the program's
        state before it: the update, the march, the filter, the field,
        the loss, the gradients and Adam's step."""
        cfg, late, r = self.cfg, self.late, self.readings["late"]
        opt, s = cfg["optimizer"], late["step"]
        params = {k: v.clone().requires_grad_(True) for k, v in late["params"].items()}
        occs, binaries = self._ref_update(late["occs"], late["binaries"], params, s)
        o, d, pixels = checks.rays_from_batch(*late["batch"], images, c2w, focal)
        colours, sampled = self._ref_render(o, d, late["batch"][2], s, binaries, occs, params, late["slots"],
                                            late["max_macro"])
        loss = ref_render.huber(colours, pixels)
        grads = ref_render.grads_of(loss, params)
        adam = ref_render.Adam(params, eps=opt["eps"], weight_decay=opt["weight_decay"], moments=late["moments"],
                               count=late["count"])
        adam.step(grads, lr_at(late["count"], cfg["max_steps"]))
        ref_grad = checks.norms(grads)
        ref_change = checks.norms({k: params[k].detach() - late["params"][k] for k in params})
        self.detail["late"] = dict(loss=(r["loss"], float(loss.detach())), step=s, rays=o.shape[0],
                                   grad=checks.leaf_gaps(r["grad"], ref_grad, list(ref_grad)),
                                   change=checks.leaf_gaps(r["change"], ref_change, checks.moving_leaves(ref_grad)))
        return {
            "late_occs_gap": float((r["occs"] - occs).abs().max() / occs.abs().max().clamp(min=1e-30)),
            "late_flip_share": float((r["binaries"] != binaries).double().mean()),
            "late_colour_gap": checks.colour_gap(r["colours"], colours.detach(), sampled),
            "late_loss_gap": checks.loss_gap([r["loss"]], [float(loss.detach())]),
            "late_grad_gap": max(self.detail["late"]["grad"].values()),
            "late_change_gap": max(self.detail["late"]["change"].values()),
        }
