"""Instant-NGP trained through one proposal network, as the port's
``examples/train_ngp_nerf_prop.py`` trains it: the window calls its
``train`` (``train_step``: the proposal and final resampling, the field,
Huber plus the proposal loss, one backward and two Adams at the annealed
cadence) on the program's ``SubjectLoader`` batches, 16 steps a segment.

The stratified offsets come from the run's generator, seeded by the
benchmark; the reference draws them again from a generator seeded alike
(one ``(rays, 1)`` draw for the proposal level, then one for the final
pass, each step).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from nerfacc_tpu_torch.datasets.nerf_synthetic import SubjectLoader
from nerfacc_tpu_torch.estimators.prop_net import get_proposal_requires_grad_fn
from nerfacc_tpu_torch.examples import train_ngp_nerf_prop as prop_cli
from nerfacc_tpu_torch.examples.common import render_image_chunked
from nerfacc_tpu_torch.models.ngp import NGPDensityField, NGPRadianceField

from .. import checks, scene
from ..flops import TRAIN_FACTOR, field_flops
from ..reference import field as ref_field
from ..reference import render as ref_render
from ..weights import load_into, seeded_weights
from . import TrainingCell, ngp_kwargs

Tensor = torch.Tensor
JITTER, WEIGHTS, PROP_WEIGHTS, LOADER = 1, 3, 5, 4
BETA1 = 0.9
SEGMENT = 16


def proposal_cadence(steps: int, target: float = 5.0, num_steps: int = 1000) -> List[bool]:
    """Whether each of steps ``0 .. steps - 1`` updates the proposal net:
    once more than ``min(step / num_steps, 1) * target`` steps have passed
    since the last update."""
    out, since = [], 0
    for step in range(steps):
        grad = since > min(step / num_steps, 1.0) * target
        since = 1 if grad else since + 1
        out.append(grad)
    return out


class Cell(TrainingCell):
    work_metric = "train_rays_per_s"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, views=None):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        sc = cfg["scene"]
        self.views = views or scene.make_views(sc, sc["pose_seed"], device)
        train_im, train_c2w, _, _, focal = self.views
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()  # the program's peak, not the views'
        self.train_ds = checks.RecordingLoader(SubjectLoader(
            split="train", num_rays=cfg["num_rays"], images=train_im, camtoworlds=train_c2w, focal=focal,
            color_bkgd_aug=traffic["background"], seed=checks.step_seed(seed, 0, LOADER), device=device))
        aabb = tuple(cfg["aabb"])
        fcfg, pcfg = cfg["field"], cfg["prop_field"]
        gen = torch.Generator().manual_seed(0)
        field = NGPRadianceField(aabb=aabb, **ngp_kwargs(fcfg), device=device, generator=gen)
        net = NGPDensityField(aabb=aabb, **ngp_kwargs(pcfg), device=device, generator=gen)
        load_into(field, seeded_weights(fcfg, checks.step_seed(seed, 0, WEIGHTS), device))
        load_into(net, seeded_weights(pcfg, checks.step_seed(seed, 0, PROP_WEIGHTS), device))
        opt = cfg["optimizer"]
        self.run = prop_cli.PropRun(
            field=field, prop_nets=[net],
            opt_field=torch.optim.Adam(field.parameters(), lr=opt["lr"], eps=opt["eps"]),
            opt_prop=torch.optim.Adam(net.parameters(), lr=opt["lr"], eps=opt["eps"]),
            render_kw=dict(num_samples=cfg["num_samples"], prop_samples=tuple(cfg["prop_samples"]),
                           near_plane=cfg["near_plane"], far_plane=cfg["far_plane"],
                           sampling_type=cfg["sampling_type"], opaque_bkgd=cfg["opaque_bkgd"]),
            requires_grad_fn=get_proposal_requires_grad_fn(),
            generator=torch.Generator(device=device).manual_seed(checks.step_seed(seed, 0, JITTER)),
        )
        self.step = 0
        self.window_start = None
        self.losses: List[Tensor] = []
        self.readings: Dict[str, object] = {}

    def _train(self, until: int) -> List[Tensor]:
        losses = prop_cli.train(self.run, self.train_ds, range(self.step, until))
        self.step = until
        return losses

    def setup(self) -> None:
        run, k = self.run, self.traffic["checked_steps"]
        leaves = {**_named(run.field, "field."), **_named(run.prop_nets[0], "prop.")}
        start = {n: p.detach().clone() for n, p in leaves.items()}
        self.train_ds.batches = []
        first_grad, losses = {}, []
        colours: List[Tensor] = []
        for s in range(k):
            with checks.recording_colours(prop_cli, "propnet_render_rays", colours):
                losses += self._train(s + 1)
            for n, p in leaves.items():
                st = run.opt_field.state.get(p) or run.opt_prop.state.get(p)
                if n not in first_grad and st and int(st["step"]) == 1:
                    first_grad[n] = float((st["exp_avg"] / (1 - BETA1)).double().norm())
        # A leaf that never stepped has no first gradient.
        first_grad = {n: first_grad.get(n, 0.0) for n in leaves}
        self.readings = dict(losses=[float(v) for v in losses], first_grad=first_grad, colours=colours[0],
                             change=checks.norms({n: p.detach() - start[n] for n, p in leaves.items()}))
        self.batches = [(b["rays"].origins, b["rays"].viewdirs, b["color_bkgd"]) for b in self.train_ds.batches]
        self.train_ds.batches = None

    def segment(self) -> int:
        if self.window_start is None:
            self.window_start, self.marks = self.step, []
        # The loop never reads the device; the host runs ahead of it by
        # what the launch queue holds, a step or two of the 256 timed.
        self.mark(self.step)
        losses = self._train(self.step + SEGMENT)
        self.losses += losses
        return len(losses) * self.cfg["num_rays"]

    def window_context(self) -> dict:
        """The window's steps, the model FLOPs of its work (every field
        sample trained, every proposal sample trained on the steps the
        cadence trains the proposal net, else evaluated), and the wall
        time a step of its last segments, at the cadence the trace sees."""
        if self.window_start is None:
            return {}
        steps = len(self.losses)
        grads = proposal_cadence(self.window_start + steps)[self.window_start:]
        n = self.cfg["num_rays"]
        field = TRAIN_FACTOR * steps * n * self.cfg["num_samples"] * field_flops(self.cfg["field"])
        per_prop = n * sum(self.cfg["prop_samples"]) * field_flops(self.cfg["prop_field"])
        prop = sum((TRAIN_FACTOR if g else 1) * per_prop for g in grads)
        return dict(window_steps=steps, window_rays=steps * n, window_flops=field + prop,
                    late_step_s=self.late_step_s(self.step))

    def trace_slice(self, steps: int) -> dict:
        self._train(self.step + steps)
        return dict(steps=steps, updates=0)

    @torch.no_grad()
    def evaluate(self) -> float:
        _, _, test_im, test_c2w, focal = self.views
        test = SubjectLoader(split="test", images=test_im, camtoworlds=test_c2w, focal=focal, device=self.device)
        white = torch.ones(3, device=self.device)
        out = []
        for i in range(len(test)):
            img = render_image_chunked(
                lambda o, d: prop_cli.render(self.run, o, d, white, requires_grad=False, stratified=False)[0],
                test[i]["rays"], chunk=self.traffic["eval_chunk"])
            out.append(checks.psnr(img, checks.composite_white(test_im[i], self.device)))
        return float(np.mean(out))

    def reference(self) -> Dict[str, float]:
        cfg, dev = self.cfg, self.device
        fcfg, pcfg = cfg["field"], cfg["prop_field"]
        train_im, train_c2w, _, _, focal = self.views
        images = torch.from_numpy(train_im).to(dev)
        c2w = torch.from_numpy(train_c2w).to(dev)
        start = {**{"field." + k: v for k, v in seeded_weights(fcfg, checks.step_seed(self.seed, 0, WEIGHTS), dev).items()},
                 **{"prop." + k: v for k, v in
                    seeded_weights(pcfg, checks.step_seed(self.seed, 0, PROP_WEIGHTS), dev).items()}}
        params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
        fp = {k[6:]: v for k, v in params.items() if k.startswith("field.")}
        pp = {k[5:]: v for k, v in params.items() if k.startswith("prop.")}
        opt = cfg["optimizer"]
        adam_f = ref_render.Adam({k: params[k] for k in params if k.startswith("field.")}, eps=opt["eps"])
        adam_p = ref_render.Adam({k: params[k] for k in params if k.startswith("prop.")}, eps=opt["eps"])
        aabb = torch.tensor(cfg["aabb"], dtype=torch.float32, device=dev)
        near, far = cfg["near_plane"], cfg["far_plane"]
        (n_prop,), n_final = cfg["prop_samples"], cfg["num_samples"]
        gen = torch.Generator(device=dev).manual_seed(checks.step_seed(self.seed, 0, JITTER))
        cadence = proposal_cadence(len(self.batches))
        losses = []
        for s, (o_p, d_p, bkgd) in enumerate(self.batches):
            o, d, pixels = checks.rays_from_batch(o_p, d_p, bkgd, images, c2w, focal)
            n = o.shape[0]
            unit = torch.cat([torch.zeros((n, 1), device=dev), torch.ones((n, 1), device=dev)], -1)
            b_prop = torch.rand((n, 1), generator=gen, dtype=torch.float32, device=dev)
            s_prop = ref_render.resample(unit, unit, n_prop, b_prop)
            t = ref_render.s_to_t(s_prop, near, far)
            ts, te = t[:, :-1], t[:, 1:]
            x = o[:, None] + ((ts + te) / 2.0)[..., None] * d[:, None]
            with torch.set_grad_enabled(cadence[s]):
                sig = ref_field.density_and_features(x.reshape(-1, 3), pp, pcfg, aabb)[0].reshape(n, n_prop)
                sdt = sig * (te - ts)
                trans = torch.exp(-(torch.cumsum(sdt, -1) - sdt))
                cdf_prop = 1.0 - torch.cat([trans, torch.zeros_like(trans[:, :1])], -1)
            b_final = torch.rand((n, 1), generator=gen, dtype=torch.float32, device=dev)
            s_final = ref_render.resample(s_prop, cdf_prop.detach(), n_final, b_final)
            t = ref_render.s_to_t(s_final, near, far)
            ts, te = t[:, :-1], t[:, 1:]
            x = o[:, None] + ((ts + te) / 2.0)[..., None] * d[:, None]
            rgb, sig = ref_field.radiance(x.reshape(-1, 3), d[:, None].expand(x.shape).reshape(-1, 3), fp, fcfg, aabb)
            color, trans_f = ref_render.composite_dense(sig.reshape(n, n_final) * (te - ts), rgb.reshape(n, n_final, 3),
                                                        bkgd)
            if s == 0:
                ref_colours = color.detach()
            loss = ref_render.huber(color, pixels)
            if cadence[s]:
                cdf_final = (1.0 - torch.cat([trans_f, torch.zeros_like(trans_f[:, :1])], -1)).detach()
                loss = loss + ref_render.proposal_loss(s_final, cdf_final, s_prop, cdf_prop)
            losses.append(float(loss.detach()))
            grads = ref_render.grads_of(loss, params)
            adam_f.step({k: grads[k] for k in adam_f.params}, opt["lr"])
            if cadence[s]:
                adam_p.step({k: grads[k] for k in adam_p.params}, opt["lr"])
        ref_grad = checks.norms({**adam_f.first_grad, **adam_p.first_grad})
        ref_change = checks.norms({k: params[k].detach() - start[k] for k in params})
        moving = checks.moving_leaves(ref_grad)
        r = self.readings
        self.detail = dict(losses=(r["losses"], losses),
                           grad=checks.leaf_gaps(r["first_grad"], ref_grad, list(ref_grad)),
                           change=checks.leaf_gaps(r["change"], ref_change, moving),
                           ref_grad=ref_grad, ref_change=ref_change)
        return {
            "colour_gap": checks.colour_gap(r["colours"], ref_colours, slice(None)),
            "loss_gap": checks.loss_gap(r["losses"], losses),
            "grad_gap": max(self.detail["grad"].values()),
            "change_gap": max(self.detail["change"].values()),
        }


def _named(module: torch.nn.Module, prefix: str) -> dict:
    return {prefix + n: p for n, p in module.named_parameters()}
