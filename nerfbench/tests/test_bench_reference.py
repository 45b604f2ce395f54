"""The plain reference against the port at a tiny size on the CPU, piece by
piece and as whole checked steps of both cells, and the planted faults
that those checked steps must catch."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
from nerfacc_tpu_torch.estimators.prop_net import _pdf_loss
from nerfacc_tpu_torch.data_specs import RayIntervals
from nerfacc_tpu_torch.models.ngp import NGPDensityField, NGPRadianceField
from nerfacc_tpu_torch.pdf import importance_sampling

from nerfbench import faults
from nerfbench.calibrate import reading
from nerfbench.pipelines import ngp_kwargs
from nerfbench.reference import field as rf
from nerfbench.reference import occgrid as ro
from nerfbench.reference import render as rr
from nerfbench.registry import Benchmark
from nerfbench.run import run_cell
from nerfbench.weights import load_into, seeded_weights
from nerfbench.tests.tiny import make_root

CPU = torch.device("cpu")
FIELD = {"encoder_type": "hash", "geo_feat_dim": 15, "mlp_width": 64,
         "encoding": {"n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 12,
                      "base_resolution": 16, "max_resolution": 4096}}
PROP = {"encoder_type": "hash", "geo_feat_dim": 0, "mlp_width": 64,
        "encoding": {"n_levels": 2, "n_features_per_level": 2, "log2_hashmap_size": 10,
                     "base_resolution": 16, "max_resolution": 32}}
AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)


def _field(cfg, cls, seed=3):
    net = cls(aabb=AABB, **ngp_kwargs(cfg), device=CPU, generator=torch.Generator().manual_seed(0))
    w = seeded_weights(cfg, seed, CPU)
    load_into(net, w)
    return net, w


def test_level_rule_matches_the_port():
    net, _ = _field({**FIELD, "encoding": {**FIELD["encoding"], "n_levels": 16, "log2_hashmap_size": 19}},
                    NGPRadianceField)
    res = rf.level_resolutions(16, 16, 4096)
    assert res == list(net.encoder.resolutions)
    assert rf.dense_levels(res, 1 << 19) == net.encoder._dense.flatten().tolist()


@pytest.mark.parametrize("cfg,cls", [(FIELD, NGPRadianceField), (PROP, NGPDensityField)])
def test_field_matches_the_port(cfg, cls):
    net, w = _field(cfg, cls)
    g = torch.Generator().manual_seed(1)
    x = torch.rand((2000, 3), generator=g) * 3.2 - 1.6
    d = torch.nn.functional.normalize(torch.randn((2000, 3), generator=g), dim=-1)
    aabb = torch.tensor(AABB)
    if cfg["geo_feat_dim"]:
        rgb, sigma = net(x, d)
        rgb_r, sigma_r = rf.radiance(x, d, w, cfg, aabb)
        torch.testing.assert_close(rgb, rgb_r, atol=1e-6, rtol=1e-5)
    else:
        sigma = net(x)
        sigma_r = rf.density_and_features(x, w, cfg, aabb)[0]
    torch.testing.assert_close(sigma[..., 0], sigma_r, atol=1e-6, rtol=1e-5)


def test_update_and_march_match_the_port():
    net, w = _field(FIELD, NGPRadianceField)
    res, step = 16, 0.04
    est = OccGridEstimator(roi_aabb=AABB, resolution=res, levels=1)
    g = torch.Generator().manual_seed(2)
    jitter = torch.rand((res**3, 3), generator=g)
    state = est._update(est.init(CPU), 0, lambda x: net.query_density(x) * step, warmup_steps=1,
                        draws=[{"jitter": jitter}])
    aabb = torch.tensor(AABB)
    occs, bins = ro.update(torch.zeros(res**3), None,
                           lambda x: rf.density_and_features(x, w, FIELD, aabb)[0], aabb, res, step, True,
                           {"jitter": jitter})
    torch.testing.assert_close(occs, state.occs, atol=1e-7, rtol=1e-5)
    assert torch.equal(bins, state.binaries)
    # Post-warm-up: the occupied-row draw and the uniform half.
    draws = {"uniform": torch.randint(0, res**3, (res**3 // 4,), generator=g),
             "offset": torch.rand((), generator=g), "jitter": torch.rand((res**3 // 2, 3), generator=g)}
    state2 = est._update(state, 10**9, lambda x: net.query_density(x) * step, warmup_steps=1, draws=[draws])
    occs2, bins2 = ro.update(occs, bins, lambda x: rf.density_and_features(x, w, FIELD, aabb)[0], aabb, res, step,
                             False, draws)
    torch.testing.assert_close(occs2, state2.occs, atol=1e-7, rtol=1e-5)
    assert torch.equal(bins2, state2.binaries)

    n = 96
    o = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1) * 4.0
    d = torch.nn.functional.normalize(-o + 0.6 * torch.randn((n, 3), generator=g), dim=-1)
    near = torch.rand((n,), generator=g)
    for capacity in (1 << 12, 1 << 14):
        cs = est.compact_samples(state2, o, d, near_plane=0.0, far_plane=1e10, render_step_size=step,
                                 stratified=True, jitter=near, sample_capacity=capacity)
        _, _, stride, max_macro, _ = est.plan_traversal(step, 0.0, 0.0)
        ray, t0, t1 = ro.march(o, d, near * step, bins2, aabb, step, 130, stride, max_macro, capacity)
        k = cs.kept
        assert torch.equal(cs.ray_indices[k].long(), ray)
        assert torch.equal(cs.t_starts[k], t0) and torch.equal(cs.t_ends[k], t1)


def test_visibility_filter_matches_the_port():
    from nerfacc_tpu_torch.volrend import render_visibility_from_density

    g = torch.Generator().manual_seed(6)
    n_rays, m = 40, 3000
    ray = torch.sort(torch.randint(0, n_rays, (m,), generator=g)).values
    t0 = torch.rand((m,), generator=g) * 4.0
    t1 = t0 + 0.05
    sigma = torch.rand((m,), generator=g) * 8.0
    mask = render_visibility_from_density(t0, t1, sigma, ray_indices=ray, n_rays=n_rays, early_stop_eps=1e-4,
                                          alpha_thre=0.0)
    assert 0 < int(mask.sum()) < m
    for capacity in (m, 500):
        keep = ro.visible(ray, t0, t1, sigma, n_rays, 0.0, capacity)
        assert torch.equal(keep, torch.nonzero(mask, as_tuple=True)[0][:capacity])


def test_resample_and_proposal_loss_match_the_port():
    g = torch.Generator().manual_seed(4)
    n = 50
    edges = torch.sort(torch.rand((n, 33), generator=g), dim=-1).values
    edges[:, 0], edges[:, -1] = 0.0, 1.0
    cdfs = torch.cumsum(torch.rand((n, 33), generator=g), -1)
    cdfs = (cdfs - cdfs[:, :1]) / (cdfs[:, -1:] - cdfs[:, :1])
    bias = torch.rand((n, 1), generator=g)
    iv, _ = importance_sampling(RayIntervals(vals=edges), cdfs, 16, stratified=True, jitter=bias)
    ours = rr.resample(edges, cdfs, 16, bias)
    torch.testing.assert_close(ours, iv.vals, atol=0, rtol=0)
    final_cdfs = torch.cumsum(torch.rand((n, 17), generator=g), -1)
    final_cdfs = final_cdfs / final_cdfs[:, -1:]
    port = _pdf_loss(RayIntervals(vals=ours), final_cdfs, RayIntervals(vals=edges), cdfs).mean()
    torch.testing.assert_close(rr.proposal_loss(ours, final_cdfs, edges, cdfs), port)


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(5)
    p0 = torch.randn((40, 3), generator=g)
    ours_p = {"w": p0.clone()}
    theirs = p0.clone().requires_grad_(True)
    ours = rr.Adam(ours_p, eps=1e-15, weight_decay=1e-6)
    opt = torch.optim.Adam([theirs], lr=1e-2, eps=1e-15, weight_decay=1e-6)
    for lr in (1e-4, 2e-3, 1e-2):
        grad = torch.randn((40, 3), generator=g)
        ours.step({"w": grad}, lr)
        for group in opt.param_groups:
            group["lr"] = lr
        theirs.grad = grad.clone()
        opt.step()
    torch.testing.assert_close(ours_p["w"], theirs.detach(), atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("workload", ["ngp_occ.train", "ngp_prop.train"])
def test_checked_steps_agree_with_the_reference(tmp_path, workload):
    bench = Benchmark(make_root(tmp_path))
    numbers, _, detail = reading(bench, workload, 2**31 + 11, "sound", CPU)
    assert max(numbers.values()) < 1e-3, numbers
    if workload == "ngp_occ.train":  # the step after the window: past warm-up, at the dynamic ray count's cap
        assert detail["late"]["step"] >= 256 and detail["late"]["rays"] > 64, detail["late"]


@pytest.mark.parametrize("workload,fault", [(w, f) for w, p in (("ngp_occ.train", "occ"), ("ngp_prop.train", "prop"))
                                            for f in faults.FAULTS_OF[p]])
def test_each_fault_fails_the_comparison(tmp_path, workload, fault):
    """A whole run (past the look for a card) with the timed path broken
    underneath comes out not correct."""
    bench = Benchmark(make_root(tmp_path))
    with faults.FAULTS[fault]():
        out = run_cell(bench, bench.workload(workload), 2**31 + 12, 0.3, 0, CPU, time.perf_counter())
    assert not out["correct"], out["checks"]
    assert max(c["value"] for c in out["checks"].values()) > 1e-2, out["checks"]


def test_rays_are_worked_out_again_from_the_views(tmp_path):
    from nerfbench import checks, scene
    from nerfacc_tpu_torch.datasets.nerf_synthetic import SubjectLoader

    sc = {"width": 32, "height": 24, "camera_angle_x": 0.69, "camera_radius": 4.0, "n_train_views": 3,
          "n_test_views": 1, "pose_seed": 0}
    tr, c2w, _, _, focal = scene.make_views(sc, 0, CPU)
    ds = SubjectLoader(split="train", num_rays=300, images=tr, camtoworlds=c2w, focal=focal,
                       color_bkgd_aug="random", seed=9, device=CPU)
    b = ds[0]
    o, d, px = checks.rays_from_batch(b["rays"].origins, b["rays"].viewdirs, b["color_bkgd"],
                                      torch.from_numpy(tr), torch.from_numpy(c2w), focal)
    torch.testing.assert_close(o, b["rays"].origins, atol=1e-6, rtol=0)
    torch.testing.assert_close(d, b["rays"].viewdirs, atol=1e-6, rtol=0)
    torch.testing.assert_close(px, b["pixels"], atol=1e-6, rtol=0)
    assert np.isfinite(px.numpy()).all()
