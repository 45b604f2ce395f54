"""Stage times of the NGP-occ training pipeline.

Port of ``scripts/run_profiler.py``: each stage of the train step timed on
its own at one configuration (``bench.py``'s occupancy shell on a res-128
grid over +-1.5, the fused encoder, 8192 rays and 2^18 sample slots by
default), its inputs drawn anew for each call, with one wait for the card
per timing window (a host read after each call would serialise every
launch behind the card).

Stages: traversal and compaction | field density forward | encoder forward
and backward | density forward and backward | field forward and backward |
render forward and backward (field, scans, loss) | the scans alone |
transmittance | optimizer | the full train step | the occupancy update.

    python -m nerfacc_tpu_torch.scripts.run_profiler                  # on the card
    python -m nerfacc_tpu_torch.scripts.run_profiler --dtype bf16 --rays 16384 --capacity 524288
    python -m nerfacc_tpu_torch.scripts.run_profiler --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

STAGES = (
    "traverse+compact", "field sigma fwd", "encoder fwd+bwd", "sigma fwd+bwd", "field fwd+bwd",
    "render fwd+bwd", "render scans fwd+bwd", "transmittance fwd+bwd", "optimizer", "FULL train step",
    "occupancy update",
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--rays", type=int, default=None, help="default 8192 on the card, 512 on the CPU")
    p.add_argument("--capacity", type=int, default=None, help="default 2^18 on the card, 2^14 on the CPU")
    p.add_argument("--grid_res", type=int, default=128)
    p.add_argument("--encoder", type=str, default="fused", choices=["hash", "soa", "fused", "folded", "grouped"])
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--feats", type=int, default=16)
    p.add_argument("--log2t", type=int, default=18)
    p.add_argument("--dtype", type=str, default="f32", choices=["f32", "bf16"])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Prints and returns each stage's ms a call."""
    from ..device import resolve_device
    from ..estimators.occ_grid import OccGridEstimator
    from ..models.ngp import NGPRadianceField, _unit_box
    from ..rendering import gather_ray_od, occgrid_render_rays
    from ..volrend import render_weight_from_density, rendering

    args = parse_args(argv)
    dev = resolve_device(args.device)
    on_cpu = dev.type == "cpu"
    n_rays = args.rays or (512 if on_cpu else 8192)
    cap = args.capacity or ((1 << 14) if on_cpu else (1 << 18))
    res, step_size = args.grid_res, 5e-3
    aabb = [-1.5] * 3 + [1.5] * 3

    est = OccGridEstimator(roi_aabb=aabb, resolution=res, levels=1, skip_factor=2)
    g = (np.arange(res) + 0.5) / res * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    shell = np.abs(np.sqrt(gx**2 + gy**2 + gz**2) - 0.45) < 0.08
    state = est.set_binaries(est.init(dev), torch.from_numpy(shell[None]))
    field = NGPRadianceField(
        aabb=aabb, encoder_type=args.encoder, n_levels=args.levels, n_features_per_level=args.feats,
        log2_hashmap_size=args.log2t, compute_dtype=torch.bfloat16 if args.dtype == "bf16" else None,
        device=dev, generator=torch.Generator().manual_seed(0),
    )
    params = list(field.parameters())
    opt = torch.optim.Adam(params, lr=1e-2, eps=1e-15)
    rng = np.random.default_rng(0)

    def on_dev(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)

    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o, rays_d, pixels = on_dev(-3.0 * d, d, rng.random((n_rays, 3), dtype=np.float32))
    bkgd = torch.ones(3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}

    def wait():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timeit(name, f, args_fn):
        f(*args_fn(0))  # warm-up
        argsets = [args_fn(i + 1) for i in range(args.iters)]
        wait()
        t0 = time.perf_counter()
        for a in argsets:
            f(*a)
        wait()
        times[name] = (time.perf_counter() - t0) / args.iters * 1e3
        print(f"{name:<28s} {times[name]:9.2f} ms", flush=True)

    def mk_rays(seed):
        rr = np.random.default_rng(seed)
        dd = rr.normal(size=(n_rays, 3)).astype(np.float32)
        dd /= np.linalg.norm(dd, axis=-1, keepdims=True)
        return on_dev(-3.0 * dd, dd, rr.random(n_rays, dtype=np.float32))

    def t_traverse(o, dvec, jitter):
        return est.compact_samples(state, o, dvec, render_step_size=step_size, stratified=True, jitter=jitter,
                                   sample_capacity=cap, max_macro_segments=8)

    with torch.no_grad():
        timeit("traverse+compact", t_traverse, mk_rays)

    def mk_samples(seed):
        rr = np.random.default_rng(seed)
        ri = np.sort(rr.integers(0, n_rays, cap)).astype(np.int64)
        ts = (1.5 + rr.random(cap) * 1.9).astype(np.float32)
        return on_dev(ri, ts, ts + np.float32(step_size))

    def positions(ri, ts, te):
        o, dd = gather_ray_od(rays_o, rays_d, ri)
        return o + ((ts + te) / 2)[:, None] * dd, dd

    def t_sigma(ri, ts, te):
        with torch.no_grad():
            return field.query_density(positions(ri, ts, te)[0])

    timeit("field sigma fwd", t_sigma, mk_samples)

    def t_encoder_bwd(ri, ts, te):
        u, _ = _unit_box(positions(ri, ts, te)[0], field.aabb, field.unbounded)
        h = field.encoder(u)
        return torch.autograd.grad((h.float() * ts[:, None]).sum(), list(field.encoder.parameters()))

    timeit("encoder fwd+bwd", t_encoder_bwd, mk_samples)

    def t_sigma_bwd(ri, ts, te):
        s = field.query_density(positions(ri, ts, te)[0])
        return torch.autograd.grad((s[..., 0] * ts).sum(), params, allow_unused=True)

    timeit("sigma fwd+bwd", t_sigma_bwd, mk_samples)

    def t_field_bwd(ri, ts, te):
        x, dd = positions(ri, ts, te)
        rgb, s = field(x, dd)
        return torch.autograd.grad((rgb * ts[:, None]).sum() + s.sum(), params)

    timeit("field fwd+bwd", t_field_bwd, mk_samples)

    def rgb_sigma_fn(t0, t1, rix):
        x, dd = positions(rix, t0, t1)
        rgb, s = field(x, dd)
        return rgb, s[..., 0]

    def t_render_bwd(ri, ts, te):
        c, _, _, _ = rendering(ts, te, ray_indices=ri, n_rays=n_rays, rgb_sigma_fn=rgb_sigma_fn, render_bkgd=bkgd)
        loss = torch.nn.functional.huber_loss(c, pixels, delta=1.0)
        return torch.autograd.grad(loss, params)

    timeit("render fwd+bwd", t_render_bwd, mk_samples)

    # The scans and sums alone: rendering() on per-sample values that need
    # a gradient, grouped by ray.
    def mk_vals(seed):
        ri, ts, te = mk_samples(seed)
        rin = ri.cpu().numpy()
        starts = np.searchsorted(rin, np.arange(n_rays))
        counts = np.searchsorted(rin, np.arange(n_rays), side="right") - starts
        rr = np.random.default_rng(seed + 7)
        rgbs, sigs = on_dev(rr.random((cap, 3), np.float32), rr.random(cap, np.float32))
        sb = on_dev(starts.astype(np.int64), counts.astype(np.int64))
        return (ri, ts, te, sb, rgbs.requires_grad_(), sigs.requires_grad_())

    def t_scans(ri, ts, te, sb, rgbs, sigs):
        c, _, _, _ = rendering(ts, te, ray_indices=ri, n_rays=n_rays, rgb_sigma_fn=lambda *_: (rgbs, sigs),
                               render_bkgd=bkgd, seg_bounds=sb)
        loss = torch.nn.functional.huber_loss(c, pixels, delta=1.0)
        return torch.autograd.grad(loss, (rgbs, sigs))

    timeit("render scans fwd+bwd", t_scans, mk_vals)

    def t_trans(ri, ts, te, sb, rgbs, sigs):
        w, _, _ = render_weight_from_density(ts, te, sigs, ray_indices=ri, n_rays=n_rays)
        return torch.autograd.grad((w * ts).sum(), sigs)

    timeit("transmittance fwd+bwd", t_trans, mk_vals)

    def t_opt(*_):
        for p in params:
            p.grad = p.detach() * 1e-3
        opt.step()

    timeit("optimizer", t_opt, lambda seed: ())

    def t_step(jitter):
        def sigma_fn(t0, t1, rix):
            return field.query_density(positions(rix, t0, t1)[0])[..., 0]

        c, _, _, n, _ = occgrid_render_rays(
            rgb_sigma_fn, sigma_fn, est, state, rays_o, rays_d, near_plane=0.0, far_plane=1e10,
            render_step_size=step_size, render_bkgd=bkgd, stratified=True, jitter=jitter,
            sample_capacity=cap, max_macro_segments=8,
        )
        loss = torch.nn.functional.huber_loss(c, pixels, delta=1.0)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), n

    timeit("FULL train step", t_step, lambda seed: mk_rays(seed)[2:])
    print(f"{'-> samples/s (cap kept)':<28s} {cap / times['FULL train step'] * 1e3:12.0f}", flush=True)

    def t_update():
        with torch.no_grad():
            return est._update(state, 10**9, lambda x: field.query_density(x) * step_size, generator=gen)

    timeit("occupancy update", t_update, lambda seed: ())
    return times


if __name__ == "__main__":
    main()
