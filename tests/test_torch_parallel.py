"""``nerfacc_tpu_torch.parallel`` over gloo ranks on the CPU, against the JAX
package's ``parallel`` on the virtual 8-device CPU mesh and against the
port's own single-process functions.

One world of 4 worker processes runs once for the module: the workers are
this file run as a script (``python tests/test_torch_parallel.py --worker
RANK PORT DIR``), joined through ``initialize_distributed`` with the gloo
backend.  Every worker takes its inputs (weights, rays, jitter, draws)
from one file written by the test process, runs each parallel function on
a world of 4 and on a subgroup of ranks 0 and 1, and writes its results;
the tests then hold them against the JAX functions on ``jax.devices()[:4]``
and ``[:2]``.  The shapes are ``tests/test_parallel.py:_setup``'s: a
res-16 grid over +-1, the L4 hash field with 2^12 rows, 64 rays.

The JAX steps are jitted, and under jit XLA contracts ``o + t d`` into a
multiply-add (``tests/test_torch_cli.py``), so a sample's position moves an
ulp: the losses are held at ``tests/test_torch_cli.py``'s rtol 2e-3 and the
occupancies at its atol 5e-5.  The stratified jitter of rank ``r`` is
rebuilt as the JAX step draws it, ``uniform(split(fold_in(key, r))[1],
(n_local,))``, and the update's draws from ``fold_in(key, r)`` as
``tests/test_torch_occ_update.py`` rebuilds them.
"""

from __future__ import annotations

import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

WORLD = 4
AABB = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
RES = 16
N_RAYS = 64
FIELD = dict(n_levels=4, log2_hashmap_size=12, max_resolution=64)
PROP_FIELD = dict(n_levels=3, log2_hashmap_size=10, max_resolution=32)
STEP_KW = dict(render_step_size=2e-2, near_plane=0.5, far_plane=4.0)
# Enough slots that no shard overflows (a ray crosses the box in ~100
# samples), so that the world's kept samples are the union's.
CAPACITY = 4096
RENDER_KW = dict(STEP_KW, samples_per_round=16, max_samples=256)
PROP_KW = dict(num_samples=8, prop_samples=(16,), near_plane=0.5, far_plane=4.0)
N_PROP_RAYS = 32
# One proposal-step pass: (requires_grad) in order, as tests/test_parallel.py.
PROP_PASSES = (True, True, False)
WORLDS = (2, 4)


# --------------------------------------------------------------------------
# The worker: one rank of the world.
# --------------------------------------------------------------------------


def _port_field(weights, cls="radiance", **cfg):
    from nerfacc_tpu_torch.models.ngp import NGPDensityField, NGPRadianceField

    make = NGPRadianceField if cls == "radiance" else NGPDensityField
    field = make(aabb=AABB, device="cpu", **cfg)
    field.load_state_dict(weights)
    return field


def _port_state(est, occs, binaries):
    return est.set_binaries(est.init("cpu"), torch.as_tensor(binaries)).replace(occs=torch.as_tensor(occs))


def _params(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def _worker(rank: int, port: int, out_dir: Path) -> None:
    import torch.distributed as dist

    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.estimators.prop_net import PropNetEstimator
    from nerfacc_tpu_torch.parallel import (
        host_local_rays_to_global,
        initialize_distributed,
        make_hybrid_mesh,
        make_mesh,
        make_parallel_occ_update,
        make_parallel_propnet_train_step,
        make_parallel_test_renderer,
        make_parallel_train_step,
        process_local_batch_size,
        replicate,
        shard_rays,
    )

    torch.set_num_threads(1)
    inp = torch.load(out_dir / "inputs.pt", weights_only=False)
    out = {}
    out["join"] = initialize_distributed(f"127.0.0.1:{port}", WORLD, rank, backend="gloo")
    out["local_batch"] = process_local_batch_size(N_RAYS)
    try:
        process_local_batch_size(N_RAYS + 2)
        out["uneven_refused"] = False
    except AssertionError:
        out["uneven_refused"] = True
    flat = make_mesh(device="cpu")
    hybrid = make_hybrid_mesh(hosts=2, device="cpu")
    by_host = make_hybrid_mesh(device="cpu")
    out["layouts"] = {
        name: (m.axis_names, m.layout.tolist(), m.index, m.size, m.device.type)
        for name, m in (("flat", flat), ("hybrid", hybrid), ("by_host", by_host))
    }
    pair = dist.new_group([0, 1])
    est = OccGridEstimator(AABB, RES, 1)
    meshes = {4: flat, "hybrid": hybrid}
    if rank < 2:
        meshes[2] = make_mesh(group=pair, device="cpu")
    for name, mesh in meshes.items():
        w = mesh.size
        res = out[name] = {}
        # Every rank starts from different weights; replicate makes them rank 0's.
        field = _port_field(inp["weights"] if mesh.rank == 0 else inp["other_weights"], **FIELD)
        opt = torch.optim.Adam(field.parameters(), lr=1e-2)
        replicate(field, mesh)
        replicate(opt, mesh)
        train_state = replicate(_port_state(est, *inp["train_grid"]), mesh)
        o, d, px = shard_rays((inp["rays_o"], inp["rays_d"], inp["pixels"]), mesh, axis=mesh.axis_names)
        n_local = N_RAYS // w
        own = slice(mesh.index * n_local, (mesh.index + 1) * n_local)
        lo, ld, lp = host_local_rays_to_global(mesh, (inp["rays_o"][own], inp["rays_d"][own], inp["pixels"][own]))
        res["local_rays_equal"] = all(torch.equal(a, b) for a, b in ((o, lo), (d, ld), (px, lp)))
        step = make_parallel_train_step(
            field, est, opt, mesh, sample_capacity_per_shard=CAPACITY, **STEP_KW
        )
        jit = inp["jitter"][w]
        res["steps"] = []
        for s in range(2):
            loss, n = step(train_state, o, d, px, torch.ones(3), jitter=jit[s][mesh.index])
            res["steps"].append((float(loss), int(n)))
            res[f"grads{s + 1}"] = {k: p.grad.clone() for k, p in field.named_parameters()}
        res["params2"] = _params(field)
        if name == "hybrid":
            continue
        field = _port_field(inp["weights"], **FIELD)
        update = make_parallel_occ_update(field, est, mesh, render_step_size=STEP_KW["render_step_size"])
        for key in ("update_grid", "fault_grid"):
            state = replicate(_port_state(est, *inp[key]), mesh)
            new = update(state, draws=inp[f"{key}_draws"][w][mesh.index])
            res[key] = {k: getattr(new, k).clone() for k in ("occs", "binaries", "binaries_packed", "skip_grid",
                                                              "skip_packed")}
        # The merge against one update on all the ranks' draws: from zero
        # occupancies, on uniform draws with given ranks (which concatenate;
        # the update reads the mode from the draws' keys).
        union = make_parallel_occ_update(field, est, mesh, render_step_size=STEP_KW["render_step_size"])
        state = replicate(_port_state(est, *inp["union_grid"]), mesh)
        new = union(state, draws=inp["union_draws"][w][mesh.index])
        res["union"] = {k: getattr(new, k).clone() for k in ("occs", "binaries")}
        render = make_parallel_test_renderer(field, est, mesh, **RENDER_KW)
        render_state = replicate(_port_state(est, *inp["render_grid"]), mesh)
        rgb, opacity, depth, rounds = render(render_state, inp["rays_o"], inp["rays_d"], render_bkgd=torch.ones(3))
        res["render"] = (rgb, opacity, depth, rounds)
        # The proposal step.
        field = _port_field(inp["weights"], **FIELD)
        nets = [_port_field(inp["prop_weights"], cls="density", **PROP_FIELD)]
        opt_f = torch.optim.Adam(field.parameters(), lr=1e-2)
        opt_p = torch.optim.Adam([p for net in nets for p in net.parameters()], lr=1e-2)
        pstep = make_parallel_propnet_train_step(field, nets, PropNetEstimator(), opt_f, opt_p, mesh, **PROP_KW)
        po, pd, ppx = shard_rays((inp["prop_rays_o"], inp["prop_rays_d"], inp["prop_pixels"]), mesh)
        res["prop"] = []
        for s, requires_grad in enumerate(PROP_PASSES):
            losses = pstep(po, pd, ppx, torch.ones(3), jitter=inp["prop_jitter"][w][s][mesh.index],
                           requires_grad=requires_grad)
            grads = {k: p.grad.clone() for k, p in field.named_parameters()}
            grads.update({f"prop0.{k}": p.grad.clone() for k, p in nets[0].named_parameters() if p.grad is not None})
            res["prop"].append(([float(v) for v in losses], _params(field), _params(nets[0]), grads))
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, out_dir / f"rank{rank}.pt")


# --------------------------------------------------------------------------
# The test process: JAX's inputs, the world, JAX's results.
# --------------------------------------------------------------------------


def _shell(res):
    g = (np.arange(res) + 0.5) / res * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    return (np.abs(np.sqrt(gx**2 + gy**2 + gz**2) - 0.5) < 0.2)[None]


def _jax_update_draws(est, key, binaries, mode="sysrow"):
    """The draws of JAX's post-warmup ``_update`` for ``key``
    (``tests/test_torch_occ_update.py:_jax_draws``)."""
    import jax
    import jax.numpy as jnp

    cells, n_cells = est.cells_per_lvl, est.cells_per_lvl // 4
    key, k_uni, k_occ = jax.random.split(key, 3)
    d = {"uniform": torch.from_numpy(np.array(jax.random.randint(k_uni, (n_cells,), 0, cells, jnp.int32))).long()}
    if mode == "uniform":
        total = max(int(np.asarray(binaries).sum()), 1)
        d["ranks"] = torch.from_numpy(np.array(jax.random.randint(k_occ, (n_cells,), 0, total, jnp.int32)))
    else:
        d["offset"] = torch.tensor(float(jax.random.uniform(k_occ, ())))
    key, k_jit = jax.random.split(key)
    d["jitter"] = torch.from_numpy(np.array(jax.random.uniform(k_jit, (2 * n_cells, 3), jnp.float32)))
    return [d]


def _jax_prop_draws(key, n_local):
    """The stratified offsets JAX's proposal estimator draws from ``key``:
    one split a level and one for the final pass
    (``tests/test_torch_prop_train.py:_jax_draws``)."""
    import jax
    import jax.numpy as jnp

    draws = []
    for _ in range(len(PROP_KW["prop_samples"]) + 1):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(jax.random.uniform(sub, (n_local, 1), jnp.float32))))
    return draws


class _Jax:
    """The JAX side: the fields of ``tests/test_parallel.py``, the states and
    the draws, and the parallel functions on a mesh of the first ``w``
    devices."""

    def __init__(self):
        import jax
        import jax.numpy as jnp

        from nerfacc_tpu.estimators.occ_grid import OccGridEstimator
        from nerfacc_tpu.models.ngp import NGPDensityField, NGPRadianceField

        self.est = OccGridEstimator(roi_aabb=AABB, resolution=RES, levels=1)
        self.field = NGPRadianceField(aabb=AABB, **FIELD)
        self.params = self.field.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
        self.other = self.field.init(jax.random.PRNGKey(9), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
        self.prop_nets = [NGPDensityField(aabb=AABB, **PROP_FIELD)]
        self.prop_params = (self.prop_nets[0].init(jax.random.PRNGKey(1), jnp.zeros((8, 3))),)
        rng = np.random.default_rng(0)
        d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        self.rays_o, self.rays_d = -2.0 * d, d
        self.pixels = rng.random((N_RAYS, 3), dtype=np.float32)
        d = rng.normal(size=(N_PROP_RAYS, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        self.prop_rays_o, self.prop_rays_d = -2.0 * d, d
        self.prop_pixels = rng.random((N_PROP_RAYS, 3), dtype=np.float32)
        cells = RES**3
        occs = (rng.random(cells, dtype=np.float32) * 0.02 * _shell(RES).reshape(-1)).astype(np.float32)
        self.grids = {
            "train_grid": (np.zeros(cells, np.float32), np.ones((1, RES, RES, RES), bool)),
            "update_grid": (occs, (occs > 0.01).reshape(1, RES, RES, RES)),
            # As tests/test_parallel.py's update: nothing occupied yet, so
            # each device's binaries are its own probes above its threshold.
            "fault_grid": (np.zeros(cells, np.float32), np.zeros((1, RES, RES, RES), bool)),
            "union_grid": (np.zeros(cells, np.float32), _shell(RES)),
            "render_grid": (np.zeros(cells, np.float32), _shell(RES)),
        }
        self.train_key, self.update_key, self.prop_key = (jax.random.PRNGKey(i) for i in (1, 2, 3))

    def jstate(self, name):
        import jax.numpy as jnp

        occs, binaries = self.grids[name]
        return self.est.set_binaries(self.est.init(), jnp.asarray(binaries)).replace(occs=jnp.asarray(occs))

    @functools.cache
    def inputs(self):
        import jax
        import jax.numpy as jnp

        from nerfacc_tpu_torch.convert import field_from_jax
        from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator

        def fold(key, r):
            return jax.random.fold_in(key, r)

        def t(a):
            return torch.from_numpy(np.array(a))

        inp = dict(
            weights=field_from_jax(jax.tree_util.tree_map(np.asarray, self.params)),
            other_weights=field_from_jax(jax.tree_util.tree_map(np.asarray, self.other)),
            prop_weights=field_from_jax(jax.tree_util.tree_map(np.asarray, self.prop_params[0])),
            rays_o=t(self.rays_o), rays_d=t(self.rays_d), pixels=t(self.pixels),
            prop_rays_o=t(self.prop_rays_o), prop_rays_d=t(self.prop_rays_d), prop_pixels=t(self.prop_pixels),
            jitter={}, prop_jitter={}, update_grid_draws={}, fault_grid_draws={}, union_draws={},
            **self.grids,
        )
        test_est = OccGridEstimator(AABB, RES, 1)
        for w in WORLDS:
            n_local = N_RAYS // w
            # Two steps, each with its own key: split(key)[0] and [1].
            keys = jax.random.split(self.train_key)
            inp["jitter"][w] = [
                [t(jax.random.uniform(jax.random.split(fold(k, r))[1], (n_local,), jnp.float32)) for r in range(w)]
                for k in keys
            ]
            for name in ("update_grid", "fault_grid"):
                inp[f"{name}_draws"][w] = [
                    _jax_update_draws(test_est, fold(self.update_key, r), self.grids[name][1]) for r in range(w)
                ]
            gen = torch.Generator().manual_seed(w)
            total = int(self.grids["union_grid"][1].sum())
            inp["union_draws"][w] = [[{
                "uniform": torch.randint(0, RES**3, (RES**3 // 4,), generator=gen),
                "ranks": torch.randint(0, total, (RES**3 // 4,), generator=gen),
                "jitter": torch.rand((RES**3 // 2, 3), generator=gen),
            }] for _ in range(w)]
            prop_keys = jax.random.split(self.prop_key, len(PROP_PASSES))
            inp["prop_jitter"][w] = [
                [_jax_prop_draws(fold(k, r), N_PROP_RAYS // w) for r in range(w)] for k in prop_keys
            ]
        return inp

    def mesh(self, w, hybrid=False):
        import jax

        from nerfacc_tpu.parallel import make_hybrid_mesh, make_mesh

        return make_hybrid_mesh(jax.devices()[:w], hosts=2) if hybrid else make_mesh(jax.devices()[:w])

    def train(self, w, hybrid=False):
        import jax
        import jax.numpy as jnp
        import optax

        from nerfacc_tpu.parallel import host_local_rays_to_global, make_parallel_train_step, replicate

        mesh = self.mesh(w, hybrid)
        tx = optax.adam(1e-2)
        step = make_parallel_train_step(self.field, self.est, tx, mesh, sample_capacity_per_shard=CAPACITY,
                                        **STEP_KW)
        params, opt = replicate(self.params, mesh), replicate(tx.init(self.params), mesh)
        state = replicate(self.jstate("train_grid"), mesh)
        rays = host_local_rays_to_global(mesh, (self.rays_o, self.rays_d, self.pixels))
        steps, mus = [], []
        for k in jax.random.split(self.train_key):
            params, opt, loss, n = step(params, opt, state, *rays, jnp.ones(3), k)
            steps.append((float(loss), int(n)))
            mus.append(opt[0].mu)
        # Adam's first moment gives the reduced gradients: mu_1 = 0.1 g_1,
        # mu_2 = 0.9 mu_1 + 0.1 g_2.
        grads = [
            jax.tree_util.tree_map(lambda a: np.asarray(a) / 0.1, mus[0]),
            jax.tree_util.tree_map(lambda a, b: (np.asarray(b) - 0.9 * np.asarray(a)) / 0.1, mus[0], mus[1]),
        ]
        return steps, params, grads

    @functools.cache
    def update(self, w):
        """The update on the first ``w`` devices from each of the two grids."""
        from nerfacc_tpu.parallel import make_parallel_occ_update, replicate

        mesh = self.mesh(w)
        update = make_parallel_occ_update(self.field, self.est, mesh, render_step_size=STEP_KW["render_step_size"])
        params = replicate(self.params, mesh)
        return {name: update(replicate(self.jstate(name), mesh), params, self.update_key)
                for name in ("update_grid", "fault_grid")}

    def render(self, w):
        import jax.numpy as jnp

        from nerfacc_tpu.parallel import make_parallel_test_renderer, replicate, shard_rays

        mesh = self.mesh(w)
        render = make_parallel_test_renderer(self.field, self.est, mesh, **RENDER_KW)
        rays = [shard_rays(jnp.asarray(a), mesh) for a in (self.rays_o, self.rays_d)]
        return render(replicate(self.params, mesh), replicate(self.jstate("render_grid"), mesh), *rays,
                      render_bkgd=jnp.ones(3))

    def prop(self, w):
        import jax
        import jax.numpy as jnp
        import optax

        from nerfacc_tpu.estimators.prop_net import PropNetEstimator
        from nerfacc_tpu.parallel import make_parallel_propnet_train_step, replicate, shard_rays
        from nerfacc_tpu_torch.convert import field_from_jax

        mesh = self.mesh(w)
        tx_f, tx_p = optax.adam(1e-2), optax.adam(1e-2)
        step = make_parallel_propnet_train_step(self.field, self.prop_nets, PropNetEstimator(), tx_f, tx_p, mesh,
                                                **PROP_KW)
        fp, pp = replicate(self.params, mesh), replicate(self.prop_params, mesh)
        of, op = replicate(tx_f.init(self.params), mesh), replicate(tx_p.init(self.prop_params), mesh)
        rays = [shard_rays(jnp.asarray(a), mesh) for a in (self.prop_rays_o, self.prop_rays_d, self.prop_pixels)]
        passes = []
        for k, requires_grad in zip(jax.random.split(self.prop_key, len(PROP_PASSES)), PROP_PASSES):
            fp, pp, of, op, loss, mse, prop_loss = step(fp, pp, of, op, *rays, jnp.ones(3), k,
                                                        requires_grad=requires_grad)
            passes.append(([float(loss), float(mse), float(prop_loss)], fp, pp))
            if len(passes) == 1:  # the first pass's reduced gradients, mu_1 / 0.1
                grads = field_from_jax(_np(jax.tree_util.tree_map(lambda m: m / 0.1, of[0].mu)))
                grads.update({f"prop0.{k}": v for k, v in field_from_jax(
                    _np(jax.tree_util.tree_map(lambda m: m / 0.1, op[0].mu[0]))).items()})
        return passes, grads


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the world of 4 gloo ranks once; returns ``(jax_side, outputs by
    rank)``."""
    import time

    out_dir = tmp_path_factory.mktemp("parallel")
    j = _Jax()
    torch.save(j.inputs(), out_dir / "inputs.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([sys.executable, __file__, "--worker", str(r), str(port), str(out_dir)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    outs = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    print(f"world of {WORLD} gloo ranks: {time.perf_counter() - t0:.1f} s")
    return j, outs


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def jax_leaves(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)


# --------------------------------------------------------------------------
# The tests.
# --------------------------------------------------------------------------


def _from_jax(tree):
    from nerfacc_tpu_torch.convert import field_from_jax

    return field_from_jax(_np(tree))


def _worlds(outs, name):
    """Each rank's results on the mesh ``name``, and that mesh's size."""
    got = [o[name] for o in outs if name in o]
    return got, len(got)


def test_join_local_batch_and_layouts(world):
    _, outs = world
    for r, o in enumerate(outs):
        assert o["join"] == (r, WORLD)
        # tests/test_parallel.py:141 and distributed_worker.py: the local share.
        assert o["local_batch"] == N_RAYS // WORLD and o["uneven_refused"]
        lay = o["layouts"]
        assert lay["flat"] == (("data",), [0, 1, 2, 3], r, WORLD, "cpu")
        # The 2 x 2 hybrid layout: host-major, then chip, so a rank's shard
        # is JAX's _linear_index over ("hosts", "chips").
        assert lay["hybrid"] == (("hosts", "chips"), [[0, 1], [2, 3]], r, WORLD, "cpu")
        # Grouped by host name: one host here.
        assert lay["by_host"] == (("hosts", "chips"), [[0, 1, 2, 3]], r, WORLD, "cpu")
    for name in (2, 4, "hybrid"):
        got, w = _worlds(outs, name)
        assert w == (2 if name == 2 else 4)
        # host_local_rays_to_global returns each rank's own rows, as shard_rays cuts them.
        assert all(g["local_rays_equal"] for g in got)


def test_nccl_without_a_card_raises_and_one_process_joins_nothing():
    from nerfacc_tpu_torch.parallel import initialize_distributed, make_mesh, process_local_batch_size

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="nccl"):
        initialize_distributed("127.0.0.1:1", 2, 0)
    assert initialize_distributed() == (0, 1)
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.index, mesh.joined) == (1, 0, False)
    assert process_local_batch_size(N_RAYS) == N_RAYS
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


@pytest.mark.parametrize(
    "cards, local_rank, rank, want",
    [(4, None, 5, 1), (8, "0", 4, 0), (8, "3", 2, 3)],
    ids=["rank-mod-cards", "2-hosts-of-4-on-8-cards", "ranks-not-host-contiguous"],
)
def test_nccl_and_the_mesh_take_the_same_card(monkeypatch, cards, local_rank, rank, want):
    """initialize_distributed binds NCCL to the card that a mesh on "cuda"
    computes on, and makes it the current device: LOCAL_RANK where the
    launcher sets it, else the global rank modulo the host's cards."""
    import torch.distributed as dist

    from nerfacc_tpu_torch.parallel import initialize_distributed, make_mesh

    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    current, joined = [], {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: current.append(torch.device(d).index))
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: joined.update(kw, backend=backend))
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(joined))
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 8)
    assert initialize_distributed("127.0.0.1:1", 8, rank) == (rank, 8)
    assert (joined["backend"], joined["device_id"]) == ("nccl", torch.device("cuda", want))
    assert make_mesh().device == torch.device("cuda", want)
    assert current == [want, want]


def test_shard_rays_splits_over_every_axis_of_the_mesh():
    from nerfacc_tpu_torch.parallel import data_sharding, make_hybrid_mesh, make_mesh, shard_rays

    x = torch.arange(8.0)
    flat, hybrid = make_mesh(device="cpu"), make_hybrid_mesh(hosts=1, device="cpu")
    assert torch.equal(shard_rays(x, flat), x) and data_sharding(flat).dim == 0
    assert torch.equal(shard_rays(x, hybrid, axis=("chips", "hosts")), x)
    for mesh, axis in ((flat, "model"), (hybrid, "data"), (hybrid, "hosts")):
        with pytest.raises(ValueError, match="every mesh axis"):
            shard_rays(x, mesh, axis=axis)


# Gradient tolerances against the jitted JAX step, relative to each
# parameter's largest entry: the first step's 1e-4 (tests/test_torch_train.py's
# float32 step; 1.8e-6 measured); the second's 1e-2: after one Adam step a
# sample whose position XLA's multiply-add moved an ulp can cross a fused
# encoder's cell face, and the entries it feeds move (5.4e-3 measured on 4
# devices).  Adam's second step moves a parameter by lr times a ratio of
# its two gradients, so the parameters after two steps are held within 1e-5
# (3.6e-6 measured) where each step's two gradients agree within 1e-3 of
# the entry itself; at most 10% of a parameter's entries are left out (5.6%
# measured, on mlp_base.2.weight on 4 devices).
STEP1_TOL, STEP2_TOL, HELD_REL, PARAM_TOL = 1e-4, 1e-2, 1e-3, 1e-5


@pytest.mark.parametrize("name", [2, 4, "hybrid"], ids=["2", "4", "hybrid-2x2"])
def test_train_step_matches_jax(world, name):
    j, outs = world
    got, w = _worlds(outs, name)
    steps, params, grads = j.train(w, hybrid=name == "hybrid")
    for g in got[1:]:  # every rank holds the same result
        assert g["steps"] == got[0]["steps"]
        assert all(torch.equal(g["params2"][k], v) for k, v in got[0]["params2"].items())
    g0 = got[0]
    for (loss_t, n_t), (loss_j, n_j) in zip(g0["steps"], steps):
        assert n_t == n_j and 0 < n_t <= w * CAPACITY
        # tests/test_torch_cli.py:282's rtol against the jitted loop.
        assert loss_t == pytest.approx(loss_j, rel=2e-3)
    want_p, want_g = _from_jax(params), [_from_jax(g) for g in grads]
    for k, p_want in want_p.items():
        g1, g2 = want_g[0][k], want_g[1][k]
        s1, s2 = float(g1.abs().max()), float(g2.abs().max())
        e1 = float((g0["grads1"][k] - g1).abs().max()) / s1
        e2 = (g0["grads2"][k] - g2).abs() / s2
        assert e1 <= STEP1_TOL and float(e2.max()) <= STEP2_TOL, (k, e1, float(e2.max()))
        held = ((g0["grads1"][k] - g1).abs() <= HELD_REL * g1.abs()) & (
            (g0["grads2"][k] - g2).abs() <= HELD_REL * g2.abs())
        assert float(held.float().mean()) >= 0.9, k
        err = float((g0["params2"][k] - p_want).abs()[held].max())
        assert err <= PARAM_TOL, (k, err)


def _plain_step(field, opt, est, state, o, d, px, jitter, capacity):
    """One step without the parallel layer: render, Huber loss, backward,
    Adam."""
    from nerfacc_tpu_torch.rendering import gather_ray_od, occgrid_render_rays

    def rgb_sigma_fn(ts, te, ri):
        ro, rd = gather_ray_od(o, d, ri)
        rgb, sigma = field(ro + ((ts + te) / 2)[:, None] * rd, rd)
        return rgb, sigma[..., 0]

    colors, _, _, n, _ = occgrid_render_rays(
        rgb_sigma_fn, None, est, state, o, d, render_bkgd=torch.ones(3), stratified=True, jitter=jitter,
        sample_capacity=capacity, **STEP_KW,
    )
    loss = torch.nn.functional.huber_loss(colors, px, delta=1.0)
    opt.zero_grad()
    loss.backward()
    opt.step()
    return loss.detach(), n


def test_bench_scaling_runs_a_world_of_two_and_refuses_shared_cards(monkeypatch):
    from nerfacc_tpu_torch.scripts import bench_scaling

    out = bench_scaling.main(["--device", "cpu", "--backend", "gloo", "--worlds", "2", "--rays-per-dev", "32",
                              "--iters", "1"])
    assert [r["world"] for r in out["rows"]] == [2] and out["rows"][0]["rays_per_sec"] > 0
    # Two ranks on one card: refused unless gloo and --allow-shared-card.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="share a card"):
        bench_scaling.main(["--worlds", "1,2"])
    with pytest.raises(SystemExit, match="share a card"):
        bench_scaling.main(["--worlds", "2", "--backend", "gloo"])


def _single_steps(inp, w, steps=2):
    """The port's single-process step on all the rays, with the ranks'
    jitter concatenated."""
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator

    est = OccGridEstimator(AABB, RES, 1)
    state = _port_state(est, *inp["train_grid"])
    field = _port_field(inp["weights"], **FIELD)
    opt = torch.optim.Adam(field.parameters(), lr=1e-2)
    out = []
    for s in range(steps):
        loss, n = _plain_step(field, opt, est, state, inp["rays_o"], inp["rays_d"], inp["pixels"],
                              torch.cat(inp["jitter"][w][s]), w * CAPACITY)
        out.append((float(loss), int(n)))
    return out, _params(field)


@pytest.mark.parametrize("w", WORLDS)
def test_train_step_matches_the_single_process_step_on_the_union(world, w):
    j, outs = world
    got, _ = _worlds(outs, w)
    steps, params = _single_steps(j.inputs(), w)
    # The kept samples exactly; the loss (a mean of the ranks' means against
    # one mean) within 1e-6 relative and the parameters after two Adam steps
    # within 1e-6 of their largest entry: the sums of the gradients over
    # ~7000 samples are added in another order (float32, 2.2e-7 measured).
    for (loss_p, n_p), (loss_s, n_s) in zip(got[0]["steps"], steps):
        assert n_p == n_s
        assert loss_p == pytest.approx(loss_s, rel=1e-6)
    for k, v in params.items():
        err = float((got[0]["params2"][k] - v).abs().max())
        assert err <= 1e-6 * max(float(v.abs().max()), 1.0), (k, err)


@pytest.mark.parametrize("w", WORLDS)
def test_occ_update_matches_jax(world, w):
    j, outs = world
    got, _ = _worlds(outs, w)
    for name, want in j.update(w).items():
        for g in got:
            # tests/test_torch_cli.py:265's 5e-5 (9.3e-10 measured: the
            # densities of jitted XLA and of the port on the same points).
            np.testing.assert_allclose(g[name]["occs"].numpy(), np.asarray(want.occs), rtol=0, atol=5e-5)
            np.testing.assert_array_equal(g[name]["binaries"].numpy(), np.asarray(want.binaries))
        assert 0 < int(got[0][name]["binaries"].sum()) < RES**3


@pytest.mark.parametrize("w", WORLDS)
def test_merged_packed_and_skip_grids_are_rebuilt_from_the_merged_binaries(world, w):
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator

    _, outs = world
    got, _ = _worlds(outs, w)
    est = OccGridEstimator(AABB, RES, 1)
    for g in got:
        for name in ("update_grid", "fault_grid"):
            want = est._grids(g[name]["binaries"])
            for k in ("binaries_packed", "skip_grid", "skip_packed"):
                assert torch.equal(g[name][k], want[k]), (name, k)


def test_jax_update_leaves_each_device_its_stale_packed_grids(world):
    """The reference's fault (``nerfacc_tpu/parallel/train.py:185-189``): the
    JAX update max-merges ``occs`` and ``binaries`` only, so each device
    keeps the packed grids of its own binaries from before the merge.  On
    an empty grid each device's binaries are its own probes above its own
    threshold, so every device's pre-merge set misses cells another found."""
    j, _ = world
    want = j.update(2)["fault_grid"]
    merged = j.est.set_binaries(want, want.binaries)
    for shard in want.binaries_packed.addressable_shards:
        assert (np.asarray(shard.data) != np.asarray(merged.binaries_packed)).any()


@pytest.mark.parametrize("w", WORLDS)
def test_occ_update_matches_the_single_process_update_on_each_and_all_draws(world, w):
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator

    j, outs = world
    got, _ = _worlds(outs, w)
    inp = j.inputs()
    est = OccGridEstimator(AABB, RES, 1)
    field = _port_field(inp["weights"], **FIELD)

    def update(name, draws, mode="sysrow"):
        return est._update(_port_state(est, *inp[name]), 10**9, lambda x: field.query_density(x) * 2e-2,
                           draws=draws, draw_mode=mode)

    # Any state: the max over the ranks of each rank's own update.
    each = [update("update_grid", d) for d in inp["update_grid_draws"][w]]
    assert torch.equal(got[0]["update_grid"]["occs"], torch.stack([s.occs for s in each]).amax(0))
    assert torch.equal(got[0]["update_grid"]["binaries"], torch.stack([s.binaries for s in each]).any(0))
    # From zero occupancies, one update on all the ranks' draws gives the
    # same occupancies (the probes' max), and the binaries are the OR of
    # each rank's own threshold (as the JAX function's).
    draws = [d[0] for d in inp["union_draws"][w]]
    q = RES**3 // 4
    union = [{
        "uniform": torch.cat([d["uniform"] for d in draws]),
        "ranks": torch.cat([d["ranks"] for d in draws]),
        "jitter": torch.cat([d["jitter"][:q] for d in draws] + [d["jitter"][q:] for d in draws]),
    }]
    one = update("union_grid", union, "uniform")
    assert torch.equal(got[0]["union"]["occs"], one.occs)
    each = [update("union_grid", d, "uniform") for d in inp["union_draws"][w]]
    assert torch.equal(got[0]["union"]["binaries"], torch.stack([s.binaries for s in each]).any(0))


@pytest.mark.parametrize("w", WORLDS)
def test_test_renderer_matches_jax_and_the_single_process_renderer(world, w):
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.rendering import occgrid_render_rays_test

    j, outs = world
    got, _ = _worlds(outs, w)
    rgb_j, opa_j, dep_j, rounds_j = j.render(w)
    inp = j.inputs()
    est = OccGridEstimator(AABB, RES, 1)
    field = _port_field(inp["weights"], **FIELD)

    def builder(o, d):
        def fn(ts, te, ri):
            rgb, sigma = field(o[ri] + ((ts + te) / 2)[:, None] * d[ri], d[ri])
            return rgb, sigma[..., 0]

        return fn

    single = occgrid_render_rays_test(builder, est, _port_state(est, *inp["render_grid"]), inp["rays_o"],
                                      inp["rays_d"], render_bkgd=torch.ones(3), **RENDER_KW)
    for g in got:
        rgb, opacity, depth, rounds = g["render"]
        assert rounds == rounds_j >= 1
        # JAX weighs each round's samples in one flat float32 scan over all
        # rays, the port along each ray's own row: atol 2e-6 (9.5e-7
        # measured, on depth).
        for a, b in ((rgb, rgb_j), (opacity, opa_j), (depth, dep_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6)
        # The shards' rounds are the single-process renderer's rounds.
        for a, b in zip((rgb, opacity, depth), single[:3]):
            assert torch.equal(a, b)
    assert 0.1 < float(got[0]["render"][1].max()) <= 1.0


@pytest.mark.parametrize("w", WORLDS)
def test_propnet_step_matches_jax_with_and_without_requires_grad(world, w):
    j, outs = world
    got, _ = _worlds(outs, w)
    passes, grads = j.prop(w)
    g0 = got[0]["prop"]
    for g in got[1:]:
        assert [p[0] for p in g["prop"]] == [p[0] for p in g0]
    for (losses_t, _, _, _), (losses_j, _, _), requires_grad in zip(g0, passes, PROP_PASSES):
        np.testing.assert_allclose(losses_t, losses_j, rtol=2e-3, atol=1e-9)
        assert (losses_j[2] > 0) == requires_grad
    # The first pass's gradients and parameters, as the train step's first.
    _, field_t, prop_t, grads_t = g0[0]
    want = dict(_from_jax(passes[0][1]), **{f"prop0.{k}": v for k, v in _from_jax(passes[0][2][0]).items()})
    got_p = dict(field_t, **{f"prop0.{k}": v for k, v in prop_t.items()})
    for k, g_want in grads.items():
        tol = STEP1_TOL * float(g_want.abs().max())
        assert float((grads_t[k] - g_want).abs().max()) <= tol, k
        held = (grads_t[k] - g_want).abs() <= HELD_REL * g_want.abs()
        assert float(held.float().mean()) >= 0.9, k
        err = float((got_p[k] - want[k]).abs()[held].max())
        assert err <= PARAM_TOL, (k, err)
    # Without requires_grad the proposal net stays as it was, and the field steps.
    assert all(torch.equal(g0[2][2][k], g0[1][2][k]) for k in g0[1][2])
    assert not all(torch.equal(g0[2][1][k], g0[1][1][k]) for k in g0[1][1])
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(jax_leaves(passes[2][2]), jax_leaves(passes[1][2])))


def test_one_process_without_a_group_takes_the_plain_step():
    """A world of one that joined nothing: the collectives are the identity,
    so the parallel step is the plain step, bit for bit."""
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.models.ngp import NGPRadianceField
    from nerfacc_tpu_torch.parallel import make_mesh, make_parallel_train_step

    est = OccGridEstimator(AABB, RES, 1)
    state = est.set_binaries(est.init("cpu"), torch.from_numpy(_shell(RES)))
    rng = np.random.default_rng(3)
    d = rng.normal(size=(16, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d, px = (torch.from_numpy(a) for a in (-2.0 * d, d, rng.random((16, 3), dtype=np.float32)))
    jitter = torch.from_numpy(rng.random(16, dtype=np.float32))
    results = []
    for parallel in (True, False):
        field = NGPRadianceField(aabb=AABB, device="cpu", generator=torch.Generator().manual_seed(0), **FIELD)
        opt = torch.optim.Adam(field.parameters(), lr=1e-2)
        if parallel:
            step = make_parallel_train_step(field, est, opt, make_mesh(device="cpu"), sample_capacity_per_shard=2048,
                                            **STEP_KW)
            loss, n = step(state, o, d, px, torch.ones(3), jitter=jitter)
        else:
            loss, n = _plain_step(field, opt, est, state, o, d, px, jitter, 2048)
        results.append((float(loss), int(n), _params(field)))
    (lp, np_, pp), (ls, ns, ps) = results
    assert (lp, np_) == (ls, ns) and np_ > 0
    assert all(torch.equal(pp[k], ps[k]) for k in ps)


if __name__ == "__main__" and len(sys.argv) == 5 and sys.argv[1] == "--worker":
    _worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
