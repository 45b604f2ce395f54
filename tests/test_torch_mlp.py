"""The vanilla-NeRF MLP family of the port (``nerfacc_tpu_torch/models/mlp.py``)
against ``nerfacc_tpu/models/mlp.py``: each class's outputs and parameter
gradients on the same inputs and weights (carried over by
``convert.mlp_field_from_jax``), and the initialisation's statistics.

Tolerance: rtol 1e-5, with atol 1e-6 of the largest value for entries that
cancel toward zero.  Both sides compute float32 matrix products on the CPU
and sum their products in another order (XLA's dot against PyTorch's GEMM),
and ``sin``, ``cos`` and ``sigmoid`` may differ by an ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.models import mlp as jmlp
from nerfacc_tpu_torch.convert import mlp_field_from_jax
from nerfacc_tpu_torch.models import mlp as tmlp

RTOL, ATOL_OF_MAX = 1e-5, 1e-6


def _close(got, want, what="", atol_of_max=ATOL_OF_MAX):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol_of_max * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _check(jmodel, tmodel, jparams, args, method=None, tmethod=None, outputs=lambda o: o, atol_of_max=ATOL_OF_MAX,
           grads=True):
    """Forward and (with ``grads``) parameter gradients of ``sum(out * r)``
    over every output, on both sides; ``args`` are numpy arrays (None passes
    through)."""
    tmodel.load_state_dict(mlp_field_from_jax(_np(jparams)))
    tmodel.zero_grad(set_to_none=True)
    rng = np.random.default_rng(123)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else torch.from_numpy(a) for a in args]

    def jout(p):
        return outputs(jmodel.apply(p, *jargs, method=method) if method else jmodel.apply(p, *jargs))

    want = jout(jparams)
    want = want if isinstance(want, tuple) else (want,)
    rs = [rng.standard_normal(np.shape(w)).astype(np.float32) for w in want]

    def jloss(p):
        o = jout(p)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(a * r) for a, r in zip(o, rs))

    jgrads = mlp_field_from_jax(_np(jax.grad(jloss)(jparams)))
    fn = getattr(tmodel, tmethod) if tmethod else tmodel
    got = outputs(fn(*targs))
    got = got if isinstance(got, tuple) else (got,)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"output {i}", atol_of_max)
    if not grads:
        return got
    sum((g * torch.from_numpy(r)).sum() for g, r in zip(got, rs)).backward()
    named = dict(tmodel.named_parameters())
    assert set(jgrads) <= set(named)
    for k, g in jgrads.items():
        # A parameter the output does not reach has no gradient in PyTorch
        # and a zero one in JAX.
        got_g = named[k].grad if named[k].grad is not None else torch.zeros_like(named[k])
        _close(got_g, g.numpy(), k, atol_of_max)
    return got


MLP_CASES = {
    # depth 2, width 32: a skip after layer 1, so the output layer reads 32 + 7.
    "skip": dict(output_dim=5, net_depth=2, net_width=32, skip_layer=1),
    "no-skip": dict(output_dim=5, net_depth=2, net_width=32, skip_layer=None),
    "init-scale": dict(output_dim=3, net_depth=2, net_width=32, skip_layer=None, output_init_scale=1e-4),
    "no-output": dict(net_depth=2, net_width=32, skip_layer=1, output_enabled=False),
    "depth-0": dict(output_dim=4, net_depth=0, skip_layer=None),
}


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_mlp_matches_jax(case):
    cfg = MLP_CASES[case]
    x = np.random.default_rng(0).standard_normal((50, 7)).astype(np.float32)
    jm = jmlp.MLP(**cfg)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = tmlp.MLP(7, **cfg, device="cpu")
    out = _check(jm, tm, p, [x])[0]
    assert out.shape[-1] == {"no-output": 32 + 7}.get(case, cfg.get("output_dim"))


@pytest.mark.parametrize("x_dim,min_deg,max_deg,identity", [(3, 0, 10, True), (3, 0, 4, True), (1, 0, 4, True),
                                                            (2, 1, 5, False), (3, 2, 2, True)])
def test_sinusoidal_encoder_matches_jax(x_dim, min_deg, max_deg, identity):
    x = np.random.default_rng(1).uniform(-2, 2, (40, x_dim)).astype(np.float32)
    je = jmlp.SinusoidalEncoder(x_dim, min_deg, max_deg, identity)
    te = tmlp.SinusoidalEncoder(x_dim, min_deg, max_deg, identity)
    want = np.asarray(je.apply({}, jnp.asarray(x)))
    got = te(torch.from_numpy(x))
    assert te.latent_dim == je.latent_dim == want.shape[-1] or min_deg == max_deg
    # The arguments of sin are the same float32 products; sin of arguments
    # up to 2^9 * 2 differ by an ulp of the argument's size at most.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-6)
    if min_deg == 0 and max_deg == 10:
        # Degree-major: entries 3..5 are x * 1, 6..8 x * 2, ..., and the
        # cosines follow the sines.
        np.testing.assert_allclose(got[:, 3 + 3 * 4 : 6 + 3 * 4].numpy(), np.sin(16 * x), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[:, 33:36].numpy(), np.cos(x), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("condition", ["per-sample", "per-ray", "none"])
def test_nerf_mlp_matches_jax(condition):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 5, 11)).astype(np.float32)
    cond = {"per-sample": rng.standard_normal((6, 5, 4)), "per-ray": rng.standard_normal((6, 4)),
            "none": None}[condition]
    cond = None if cond is None else cond.astype(np.float32)
    cfg = dict(net_depth=2, net_width=32, skip_layer=1, net_depth_condition=1, net_width_condition=16)
    jm = jmlp.NerfMLP(**cfg)
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), None if cond is None else jnp.asarray(cond))
    tm = tmlp.NerfMLP(11, 0 if cond is None else 4, **cfg, device="cpu")
    rgb, sigma = _check(jm, tm, p, [x, cond])
    assert rgb.shape == (6, 5, 3) and sigma.shape == (6, 5, 1)
    _check(jm, tm, p, [x], method="query_density", tmethod="query_density")


def test_vanilla_nerf_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cfg = dict(net_depth=2, net_width=32, skip_layer=1)
    jm = jmlp.VanillaNeRFRadianceField(**cfg)
    p = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(d))
    tm = tmlp.VanillaNeRFRadianceField(**cfg, device="cpu")
    rgb, sigma = _check(jm, tm, p, [x, d])
    assert float(rgb.min()) >= 0 and float(rgb.max()) <= 1 and float(sigma.min()) >= 0
    _check(jm, tm, p, [x], method="query_density", tmethod="query_density")
    want = np.asarray(jm.apply(p, jnp.asarray(x), 5e-3, method="query_opacity"))
    _close(tm.query_opacity(torch.from_numpy(x), 5e-3), want, "query_opacity")


def test_vanilla_nerf_full_width_layout():
    # The CLI's field: 8 x 256, skip after layer 4 (layer 5 reads 256 + 63),
    # condition 1 x 128 on the 27-wide view encoding.
    tm = tmlp.VanillaNeRFRadianceField(device="cpu")
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert shapes["mlp.base.layers.0.weight"] == (256, 63)
    assert shapes["mlp.base.layers.5.weight"] == (256, 256 + 63)
    assert shapes["mlp.base.layers.7.weight"] == (256, 256)
    assert shapes["mlp.sigma_layer.layers.0.weight"] == (1, 256)
    assert shapes["mlp.bottleneck_layer.layers.0.weight"] == (256, 256)
    assert shapes["mlp.rgb_layer.layers.0.weight"] == (128, 256 + 27)
    assert shapes["mlp.rgb_layer.layers.1.weight"] == (3, 128)
    jm = jmlp.VanillaNeRFRadianceField()
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    state = mlp_field_from_jax(_np(p))
    assert {k: tuple(v.shape) for k, v in state.items()} == shapes


@pytest.mark.parametrize("field", ["tnerf", "ndr"])
def test_dynamic_fields_match_jax(field):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    t = rng.random((64, 1), dtype=np.float32)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jcls, tcls = {"tnerf": (jmlp.TNeRFRadianceField, tmlp.TNeRFRadianceField),
                  "ndr": (jmlp.NDRTNeRFRadianceField, tmlp.NDRTNeRFRadianceField)}[field]
    jm = jcls()
    p = jm.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(t), jnp.asarray(d))
    tm = tcls(device="cpu")
    state = mlp_field_from_jax(_np(p))
    assert set(state) == set(tm.state_dict())
    if field == "tnerf":
        rgb, sigma = _check(jm, tm, p, [x, t, d])
        _check(jm, tm, p, [x, t], method="query_density", tmethod="query_density")
    else:
        # NDR's warped positions differ from JAX's by up to an ulp of 1 (its
        # sin, cos and rotation round an ulp apart here and there; 1.19e-7
        # measured), and the vanilla field's degree-10 encoding multiplies a
        # position by up to 2^9 before its sin.  So the warp is held with its
        # parameter gradients, the vanilla field with its gradients on JAX's
        # own warped positions, and the whole field's outputs at rtol 1e-5
        # with atol 5e-5 of the largest value (2.2e-5 measured).
        warped = _check(jm, tm, p, [x, t], method="warp", tmethod="warp")[0].detach().numpy()
        want = np.asarray(jm.apply(p, jnp.asarray(x), jnp.asarray(t), method="warp"))
        np.testing.assert_allclose(warped, want, rtol=0, atol=2 * np.spacing(np.float32(1.0)))
        _check(jmlp.VanillaNeRFRadianceField(), tm.nerf, {"params": p["params"]["nerf"]}, [want.copy(), d])
        rgb, sigma = _check(jm, tm, p, [x, t, d], atol_of_max=5e-5, grads=False)
    assert rgb.shape == (64, 3) and sigma.shape == (64, 1)
    # Time changes the density.
    with torch.no_grad():
        s0 = tm.query_density(torch.from_numpy(x), torch.zeros(64, 1))
        s1 = tm.query_density(torch.from_numpy(x), torch.ones(64, 1))
    assert float((s0 - s1).abs().max()) > 0


def test_init_statistics_match_flax():
    """xavier-uniform kernels on +-sqrt(6 / (fan_in + fan_out)), the output
    kernel of ``output_init_scale`` uniform on [0, scale), zero biases: the
    port's draws against flax's, by their range, mean and spread (the two
    generators draw other numbers)."""
    jm = jmlp.MLP(output_dim=64, net_depth=2, net_width=256, skip_layer=1, output_init_scale=1e-4)
    p = _np(jm.init(jax.random.PRNGKey(9), jnp.zeros((4, 63))))["params"]
    tm = tmlp.MLP(63, output_dim=64, net_depth=2, net_width=256, skip_layer=1, output_init_scale=1e-4,
                  device="cpu", generator=torch.Generator().manual_seed(9))
    for i, (fan_in, fan_out) in enumerate([(63, 256), (256, 256 + 0), (256 + 63, 64)]):
        want = p[f"Dense_{i}"]["kernel"]
        got = tm.layers[i].weight.detach().numpy().T
        assert got.shape == want.shape == (fan_in, fan_out)
        assert not tm.layers[i].bias.detach().numpy().any() and not p[f"Dense_{i}"]["bias"].any()
        if i < 2:
            bound = np.sqrt(6.0 / (fan_in + fan_out))
            for w in (got, want):
                assert np.abs(w).max() <= bound and np.abs(w).max() > 0.99 * bound
                assert abs(w.mean()) < 0.02 * bound
                assert w.std() == pytest.approx(bound / np.sqrt(3), rel=0.03)
        else:
            for w in (got, want):
                assert w.min() >= 0 and w.max() < 1e-4 and w.max() > 0.99e-4
                assert w.mean() == pytest.approx(0.5e-4, rel=0.05)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tmlp.MLP(3, 1), tmlp.VanillaNeRFRadianceField, tmlp.TNeRFRadianceField,
                 tmlp.NDRTNeRFRadianceField):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
