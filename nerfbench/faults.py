"""Faults planted under a training cell's timed path, and the control, to
show that the comparison which decides ``correct`` catches them.

Each is a context manager that patches the program for the duration:

- ``unchanged``: every optimizer step returns the parameters unchanged;
- ``half_batch``: each step trains on the first half of its rays, the
  loss the mean over them;
- ``altered``: one ray's rendered colour is altered where the renderer
  produces it (+0.5 on ray 0 of every step);
- ``stale_grid``: every occupancy update past warm-up returns the grid
  unchanged (the occupancy cells only);
- ``tf32``: the control, the program with its TF32 matmul path switched on
  (the precision below the float32 that the configurations state).
"""

from __future__ import annotations

import contextlib

import torch

from nerfacc_tpu_torch.examples import train_ngp_nerf_occ as occ_cli
from nerfacc_tpu_torch.examples import train_ngp_nerf_prop as prop_cli


@contextlib.contextmanager
def _patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def unchanged():
    with _patched(torch.optim.Adam, "step", lambda self, closure=None: None):
        yield


def _half_occ(step_fn):
    def train_step(run, rays_o, rays_d, pixels, bkgd, jitter):
        h = rays_o.shape[0] // 2
        return step_fn(run, rays_o[:h], rays_d[:h], pixels[:h], bkgd, jitter[:h])
    return train_step


def _half_prop(step_fn):
    def train_step(run, rays_o, rays_d, pixels, bkgd, requires_grad):
        h = rays_o.shape[0] // 2
        return step_fn(run, rays_o[:h], rays_d[:h], pixels[:h], bkgd, requires_grad)
    return train_step


@contextlib.contextmanager
def half_batch():
    with _patched(occ_cli, "train_step", _half_occ(occ_cli.train_step)), \
            _patched(prop_cli, "train_step", _half_prop(prop_cli.train_step)):
        yield


def _alter_first(render_fn):
    def render(*args, **kwargs):
        out = render_fn(*args, **kwargs)
        colors = out[0]
        bump = torch.zeros_like(colors)
        bump[0] = 0.5
        return (colors + bump,) + tuple(out[1:])
    return render


@contextlib.contextmanager
def altered():
    with _patched(occ_cli, "occgrid_render_rays", _alter_first(occ_cli.occgrid_render_rays)), \
            _patched(prop_cli, "propnet_render_rays", _alter_first(prop_cli.propnet_render_rays)):
        yield


def _warmup_only(update_fn):
    def occ_update(run, warmup, draws=None):
        if warmup:
            update_fn(run, warmup, draws)
    return occ_update


@contextlib.contextmanager
def stale_grid():
    with _patched(occ_cli, "occ_update", _warmup_only(occ_cli.occ_update)):
        yield


@contextlib.contextmanager
def tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered, "stale_grid": stale_grid}
# The faults each pipeline can have.
FAULTS_OF = {"occ": ("unchanged", "half_batch", "altered", "stale_grid"),
             "prop": ("unchanged", "half_batch", "altered")}
CONTROL = {"tf32": tf32}
