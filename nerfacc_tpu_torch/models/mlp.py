"""The vanilla-NeRF MLP radiance-field family.

Port of ``nerfacc_tpu/models/mlp.py``: ``MLP`` with skip connections,
``NerfMLP`` (trunk, density head and view-conditioned colour head), the
``SinusoidalEncoder`` positional encoding, ``VanillaNeRFRadianceField``, and
the dynamic fields ``TNeRFRadianceField`` (a time-conditioned warp in front
of a vanilla NeRF) and ``NDRTNeRFRadianceField`` (three invertible warp
blocks).

Every layer is a dense float32 matrix product (``nn.Linear``), as the JAX
package leaves them to XLA; no Pallas kernel is involved.  Flax infers a
layer's input width from its first call, so the port takes the input widths
at construction.  Each ``MLP`` keeps its dense layers in ``layers`` in flax's
order (``Dense_0`` is ``layers.0``), so
:func:`~nerfacc_tpu_torch.convert.mlp_field_from_jax` maps the JAX
parameters one to one.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
from torch import nn

from ..device import resolve_device

Tensor = torch.Tensor


def _dense(fan_in: int, fan_out: int, init_scale: Optional[float], generator: Optional[torch.Generator]) -> nn.Linear:
    """A dense layer as flax initialises it: a xavier-uniform kernel
    (uniform on ``+-sqrt(6 / (fan_in + fan_out))``), or with ``init_scale``
    flax's ``uniform(scale)``, which is uniform on ``[0, scale)``, not
    symmetric; zero bias."""
    layer = nn.Linear(fan_in, fan_out, device="cpu")
    u = torch.rand((fan_out, fan_in), generator=generator)
    with torch.no_grad():
        if init_scale is None:
            layer.weight.copy_((2.0 * u - 1.0) * math.sqrt(6.0 / (fan_in + fan_out)))
        else:
            layer.weight.copy_(u * init_scale)
        layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """ReLU MLP with periodic skip connections (``mlp.py:25-56``): after
    hidden layer ``i`` with ``i % skip_layer == 0 and i > 0`` the input is
    concatenated to the features, so the next layer reads ``net_width +
    input_dim`` of them.  ``hidden_activation`` follows every hidden layer
    (ReLU by default).  ``output_init_scale`` draws the output kernel
    uniform on ``[0, output_init_scale)``."""

    def __init__(
        self,
        input_dim: int,
        output_dim: Optional[int] = None,
        net_depth: int = 8,
        net_width: int = 256,
        skip_layer: Optional[int] = 4,
        hidden_activation: Callable[[Tensor], Tensor] = torch.relu,
        output_enabled: bool = True,
        output_init_scale: Optional[float] = None,
        *,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.skip_layer, self.output_enabled = skip_layer, output_enabled
        self.hidden_activation = hidden_activation
        layers, width = [], input_dim
        for i in range(net_depth):
            layers.append(_dense(width, net_width, None, generator))
            width = net_width + (input_dim if self._skips_after(i) else 0)
        if output_enabled:
            layers.append(_dense(width, output_dim, output_init_scale, generator))
        self.layers = nn.ModuleList(layers).to(device)
        self.net_depth = net_depth
        self.output_width = output_dim if output_enabled else width

    def _skips_after(self, i: int) -> bool:
        return self.skip_layer is not None and i % self.skip_layer == 0 and i > 0

    def forward(self, x: Tensor) -> Tensor:
        inputs = x
        for i in range(self.net_depth):
            x = self.hidden_activation(self.layers[i](x))
            if self._skips_after(i):
                x = torch.cat([x, inputs], dim=-1)
        if self.output_enabled:
            x = self.layers[-1](x)
        return x


class NerfMLP(nn.Module):
    """Trunk, density head and view-conditioned colour head
    (``mlp.py:59-108``).  ``condition_dim`` is the width of the condition
    that ``forward`` takes (0 for none); a per-ray condition ``(n_rays, C)``
    is broadcast over the samples of ``x (n_rays, ..., D)``."""

    def __init__(
        self,
        input_dim: int,
        condition_dim: int = 0,
        net_depth: int = 8,
        net_width: int = 256,
        skip_layer: int = 4,
        net_depth_condition: int = 1,
        net_width_condition: int = 128,
        *,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.base = MLP(input_dim, net_depth=net_depth, net_width=net_width, skip_layer=skip_layer,
                        output_enabled=False, **kw)
        hidden = self.base.output_width
        self.sigma_layer = MLP(hidden, output_dim=1, net_depth=0, skip_layer=None, **kw)
        self.condition_dim = condition_dim
        if condition_dim > 0:
            self.bottleneck_layer = MLP(hidden, output_dim=net_width, net_depth=0, skip_layer=None, **kw)
        self.rgb_layer = MLP(
            net_width + condition_dim if condition_dim > 0 else hidden, output_dim=3,
            net_depth=net_depth_condition, net_width=net_width_condition, skip_layer=None, **kw,
        )

    def query_density(self, x: Tensor) -> Tensor:
        return self.sigma_layer(self.base(x))

    def forward(self, x: Tensor, condition: Optional[Tensor] = None):
        x = self.base(x)
        raw_sigma = self.sigma_layer(x)
        if condition is not None:
            if condition.shape[:-1] != x.shape[:-1]:
                # Broadcast a per-ray condition across the samples.
                view = condition.shape[:1] + (1,) * (x.ndim - condition.ndim) + condition.shape[-1:]
                condition = condition.reshape(view).expand(x.shape[:-1] + condition.shape[-1:])
            x = torch.cat([self.bottleneck_layer(x), condition], dim=-1)
        return self.rgb_layer(x), raw_sigma


class SinusoidalEncoder(nn.Module):
    """NeRF positional encoding (``mlp.py:111-140``): the input scaled by
    ``2^min_deg .. 2^(max_deg - 1)`` in degree-major order, ``xb``, then
    ``[sin xb, sin(xb + pi / 2)]``, the input itself first when
    ``use_identity``."""

    def __init__(self, x_dim: int, min_deg: int, max_deg: int, use_identity: bool = True) -> None:
        super().__init__()
        self.x_dim, self.min_deg, self.max_deg, self.use_identity = x_dim, min_deg, max_deg, use_identity

    @property
    def latent_dim(self) -> int:
        return (int(self.use_identity) + (self.max_deg - self.min_deg) * 2) * self.x_dim

    def forward(self, x: Tensor) -> Tensor:
        if self.max_deg == self.min_deg:
            return x
        scales = torch.tensor([2.0**i for i in range(self.min_deg, self.max_deg)], dtype=x.dtype, device=x.device)
        xb = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + ((self.max_deg - self.min_deg) * self.x_dim,))
        latent = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
        if self.use_identity:
            latent = torch.cat([x, latent], dim=-1)
        return latent


class VanillaNeRFRadianceField(nn.Module):
    """Positional encoding of degree 10 (positions) and 4 (view directions)
    and a :class:`NerfMLP` (``mlp.py:143-181``).  ``forward(x, condition)``
    returns ``(sigmoid(rgb) (..., 3), relu(sigma) (..., 1))``."""

    def __init__(
        self,
        net_depth: int = 8,
        net_width: int = 256,
        skip_layer: int = 4,
        net_depth_condition: int = 1,
        net_width_condition: int = 128,
        *,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.posi_encoder = SinusoidalEncoder(3, 0, 10, True)
        self.view_encoder = SinusoidalEncoder(3, 0, 4, True)
        self.mlp = NerfMLP(
            self.posi_encoder.latent_dim, self.view_encoder.latent_dim, net_depth=net_depth,
            net_width=net_width, skip_layer=skip_layer, net_depth_condition=net_depth_condition,
            net_width_condition=net_width_condition, device=device, generator=generator,
        )

    def query_opacity(self, x: Tensor, step_size: float) -> Tensor:
        # density * step_size stands in for 1 - exp(-density * step_size):
        # the reference's own approximation for small densities.
        return self.query_density(x) * step_size

    def query_density(self, x: Tensor) -> Tensor:
        return torch.relu(self.mlp.query_density(self.posi_encoder(x)))

    def forward(self, x: Tensor, condition: Optional[Tensor] = None):
        x = self.posi_encoder(x)
        if condition is not None:
            condition = self.view_encoder(condition)
        rgb, sigma = self.mlp(x, condition=condition)
        return torch.sigmoid(rgb), torch.relu(sigma)


class TNeRFRadianceField(nn.Module):
    """Time-warped dynamic NeRF (``mlp.py:184-213``): a 4 x 64 warp MLP
    (skip after layer 2, output kernel uniform on ``[0, 1e-4)``) moves each
    point by an offset from its encoding and its time's, and a
    :class:`VanillaNeRFRadianceField` renders the moved point."""

    def __init__(self, *, device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.posi_encoder = SinusoidalEncoder(3, 0, 4, True)
        self.time_encoder = SinusoidalEncoder(1, 0, 4, True)
        kw = dict(device=device, generator=generator)
        self.warp = MLP(self.posi_encoder.latent_dim + self.time_encoder.latent_dim, output_dim=3, net_depth=4,
                        net_width=64, skip_layer=2, output_init_scale=1e-4, **kw)
        self.nerf = VanillaNeRFRadianceField(**kw)

    def _warped(self, x: Tensor, t: Tensor) -> Tensor:
        return x + self.warp(torch.cat([self.posi_encoder(x), self.time_encoder(t)], dim=-1))

    def query_opacity(self, x: Tensor, t: Tensor, step_size: float) -> Tensor:
        return self.query_density(x, t) * step_size

    def query_density(self, x: Tensor, t: Tensor) -> Tensor:
        return self.nerf.query_density(self._warped(x, t))

    def forward(self, x: Tensor, t: Tensor, condition: Optional[Tensor] = None):
        return self.nerf(self._warped(x, t), condition=condition)


class NDRTNeRFRadianceField(nn.Module):
    """Invertible-warp dynamic NeRF (``mlp.py:216-291``; NDR,
    arXiv:2206.15258): three blocks, each moving the third coordinate by an
    offset from the first two and time, then translating and rotating the
    first two by amounts from the moved third and time; the coordinates are
    permuted ``[1, 2, 0]`` after the first block and ``[2, 0, 1]`` after the
    second."""

    def __init__(self, *, device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.time_encoder = SinusoidalEncoder(1, 0, 4, True)
        self.posi_encoder_1 = SinusoidalEncoder(2, 0, 4, True)
        self.posi_encoder_2 = SinusoidalEncoder(1, 0, 4, True)
        kw = dict(device=device, generator=generator)
        t_dim, width = self.time_encoder.latent_dim, 64
        self.warp_layers_1 = nn.ModuleList(
            MLP(self.posi_encoder_1.latent_dim + width, output_dim=1, net_depth=2, net_width=128, skip_layer=None,
                output_init_scale=1e-4, **kw)
            for _ in range(3)
        )
        self.warp_layers_2 = nn.ModuleList(
            MLP(self.posi_encoder_2.latent_dim + width, output_dim=1 + 2, net_depth=1, net_width=128,
                skip_layer=None, output_init_scale=1e-4, **kw)
            for _ in range(3)
        )
        self.time_layers_1 = nn.ModuleList(
            MLP(t_dim, output_dim=width, net_depth=0, skip_layer=None, **kw) for _ in range(3)
        )
        self.time_layers_2 = nn.ModuleList(
            MLP(t_dim, output_dim=width, net_depth=0, skip_layer=None, **kw) for _ in range(3)
        )
        self.nerf = VanillaNeRFRadianceField(**kw)

    def _warp_block(self, x: Tensor, t_enc: Tensor, i: int) -> Tensor:
        uv, w = x[..., :2], x[..., 2:]
        w = w + self.warp_layers_1[i](torch.cat([self.posi_encoder_1(uv), self.time_layers_1[i](t_enc)], -1))
        rt = self.warp_layers_2[i](torch.cat([self.posi_encoder_2(w), self.time_layers_2[i](t_enc)], -1))
        theta, tr = rt[..., 0], rt[..., 1:]
        cos, sin = torch.cos(theta), torch.sin(theta)
        u = uv[..., 0] - tr[..., 0]
        v = uv[..., 1] - tr[..., 1]
        # The inverse 2-D rotation of the translated (u, v).
        uv = torch.stack([cos * u - sin * v, sin * u + cos * v], -1)
        return torch.cat([uv, w], -1)

    def warp(self, x: Tensor, t: Tensor) -> Tensor:
        t_enc = self.time_encoder(t)
        x = self._warp_block(x, t_enc, 0)
        x = x[..., [1, 2, 0]]
        x = self._warp_block(x, t_enc, 1)
        x = x[..., [2, 0, 1]]
        return self._warp_block(x, t_enc, 2)

    def query_opacity(self, x: Tensor, t: Tensor, step_size: float) -> Tensor:
        return self.query_density(x, t) * step_size

    def query_density(self, x: Tensor, t: Tensor) -> Tensor:
        return self.nerf.query_density(self.warp(x, t))

    def forward(self, x: Tensor, t: Tensor, condition: Optional[Tensor] = None):
        return self.nerf(self.warp(x, t), condition=condition)
