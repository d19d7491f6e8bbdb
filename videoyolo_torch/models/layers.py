"""Primitive layers, float path (port of videoyolo_tpu/models/layers.py:32-68,
84-146, 437-544).

The cells take and return NCHW tensors; the models keep them in
`channels_last` memory, so NHWC is what lies in device memory, as in the JAX
package.  Submodules are named after the flax tree paths (`Conv_0`,
`BatchNorm_0`), which makes the weight bridge (utils/flax_bridge.py) a walk.

`dtype` mirrors flax's: the conv computes in it (bf16 on the main path),
while the BatchNorm parameters and statistics stay float32 and normalise the
conv's output in its own dtype.

The temporal layers (`time_distributed`, `TemporalPooling`, `Corr`) take
NHWC windows (B, T, H, W, C), as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.correlation import correlation

BN_EPS = 1e-5
# flax's momentum 0.9 (weight of the running average) is torch's 0.1
# (weight of the new batch)
BN_MOMENTUM = 0.1
LEAKY_SLOPE = 0.1


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=LEAKY_SLOPE)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor: each pixel repeated
    2x2 (keeps `channels_last` memory)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ConvBNLeaky(nn.Module):
    """The conv-BN-LeakyReLU(0.1) cell: no conv bias; BN eps 1e-5.

    BN stays its own op in eval, as in the JAX package; folding it into the
    conv would change the bf16 rounding."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel: int = 3,
        stride: int = 1,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.Conv_0 = nn.Conv2d(
            in_channels, features, kernel, stride=stride, padding=kernel // 2, bias=False,
            dtype=dtype,
        )
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky(self.BatchNorm_0(self.Conv_0(x)))


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init in place: conv kernels N(0, 1/fan_in) (flax's
    lecun scale), conv biases 0, BN at identity (scale 1, bias 0, mean 0,
    var 1).  Draws on the CPU from `generator`, so a seed gives the same
    weights on every device."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator) / fan_in**0.5
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return module


class TemporalPooling(nn.Module):
    """Max / mean pool over the time axis of (B, T, ...) (layers.py:437-467).

    Without `pool_size` the whole window collapses ('direct' style); with
    it, a window of `pool_size` steps slides by `strides` (default
    `pool_size`) over T padded by `padding` steps of -inf (max) or 0 (mean),
    and the mean divides by the window, padding included, as
    `jax.lax.reduce_window` does."""

    def __init__(
        self, type: Optional[str] = "max", pool_size: Optional[int] = None,
        strides: Optional[int] = None, padding: int = 0,
    ):
        super().__init__()
        if type not in ("max", "mean"):
            raise ValueError(f"TemporalPooling type must be 'max' or 'mean', got {type!r}")
        self.type = type
        self.pool_size = pool_size
        self.strides = strides
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool_size is None:
            return x.amax(dim=1) if self.type == "max" else x.mean(dim=1)
        window = self.pool_size
        if self.padding:
            fill = -torch.inf if self.type == "max" else 0.0
            pad = x.new_full((x.shape[0], self.padding) + x.shape[2:], fill)
            x = torch.cat([pad, x, pad], dim=1)
        # (B, T', ..., window): the windows along a new last axis
        windows = x.unfold(1, window, self.strides or window)
        if self.type == "max":
            return windows.amax(dim=-1)
        return windows.sum(dim=-1) / window


def time_distributed(module_call: Callable, x: torch.Tensor, *args, **kwargs):
    """Apply `module_call` over every timestep of (B, T, ...) by folding the
    time axis into the batch (layers.py:470-487).  Returns outputs with (B,
    T, ...) leading dims (tuple and list outputs element-wise)."""
    b, t = x.shape[0], x.shape[1]
    out = module_call(x.reshape((b * t,) + x.shape[2:]), *args, **kwargs)

    def unfold(y):
        return y.reshape((b, t) + y.shape[1:])

    if isinstance(out, (tuple, list)):
        return type(out)(unfold(o) for o in out)
    return unfold(out)


class Corr(nn.Module):
    """Correlation block over t timesteps against the middle frame
    (layers.py:490-544).  Input (B, T, H, W, C); computed in float32.

    keep='all'  -> (B, H, W, T*C + n*D): time folded into channels (channel
                   t*C + c), then one cost volume per compared timestep;
    keep='mid'  -> (B, H, W, C + n*D): the middle frame only;
    keep='none' -> (B, n, H, W, D): the stacked cost volumes.
    `comp_mid` also compares the middle frame with itself.  Each frame goes
    to `correlation` as a slice of the window (its batch stride is the
    window's), so the CUDA kernel reads it in place."""

    def __init__(
        self, d: int, t: int, kernel_size: int = 1, stride: int = 1, keep: str = "all",
        comp_mid: bool = False,
    ):
        super().__init__()
        if keep not in ("all", "mid", "none"):
            raise ValueError(f"Corr keep must be 'all', 'mid' or 'none', got {keep!r}")
        self.d = d
        self.t = t
        self.kernel_size = kernel_size
        self.stride = stride
        self.keep = keep
        self.comp_mid = comp_mid

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        if t != self.t:
            raise ValueError(f"Corr over t={self.t} frames got a window of {t}")
        mid = t // 2
        x32 = x.float()
        corrs = [
            correlation(
                x32[:, i], x32[:, mid], self.d, kernel_size=self.kernel_size,
                stride1=self.stride, stride2=self.stride,
            )
            for i in range(t)
            if self.comp_mid or i != mid
        ]
        if self.keep == "none":
            return torch.stack(corrs, dim=1)
        if self.keep == "all":
            base = x32.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)
        else:
            base = x32[:, mid]
        return torch.cat([base] + corrs, dim=-1)
