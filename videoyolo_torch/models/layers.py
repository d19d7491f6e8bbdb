"""Primitive layers, float path (port of videoyolo_tpu/models/layers.py:32-68,
84-146).

The cells take and return NCHW tensors; the models keep them in
`channels_last` memory, so NHWC is what lies in device memory, as in the JAX
package.  Submodules are named after the flax tree paths (`Conv_0`,
`BatchNorm_0`), which makes the weight bridge (utils/flax_bridge.py) a walk.

`dtype` mirrors flax's: the conv computes in it (bf16 on the main path),
while the BatchNorm parameters and statistics stay float32 and normalise the
conv's output in its own dtype.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

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
