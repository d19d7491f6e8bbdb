"""DarkNet-53 backbone (port of videoyolo_tpu/models/darknet.py:80-211).

Organised, as in the JAX package, into stages that return the
stride-8/16/32 FPN routes directly.  `quant` "fused" / "fused_calib" builds
the fused-int8 backbone (models/layers.py): int8 cells, residual joins
through `QuantResidual`, QTensor routes.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .layers import ConvBNLeaky, QTensor, QuantResidual

DARKNET53_LAYERS = (1, 2, 8, 8, 4)
DARKNET53_CHANNELS = (32, 64, 128, 256, 512, 1024)

_ROADMAP = "see ROADMAP.md"


class DarknetBasicBlock(nn.Module):
    """Residual 1x1-reduce + 3x3-expand block on a 2*channels input (NCHW).
    In the fused-int8 modes both branches are QTensors and join through a
    `QuantResidual`."""

    def __init__(self, channels: int, dtype: torch.dtype | None = None, quant=None):
        super().__init__()
        self.ConvBNLeaky_0 = ConvBNLeaky(2 * channels, channels, kernel=1, dtype=dtype, quant=quant)
        self.ConvBNLeaky_1 = ConvBNLeaky(channels, 2 * channels, kernel=3, dtype=dtype, quant=quant)
        if quant:
            self.QuantResidual_0 = QuantResidual(calib=quant == "fused_calib")

    def forward(self, x):
        y = self.ConvBNLeaky_1(self.ConvBNLeaky_0(x))
        if isinstance(y, QTensor):
            return self.QuantResidual_0(y, x)
        return y + x


class DarknetStage(nn.Module):
    """Stride-2 downsample conv followed by `num_blocks` residual blocks (NCHW)."""

    def __init__(
        self, in_channels: int, channels: int, num_blocks: int,
        dtype: torch.dtype | None = None, quant=None, ds_conv: str = "direct",
    ):
        super().__init__()
        self.ConvBNLeaky_0 = ConvBNLeaky(
            in_channels, channels, kernel=3, stride=2, dtype=dtype, quant=quant, ds_conv=ds_conv
        )
        for n in range(num_blocks):
            self.add_module(
                f"DarknetBasicBlock_{n}", DarknetBasicBlock(channels // 2, dtype=dtype, quant=quant)
            )

    def forward(self, x):
        for cell in self.children():
            x = cell(x)
        return x


class Darknet53(nn.Module):
    """DarkNet-53 feature extractor returning the three FPN routes.

    Input (B, H, W, 3) NHWC -> routes, NHWC:
      r1 (B, H/8, W/8, 256), r2 (B, H/16, W/16, 512), r3 (B, H/32, W/32, 1024)

    `pad_stem` zero-pads the RGB input to 4 channels (conv0's kernel is then
    (32, 4, 3, 3); standard checkpoints refold with models/s2d.pad_stem_cin).
    The NHWC <-> NCHW permutes are views: an NHWC tensor is an NCHW one in
    `channels_last` memory.  With `quant` the routes are QTensors whose
    data is NHWC; `ds_conv` picks the downsample emitter (layers.py)."""

    def __init__(
        self,
        layers: Sequence[int] = DARKNET53_LAYERS,
        channels: Sequence[int] = DARKNET53_CHANNELS,
        remat_stages: int = 0,
        s2d_stem: bool = False,
        pad_stem: bool = False,
        quant=None,
        ds_conv: str = "direct",
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if remat_stages:
            raise NotImplementedError(f"rematerialisation is training work (slice 4), {_ROADMAP}")
        if s2d_stem:
            raise NotImplementedError(
                "the int8 space-to-depth stem is deferred, see ROADMAP.md Queue 1 item 9c" if quant
                else f"the space-to-depth stem is deferred, {_ROADMAP}"
            )
        self.pad_stem = pad_stem
        self.dtype = dtype or torch.float32
        self.conv0 = ConvBNLeaky(
            4 if pad_stem else 3, channels[0], kernel=3, dtype=dtype, quant=quant, real_input=True
        )
        for i, (nblocks, ch) in enumerate(zip(layers, channels[1:])):
            self.add_module(
                f"stage{i + 1}",
                DarknetStage(channels[i], ch, nblocks, dtype=dtype, quant=quant, ds_conv=ds_conv),
            )
        self.num_stages = len(layers)

    def forward(self, x: torch.Tensor):
        if self.pad_stem and x.shape[-1] == 3:
            x = F.pad(x, (0, 1))
        x = self.conv0(x.to(self.dtype).permute(0, 3, 1, 2))
        routes = []
        for i in range(self.num_stages):
            x = getattr(self, f"stage{i + 1}")(x)
            if i >= 2:  # the last three stages are the FPN routes
                routes.append(
                    x._replace(q=x.q.permute(0, 2, 3, 1)) if isinstance(x, QTensor) else x.permute(0, 2, 3, 1)
                )
        return tuple(routes)


class Darknet53Stage1(nn.Module):
    """The first FPN slice on its own (darknet.py:197-211), as the temporal
    models route the stages separately: conv0 (3-channel stem) and the
    64/128/256-channel groups.  Input (B, H, W, 3) NHWC -> (B, H/8, W/8, 256)
    NHWC."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.conv0 = ConvBNLeaky(3, 32, kernel=3, dtype=dtype)
        self.stage1 = DarknetStage(32, 64, 1, dtype=dtype)
        self.stage2 = DarknetStage(64, 128, 2, dtype=dtype)
        self.stage3 = DarknetStage(128, 256, 8, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv0(x.to(self.dtype).permute(0, 3, 1, 2))
        return self.stage3(self.stage2(self.stage1(x))).permute(0, 2, 3, 1)
