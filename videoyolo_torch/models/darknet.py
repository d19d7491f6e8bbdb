"""DarkNet-53 backbone (port of videoyolo_tpu/models/darknet.py:29-227).

Organised, as in the JAX package, into stages that return the
stride-8/16/32 FPN routes directly.  `quant` "fused" / "fused_calib" builds
the fused-int8 backbone (models/layers.py): int8 cells, residual joins
through `QuantResidual`, QTensor routes.  True / "dynamic" and "static"
build int8 cells that pass real values in `dtype`, with the residual adds
in `dtype` (darknet.py:88-98).  `s2d_stem` evaluates the stem on
the space-to-depth grid (`ConvBNLeakyS2D`; weights refold with
models/s2d.refold_stem_s2d).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .layers import BatchNorm, Conv2d, ConvBNLeaky, QTensor, QuantResidual, leaky, remat

DARKNET53_LAYERS = (1, 2, 8, 8, 4)
DARKNET53_CHANNELS = (32, 64, 128, 256, 512, 1024)

def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), phase-major channels: channel
    (p * 2 + q) * C + c holds pixel (2i + p, 2j + q) of channel c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


class ConvBNLeakyS2D(nn.Module):
    """The stem evaluated on the space-to-depth grid (darknet.py:38-77): a
    3x3 conv of 4C inputs to all 4 output phases at once (4F channels,
    phase-major), BatchNorm over the F original channels with its
    statistics pooled across the 4 phases, so train-mode statistics equal
    the standard stem's.  NCHW in and out."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.Conv_0 = Conv2d(in_channels, 4 * features, 3, padding=1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, phases=4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky(self.BatchNorm_0(self.Conv_0(x)))


class DarknetBasicBlock(nn.Module):
    """Residual 1x1-reduce + 3x3-expand block on a 2*channels input (NCHW).
    In the fused-int8 modes both branches are QTensors and join through a
    `QuantResidual`; otherwise the join is an add in `dtype`."""

    def __init__(self, channels: int, dtype: torch.dtype | None = None, quant=None):
        super().__init__()
        self.ConvBNLeaky_0 = ConvBNLeaky(2 * channels, channels, kernel=1, dtype=dtype, quant=quant)
        self.ConvBNLeaky_1 = ConvBNLeaky(channels, 2 * channels, kernel=3, dtype=dtype, quant=quant)
        if quant in ("fused", "fused_calib"):
            self.QuantResidual_0 = QuantResidual(calib=quant == "fused_calib")

    def forward(self, x):
        y = self.ConvBNLeaky_1(self.ConvBNLeaky_0(x))
        if isinstance(y, QTensor):
            return self.QuantResidual_0(y, x)
        return y + x


class DarknetStage(nn.Module):
    """Stride-2 downsample conv followed by `num_blocks` residual blocks (NCHW).

    `s2d_in` takes the space-to-depth stem's output (4 * in_channels phase
    channels at half the resolution): the downsample is then the refolded
    2x2 / stride-1 conv padded one row and column at the top and left,
    under the same module name."""

    def __init__(
        self, in_channels: int, channels: int, num_blocks: int,
        dtype: torch.dtype | None = None, quant=None, ds_conv: str = "direct", s2d_in: bool = False,
    ):
        super().__init__()
        if s2d_in:
            self.ConvBNLeaky_0 = ConvBNLeaky(4 * in_channels, channels, kernel=2, dtype=dtype, padding=(1, 0, 1, 0))
        else:
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
    `s2d_stem` runs conv0 and stage1's downsample on the space-to-depth
    grid (models/s2d.refold_stem_s2d).  `remat_stages` rematerialises the
    first that many stages in train mode (layers.remat).
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
        if s2d_stem and quant:
            raise NotImplementedError("the int8 space-to-depth stem is deferred, see ROADMAP.md Queue 1 item 9c")
        if s2d_stem and pad_stem:
            raise ValueError("s2d_stem and pad_stem exclude each other")
        self.pad_stem, self.s2d_stem, self.remat_stages = pad_stem, s2d_stem, remat_stages
        self.quant = quant or None
        self.dtype = dtype or torch.float32
        if s2d_stem:
            self.conv0 = ConvBNLeakyS2D(12, channels[0], dtype=dtype)
        else:
            self.conv0 = ConvBNLeaky(
                4 if pad_stem else 3, channels[0], kernel=3, dtype=dtype, quant=quant, real_input=True
            )
        for i, (nblocks, ch) in enumerate(zip(layers, channels[1:])):
            self.add_module(
                f"stage{i + 1}",
                DarknetStage(channels[i], ch, nblocks, dtype=dtype, quant=quant, ds_conv=ds_conv,
                             s2d_in=s2d_stem and i == 0),
            )
        self.num_stages = len(layers)

    def forward(self, x: torch.Tensor):
        if self.pad_stem and x.shape[-1] == 3:
            x = F.pad(x, (0, 1))
        if self.s2d_stem:
            x = space_to_depth(x)
        x = self.conv0((x if self.quant else x.to(self.dtype)).permute(0, 3, 1, 2))
        routes = []
        train = self.training and torch.is_grad_enabled()
        for i in range(self.num_stages):
            stage = getattr(self, f"stage{i + 1}")
            x = remat(stage, x) if train and i < self.remat_stages else stage(x)
            if i >= 2:  # the last three stages are the FPN routes
                routes.append(
                    x._replace(q=x.q.permute(0, 2, 3, 1)) if isinstance(x, QTensor) else x.permute(0, 2, 3, 1)
                )
        return tuple(routes)


class Darknet53Stage1(nn.Module):
    """The first FPN slice on its own (darknet.py:197-211), as the temporal
    models route the stages separately: conv0 (3-channel stem) and the
    64/128/256-channel groups.  Input (B, H, W, 3) NHWC -> (B, H/8, W/8, 256)
    NHWC.  `quant` True / "dynamic" or "static" builds its int8 cells (real
    values between them); the int8 stem quantises the input as it comes."""

    def __init__(self, dtype: torch.dtype | None = None, quant=None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.quant = quant or None
        self.conv0 = ConvBNLeaky(3, 32, kernel=3, dtype=dtype, quant=quant)
        self.stage1 = DarknetStage(32, 64, 1, dtype=dtype, quant=quant)
        self.stage2 = DarknetStage(64, 128, 2, dtype=dtype, quant=quant)
        self.stage3 = DarknetStage(128, 256, 8, dtype=dtype, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv0((x if self.quant else x.to(self.dtype)).permute(0, 3, 1, 2))
        return self.stage3(self.stage2(self.stage1(x))).permute(0, 2, 3, 1)


class Darknet53Classifier(nn.Module):
    """The ImageNet classifier (darknet.py:214-227): Darknet-53's last route,
    a global average pool and a dense layer.  NHWC images in, (B, classes)
    logits in `dtype` out."""

    def __init__(self, classes: int = 1000, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.backbone = Darknet53(dtype=dtype)
        self.Dense_0 = nn.Linear(DARKNET53_CHANNELS[-1], classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = self.backbone(x)[-1].mean(dim=(1, 2))
        d = self.Dense_0
        return F.linear(pooled.to(self.dtype), d.weight.to(self.dtype), d.bias.to(self.dtype))
