"""The 3D / 2+1D DarkNet backbone (port of
videoyolo_tpu/models/darknet3d.py:31-223).

`Darknet3D` is Darknet-53 with a conv type a stage (`conv_types`: the stem
and the five stages): 2 a 2D cell (over a window, per frame: time folded
into the batch), 3 a (3, 3, 3) cell, 21 the darknet R(2+1)D cell
(`Conv21DRepPad`: a (1, 3, 3) conv-BN-leaky, the window padded by repeating
its first and last frames, then a depthwise (3, 1, 1) conv with no bias, BN
or activation).  The 1x1 reduce of a 21 block is a (1, 1, 1) 3-D cell.
Once a stage goes 2D after a 3-D one, the window is max-pooled over time at
that single point and the stages stay 2D; routes that still carry time at
the end are max-pooled too, so the routes are NHWC maps (B, H/s, W/s, C)
for s = 8, 16, 32.  `funnel_time` gives the 3-D downsamples a temporal
stride of 2.

Activations are NHWC, (B, T, H, W, C) while time lives; each cell sees an
NCHW / NCDHW view of them (`channels_last` / `channels_last_3d` memory).
Submodules carry the flax names (`stem`, `down{i}`, `stage{i}_block{j}`,
`_Unit_0`, `ConvBNLeaky3D_0`, `Conv21DRepPad_0/{spatial,temporal}`), so the
weight bridge walks the JAX package's tree.

Refused with ValueError where the JAX forward is at fault (ROADMAP.md
Queue 3): a 3-D cell handed a 4-D map (flax's 3-D conv reads the batch as
time, so the images of a batch mix), and conv types whose stride-8 route is
tapped before the swap point (it keeps its time axis, and YOLOv3T's FPN
fails to concatenate it).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .layers import Conv3d, ConvBNLeaky, ConvBNLeaky3D, nhwc, temporal_pad

__all__ = [
    "DARKNET_LAYERS", "DARKNET_CHANNELS", "Conv21DRepPad", "Darknet3D", "Darknet3DBasicBlock",
    "inflate_conv2d_to_3d", "inflate_conv2d_to_21d",
]

DARKNET_LAYERS = (1, 2, 8, 8, 4)
DARKNET_CHANNELS = (32, 64, 128, 256, 512, 1024)
CONV_TYPES = (2, 3, 21)


class Conv21DRepPad(nn.Module):
    """The darknet R(2+1)D cell (darknet3d.py:35-73) over NHWC windows: a
    (1, k, k) `ConvBNLeaky3D` (`spatial`) of spatial stride, then a
    depthwise (k, 1, 1) conv (`temporal`, `features` groups, no bias, BN or
    activation) of temporal stride; k = 3 pads time by repeating the edge
    frames, any other k by zeros."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: Tuple[int, int, int] = (1, 1, 1),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        ts, hs, ws = stride
        pad = kernel // 2
        self.kernel = kernel
        self.spatial = ConvBNLeaky3D(in_channels, features, kernel=(1, kernel, kernel), stride=(1, hs, ws),
                                     padding=(0, pad, pad), dtype=dtype)
        self.temporal = Conv3d(features, features, (kernel, 1, 1), (ts, 1, 1), (0 if kernel == 3 else pad, 0, 0),
                               dtype=dtype, groups=features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.spatial(x)
        if self.kernel == 3:
            y = temporal_pad(y, 1, zeros=False)
        return self.temporal(y.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


class _Unit(nn.Module):
    """One conv cell of `conv_type` over NHWC (B, [T,] H, W, C)
    (darknet3d.py:76-121): 2 a `ConvBNLeaky` (per frame over a window); 3
    a (k, k, k) `ConvBNLeaky3D`; 21 a `Conv21DRepPad`, or for k = 1 a (1, 1,
    1) `ConvBNLeaky3D`.  The 3-D cells take windows only."""

    def __init__(self, in_channels: int, features: int, kernel: int, conv_type: int, stride: int = 1,
                 temp_stride: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if conv_type not in CONV_TYPES:
            raise ValueError(f"conv_type must be one of {CONV_TYPES}, got {conv_type!r}")
        self.conv_type = conv_type
        strides = (temp_stride, stride, stride)
        if conv_type == 2:
            self.ConvBNLeaky_0 = ConvBNLeaky(in_channels, features, kernel=kernel, stride=stride, dtype=dtype)
        elif conv_type == 3 or kernel == 1:
            kt = kernel if conv_type == 3 else 1
            self.ConvBNLeaky3D_0 = ConvBNLeaky3D(in_channels, features, kernel=(kt, kernel, kernel), stride=strides,
                                                 dtype=dtype)
        else:
            self.Conv21DRepPad_0 = Conv21DRepPad(in_channels, features, kernel=kernel, stride=strides, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv_type == 2:
            return nhwc(self.ConvBNLeaky_0, x)
        if x.dim() != 5:
            raise ValueError(
                f"a 3-D cell (conv type {self.conv_type}) takes a window (B, T, H, W, C), got {tuple(x.shape)}: the "
                "JAX package's 3-D conv reads a 4-D map's batch as time and mixes its images; not built")
        return next(iter(self.children()))(x)


class Darknet3DBasicBlock(nn.Module):
    """1x1 reduce, 3x3 expand and the residual for a conv type
    (darknet3d.py:124-139); a 21 block's reduce is a (1, 1, 1) 3-D cell."""

    def __init__(self, channel: int, conv_type: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self._Unit_0 = _Unit(2 * channel, channel, 1, 3 if conv_type == 21 else conv_type, dtype=dtype)
        self._Unit_1 = _Unit(channel, 2 * channel, 3, conv_type, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._Unit_1(self._Unit_0(x)) + x


def _swap_point(conv_types: Sequence[int]) -> int:
    """The index into `conv_types` of the first 2D stage after a 3-D one
    (-1: none); raises where a stage returns to 3-D after it."""
    swap, past = -1, conv_types[0]
    for i, ct in enumerate(conv_types[1:], 1):
        if past in (3, 21) and ct == 2 and swap == -1:
            swap = i
        if swap != -1 and ct != 2:
            raise ValueError(f"conv_types {tuple(conv_types)}: cannot return to 3D after the temporal pool")
        past = ct
    return swap


class Darknet3D(nn.Module):
    """DarkNet-53 with a 2D / 3D / 2+1D conv type a stage
    (darknet3d.py:142-205).

    Input NHWC (B, T, H, W, 3) windows ((B, H, W, 3) images when every conv
    type is 2).  Returns the three NHWC routes (B, H/8, W/8, 256), (B,
    H/16, W/16, 512), (B, H/32, W/32, 1024), time max-pooled at the swap
    point or, where it lives to the end, at each route."""

    def __init__(self, conv_types: Sequence[int] = (2, 2, 2, 2, 2, 2), funnel_time: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        conv_types = tuple(int(c) for c in conv_types)
        if len(conv_types) != 6 or any(c not in CONV_TYPES for c in conv_types):
            raise ValueError(f"conv_types must be 6 of {CONV_TYPES} (the stem and five stages), got {conv_types}")
        swap = _swap_point(conv_types)
        if swap >= 4:
            raise ValueError(
                f"conv_types {conv_types}: the stride-8 route is tapped before the temporal pool and keeps its time "
                "axis (the JAX package returns it 5-D and YOLOv3T's FPN fails to concatenate it); not built")
        self.conv_types = conv_types
        self.dtype = dtype or torch.float32
        channels = DARKNET_CHANNELS
        self.stem = _Unit(3, channels[0], 3, conv_types[0], dtype=dtype)
        for i, (n, ch, ct) in enumerate(zip(DARKNET_LAYERS, channels[1:], conv_types[1:])):
            ts = 2 if funnel_time and ct in (3, 21) else 1
            self.add_module(f"down{i}", _Unit(channels[i], ch, 3, ct, stride=2, temp_stride=ts, dtype=dtype))
            for j in range(n):
                self.add_module(f"stage{i}_block{j}", Darknet3DBasicBlock(ch // 2, ct, dtype=dtype))

    def forward(self, x: torch.Tensor):
        time_alive = x.dim() == 5
        y = self.stem(x.to(self.dtype))
        routes, past = [], self.conv_types[0]
        for i, (n, ct) in enumerate(zip(DARKNET_LAYERS, self.conv_types[1:])):
            if past in (3, 21) and ct == 2 and time_alive:
                y = y.amax(dim=1)  # TemporalGlobalMaxPool3D
                time_alive = False
            y = getattr(self, f"down{i}")(y)
            for j in range(n):
                y = getattr(self, f"stage{i}_block{j}")(y)
            past = ct
            if i >= 2:
                routes.append(y)
        return tuple(r.amax(dim=1) if time_alive and r.dim() == 5 else r for r in routes)


def inflate_conv2d_to_3d(kernel2d, tau: int) -> np.ndarray:
    """(kh, kw, cin, cout) -> (tau, kh, kw, cin, cout) / tau: the 2D kernel
    repeated over time (darknet3d.py:208-212)."""
    k = np.asarray(kernel2d)
    return np.repeat(k[None], tau, axis=0) / float(tau)


def inflate_conv2d_to_21d(kernel2d, tau: int):
    """The 2+1D inflation (darknet3d.py:215-223): the spatial (1, kh, kw,
    cin, cout) kernel is the 2D one, the depthwise temporal (tau, 1, 1, 1,
    cout) kernel uniform 1/tau.  Returns (spatial, temporal)."""
    k = np.asarray(kernel2d)
    return k[None], np.full((tau, 1, 1, 1, k.shape[-1]), 1.0 / float(tau), k.dtype)
