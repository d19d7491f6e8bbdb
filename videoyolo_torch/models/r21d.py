"""The R(2+1)D ResNet action backbone (port of
videoyolo_tpu/models/r21d.py:1-214).

The 34-layer (basic blocks) and 152-layer (bottleneck blocks) networks of
VMZ: each 3x3x3 conv factored into a (1, kh, kw) spatial conv to `mid`
channels, BN and ReLU, then a (kt, 1, 1) temporal conv (`Conv21DR`), with
the mid count chosen so the pair holds as many weights as the full 3-D
conv (`_mid_channels`).  The stages after the first halve time, height and
width (stride (2, 2, 2), the temporal half padded by 1): 9 frames shrink to
5, 3 and 2, 33 frames to 17, 9 and 5.

BN is flax's with epsilon 1e-3 and momentum 0.9, built with
`use_running_average=True` whatever `train` says: it always normalises
with the running statistics and never updates them.  `R21D.train` keeps
every BN of the network in eval mode to mirror that (its scale and bias
still get gradients), so a train step leaves R21D's statistics alone, and
several processes take no global statistics for it.

Input: NDHWC windows (B, T, H, W, 3), as the JAX package's; inside, NCDHW
tensors in `channels_last_3d` memory through `layers.Conv3d`.  The outputs
are the JAX package's, NDHWC / NHWC views: with `return_taps` the four
stage outputs; with `return_features` stages 2-4 each max-pooled 2x2 (flax's
VALID `max_pool` a frame) then maxed over time; else the classifier's
(features, mean over T, H and W, softmax of `dense`).  Submodules carry the
flax names (`init`, `init_bn`, `stage{i}_block{j}`, `conv1`-`conv3`,
`bn{j}`, `down`, `down_bn`, `spatial`, `mid_bn`, `temporal`, `dense`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .layers import BatchNorm, Conv3d

__all__ = ["R21D", "R21D_CONFIGS", "r21d_34", "r21d_152", "pool_features"]

BN_EPS_R21D = 1e-3

# layers: (block, blocks a stage, the init's then each stage's channels)
R21D_CONFIGS = {
    34: ("basic", (3, 4, 6, 3), (64, 64, 128, 256, 512)),
    152: ("bottleneck", (3, 8, 36, 3), (64, 256, 512, 1024, 2048)),
}


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, eps=BN_EPS_R21D)


def _mid_channels(kernel: Sequence[int], cin: int, cout: int) -> int:
    """The factored conv's mid-channel count (r21d.py:37-42)."""
    kt, kh, kw = kernel
    return int(math.floor((kt * kh * kw * cin * cout) / (kh * kw * cin + kt * cout)))


def pool_features(tap: torch.Tensor) -> torch.Tensor:
    """A stage output (B, C, T, H, W) -> (B, C, H/2, W/2): max over time and
    2x2 max-pool (VALID).  The two maxes commute, so this equals the JAX
    package's pool a frame then max over time, bit for bit, at 1/T of the
    pooling's reads."""
    return F.max_pool2d(tap.amax(dim=2), 2, 2)


def temporal_conv(conv: Conv3d, y: torch.Tensor) -> torch.Tensor:
    """`conv`, a (kt, 1, 1) conv, on y (B, C, T, H, W) as a (kt, 1) 2-D conv
    of the (B, C, T, H*W) view of the same memory (a view in
    `channels_last_3d` memory or contiguous).  The products and sums are
    the 3-D conv's; on the card cuDNN runs the 2-D form on its bf16 NHWC
    kernels, where it sends the stride-1 3-D form to a float32 NCHW kernel
    behind two layout copies (measured in PERF.md)."""
    b, c, t, h, w = y.shape
    out = F.conv2d(y.reshape(b, c, t, h * w), conv._cast("weight", conv.weight)[..., 0], None,
                   (conv.stride[0], 1), (conv.padding[0], 0))
    return out.reshape(b, out.shape[1], out.shape[2], h, w)


class Conv21DR(nn.Module):
    """(1, kh, kw) spatial conv of stride (1, hs, ws), BN, ReLU, then a
    (kt, 1, 1) temporal conv of stride ts padded kt//2 (r21d.py:45-81); no
    norm after the temporal half.  `mid` defaults to `_mid_channels` of
    the input's channels.  NCDHW; the temporal half runs through
    `temporal_conv`."""

    def __init__(self, in_channels: int, features: int, kernel: Tuple[int, int, int] = (3, 3, 3),
                 stride: Tuple[int, int, int] = (1, 1, 1), mid: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        kt, kh, kw = kernel
        ts, hs, ws = stride
        mid = _mid_channels(kernel, in_channels, features) if mid is None else mid
        self.spatial = Conv3d(in_channels, mid, (1, kh, kw), (1, hs, ws), (0, kh // 2, kw // 2), dtype=dtype)
        self.mid_bn = _bn(mid)
        self.temporal = Conv3d(mid, features, (kt, 1, 1), (ts, 1, 1), (kt // 2, 0, 0), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return temporal_conv(self.temporal, F.relu(self.mid_bn(self.spatial(x))))


class BasicBlock21D(nn.Module):
    """Two 2+1D convs and the residual (r21d.py:84-107); `down` a 1x1x1
    projection of the block's stride.  NCDHW."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1, downsample: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        s = (stride,) * 3
        self.conv1 = Conv21DR(in_channels, channels, stride=s, dtype=dtype)
        self.bn1 = _bn(channels)
        self.conv2 = Conv21DR(channels, channels, dtype=dtype)
        self.bn2 = _bn(channels)
        if downsample:
            self.down = Conv3d(in_channels, channels, (1, 1, 1), s, (0, 0, 0), dtype=dtype)
            self.down_bn = _bn(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        residual = self.down_bn(self.down(x)) if hasattr(self, "down") else x
        return F.relu(y + residual)


class Bottleneck21D(nn.Module):
    """1x1x1 reduce to channels/4 (the block's stride), a 2+1D conv, 1x1x1
    expand, and the residual (r21d.py:110-141).  NCDHW."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1, downsample: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        s, c = (stride,) * 3, channels // 4
        self.conv1 = Conv3d(in_channels, c, (1, 1, 1), s, (0, 0, 0), dtype=dtype)
        self.bn1 = _bn(c)
        self.conv2 = Conv21DR(c, c, dtype=dtype)
        self.bn2 = _bn(c)
        self.conv3 = Conv3d(c, channels, (1, 1, 1), (1, 1, 1), (0, 0, 0), dtype=dtype)
        self.bn3 = _bn(channels)
        if downsample:
            self.down = Conv3d(in_channels, channels, (1, 1, 1), s, (0, 0, 0), dtype=dtype)
            self.down_bn = _bn(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn3(self.conv3(F.relu(self.bn2(self.conv2(y)))))
        residual = self.down_bn(self.down(x)) if hasattr(self, "down") else x
        return F.relu(y + residual)


class R21D(nn.Module):
    """R(2+1)D ResNet (r21d.py:150-204): NDHWC windows (B, T, H, W, 3) ->
    the JAX package's outputs (see the module docstring).  `dense`
    (channels[-1] -> classes) exists only on the classifier path, as in
    flax."""

    def __init__(self, block: str = "basic", layers: Sequence[int] = (3, 4, 6, 3),
                 channels: Sequence[int] = (64, 64, 128, 256, 512), classes: int = 400,
                 return_features: bool = False, return_taps: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"block must be 'basic' or 'bottleneck', got {block!r}")
        blk = BasicBlock21D if block == "basic" else Bottleneck21D
        self.layers, self.channels = tuple(layers), tuple(channels)
        self.return_features, self.return_taps = return_features, return_taps
        self.dtype = dtype or torch.float32
        self.init = Conv21DR(3, channels[0], kernel=(3, 7, 7), stride=(1, 2, 2), mid=45, dtype=dtype)
        self.init_bn = _bn(channels[0])
        cin = channels[0]
        for i, (n, ch) in enumerate(zip(layers, channels[1:]), start=1):
            self.add_module(f"stage{i}_block1", blk(cin, ch, 1 if i == 1 else 2, downsample=ch != cin, dtype=dtype))
            for j in range(2, n + 1):
                self.add_module(f"stage{i}_block{j}", blk(ch, ch, dtype=dtype))
            cin = ch
        if not (return_taps or return_features):
            self.dense = nn.Linear(cin, classes)

    def train(self, mode: bool = True):
        # the JAX package builds every BN with use_running_average=True:
        # frozen statistics in train mode too (ROADMAP.md Queue 3), mirrored
        super().train(mode)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.eval()
        return self

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """The init 2+1D conv, its BN and ReLU: (B, 3, T, H, W) -> (B, 64, T,
        H/2, W/2)."""
        return F.relu(self.init_bn(self.init(x)))

    def taps(self, x: torch.Tensor):
        """NCDHW (B, 3, T, H, W) in `dtype` -> the four stage outputs, NCDHW."""
        y, taps = self.stem(x), []
        for i, n in enumerate(self.layers, start=1):
            for j in range(1, n + 1):
                y = getattr(self, f"stage{i}_block{j}")(y)
            taps.append(y)
        return tuple(taps)

    def forward(self, x: torch.Tensor):
        taps = self.taps(x.to(self.dtype).permute(0, 4, 1, 2, 3))
        if self.return_taps:
            return tuple(t.permute(0, 2, 3, 4, 1) for t in taps)
        if self.return_features:
            return tuple(pool_features(t).permute(0, 2, 3, 1) for t in taps[1:])
        y = taps[-1]
        pooled = y.mean(dim=(2, 3, 4))
        d = self.dense
        logits = F.linear(pooled, d.weight.to(self.dtype), d.bias.to(self.dtype))
        return y.permute(0, 2, 3, 4, 1), pooled, F.softmax(logits, dim=-1)


def r21d_34(**kwargs) -> R21D:
    block, layers, channels = R21D_CONFIGS[34]
    return R21D(block=block, layers=layers, channels=channels, **kwargs)


def r21d_152(**kwargs) -> R21D:
    block, layers, channels = R21D_CONFIGS[152]
    return R21D(block=block, layers=layers, channels=channels, **kwargs)
