"""The hierarchical temporal DarkNet (port of
videoyolo_tpu/models/h_darknet.py:31-81).

t input frames run through Darknet-53's levels per frame (time folded into
the batch) and merge in groups of 3 after the stem and after the 64-, 128-
and 256-channel stages, where `windows[level]` > 1: a max over each group,
or the zero-initialised depthwise temporal cell `conv1d_{level}`
(`Conv1DTemporal`, kernel `windows[level]`, no padding; its first output
frame).  With windows (3, 3, 1, 1, 1), t = 9 frames funnel 9 -> 3 -> 1.
The routes are NHWC maps: (B, H/8, W/8, 256), (B, H/16, W/16, 512), (B,
H/32, W/32, 1024).  The tree is Darknet-53's (`conv0`, `stage1`-`stage5`)
plus the merge cells, so an ImageNet Darknet-53 loads into it as it is.

The JAX package creates a merge cell only when its level merges a window;
the port builds `conv1d_{level}` for every level whose window is above 1,
and raises ValueError on an input that would skip one (its tree would then
differ from JAX's).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .darknet import DarknetStage
from .layers import Conv1DTemporal, ConvBNLeaky, nhwc

__all__ = ["HDarknet"]

_MERGE_WIDTHS = (32, 64, 128, 256)  # the channels after the stem and stages 1-3


class HDarknet(nn.Module):
    """NHWC windows (B, t, H, W, 3) (or images) -> the three routes."""

    route_channels = (256, 512, 1024)

    def __init__(self, windows: Sequence[int] = (3, 1, 1, 1, 1), merge_type: str = "max",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        windows = tuple(int(w) for w in windows)
        if merge_type not in ("max", "conv"):
            raise ValueError(f"merge_type must be 'max' or 'conv', got {merge_type!r}")
        if len(windows) != 5 or windows[4] != 1:
            raise ValueError(f"windows {windows}: five levels, the fifth 1 (a 5th-level merge never reaches the "
                             "detection path, h_darknet.py:181-188)")
        self.windows, self.merge_type = windows, merge_type
        self.dtype = dtype or torch.float32
        self.conv0 = ConvBNLeaky(3, 32, kernel=3, dtype=dtype)
        self.stage1 = DarknetStage(32, 64, 1, dtype=dtype)
        self.stage2 = DarknetStage(64, 128, 2, dtype=dtype)
        self.stage3 = DarknetStage(128, 256, 8, dtype=dtype)
        self.stage4 = DarknetStage(256, 512, 8, dtype=dtype)
        self.stage5 = DarknetStage(512, 1024, 4, dtype=dtype)
        if merge_type == "conv":
            for level, (w, c) in enumerate(zip(windows, _MERGE_WIDTHS)):
                if w > 1:
                    self.add_module(f"conv1d_{level}", Conv1DTemporal(c, kernel=w, padding=0, dtype=dtype))

    def train(self, mode: bool = True):
        # the JAX package calls the merge cells without `train`
        # (h_darknet.py:45-48): their BN always normalises with the running
        # statistics and never updates them (ROADMAP.md Queue 3), mirrored
        super().train(mode)
        for name, cell in self.named_children():
            if name.startswith("conv1d_"):
                cell.eval()
        return self

    def _merge(self, x: torch.Tensor, level: int) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, T/3, H, W, C): groups of 3 frames merged."""
        b, t = x.shape[:2]
        if t % 3:
            raise ValueError(f"t={t} frames at level {level} do not divide into windows of 3")
        g = x.reshape((b * (t // 3), 3) + x.shape[2:])
        if self.merge_type == "max":
            merged = g.amax(dim=1)
        else:
            merged = getattr(self, f"conv1d_{level}")(g)[:, 0]
        return merged.reshape((b, t // 3) + merged.shape[1:])

    def forward(self, x: torch.Tensor):
        y = x.to(self.dtype)
        for level, name in enumerate(("conv0", "stage1", "stage2", "stage3")):
            if y.dim() == 5 and y.shape[1] == 1:
                y = y[:, 0]
            y = nhwc(getattr(self, name), y)
            if self.windows[level] > 1:
                if y.dim() == 5:
                    y = self._merge(y, level)
                elif self.merge_type == "conv":
                    raise ValueError(
                        f"windows {self.windows}: level {level} has no window to merge for an input of "
                        f"{tuple(x.shape)}, so the JAX package would create no conv1d_{level}; give a window whose "
                        "frames merge at every such level")
        if y.dim() == 5:
            if y.shape[1] != 1:
                raise ValueError(f"windows {self.windows} do not collapse t={x.shape[1]} to 1")
            y = y[:, 0]
        r2 = nhwc(self.stage4, y)
        return y, r2, nhwc(self.stage5, r2)
