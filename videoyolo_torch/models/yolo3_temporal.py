"""Temporal YOLOv3 over k-frame windows (port of
videoyolo_tpu/models/yolo3_temporal.py:52-375).

`YOLOv3T` takes NHWC windows (B, k, H, W, 3): the Darknet-53 stages run per
frame, then the k frames join early (on the routes) or late (on the tips) by
max, mean or a fold of time into channels, and a correlation block (`Corr`,
cost volumes of frames 0 and 2 against the middle one) runs early or late.
Eval mode returns (boxes (B, N, 4), scores (B, N, C)) as `YOLOv3` does;
train mode the raw-head dict of `YOLOv3`'s train mode
(yolo3_temporal.py:241-256 `_finish`), with a leading time axis where no
join collapses the window (per-frame heads).  In train mode BatchNorm takes
its statistics over the B*k frames folded into the batch, as the JAX
package's `time_distributed` does, and the cost volumes are differentiated
through `ops/correlation.CostVolume` (the adjoint kernel on the card).

The temporal tensors are NHWC, 5-D per frame and 4-D once joined, as in the
JAX package; each conv cell sees an NCHW view of them (`channels_last`
memory).  The cells cast their input to the model's dtype, as flax's convs
do: the correlation routes are float32 and meet the bf16 cells there.

Not ported yet (they raise NotImplementedError naming the slice and the
ROADMAP.md item): the conv-RNN (`rnn_pos`, item 5), 3D and 2+1D blocks
(item 6), custom backbones (item 7), the streaming split (`feed`, item 11),
int8 cells (item 9a), and `YOLOv3Temporal` (item 8).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn

from ..ops.anchors import DEFAULT_ANCHORS, DEFAULT_STRIDES
from ..ops.correlation import num_corr_channels
from .darknet import DARKNET53_CHANNELS, Darknet53Stage1, DarknetStage
from .layers import ConvBNLeaky, Corr, TemporalPooling, time_distributed, upsample2x
from .yolo3 import FPN_CHANNELS, YOLOOutput

__all__ = ["YOLOv3T"]

_LATER = "comes with slice 5 (the rest of the temporal family), see ROADMAP.md Queue 1 item"


def _fold_time_into_channels(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, H, W, T*C), channel t*C + c (the 'cat' join)."""
    b, t, h, w, c = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)


def _nhwc(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """An NCHW module or function on an NHWC tensor, per frame when 5-D."""
    if x.dim() == 5:
        return time_distributed(partial(_nhwc, fn), x)
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _TCell(nn.Module):
    """A 2D conv cell on NHWC input, per frame when 5-D (yolo3_temporal.py:
    66-92, conv_type '2'); it casts its input to its dtype."""

    def __init__(self, in_channels: int, features: int, kernel: int, conv_type: str = "2",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if conv_type != "2":
            raise NotImplementedError(f"3D and 2+1D cells: {_LATER} 6")
        self.dtype = dtype or torch.float32
        self.ConvBNLeaky_0 = ConvBNLeaky(in_channels, features, kernel=kernel, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.ConvBNLeaky_0, x.to(self.dtype))


class YOLODetectionBlockT(nn.Module):
    """5-conv FPN block + 3x3 tip on NHWC input (yolo3_temporal.py:95-117);
    returns (route, tip)."""

    def __init__(self, in_channels: int, channel: int, conv_type: str = "2",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if channel % 2:
            raise ValueError(f"channel must be even, got {channel}")
        specs = [(in_channels, channel, 1), (channel, 2 * channel, 3),
                 (2 * channel, channel, 1), (channel, 2 * channel, 3),
                 (2 * channel, channel, 1), (channel, 2 * channel, 3)]
        for n, (cin, cout, kernel) in enumerate(specs):
            self.add_module(f"_TCell_{n}", _TCell(cin, cout, kernel, conv_type, dtype=dtype))

    def forward(self, x: torch.Tensor):
        cells = list(self.children())
        for cell in cells[:-1]:
            x = cell(x)
        return x, cells[-1](x)


class YOLOOutputConvT(YOLOOutput):
    """`YOLOOutput` on an NHWC tip (yolo3_temporal.py:140-163): a 5-D tip is
    decoded per frame, with outputs (B, T, N, ...) (in train mode, each
    value of the raw-head dict)."""

    def forward(self, tip: torch.Tensor):
        if tip.dim() == 5:
            b, t = tip.shape[:2]
            out = self(tip.flatten(0, 1))
            if isinstance(out, dict):
                return {k: v.reshape((b, t) + v.shape[1:]) for k, v in out.items()}
            return tuple(o.reshape((b, t) + o.shape[1:]) for o in out)
        return super().forward(tip.to(self.prediction.dtype).permute(0, 3, 1, 2))


def _validate(k_join_type, k_join_pos, rnn_pos, corr_pos, corr_d):
    # the JAX package's config asserts (yolo3_temporal.py:205-234)
    for name, value, allowed in (
        ("rnn_pos", rnn_pos, (None, "late", "out")),
        ("k_join_type", k_join_type, (None, "max", "mean", "cat")),
        ("k_join_pos", k_join_pos, (None, "early", "late")),
        ("corr_pos", corr_pos, (None, "early", "late")),
    ):
        if value not in allowed:
            raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
    if corr_pos is not None and not corr_d:
        raise ValueError("corr_pos requires corr_d > 0")


class YOLOv3T(nn.Module):
    """k-frame temporal YOLOv3 (yolo3_temporal.py:166-375) with the built-in
    Darknet-53 stages.

    Input (B, k, H, W, 3) NHWC for k > 1 ((B, H, W, 3) for k = 1).  The
    joins and the correlation follow the JAX package's precedence: an early
    join pre-empts an early correlation, a late join a late one, and once
    the routes are joined the late ones do not run.  `frame_routes` and
    `head` are the forward's two halves, around the early join or
    correlation."""

    def __init__(
        self,
        num_classes: int,
        k: int = 1,
        k_join_type: Optional[str] = None,  # max | mean | cat
        k_join_pos: Optional[str] = None,  # early | late
        block_conv_type: str = "2",
        rnn_pos: Optional[str] = None,
        corr_pos: Optional[str] = None,  # early | late
        corr_d: Optional[int] = None,
        agnostic: bool = False,
        backbone: Optional[nn.Module] = None,
        feed: Optional[str] = None,
        anchors=DEFAULT_ANCHORS,  # shallow -> deep per level
        strides: Sequence[int] = DEFAULT_STRIDES,
        channels: Sequence[int] = FPN_CHANNELS,
        quant: Any = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        _validate(k_join_type, k_join_pos, rnn_pos, corr_pos, corr_d)
        if quant:
            raise NotImplementedError("the int8 temporal family is deferred, see ROADMAP.md Queue 1 item 9a")
        if rnn_pos is not None:
            raise NotImplementedError(f"the conv-RNN (rnn_pos): {_LATER} 5")
        if block_conv_type != "2":
            raise NotImplementedError(f"3D and 2+1D blocks: {_LATER} 6")
        if backbone is not None:
            raise NotImplementedError(f"custom and two-stream backbones: {_LATER} 7")
        if feed is not None:
            raise NotImplementedError(f"the streaming split (feed): {_LATER} 11")
        self.k = k or 1
        self.k_join_type = k_join_type
        self.agnostic = agnostic
        temporal = self.k > 1

        self.stage1 = Darknet53Stage1(dtype=dtype)
        self.stage2 = DarknetStage(256, 512, 8, dtype=dtype)
        self.stage3 = DarknetStage(512, 1024, 4, dtype=dtype)

        # which join and correlation run where (yolo3_temporal.py:306-345)
        self.early_join = temporal and k_join_pos == "early"
        self.early_corr = temporal and not self.early_join and corr_pos == "early"
        per_frame = temporal and not (self.early_join or self.early_corr)
        self.late_join = per_frame and k_join_pos == "late" and k_join_type is not None
        self.late_corr = per_frame and not self.late_join and corr_pos == "late"
        self.corr = (
            Corr(corr_d, self.k, kernel_size=1, stride=1, keep="all")
            if temporal and corr_pos is not None else None
        )
        if (self.early_join or self.late_join) and k_join_type != "cat":
            self.pool = TemporalPooling(type=k_join_type)
        n_corr = (self.k - 1) * num_corr_channels(corr_d, 1) if self.corr is not None else 0

        def after(c, join, corr):  # channels of a C-channel map after its join / corr
            if join:
                return self.k * c if k_join_type == "cat" else c
            return self.k * c + n_corr if corr else c

        route_channels = [
            after(c, self.early_join, self.early_corr) for c in DARKNET53_CHANNELS[-3:]
        ]
        anchors_rev = list(anchors)[::-1]
        strides_rev = list(strides)[::-1]
        cin = route_channels[-1]
        for i in range(3):
            self.add_module(
                f"block{i}", YOLODetectionBlockT(cin, channels[i], block_conv_type, dtype=dtype)
            )
            pairs = [(anchors_rev[i][2 * j], anchors_rev[i][2 * j + 1])
                     for j in range(len(anchors_rev[i]) // 2)]
            tip = after(2 * channels[i], self.late_join, self.late_corr)
            self.add_module(
                f"output{i}",
                YOLOOutputConvT(tip, num_classes, pairs, strides_rev[i], dtype=dtype),
            )
            if i < 2:
                self.add_module(
                    f"transition{i}",
                    ConvBNLeaky(channels[i], channels[i + 1], kernel=1, dtype=dtype),
                )
                cin = channels[i + 1] + route_channels[1 - i]

    def _join(self, x: torch.Tensor) -> torch.Tensor:
        if self.k_join_type == "cat":
            return _fold_time_into_channels(x)
        return self.pool(x)

    def forward(self, x: torch.Tensor):
        routes = self.frame_routes(x)
        if routes[0].dim() == 5 and self.early_join:
            routes = [self._join(r) for r in routes]
        elif routes[0].dim() == 5 and self.early_corr:
            routes = [self.corr(r) for r in routes]
        return self.head(routes)

    def frame_routes(self, x: torch.Tensor):
        """The Darknet-53 stages, per frame of a window: the three NHWC
        routes, (B, k, H/s, W/s, C) for s = 8, 16, 32."""
        temporal = self.k > 1 and x.dim() == 5
        routes = []
        y = x
        for stage in (self.stage1, partial(_nhwc, self.stage2), partial(_nhwc, self.stage3)):
            y = time_distributed(stage, y) if temporal else stage(y)
            routes.append(y)
        return routes

    def head(self, routes):
        """Routes after any early join or correlation -> the detection
        blocks, late join or correlation, outputs: (boxes, scores), or in
        train mode the raw-head dict, levels deep -> shallow."""
        level_outs = []
        y = routes[-1]
        for i in range(3):
            y, tip = getattr(self, f"block{i}")(y)
            if tip.dim() == 5:
                if self.late_join:
                    tip = self._join(tip)
                elif self.late_corr:
                    tip = self.corr(tip)
            level_outs.append(getattr(self, f"output{i}")(tip))
            if i < 2:
                y = _nhwc(upsample2x, _nhwc(getattr(self, f"transition{i}"), y))
                # a float32 correlation route meets the bf16 cells: cast it
                # here, as the next conv would
                y = torch.cat([y, routes[1 - i].to(y.dtype)], dim=-1)

        if self.training:
            return {key: torch.cat([o[key] for o in level_outs], dim=-2) for key in level_outs[0]}
        boxes = torch.cat([o[0] for o in level_outs], dim=-2)
        scores = torch.cat([o[2 if self.agnostic else 1] for o in level_outs], dim=-2)
        return boxes, scores
