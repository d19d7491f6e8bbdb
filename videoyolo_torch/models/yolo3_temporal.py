"""Temporal YOLOv3 over k-frame windows (port of
videoyolo_tpu/models/yolo3_temporal.py:52-549).

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

`YOLOv3Temporal` is the t=5 model: per-timestep heads (`t_out`) over
per-frame stages, or over the correlation pyramid (stage 1 per frame, the
kernel_size=3 cost volumes of every frame against the middle one, a conv
pyramid of them beside the middle frame's deeper stages), or, without
`t_out`, the 5 -> 3 -> 1 funnel of 3-D convs that ends in one frame's
detections.

The forward is built from halves that the streaming detector
(`videoyolo_torch/streaming.py`) calls apart, so that a new frame pays one
per-frame pass: YOLOv3T's `frame_routes` (the stages, per frame),
`window_routes` (the early join or correlation), `fpn` (the detection
blocks and transitions, giving the three tips) and `outputs` (the late join
or correlation, the output heads); YOLOv3Temporal's `frame_routes` or
`frame_stage1`, `routes_from_stage1` and `head`.  A model built with `feed`
holds only the parameters of the half its forward then takes, as the JAX
package's feed clones do: YOLOv3T `feed="tips"` the outputs over windows of
pre-join tips; YOLOv3Temporal `feed="stage1"` everything after stage 1 over
a window of stage-1 features, `feed="routes"` the head over windows of
routes.

The conv-RNN (`rnn_pos`): "late" replaces each block's tip cell by a
bidirectional 3x3 conv-GRU over the window of routes (`tip_rnn{i}`), then
the late join or correlation; "out" keeps the per-frame FPN and its tips
and replaces each output conv by `YOLOOutputRNN`, a 1x1 conv-GRU over the
window of tips, pooled over time.  The 3D and 2+1D blocks
(`block_conv_type` '3' / '21', YOLOv3Temporal's `conv` 3 / 21) run the
detection blocks over the window, (k, k, k) or (1, k, k) then (k, 1, 1)
cells; the transitions stay per frame.

With a `backbone` (`Darknet3D` or `HDarknet`, the factory's `new_model`,
or the two-stream `TwoStreamDarknet`, its `motion_stream` flownet or r21d),
YOLOv3T takes the backbone's three 4-D routes, of the backbone's
`route_channels`, in place of the Darknet-53 stages, and its FPN and heads
run in 2D on them, as the JAX package's do: no join or correlation runs,
whatever the flags.

The configurations whose JAX forward is at fault raise ValueError (ROADMAP.md
Queue 3): the conv-RNN or 3-D blocks after an early correlation or on a
backbone's 4-D routes, and the 3-D funnel.  A backbone of another class
raises NotImplementedError (the factory builds none: ROADMAP.md item 7
lists the three).

`quant` True / "dynamic" or "static" builds the int8 models of
ops/quantize.py:quantize_static (yolo3_temporal.py:190-200, 410-411): every
conv-BN cell int8 (the stages, the 2-D, 3-D and 2+1D blocks, the
transitions, the pyramid's `convs1-3`, the funnel's 3-D cells), real values
in `dtype` between them; the correlation, the conv-RNN (its carry stays
real: mixed precision) and the prediction convs stay real-valued.  An int8
cell quantises its input as it comes (a float32 correlation route is not
cast to `dtype` first, as the JAX package's concat keeps it float32).  Not
ported yet (NotImplementedError naming the ROADMAP.md item): the
two-stream int8 backbone (item 9a).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..ops.anchors import DEFAULT_ANCHORS, DEFAULT_STRIDES
from ..ops.correlation import num_corr_channels
from .darknet import DARKNET53_CHANNELS, Darknet53Stage1, DarknetStage
from .darknet3d import Darknet3D
from .h_darknet import HDarknet
from .ts_darknet import TwoStreamDarknet
from .layers import (
    REAL_MODES, Conv21D, ConvBNLeaky, ConvBNLeaky3D, ConvRNN, Corr, TemporalPooling, nhwc, time_distributed,
    upsample2x,
)
from .yolo3 import FPN_CHANNELS, YOLOOutput, decode_predictions

__all__ = ["YOLOv3T", "YOLOv3Temporal"]


def _anchor_pairs(level_anchors):
    return [(level_anchors[2 * j], level_anchors[2 * j + 1]) for j in range(len(level_anchors) // 2)]


def _check_quant(quant) -> None:
    if quant and quant not in REAL_MODES:
        raise ValueError(f"the temporal family serves int8 with quant True, 'dynamic' or 'static' (the fused "
                         f"pipeline is YOLOv3's), got {quant!r}")


def _as_input(x: torch.Tensor, dtype: torch.dtype, quant) -> torch.Tensor:
    """A cell's input: cast to `dtype` as flax's convs cast, or as it comes
    for an int8 cell, which quantises it from its own dtype."""
    return x if quant else x.to(dtype)


def _fold_time_into_channels(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, H, W, T*C), channel t*C + c (the 'cat' join)."""
    b, t, h, w, c = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)


class _TCell(nn.Module):
    """A conv cell on NHWC input (yolo3_temporal.py:66-92): conv_type '2' a
    2D cell, per frame when 5-D; '3' a (k, k, k) `ConvBNLeaky3D` and '21' a
    `Conv21D` over a window (B, T, H, W, C), a 1x1 cell of either a (1, 1,
    1) one.  It casts its input to its dtype (an int8 cell takes it as it
    comes)."""

    def __init__(self, in_channels: int, features: int, kernel: int, conv_type: str = "2",
                 dtype: Optional[torch.dtype] = None, quant=None):
        super().__init__()
        if conv_type not in ("2", "3", "21"):
            raise ValueError(f"conv_type must be '2', '3' or '21', got {conv_type!r}")
        self.conv_type, self.dtype, self.quant = conv_type, dtype or torch.float32, quant or None
        if conv_type == "2":
            self.ConvBNLeaky_0 = ConvBNLeaky(in_channels, features, kernel=kernel, dtype=dtype, quant=quant)
        elif conv_type == "3" or kernel == 1:
            kt = kernel if conv_type == "3" else 1
            self.ConvBNLeaky3D_0 = ConvBNLeaky3D(in_channels, features, kernel=(kt, kernel, kernel), dtype=dtype,
                                                 quant=quant)
        else:
            self.Conv21D_0 = Conv21D(in_channels, features, kernel=kernel, dtype=dtype, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv_type == "2":
            return nhwc(self.ConvBNLeaky_0, _as_input(x, self.dtype, self.quant))
        if x.dim() != 5:
            raise ValueError(f"a 3-D cell takes a window (B, T, H, W, C), got {tuple(x.shape)}")
        return next(iter(self.children()))(x)


class YOLODetectionBlockT(nn.Module):
    """5-conv FPN block + 3x3 tip on NHWC input (yolo3_temporal.py:95-117);
    returns (route, tip), or with `with_tip=False` (the conv-RNN's block)
    the route alone.  The 1x1 cells of a '3' or '21' block are (1, 1, 1)
    3-D cells."""

    def __init__(self, in_channels: int, channel: int, conv_type: str = "2", with_tip: bool = True,
                 dtype: Optional[torch.dtype] = None, quant=None):
        super().__init__()
        if channel % 2:
            raise ValueError(f"channel must be even, got {channel}")
        one = "3" if conv_type in ("3", "21") else "2"
        specs = [(in_channels, channel, 1, one), (channel, 2 * channel, 3, conv_type),
                 (2 * channel, channel, 1, one), (channel, 2 * channel, 3, conv_type),
                 (2 * channel, channel, 1, one)]
        if with_tip:
            specs.append((channel, 2 * channel, 3, conv_type))
        self.with_tip = with_tip
        for n, (cin, cout, kernel, ctype) in enumerate(specs):
            self.add_module(f"_TCell_{n}", _TCell(cin, cout, kernel, ctype, dtype=dtype, quant=quant))

    def forward(self, x: torch.Tensor):
        cells = list(self.children())
        for cell in cells[:5]:
            x = cell(x)
        return (x, cells[5](x)) if self.with_tip else x


class YOLOOutputRNN(nn.Module):
    """The rnn_pos='out' head (yolo3_temporal.py:120-137): a 1x1
    bidirectional conv-GRU (`prediction`) over the window's tips (B, k, H,
    W, C), the window pooled by `k_join_type` (max when None), then the
    anchor decode of `YOLOOutput`."""

    def __init__(self, in_channels: int, num_classes: int, anchors, stride: int, k_join_type: Optional[str] = "max",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes, self.stride = num_classes, stride
        self.prediction = ConvRNN(in_channels, len(anchors) * (5 + num_classes), kernel=(1, 1), dtype=dtype)
        self.pool = TemporalPooling(type=k_join_type or "max")
        self.register_buffer("anchors", torch.tensor(anchors, dtype=torch.float32), persistent=False)

    def forward(self, tip: torch.Tensor):
        pred = self.pool(self.prediction(tip))
        return decode_predictions(pred.permute(0, 3, 1, 2), self.anchors, self.stride, self.num_classes,
                                  self.training)


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


def _validate(k, k_join_type, k_join_pos, block_conv_type, rnn_pos, corr_pos, corr_d):
    # the JAX package's config asserts (yolo3_temporal.py:205-234), and the
    # configurations whose JAX forward is at fault (ROADMAP.md Queue 3)
    for name, value, allowed in (
        ("rnn_pos", rnn_pos, (None, "late", "out")),
        ("k_join_type", k_join_type, (None, "max", "mean", "cat")),
        ("k_join_pos", k_join_pos, (None, "early", "late")),
        ("block_conv_type", block_conv_type, ("2", "3", "21")),
        ("corr_pos", corr_pos, (None, "early", "late")),
    ):
        if value not in allowed:
            raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
    if corr_pos is not None and not corr_d:
        raise ValueError("corr_pos requires corr_d > 0")
    if block_conv_type != "2":
        if not (k or 1) > 1:
            raise ValueError("3D/2+1D blocks need k > 1")
        if k_join_pos != "late" or k_join_type is None:
            raise ValueError("3D/2+1D blocks join late: k_join_pos='late' and a k_join_type")
        if corr_pos == "early":
            raise ValueError("3D/2+1D blocks with corr_pos='early' would take the correlation's 4-D routes (the JAX "
                             "package's 3-D convs then mix the images of a batch); not built")
    if rnn_pos is not None:
        if not (k or 1) > 1:
            raise ValueError("the conv-RNN scans a window: k > 1")
        if rnn_pos == "late" and k_join_pos != "late":
            raise ValueError("rnn_pos='late' needs k_join_pos='late'")
        if corr_pos == "early":
            raise ValueError("the conv-RNN with corr_pos='early' would scan the correlation's 4-D routes (the JAX "
                             "package reads their rows as time and fails); not built")


class YOLOv3T(nn.Module):
    """k-frame temporal YOLOv3 (yolo3_temporal.py:166-375) with the built-in
    Darknet-53 stages, or over a `backbone` (`Darknet3D`, `HDarknet`,
    `TwoStreamDarknet`) that returns the three routes itself from its
    window.

    Input (B, k, H, W, 3) NHWC for k > 1 ((B, H, W, 3) for k = 1), or with
    `feed="tips"` the three (B, k, H/s, W/s, C) windows of pre-join tips,
    deep first.  The joins and the correlation follow the JAX package's
    precedence: an early join pre-empts an early correlation, a late join a
    late one, and once the routes are joined the late ones do not run; with
    the output conv-RNN (`rnn_pos="out"`) no join or correlation runs.
    `fpn` gives the tips, after the tip conv-RNN for `rnn_pos="late"`.  The
    forward is `outputs(fpn(window_routes(frame_routes(x))))`; `head` is
    `outputs(fpn(.))`."""

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
        self.init_kwargs = dict(
            num_classes=num_classes, k=k, k_join_type=k_join_type, k_join_pos=k_join_pos,
            block_conv_type=block_conv_type, rnn_pos=rnn_pos, corr_pos=corr_pos, corr_d=corr_d, agnostic=agnostic,
            backbone=backbone, feed=feed, anchors=anchors, strides=strides, channels=channels, quant=quant,
            dtype=dtype,
        )
        _validate(k, k_join_type, k_join_pos, block_conv_type, rnn_pos, corr_pos, corr_d)
        _check_quant(quant)
        if quant and isinstance(backbone, TwoStreamDarknet):
            raise NotImplementedError("the two-stream int8 model is deferred, see ROADMAP.md Queue 1 item 9a")
        if quant and backbone is not None:
            # YOLOv3T._validate's assertion (yolo3_temporal.py:207-212):
            # Darknet3D and HDarknet have no int8 cells
            raise ValueError("a custom backbone must carry the same quant mode (ops/quantize.replace_quant threads "
                             "it)")
        if backbone is not None and not isinstance(backbone, (Darknet3D, HDarknet, TwoStreamDarknet)):
            raise NotImplementedError("backbones other than Darknet3D, HDarknet and TwoStreamDarknet, the factory's "
                                      "three (ROADMAP.md Queue 1 item 7): not built")
        if backbone is not None and (rnn_pos is not None or block_conv_type != "2"):
            raise ValueError("the conv-RNN and 3-D blocks scan a window, and a backbone's routes are 4-D (the JAX "
                             "package reads their batch or rows as time); not built")
        if feed not in (None, "tips"):
            raise ValueError(f"YOLOv3T's feed must be None or 'tips', got {feed!r}")
        if feed == "tips" and (corr_pos is not None or block_conv_type != "2"):
            raise ValueError("feed='tips' needs a frame-pure per-frame FPN: 2D blocks, no correlation")
        if feed == "tips" and not (rnn_pos == "out" or (rnn_pos is None and k_join_pos == "late"
                                                         and k_join_type is not None)):
            raise ValueError("feed='tips' covers plain late joins and rnn_pos='out'")
        self.k = k or 1
        self.k_join_type, self.k_join_pos, self.rnn_pos = k_join_type, k_join_pos, rnn_pos
        self.corr_pos, self.block_conv_type, self.feed = corr_pos, block_conv_type, feed
        self.agnostic, self.quant = agnostic, quant or None
        # a backbone's routes are 4-D: no join or correlation runs on them
        temporal = self.k > 1 and backbone is None

        self.has_backbone = feed is None and backbone is not None
        if self.has_backbone:
            self.backbone = backbone
        elif feed is None:
            self.stage1 = Darknet53Stage1(dtype=dtype, quant=quant)
            self.stage2 = DarknetStage(256, 512, 8, dtype=dtype, quant=quant)
            self.stage3 = DarknetStage(512, 1024, 4, dtype=dtype, quant=quant)

        # which join and correlation run where (yolo3_temporal.py:306-345):
        # the output conv-RNN takes the window's tips unjoined
        self.early_join = temporal and k_join_pos == "early" and rnn_pos != "out"
        self.early_corr = temporal and not self.early_join and corr_pos == "early"
        per_frame = temporal and not (self.early_join or self.early_corr) and rnn_pos != "out"
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
            after(c, self.early_join, self.early_corr)
            for c in (backbone.route_channels if backbone is not None else DARKNET53_CHANNELS[-3:])
        ]
        anchors_rev = list(anchors)[::-1]
        strides_rev = list(strides)[::-1]
        cin = route_channels[-1]
        for i in range(3):
            if feed is None:
                self.add_module(f"block{i}", YOLODetectionBlockT(
                    cin, channels[i], block_conv_type, with_tip=rnn_pos != "late", dtype=dtype, quant=quant))
                if rnn_pos == "late":
                    self.add_module(f"tip_rnn{i}", ConvRNN(channels[i], 2 * channels[i], kernel=(3, 3), dtype=dtype))
            pairs = _anchor_pairs(anchors_rev[i])
            if rnn_pos == "out":
                head = YOLOOutputRNN(2 * channels[i], num_classes, pairs, strides_rev[i], k_join_type, dtype=dtype)
            else:
                tip = after(2 * channels[i], self.late_join, self.late_corr)
                head = YOLOOutputConvT(tip, num_classes, pairs, strides_rev[i], dtype=dtype)
            self.add_module(f"output{i}", head)
            if i < 2:
                if feed is None:
                    self.add_module(
                        f"transition{i}",
                        ConvBNLeaky(channels[i], channels[i + 1], kernel=1, dtype=dtype, quant=quant),
                    )
                cin = channels[i + 1] + route_channels[1 - i]

    def _join(self, x: torch.Tensor) -> torch.Tensor:
        if self.k_join_type == "cat":
            return _fold_time_into_channels(x)
        return self.pool(x)

    def forward(self, x):
        if self.feed == "tips":
            return self.outputs(x)
        return self.head(self.window_routes(self.frame_routes(x)))

    def frame_routes(self, x: torch.Tensor):
        """The Darknet-53 stages, per frame of a window: the three NHWC
        routes, (B, k, H/s, W/s, C) for s = 8, 16, 32 ((B, H/s, W/s, C) for
        one frame); with a backbone, its three 4-D routes."""
        if self.has_backbone:
            return list(self.backbone(x))
        temporal = self.k > 1 and x.dim() == 5
        routes = []
        y = x
        for stage in (self.stage1, partial(nhwc, self.stage2), partial(nhwc, self.stage3)):
            y = time_distributed(stage, y) if temporal else stage(y)
            routes.append(y)
        return routes

    def window_routes(self, routes):
        """Per-frame route windows -> the routes after the early join or
        correlation (unchanged when neither runs, or for one frame)."""
        if routes[0].dim() == 5 and self.early_join:
            return [self._join(r) for r in routes]
        if routes[0].dim() == 5 and self.early_corr:
            return [self.corr(r) for r in routes]
        return list(routes)

    def fpn(self, routes):
        """Routes -> the three tips, deep first: the detection blocks, and
        between them the transitions, the upsample and the concat with the
        next route.  Per frame when the routes are (a frame's, or a window's
        that no early join or correlation mixed)."""
        tips = []
        y = routes[-1]
        for i in range(3):
            if self.rnn_pos == "late":
                y = getattr(self, f"block{i}")(y)
                tip = getattr(self, f"tip_rnn{i}")(y)
            else:
                y, tip = getattr(self, f"block{i}")(y)
            tips.append(tip)
            if i < 2:
                y = nhwc(upsample2x, nhwc(getattr(self, f"transition{i}"), y))
                # a float32 correlation route meets the bf16 cells: cast it
                # here, as the next conv would (an int8 cell takes it as it is)
                y = torch.cat([y, _as_input(routes[1 - i], y.dtype, self.quant)], dim=-1)
        return tips

    def outputs(self, tips):
        """The three tips, deep first -> the late join or correlation of a
        window's tips, the output heads: (boxes, scores), or in train mode
        the raw-head dict, levels deep -> shallow."""
        level_outs = []
        for i, tip in enumerate(tips):
            if tip.dim() == 5:
                if self.late_join:
                    tip = self._join(tip)
                elif self.late_corr:
                    tip = self.corr(tip)
            level_outs.append(getattr(self, f"output{i}")(tip))
        return _finish(level_outs, self.training, self.agnostic)

    def head(self, routes):
        """Routes after any early join or correlation -> the detection
        blocks, late join or correlation, outputs."""
        return self.outputs(self.fpn(routes))


def _finish(level_outs, training: bool, agnostic: bool):
    """The levels' outputs -> (boxes, scores), or the raw-head dict in train
    mode (yolo3_temporal.py:241-256)."""
    if training:
        return {key: torch.cat([o[key] for o in level_outs], dim=-2) for key in level_outs[0]}
    boxes = torch.cat([o[0] for o in level_outs], dim=-2)
    scores = torch.cat([o[2 if agnostic else 1] for o in level_outs], dim=-2)
    return boxes, scores


def _cell(cell: nn.Module, x: torch.Tensor, dtype: torch.dtype, quant=None) -> torch.Tensor:
    """A 2D cell on an NHWC map or window, its input cast to `dtype` (as
    flax's convs cast a float32 correlation route; an int8 cell takes it as
    it comes)."""
    return nhwc(cell, _as_input(x, dtype, quant))


class YOLOv3Temporal(nn.Module):
    """The t=5 temporal model (yolo3_temporal.py:378-549).

    Input (B, t, H, W, 3) NHWC windows ((B, H, W, 3) for t = 1); with
    `feed="stage1"` (the pyramid and the funnel) the (B, t, H/8, W/8, 256)
    window of stage-1 features, with `feed="routes"` (the plain t_out path)
    the three windows of per-frame routes.
    t_out=True: every branch runs per frame and the outputs keep the time
    axis: eval (boxes (B, t, N, 4), scores (B, t, N, C)), train the
    raw-head dict with (B, t, ...) values.  With `corr_d`, the correlation
    pyramid: stage 1 per frame, `Corr(corr_d, t, kernel_size=3,
    keep='none', comp_mid=True)` (each frame against the middle one, the
    middle one against itself), `convs1-3` per frame on the cost volumes,
    each level concatenated with the middle frame's stage-1-3 features
    repeated over t.  t_out=False: the 5 -> 3 -> 1 funnel, per-frame stages
    fused with (1,3,3)/(1,2,2) then (3,1,1) 3-D cells (`convs{1,2}_s/_t`),
    single-frame routes and outputs (B, N, ...).  Submodules carry the flax
    names (`stage1-3`, `corr`, `convs*`, `block{i}`, `output{i}`,
    `transition{i}`).  `conv` 3 or 21 (t_out only) runs the detection
    blocks over the window (3-D or 2+1D cells), the transitions per frame.
    In train mode BatchNorm takes its statistics over the frames folded
    into the batch, as `time_distributed` does in JAX."""

    def __init__(
        self,
        num_classes: int,
        t: int = 5,
        conv: int = 2,
        corr_d: int = 0,
        t_out: bool = True,
        feed: Optional[str] = None,
        agnostic: bool = False,
        anchors=DEFAULT_ANCHORS,
        strides: Sequence[int] = DEFAULT_STRIDES,
        channels: Sequence[int] = FPN_CHANNELS,
        quant: Any = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.init_kwargs = dict(
            num_classes=num_classes, t=t, conv=conv, corr_d=corr_d, t_out=t_out, feed=feed, agnostic=agnostic,
            anchors=anchors, strides=strides, channels=channels, quant=quant, dtype=dtype,
        )
        if t not in (1, 5):
            raise ValueError(f"YOLOv3Temporal takes t=1 or t=5 (yolo3_temporal.py:400), got {t}")
        _check_quant(quant)
        if conv not in (2, 3, 21):
            raise ValueError(f"YOLOv3Temporal's conv must be 2, 3 or 21, got {conv}")
        if conv != 2 and not (t > 1 and t_out):
            raise ValueError(f"YOLOv3Temporal's 3D and 2+1D blocks (conv={conv}) take per-frame routes (t_out, t=5): "
                             "the funnel's and one frame's routes are 4-D (the JAX package's 3-D convs then mix the "
                             "images of a batch); not built")
        # the JAX package's feed asserts (yolo3_temporal.py:420-427)
        if feed not in (None, "stage1", "routes"):
            raise ValueError(f"YOLOv3Temporal's feed must be None, 'stage1' or 'routes', got {feed!r}")
        if feed == "routes" and not (t_out and not corr_d):
            raise ValueError("feed='routes' is the plain t_out split; the corr/funnel paths split at stage1 "
                             "(feed='stage1')")
        if feed == "stage1" and not (t > 1 and (corr_d or not t_out)):
            raise ValueError("feed='stage1' is the split of the correlation pyramid and the funnel (t=5)")
        self.t, self.corr_d, self.t_out, self.agnostic, self.feed = t, corr_d, t_out, agnostic, feed
        self.dtype, self.quant = dtype or torch.float32, quant or None
        q = dict(dtype=dtype, quant=quant)
        self.path = "single" if t == 1 else ("pyramid" if t_out and corr_d else "per_frame" if t_out else "funnel")
        if feed is None:
            self.stage1 = Darknet53Stage1(**q)
        if feed != "routes":
            self.stage2 = DarknetStage(256, 512, 8, **q)
            self.stage3 = DarknetStage(512, 1024, 4, **q)
        route_channels = list(DARKNET53_CHANNELS[-3:])
        if self.path == "pyramid":
            self.corr = Corr(corr_d, t, kernel_size=3, stride=1, keep="none", comp_mid=True)
            self.convs1 = ConvBNLeaky(num_corr_channels(corr_d, 1), 128, kernel=3, stride=1, **q)
            self.convs2 = ConvBNLeaky(128, 128, kernel=3, stride=2, **q)
            self.convs3 = ConvBNLeaky(128, 128, kernel=3, stride=2, **q)
            route_channels = [c + 128 for c in route_channels]
        elif self.path == "funnel":
            for name, cin, mid, feat in (("convs1", 256, 256, 512), ("convs2", 512, 512, 1024)):
                self.add_module(f"{name}_s", ConvBNLeaky3D(cin, mid, kernel=(1, 3, 3), stride=(1, 2, 2),
                                                           padding=(0, 1, 1), **q))
                self.add_module(f"{name}_t", ConvBNLeaky3D(mid, feat, kernel=(3, 1, 1), stride=(1, 1, 1),
                                                           padding=(0, 0, 0), **q))
        anchors_rev = list(anchors)[::-1]
        strides_rev = list(strides)[::-1]
        cin = route_channels[-1]
        for i in range(3):
            self.add_module(f"block{i}", YOLODetectionBlockT(cin, channels[i], str(conv), **q))
            self.add_module(f"output{i}", YOLOOutputConvT(2 * channels[i], num_classes, _anchor_pairs(anchors_rev[i]),
                                                          strides_rev[i], dtype=dtype))
            if i < 2:
                self.add_module(f"transition{i}", ConvBNLeaky(channels[i], channels[i + 1], kernel=1, **q))
                cin = channels[i + 1] + route_channels[1 - i]

    def frame_routes(self, x: torch.Tensor):
        """Stages 1-3, per frame of a window: the three NHWC routes of a
        frame (B, H/s, W/s, C), or of each frame of a window (B, t, ...)."""
        r1 = self.frame_stage1(x)
        r2 = nhwc(self.stage2, r1)
        return [r1, r2, nhwc(self.stage3, r2)]

    def frame_stage1(self, x: torch.Tensor) -> torch.Tensor:
        """Stage 1 on a frame (B, H, W, 3), or per frame of a window."""
        return time_distributed(self.stage1, x) if x.dim() == 5 else self.stage1(x)

    def routes(self, x: torch.Tensor):
        """The three NHWC routes of the path, deep last: (B, t, H/s, W/s, C)
        per frame on the t_out paths, (B, H/s, W/s, C) on the funnel and
        for t = 1."""
        if self.path in ("single", "per_frame"):
            return self.frame_routes(x)
        return self.routes_from_stage1(self.frame_stage1(x))

    def routes_from_stage1(self, y: torch.Tensor):
        """The pyramid's or the funnel's routes from the window's stage-1
        features (B, t, H/8, W/8, 256): everything after stage 1 mixes the
        window."""
        stage2, stage3 = partial(nhwc, self.stage2), partial(nhwc, self.stage3)
        if self.path == "pyramid":
            mid = y[:, self.t // 2]
            c = _cell(self.convs1, self.corr(y), self.dtype, self.quant)
            routes = []
            for level in range(3):
                if level:
                    mid = (stage2 if level == 1 else stage3)(mid)
                    c = _cell(getattr(self, f"convs{level + 1}"), c, self.dtype, self.quant)
                rep = mid[:, None].expand((-1, self.t) + mid.shape[1:])
                routes.append(torch.cat([rep, c], dim=-1))
            return routes
        # the funnel: T 5 -> 3 -> 1 while the stages run on the shrinking window
        routes = [y[:, 2]]
        cx = self.convs1_t(self.convs1_s(y))  # (B, 3, H/16, W/16, 512)
        y = stage2(y[:, 1:4]) + cx
        routes.append(y[:, 1])
        cx = self.convs2_t(self.convs2_s(y))  # (B, 1, H/32, W/32, 1024)
        y = stage3(y[:, 1:2]) + cx
        routes.append(y[:, 0])
        return routes

    def forward(self, x):
        if self.feed == "routes":
            return self.head(list(x))
        if self.feed == "stage1":
            return self.head(self.routes_from_stage1(x))
        return self.head(self.routes(x))

    def head(self, routes):
        """Routes -> the detection blocks, transitions and outputs: (boxes,
        scores), per frame on the t_out paths, or the raw-head dict in train
        mode."""
        level_outs = []
        y = routes[-1]
        for i in range(3):
            y, tip = getattr(self, f"block{i}")(y)
            level_outs.append(getattr(self, f"output{i}")(tip))
            if i < 2:
                y = nhwc(upsample2x, nhwc(getattr(self, f"transition{i}"), y))
                y = torch.cat([y, _as_input(routes[1 - i], y.dtype, self.quant)], dim=-1)
        return _finish(level_outs, self.training, self.agnostic)
