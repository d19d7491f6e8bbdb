"""The two-stream DarkNet backbone (port of
videoyolo_tpu/models/ts_darknet.py:1-165), its FlowNet stream.

Of a window of t frames, the middle one runs through Darknet-53 while the
others, stacked on channels, run through the FlowNetS encoder and decoder;
each FPN level's darknet route is concatenated with the decoder's concat3,
concat4 or concat5 (256 + 386, 512 + 770 and 1024 + 1026 channels at
strides 8, 16 and 32).  With `add_type` "add" or "mul" the encoder's c1 ...
c4 also gate the first residual block of Darknet-53's first four groups:
the block's body runs on `d + relu(g)` or `d * relu(g)` and the residual
`d` is added by hand (ts_darknet.py:33-85, `gstart` and `gstage4`).  The
input is NHWC windows (B, t, H, W, 3), H and W multiples of 64; the routes
NHWC maps.  Submodules carry the flax names (`flow_encoder`,
`flow_decoder`, `conv0`, `stage1`-`stage5`, `gstart`, `gstage4`).

Not ported yet (NotImplementedError naming the ROADMAP.md item): the
R(2+1)D stream (`stream="r21d"`, item 7's R(2+1)D half) and int8 cells
(item 9a).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .darknet import DarknetBasicBlock, DarknetStage
from .flownet import CONCAT_CHANNELS, FlowNetSEncoder, _FlowDecoder, stack_frames_on_channels
from .layers import ConvBNLeaky

__all__ = ["TwoStreamDarknet"]

ADD_TYPES = (None, "add", "mul")
# _GatedStart's groups: (input channels, channels, blocks), the first block gated
_GATED_GROUPS = ((32, 64, 1), (64, 128, 2), (128, 256, 8))


def _gated_block(d, gate, reduce: nn.Module, expand: nn.Module, add_type: str):
    """A residual block's body on `d <op> relu(gate)`, the residual `d`
    added by hand (ts_darknet.py:42-49).  NCHW."""
    body_in = d + F.relu(gate) if add_type == "add" else d * F.relu(gate)
    return d + expand(reduce(body_in))


class _GatedStart(nn.Module):
    """conv0 and Darknet-53's 64-, 128- and 256-channel groups with the
    gates g1 ... g3 on each group's first block (ts_darknet.py:33-66).
    NCHW; returns the stride-8 map (256 channels)."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv0 = ConvBNLeaky(3, 32, kernel=3, dtype=dtype)
        for g, (cin, c, n) in enumerate(_GATED_GROUPS, start=1):
            self.add_module(f"down{g}", ConvBNLeaky(cin, c, kernel=3, stride=2, dtype=dtype))
            self.add_module(f"g{g}_reduce", ConvBNLeaky(c, c // 2, kernel=1, dtype=dtype))
            self.add_module(f"g{g}_expand", ConvBNLeaky(c // 2, c, kernel=3, dtype=dtype))
            for j in range(2, n + 1):
                self.add_module(f"b{g}_{j}", DarknetBasicBlock(c // 2, dtype=dtype))

    def forward(self, x, g1, g2, g3, add_type: str):
        d = self.conv0(x)
        for g, (gate, (_, _, n)) in enumerate(zip((g1, g2, g3), _GATED_GROUPS), start=1):
            d = getattr(self, f"down{g}")(d)
            d = _gated_block(d, gate, getattr(self, f"g{g}_reduce"), getattr(self, f"g{g}_expand"), add_type)
            for j in range(2, n + 1):
                d = getattr(self, f"b{g}_{j}")(d)
        return d


class _GatedStage4(nn.Module):
    """Darknet-53's 512-channel group with the gate g4 on its first block
    (ts_darknet.py:69-85).  NCHW."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.down4 = ConvBNLeaky(256, 512, kernel=3, stride=2, dtype=dtype)
        self.g4_reduce = ConvBNLeaky(512, 256, kernel=1, dtype=dtype)
        self.g4_expand = ConvBNLeaky(256, 512, kernel=3, dtype=dtype)
        for j in range(2, 9):
            self.add_module(f"b4_{j}", DarknetBasicBlock(256, dtype=dtype))

    def forward(self, d, g4, add_type: str):
        d = _gated_block(self.down4(d), g4, self.g4_reduce, self.g4_expand, add_type)
        for j in range(2, 9):
            d = getattr(self, f"b4_{j}")(d)
        return d


class TwoStreamDarknet(nn.Module):
    """DarknetFlownet (ts_darknet.py:88-165): NHWC windows (B, t, H, W, 3)
    -> the three NHWC routes, darknet's channels then FlowNet's."""

    def __init__(self, stream: str = "flownet", t: int = 3, add_type: Optional[str] = None, quant=False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if stream == "r21d":
            raise NotImplementedError("the R(2+1)D motion stream (stream='r21d') comes with ROADMAP.md Queue 1 "
                                      "item 7's R(2+1)D half")
        if stream != "flownet":
            raise ValueError(f"stream must be 'flownet' or 'r21d', got {stream!r}")
        if add_type not in ADD_TYPES:
            raise ValueError(f"add_type must be one of {ADD_TYPES}, got {add_type!r}")
        if quant:
            raise NotImplementedError("the two-stream int8 model is deferred, see ROADMAP.md Queue 1 item 9a")
        if t < 2:
            raise ValueError(f"the two-stream backbone takes a window of t >= 2 frames, got {t}")
        self.t, self.add_type = t, add_type
        self.dtype = dtype or torch.float32
        self.route_channels = tuple(c + f for c, f in zip((256, 512, 1024), CONCAT_CHANNELS))
        self.flow_encoder = FlowNetSEncoder(3 * (t - 1), dtype=dtype)
        self.flow_decoder = _FlowDecoder(dtype=dtype)
        if add_type is None:
            self.conv0 = ConvBNLeaky(3, 32, kernel=3, dtype=dtype)
            for i, (cin, c, n) in enumerate(((32, 64, 1), (64, 128, 2), (128, 256, 8), (256, 512, 8)), start=1):
                self.add_module(f"stage{i}", DarknetStage(cin, c, n, dtype=dtype))
        else:
            self.gstart = _GatedStart(dtype=dtype)
            self.gstage4 = _GatedStage4(dtype=dtype)
        self.stage5 = DarknetStage(512, 1024, 4, dtype=dtype)

    def forward(self, x: torch.Tensor):
        if x.dim() != 5 or x.shape[1] != self.t:
            raise ValueError(f"TwoStreamDarknet takes windows (B, {self.t}, H, W, 3), got {tuple(x.shape)}")
        m = self.t // 2
        gates, feats = self.motion(stack_frames_on_channels(torch.cat([x[:, :m], x[:, m + 1:]], dim=1)))
        routes = self.appearance(x[:, m], gates)
        return tuple(torch.cat([d, f], dim=1).permute(0, 2, 3, 1) for d, f in zip(routes, feats))

    def motion(self, rest: torch.Tensor):
        """The FlowNet stream on the other frames stacked on channels (B, H,
        W, 3(t-1)): the gates (the encoder's c1 ... c4) and the route
        features (concat3, concat4, concat5), NCHW."""
        c1, c2, c3, c4, c5, c6 = self.flow_encoder(rest.permute(0, 3, 1, 2))
        return (c1, c2, c3, c4), self.flow_decoder(c2, c3, c4, c5, c6, flows=False)

    def appearance(self, mid: torch.Tensor, gates):
        """Darknet-53 on the middle frame (B, H, W, 3), gated by `gates`
        where `add_type` says: its stride-8, 16 and 32 maps, NCHW."""
        d = mid.to(self.dtype).permute(0, 3, 1, 2)
        if self.add_type is None:
            d1 = self.stage3(self.stage2(self.stage1(self.conv0(d))))
            d2 = self.stage4(d1)
        else:
            g1, g2, g3, g4 = gates
            d1 = self.gstart(d, g1, g2, g3, self.add_type)
            d2 = self.gstage4(d1, g4, self.add_type)
        return d1, d2, self.stage5(d2)
