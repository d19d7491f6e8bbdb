"""FlowNetS / FlowNetC optical-flow networks (port of
videoyolo_tpu/models/flownet.py:1-199).

Encoder-decoder flow estimation without batch norm, LeakyReLU(0.1) after
every conv but the flow predictions, and a `return_features` mode giving
the decoder's concat3/4/5 skips (strides 8, 16, 32) to the two-stream
detector (models/ts_darknet.py).  Inputs and outputs are NHWC, as in the
JAX package; the cells run on NCHW views of them (`channels_last` memory).
Submodules carry the flax names (`encoder`/`decoder` scopes, `conv1` ...
`conv6_1`, `predict_flow{2..6}`, `deconv{2..5}`, `upsampled_flow*`), so
the weight bridge walks the JAX package's tree; the decoder's transposed
convs are `layers.ConvTranspose2d`, whose weights the bridge flips.

FlowNetC's cost volume (flownet.py:171-182) is `ops/correlation.
correlation` at d=20, kernel_size 1, stride2 2 (441 displacement channels)
on the two frames' stride-8, 256-channel features cast to
`layers.CORR_DTYPE`: K2 on the card, `correlation_plain` on the CPU.  Its
siamese convs share their weights across the two frames, which run as one
batch of 2B.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.correlation import correlation
from . import layers
from .layers import Conv2d, ConvTranspose2d, leaky

__all__ = ["FlowNetC", "FlowNetS", "FlowNetSEncoder", "check_input_size", "stack_frames_on_channels"]

# FlowNetC's cost volume (flownet.py:171-182)
CORR_D, CORR_STRIDE2 = 20, 2
# the decoder's concat3/4/5 channels: the encoder's skip, the deconv's, the flow
CONCAT_CHANNELS = (256 + 128 + 2, 512 + 256 + 2, 512 + 512 + 2)
_ENCODER_TAPS = ("conv1", "conv2", "conv3_1", "conv4_1", "conv5_1", "conv6_1")


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, dtype=None) -> Conv2d:
    """flax's `nn.Conv` with its bias, zero-padded by kernel // 2."""
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=True, dtype=dtype)


def _run(cell: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A cell on its input cast to the cell's dtype, as flax's convs cast."""
    return cell(x.to(cell.dtype))


def stack_frames_on_channels(x: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W, C) -> (B, H, W, K*C), frame k's channels at k*C
    (flownet.py:109-114)."""
    b, k, h, w, c = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b, h, w, k * c)


def check_input_size(h: int, w: int) -> None:
    """Raise ValueError unless H and W are multiples of 64: the decoder's
    skip concats line up only when every stride-2 step halves exactly (the
    JAX encoder's assertion and message, flownet.py:88-95)."""
    if h % 64 or w % 64:
        raise ValueError(f"FlowNetS needs input H/W divisible by 64, got {(h, w)} "
                         "(use e.g. data_shape 384 or 448 with the flownet stream)")


class FlowNetSEncoder(nn.Module):
    """The FlowNetS encoder (flownet.py:80-106): NCHW frames stacked on
    channels -> every scale (c1 ... c6, NCHW, strides 2 ... 64).  The
    two-stream detector gates Darknet-53 with c1 ... c4."""

    def __init__(self, in_channels: int = 6, dtype: Optional[torch.dtype] = None):
        super().__init__()
        specs = [("conv1", in_channels, 64, 7, 2), ("conv2", 64, 128, 5, 2), ("conv3", 128, 256, 5, 2),
                 ("conv3_1", 256, 256, 3, 1), ("conv4", 256, 512, 3, 2), ("conv4_1", 512, 512, 3, 1),
                 ("conv5", 512, 512, 3, 2), ("conv5_1", 512, 512, 3, 1), ("conv6", 512, 1024, 3, 2),
                 ("conv6_1", 1024, 1024, 3, 1)]
        for name, cin, cout, k, s in specs:
            self.add_module(name, _conv(cin, cout, k, s, dtype))

    def forward(self, x: torch.Tensor):
        check_input_size(*x.shape[-2:])
        taps, y = [], x
        for name, cell in self.named_children():
            y = leaky(_run(cell, y))
            if name in _ENCODER_TAPS:
                taps.append(y)
        return tuple(taps)


class _FlowDecoder(nn.Module):
    """The refinement decoder (flownet.py:48-77): a flow predicted at each
    scale, flow and features upsampled and concatenated with the encoder's
    skip.  NCHW in and out: (flow2 ... flow6, concat3, concat4, concat5)."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        c3, c4, c5 = CONCAT_CHANNELS
        self.predict_flow6 = _conv(1024, 2, 3, dtype=dtype)
        self.upsampled_flow6_to_5 = ConvTranspose2d(2, 2, bias=False, dtype=dtype)
        self.deconv5 = ConvTranspose2d(1024, 512, dtype=dtype)
        self.predict_flow5 = _conv(c5, 2, 3, dtype=dtype)
        self.upsampled_flow5_to_4 = ConvTranspose2d(2, 2, bias=False, dtype=dtype)
        self.deconv4 = ConvTranspose2d(c5, 256, dtype=dtype)
        self.predict_flow4 = _conv(c4, 2, 3, dtype=dtype)
        self.upsampled_flow4_to_3 = ConvTranspose2d(2, 2, bias=False, dtype=dtype)
        self.deconv3 = ConvTranspose2d(c4, 128, dtype=dtype)
        self.predict_flow3 = _conv(c3, 2, 3, dtype=dtype)
        self.upsampled_flow3_to_2 = ConvTranspose2d(2, 2, bias=False, dtype=dtype)
        self.deconv2 = ConvTranspose2d(c3, 64, dtype=dtype)
        self.predict_flow2 = _conv(128 + 64 + 2, 2, 3, dtype=dtype)

    def forward(self, c2, c3, c4, c5, c6, flows: bool = True):
        """With `flows=False` (the two-stream backbone, which takes the
        concats alone) the decoder stops at concat3 and returns (concat3,
        concat4, concat5): its finer levels reach none of them, and XLA
        drops them from the JAX package's graph alike."""
        preds, concats, y = [], [], c6
        for level, skip in zip((6, 5, 4, 3), (c5, c4, c3, c2)):
            if not flows and level == 3:
                return concats[::-1]
            flow = _run(getattr(self, f"predict_flow{level}"), y)
            flow_up = _run(getattr(self, f"upsampled_flow{level}_to_{level - 1}"), flow)
            deconv = leaky(_run(getattr(self, f"deconv{level - 1}"), y))
            y = torch.cat([skip, deconv, flow_up], dim=1)
            preds.append(flow)
            concats.append(y)
        preds.append(_run(self.predict_flow2, y))
        flow6, flow5, flow4, flow3, flow2 = preds
        concat5, concat4, concat3, _ = concats
        return flow2, flow3, flow4, flow5, flow6, concat3, concat4, concat5


def _outputs(decoded, return_features: bool, training: bool):
    """The decoder's NCHW outputs -> NHWC: the concat3/4/5 features, the
    train pyramid (flow2 ... flow6) or the eval flow2."""
    flow2, flow3, flow4, flow5, flow6, cat3, cat4, cat5 = (t.permute(0, 2, 3, 1) for t in decoded)
    if return_features:
        return cat3, cat4, cat5
    if training:
        return flow2, flow3, flow4, flow5, flow6
    return flow2


class FlowNetS(nn.Module):
    """FlowNet-Simple (flownet.py:117-142): the pair stacked on channels.

    Input (B, 2, H, W, 3) or (B, H, W, 6) NHWC, H and W multiples of 64.
    `return_features` gives (concat3, concat4, concat5) at strides 8 / 16 /
    32; train mode the flow pyramid (flow2 ... flow6, strides 4 ... 64);
    eval mode flow2 (B, H/4, W/4, 2)."""

    def __init__(self, return_features: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.return_features = return_features
        self.encoder = FlowNetSEncoder(6, dtype=dtype)
        self.decoder = _FlowDecoder(dtype=dtype)

    def forward(self, x: torch.Tensor):
        if x.dim() == 5:
            x = stack_frames_on_channels(x)
        c1, c2, c3, c4, c5, c6 = self.encoder(x.permute(0, 3, 1, 2))
        return _outputs(self.decoder(c2, c3, c4, c5, c6), self.return_features, self.training)


class FlowNetC(nn.Module):
    """FlowNet-Correlation (flownet.py:145-199): a siamese encoder to
    stride 8, the cost volume of frame 0 against frame 1 (d=20, stride2=2:
    441 channels, leaky) beside `conv_redir` of frame 0 (32 channels), then
    FlowNetS's deeper encoder and decoder.

    Input (B, 2, H, W, 3) NHWC, H and W multiples of 64 (not checked by the
    JAX model: other sizes fail in its decoder's concat); outputs as
    `FlowNetS`'s."""

    def __init__(self, return_features: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.return_features = return_features
        n_corr = (2 * (CORR_D // CORR_STRIDE2) + 1) ** 2
        specs = [("conv1", 3, 64, 7, 2), ("conv2", 64, 128, 5, 2), ("conv3", 128, 256, 5, 2),
                 ("conv_redir", 256, 32, 1, 1), ("conv3_1", 32 + n_corr, 256, 3, 1), ("conv4", 256, 512, 3, 2),
                 ("conv4_1", 512, 512, 3, 1), ("conv5", 512, 512, 3, 2), ("conv5_1", 512, 512, 3, 1),
                 ("conv6", 512, 1024, 3, 2), ("conv6_1", 1024, 1024, 3, 1)]
        for name, cin, cout, k, s in specs:
            self.add_module(name, _conv(cin, cout, k, s, dtype))
        self.decoder = _FlowDecoder(dtype=dtype)

    def forward(self, x: torch.Tensor):
        if x.dim() != 5 or x.shape[1] != 2:
            raise ValueError(f"FlowNetC takes pairs (B, 2, H, W, 3), got {tuple(x.shape)}")
        b = x.shape[0]
        # the siamese convs on both frames as one batch: frame 0's, then frame 1's
        y = x.transpose(0, 1).flatten(0, 1).permute(0, 3, 1, 2)
        c2 = leaky(_run(self.conv2, leaky(_run(self.conv1, y))))
        y = leaky(_run(self.conv3, c2))
        c3 = y.permute(0, 2, 3, 1).to(layers.CORR_DTYPE).contiguous()
        corr = leaky(correlation(c3[:b], c3[b:], max_displacement=CORR_D, kernel_size=1, stride1=1,
                                 stride2=CORR_STRIDE2))
        redir = leaky(_run(self.conv_redir, y[:b]))
        dt = torch.promote_types(redir.dtype, corr.dtype)  # bf16 beside float32: float32, as JAX promotes
        c3 = torch.cat([redir.to(dt), corr.permute(0, 3, 1, 2).to(dt)], dim=1)
        c3 = leaky(_run(self.conv3_1, c3))
        c4 = leaky(_run(self.conv4_1, leaky(_run(self.conv4, c3))))
        c5 = leaky(_run(self.conv5_1, leaky(_run(self.conv5, c4))))
        c6 = leaky(_run(self.conv6_1, leaky(_run(self.conv6, c5))))
        return _outputs(self.decoder(c2[:b], c3, c4, c5, c6), self.return_features, self.training)
