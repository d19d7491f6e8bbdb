"""Primitive layers (port of videoyolo_tpu/models/layers.py:32-288, 437-544).

The cells take and return NCHW tensors; the models keep them in
`channels_last` memory, so NHWC is what lies in device memory, as in the JAX
package.  Submodules are named after the flax tree paths (`Conv_0`,
`BatchNorm_0`), which makes the weight bridge (utils/flax_bridge.py) a walk.

`dtype` mirrors flax's: the parameters are float32 (the masters that SGD
updates) and the conv casts its kernel to `dtype` and computes in it (bf16 on
the main path), while the BatchNorm parameters and statistics stay float32
and normalise the conv's output in its own dtype.  In train mode BatchNorm
normalises with the batch's statistics and updates the running ones as
flax does (`BatchNorm`).

The temporal layers (`time_distributed`, `TemporalPooling`, `Corr`) take
NHWC windows (B, T, H, W, C), as in the JAX package.

The fused-int8 path (`quant="fused"`, and its calibration twin
"fused_calib") keeps activations int8 from cell to cell as `QTensor`s; its
cells hold the buffers `qkernel` (int8), `wscale`, `bias`, `xscale` and
`oscale`, named like the flax leaves that ops/quantize.py produces.  The
convs go to ops/int8_conv.py (CUDA kernels on the card); the elementwise
joins (the stem's input quantize, `QuantResidual`, `quant_concat`, the int8
upsample) are torch ops in the JAX package's order of operations.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.correlation import correlation
from ..ops.int8_conv import dequant_leaky, int8_conv, quant_downsample, requantize

BN_EPS = 1e-5
# flax's momentum: the weight of the running average (torch's BatchNorm
# momentum is the new batch's weight, 1 - this)
BN_MOMENTUM = 0.9
LEAKY_SLOPE = 0.1
QUANT_MODES = ("fused", "fused_calib")
# the input rows above which the JAX package keeps a downsample off its
# Pallas kernel (a VMEM limit of the TPU, layers.py:157-159); mirrored so the
# outputs stay the JAX package's (lifting it: ROADMAP.md Queue 1 item 9d)
K3_MAX_ROWS = 208
# 1/127 in float32: XLA computes `amax / 127.0` as amax times this
_INV_127 = (torch.tensor(1.0) / torch.tensor(127.0)).item()
_DEFERRED = "is deferred, see ROADMAP.md Queue 1 item"


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=LEAKY_SLOPE)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor: each pixel repeated
    2x2 (keeps `channels_last` memory).  Integer tensors (int8 QTensor data,
    which `F.interpolate` does not take) repeat through a broadcast view of
    their NHWC memory, one copy."""
    if x.is_floating_point():
        return F.interpolate(x, scale_factor=2, mode="nearest")
    b, c, h, w = x.shape
    nhwc = x.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return nhwc.reshape(b, 2 * h, 2 * w, c).permute(0, 3, 1, 2)


class Conv2d(nn.Conv2d):
    """flax's `nn.Conv`: float32 parameters, cast to `dtype` at each call,
    and the conv computed in `dtype`.  `padding` is an int, or (left, right,
    top, bottom) for an asymmetric zero pad.

    Where no gradient is taken, the cast parameters are kept until the
    float32 ones change, so serving casts each kernel once."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 padding=0, bias: bool = False, dtype: torch.dtype | None = None):
        pad4 = tuple(padding) if isinstance(padding, (tuple, list)) else None
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=0 if pad4 else padding, bias=bias)
        self.pad4 = pad4
        self.dtype = dtype or torch.float32
        self._cast_cache = {}

    def _cast(self, name: str, p: torch.Tensor) -> torch.Tensor:
        if p.dtype == self.dtype:
            return p
        if torch.is_grad_enabled() and p.requires_grad:
            return p.to(self.dtype)
        key = (p.data_ptr(), p.device, p._version)
        hit = self._cast_cache.get(name)
        if hit is None or hit[0] != key:
            hit = self._cast_cache[name] = (key, p.detach().to(self.dtype))
        return hit[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad4:
            x = F.pad(x, self.pad4)
        bias = None if self.bias is None else self._cast("bias", self.bias)
        return F.conv2d(x, self._cast("weight", self.weight), bias, self.stride, self.padding)


class BatchNorm(nn.BatchNorm2d):
    """flax's `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` over dim 1.

    Eval normalises with the running statistics.  Train normalises with the
    batch's and updates the running ones as flax's `_compute_stats` does:
    float32 reductions whatever the input's dtype, the biased variance, and
    ra = 0.9 ra + 0.1 stat (torch's own update takes the unbiased
    variance).  The batch's mean and 1/sqrt(var + eps) come from the
    normalising kernel itself, so the statistics cost no pass of their own;
    flax computes var as E[x^2] - E[x]^2, the kernel as a mean of squared
    deviations, equal up to float32 rounding (held against flax's
    `batch_stats` in tests/test_torch_train.py).  `phases` > 1 pools the
    statistics of `phases` channel groups of `num_features` channels each
    (the space-to-depth stem: channel p * C + c is channel c).

    While `frozen` (the recompute of `remat`), train mode leaves the
    running statistics alone."""

    def __init__(self, num_features: int, phases: int = 1):
        super().__init__(num_features, eps=BN_EPS, momentum=1 - BN_MOMENTUM)
        self.phases = phases
        self.frozen = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.phases > 1:  # NHWC memory (B, H, W, P, C) as rows of C channels: a view
            b, _, h, w = x.shape
            x = x.permute(0, 2, 3, 1).reshape(-1, self.num_features)
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        else:
            # the native op, not F.batch_norm: it also takes a batch of one
            # value per channel (variance 0), as flax does
            y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            if not self.frozen:
                self._update_stats(mean, invstd)
        if self.phases > 1:
            y = y.reshape(b, h, w, -1).permute(0, 3, 1, 2)
        return y

    @torch.no_grad()
    def _update_stats(self, mean: torch.Tensor, invstd: torch.Tensor):
        # ra + 0.1 (stat - ra): flax's 0.9 ra + 0.1 stat in five launches
        # (a step runs 72 of these), equal up to float32 rounding
        var = invstd.pow(-2).sub_(self.eps).clamp_min_(0.0)
        self.running_mean.lerp_(mean, 1 - BN_MOMENTUM)
        self.running_var.lerp_(var, 1 - BN_MOMENTUM)


@contextmanager
def frozen_stats(module: nn.Module, frozen: bool = True):
    """Leave the running statistics of every `BatchNorm` in `module` alone
    inside the block."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [m.frozen for m in bns]
    for m in bns:
        m.frozen = frozen or m.frozen
    try:
        yield
    finally:
        for m, f in zip(bns, before):
            m.frozen = f


def remat(module: nn.Module, *args):
    """`module(*args)` rematerialised: its activations are recomputed in the
    backward pass instead of kept (`torch.utils.checkpoint`, the counterpart
    of flax's `nn.remat`).  jax's remat is pure, so the BN running statistics
    update once; here the recompute runs with them frozen."""
    calls = []

    def run(*a):
        with frozen_stats(module, bool(calls)):
            calls.append(1)
            return module(*a)

    return checkpoint(run, *args, use_reentrant=False)


class QTensor(NamedTuple):
    """An int8 activation between fused-int8 cells: `q` (int8, NCHW in
    `channels_last` memory) with its symmetric scale `s` (a float32 scalar
    tensor on q's device; value = q * s).  `host` is `s` as a Python float
    where the scale is a constant of the model (fused mode), else None."""

    q: torch.Tensor
    s: torch.Tensor
    host: Optional[float] = None


def dequantize(x, dtype=None):
    """QTensor -> real values (float32, or `dtype`); other inputs pass
    through."""
    if isinstance(x, QTensor):
        out = x.q.float() * x.s
        return out.to(dtype) if dtype is not None else out
    return x


def dynamic_scale(amax: torch.Tensor) -> torch.Tensor:
    """`jnp.maximum(amax / 127.0, 1e-12)` as the JAX package computes it."""
    return torch.clamp_min(amax * _INV_127, 1e-12)


class _QuantState(nn.Module):
    """Calibration record and host scale shared by the int8 cells."""

    def _sow(self, name: str, value: torch.Tensor):
        """Keep the running max of an observed amax (the JAX package sows it
        under "quant_calib" and takes the max over the batches)."""
        prev = self.calib.get(name)
        self.calib[name] = value if prev is None else torch.maximum(prev, value)

    def _host(self, scale: torch.Tensor) -> float:
        """`scale` as a Python float, read from the device once per value."""
        key = (scale.data_ptr(), scale._version)
        if getattr(self, "_host_cache", (None,))[0] != key:
            self._host_cache = (key, float(scale))
        return self._host_cache[1]


class ConvBNLeaky(_QuantState):
    """The conv-BN-LeakyReLU(0.1) cell: no conv bias; BN eps 1e-5.

    BN stays its own op in eval, as in the JAX package; folding it into the
    conv would change the bf16 rounding.

    `quant` "fused" / "fused_calib" builds the int8 cell instead (BN folded
    offline by ops/quantize.py; never initialised, always converted): a
    QTensor in (or, with `real_input`, a real-valued input quantised by
    `xscale`), a QTensor out requantised by `oscale` (or, without `qout`,
    real values in `dtype`).  `ds_conv="pallas"` sends the eligible 3x3 /
    stride-2 cells to K3, as the JAX package sends them to its Pallas
    kernel."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel: int = 3,
        stride: int = 1,
        dtype: torch.dtype | None = None,
        quant=None,
        qout: bool = True,
        ds_conv: str = "direct",
        real_input: bool = False,
        padding=None,
    ):
        super().__init__()
        self.kernel, self.stride, self.quant = kernel, stride, quant or None
        if self.quant is None:
            self.Conv_0 = Conv2d(
                in_channels, features, kernel, stride=stride,
                padding=kernel // 2 if padding is None else padding, dtype=dtype,
            )
            self.BatchNorm_0 = BatchNorm(features)
            return
        if self.quant not in QUANT_MODES:
            raise NotImplementedError(f"int8 mode {quant!r} (dynamic and static scales) {_DEFERRED} 9a")
        if ds_conv == "s2d":
            raise NotImplementedError(f"ds_conv='s2d' {_DEFERRED} 9b")
        if ds_conv not in ("direct", "pallas"):
            raise ValueError(f"ds_conv must be 'direct' or 'pallas', got {ds_conv!r}")
        self.qout, self.ds_conv, self.dtype = qout, ds_conv, dtype or torch.float32
        self.register_buffer("qkernel", torch.zeros((features, in_channels, kernel, kernel), dtype=torch.int8))
        self.register_buffer("wscale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        if self.quant == "fused_calib":
            self.calib = {}
            return
        if real_input:
            self.register_buffer("xscale", torch.ones(()))
        if qout:
            self.register_buffer("oscale", torch.ones(()))

    def forward(self, x):
        if self.quant is None:
            return leaky(self.BatchNorm_0(self.Conv_0(x)))
        if self._k3_eligible(x):
            out = quant_downsample(x.q, self.qkernel, x.s * self.wscale, self.bias, self.oscale)
            return QTensor(out, self.oscale, self._host(self.oscale))
        return quant_conv_cell(self, x)

    def _k3_eligible(self, x) -> bool:
        """The JAX package's rule (layers.py:149-160); H is dim 2 of NCHW."""
        return (
            self.ds_conv == "pallas" and self.quant == "fused" and self.kernel == 3
            and self.stride == 2 and isinstance(x, QTensor) and self.qout
            and x.q.shape[2] % 2 == 0 and x.q.shape[2] <= K3_MAX_ROWS
        )


def quant_conv_cell(cell: ConvBNLeaky, x):
    """The int8 cell body (layers.py:187-247): quantise a real-valued input,
    int8 conv with int32 sums, y = leaky(acc * (s_x * wscale) + bias), then
    requantise by `oscale` (fused) or by the batch's own max (fused_calib,
    which records the input amax of a real-valued input and the output
    amax)."""
    fused = cell.quant == "fused"
    if isinstance(x, QTensor):
        q, s_x = x.q, x.s
    else:
        xf = x.float()
        if fused:
            if not hasattr(cell, "xscale"):
                raise NotImplementedError(f"real-valued input to a fused cell without xscale (static scales) {_DEFERRED} 9a")
            s_x = cell.xscale
        else:
            amax = xf.abs().amax(dim=(1, 2, 3), keepdim=True)  # per image
            cell._sow("amax", amax.max())
            s_x = dynamic_scale(amax)
        q = requantize(xf / s_x)
    if fused:
        scale = s_x * cell.wscale
        if cell.qout:
            out = int8_conv(q, cell.qkernel, cell.stride, scale, cell.bias, cell.oscale)
            return QTensor(out, cell.oscale, cell._host(cell.oscale))
        return int8_conv(q, cell.qkernel, cell.stride, scale, cell.bias, out_dtype=cell.dtype)
    # calibration: the raw sums from the conv, the epilogue here (its scale
    # is per image at the stem)
    y = int8_conv(q, cell.qkernel, cell.stride)
    scale = s_x.reshape(-1, 1) * cell.wscale if s_x.dim() else s_x * cell.wscale
    out = dequant_leaky(y, scale, cell.bias)
    if not cell.qout:
        return out.to(cell.dtype)
    oamax = out.abs().amax()
    cell._sow("oamax", oamax)
    s_o = dynamic_scale(oamax)
    return QTensor(requantize(out / s_o), s_o)


class QuantResidual(_QuantState):
    """Residual join of the fused-int8 pipeline (layers.py:250-271): both
    int8 branches dequantised and added in float32, requantised by the
    calibrated `xscale` (or, with `calib`, by the sum's own max, recorded).

    The sum is `a.q * a.s + round(b.q * b.s)`, the first product fused into
    the add: the JAX package's order under jit, where XLA contracts it into
    an FMA (`torch.add` with `alpha` is one, on the CPU and the card)."""

    def __init__(self, calib: bool = False):
        super().__init__()
        if calib:
            self.calib = {}
        else:
            self.register_buffer("xscale", torch.ones(()))

    def forward(self, a: QTensor, b: QTensor) -> QTensor:
        alpha = a.host if a.host is not None else float(a.s)
        f = torch.add(b.q.float() * b.s, a.q.float(), alpha=alpha)
        if hasattr(self, "calib"):
            amax = f.abs().amax()
            self._sow("amax", amax)
            s = dynamic_scale(amax)
            return QTensor(requantize(f / s), s)
        return QTensor(requantize(f / self.xscale), self.xscale, self._host(self.xscale))


def quant_concat(parts, dim: int = 1):
    """Channel concat without leaving int8 (layers.py:274-288): each part
    rescaled onto the largest incoming scale, the ratio `p.s / s` first;
    parts that are not all QTensors concatenate as real values."""
    if not all(isinstance(p, QTensor) for p in parts):
        return torch.cat([dequantize(p) for p in parts], dim=dim)
    s = parts[0].s
    for p in parts[1:]:
        s = torch.maximum(s, p.s)
    qs = [requantize(p.q.float() * (p.s / s)) for p in parts]
    return QTensor(torch.cat(qs, dim=dim), s)


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init in place: conv kernels N(0, 1/fan_in) (flax's
    lecun scale), conv biases 0, BN at identity (scale 1, bias 0, mean 0,
    var 1).  Draws on the CPU from `generator`, so a seed gives the same
    weights on every device."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator) / fan_in**0.5
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return module


class TemporalPooling(nn.Module):
    """Max / mean pool over the time axis of (B, T, ...) (layers.py:437-467).

    Without `pool_size` the whole window collapses ('direct' style); with
    it, a window of `pool_size` steps slides by `strides` (default
    `pool_size`) over T padded by `padding` steps of -inf (max) or 0 (mean),
    and the mean divides by the window, padding included, as
    `jax.lax.reduce_window` does."""

    def __init__(
        self, type: Optional[str] = "max", pool_size: Optional[int] = None,
        strides: Optional[int] = None, padding: int = 0,
    ):
        super().__init__()
        if type not in ("max", "mean"):
            raise ValueError(f"TemporalPooling type must be 'max' or 'mean', got {type!r}")
        self.type = type
        self.pool_size = pool_size
        self.strides = strides
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool_size is None:
            return x.amax(dim=1) if self.type == "max" else x.mean(dim=1)
        window = self.pool_size
        if self.padding:
            fill = -torch.inf if self.type == "max" else 0.0
            pad = x.new_full((x.shape[0], self.padding) + x.shape[2:], fill)
            x = torch.cat([pad, x, pad], dim=1)
        # (B, T', ..., window): the windows along a new last axis
        windows = x.unfold(1, window, self.strides or window)
        if self.type == "max":
            return windows.amax(dim=-1)
        return windows.sum(dim=-1) / window


def time_distributed(module_call: Callable, x: torch.Tensor, *args, **kwargs):
    """Apply `module_call` over every timestep of (B, T, ...) by folding the
    time axis into the batch (layers.py:470-487).  Returns outputs with (B,
    T, ...) leading dims (tuple and list outputs element-wise)."""
    b, t = x.shape[0], x.shape[1]
    out = module_call(x.reshape((b * t,) + x.shape[2:]), *args, **kwargs)

    def unfold(y):
        return y.reshape((b, t) + y.shape[1:])

    if isinstance(out, (tuple, list)):
        return type(out)(unfold(o) for o in out)
    return unfold(out)


class Corr(nn.Module):
    """Correlation block over t timesteps against the middle frame
    (layers.py:490-544).  Input (B, T, H, W, C); computed in float32.

    keep='all'  -> (B, H, W, T*C + n*D): time folded into channels (channel
                   t*C + c), then one cost volume per compared timestep;
    keep='mid'  -> (B, H, W, C + n*D): the middle frame only;
    keep='none' -> (B, n, H, W, D): the stacked cost volumes.
    `comp_mid` also compares the middle frame with itself.  Each frame goes
    to `correlation` as a slice of the window (its batch stride is the
    window's), so the CUDA kernel reads it in place."""

    def __init__(
        self, d: int, t: int, kernel_size: int = 1, stride: int = 1, keep: str = "all",
        comp_mid: bool = False,
    ):
        super().__init__()
        if keep not in ("all", "mid", "none"):
            raise ValueError(f"Corr keep must be 'all', 'mid' or 'none', got {keep!r}")
        self.d = d
        self.t = t
        self.kernel_size = kernel_size
        self.stride = stride
        self.keep = keep
        self.comp_mid = comp_mid

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        if t != self.t:
            raise ValueError(f"Corr over t={self.t} frames got a window of {t}")
        mid = t // 2
        x32 = x.float()
        corrs = [
            correlation(
                x32[:, i], x32[:, mid], self.d, kernel_size=self.kernel_size,
                stride1=self.stride, stride2=self.stride,
            )
            for i in range(t)
            if self.comp_mid or i != mid
        ]
        if self.keep == "none":
            return torch.stack(corrs, dim=1)
        if self.keep == "all":
            base = x32.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)
        else:
            base = x32[:, mid]
        return torch.cat([base] + corrs, dim=-1)
