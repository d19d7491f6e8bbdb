"""Primitive layers (port of videoyolo_tpu/models/layers.py:32-636).

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

The temporal layers (`time_distributed`, `TemporalPooling`, `Corr`,
`ConvBNLeaky3D`, `Conv21D`, `Conv1DTemporal`, `temporal_pad`, `ConvRNN`)
take NHWC windows (B, T, H, W, C), as in the JAX package; the conv-RNN's
cells (`ConvGRUCell`, `ConvLSTMCell`) take NCHW frames.

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
from functools import partial
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.correlation import CostVolumePair, correlation
from ..ops.int8_conv import dequant_leaky, int8_conv, quant_downsample, requantize
from ..parallel import multihost

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
# the cost volumes' dtype whatever the model's: `Corr` casts its window to
# it, as the JAX package's Corr casts to float32 (layers.py:517)
CORR_DTYPE = torch.float32
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


class ConvTranspose2d(nn.ConvTranspose2d):
    """flax's `nn.ConvTranspose((4, 4), strides=2, padding="SAME")` as
    FlowNet's decoder builds it: output 2H x 2W, float32 parameters cast
    to `dtype` at each call, NCHW in and out.  The weight is torch's (in,
    out, kh, kw), which applies the kernel spatially flipped: flax's
    kernel (kh, kw, in, out) is not flipped (`transpose_kernel=False`), so
    the weight is that kernel reversed in kh and kw (utils/flax_bridge.py
    flips it both ways)."""

    _cast = Conv2d._cast

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True, dtype: torch.dtype | None = None):
        super().__init__(in_channels, out_channels, 4, stride=2, padding=1, bias=bias)
        self.dtype = dtype or torch.float32
        self._cast_cache = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self._cast("bias", self.bias)
        return F.conv_transpose2d(x, self._cast("weight", self.weight), bias, self.stride, self.padding)


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of every process of the
    group: flax's statistics under the JAX package's batch-sharded step
    (videoyolo_tpu/parallel/mesh.py:1-17).

    Forward: each channel's sum of x, sum of x^2 and count, one packed
    all-reduce, then mean = sum/n and var = sum of squares/n - mean^2,
    clamped at 0 (flax's `E[x^2] - E[x]^2`: the biased variance).  The sums
    are made in float64 from each process's centred statistics (float32, or
    the input's wider float): in float32, E[x^2] - E[x]^2 loses the variance
    of a channel whose mean is large beside its spread, and train-mode BN
    amplifies that into the update; float64 also keeps the count of a
    416-px stem (past 2^24) exact.  Backward: the sums of dy and dy * xhat
    in one packed all-reduce; dx = w * invstd * (dy - sum dy/n - xhat *
    sum(dy xhat)/n), the gradient of the sum of the processes' losses.  The
    BN weight's and bias's gradients stay local: the step's gradient
    average over the processes completes them.  x is 2-D (rows of channels)
    or N, C, ...; returns (y, mean, var), the statistics for the running
    averages."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        dt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dt)
        c = x.shape[1]
        var_l, mean_l = (t.double() for t in torch.var_mean(xf, dims, correction=0))
        n_l = x.numel() // c
        packed = torch.cat([mean_l * n_l, (var_l + mean_l.square()) * n_l, mean_l.new_full((1,), n_l)])
        dist.all_reduce(packed)
        n = packed[-1:]  # on the device: reading it on the host would wait for the card
        mean = packed[:c] / n
        var = (packed[c:2 * c] / n - mean.square()).clamp_min_(0.0)
        mean, var = mean.to(dt), var.to(dt)
        invstd = torch.rsqrt(var + eps)
        y = (xf - mean.view(shape)) * (invstd * weight.to(dt)).view(shape) + bias.to(dt).view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        dt = mean.dtype
        c = x.shape[1]
        dyf = dy.to(dt)
        xhat = (x.to(dt) - mean.view(shape)) * invstd.view(shape)
        sums = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
        dbias, dweight = sums[:c].clone(), sums[c:].clone()
        dist.all_reduce(sums)
        sums = sums / n.to(dt)
        dx = (dyf - sums[:c].view(shape) - xhat * sums[c:].view(shape)) \
            * (invstd * weight.to(dt)).view(shape)
        return dx.to(x.dtype), dweight.to(weight.dtype), dbias.to(weight.dtype), None


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

    In a data-parallel job of several processes (`multihost.process_count`
    > 1), train mode takes the statistics of the global batch
    (`GlobalBatchNorm`), as the JAX package's step always does;
    `torch.nn.SyncBatchNorm` would keep the unbiased variance in its
    running statistics.

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
        elif multihost.process_count() > 1:
            y, mean, var = GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
            if not self.frozen:
                self._lerp_stats(mean, var)
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
        self._lerp_stats(mean, var)

    @torch.no_grad()
    def _lerp_stats(self, mean: torch.Tensor, var: torch.Tensor):
        self.running_mean.lerp_(mean.to(self.running_mean.dtype), 1 - BN_MOMENTUM)
        self.running_var.lerp_(var.to(self.running_var.dtype), 1 - BN_MOMENTUM)


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


class Conv3d(nn.Conv3d):
    """flax's 3-D `nn.Conv`, as `Conv2d` is its 2-D one: float32 kernel
    (O, I, kt, kh, kw), cast to `dtype` at each call, no bias; NCDHW in and
    out (an NDHWC window seen through a permute: `channels_last_3d`
    memory)."""

    _cast = Conv2d._cast

    def __init__(self, in_channels: int, out_channels: int, kernel, stride, padding,
                 dtype: torch.dtype | None = None, groups: int = 1):
        super().__init__(in_channels, out_channels, tuple(kernel), stride=tuple(stride), padding=tuple(padding),
                         bias=False, groups=groups)
        self.dtype = dtype or torch.float32
        self._cast_cache = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self._cast("weight", self.weight), None, self.stride, self.padding, 1, self.groups)

    def _apply(self, fn, recurse=True):
        # `Module.to(memory_format=torch.channels_last)`, which the entry
        # points call on whole models, raises on a 5-D tensor: the kernel
        # then takes the conversion's device and dtype, read off a 4-D
        # probe, in channels_last_3d memory
        def convert(t):
            try:
                return fn(t)
            except RuntimeError as e:
                if t.dim() != 5 or "channels_last" not in str(e):
                    raise
                probe = fn(t.new_empty((1, 1, 1, 1)))
                return t.to(probe.device, probe.dtype, memory_format=torch.channels_last_3d)

        return super()._apply(convert, recurse)


class ConvBNLeaky3D(nn.Module):
    """The 3-D conv-BN-LeakyReLU(0.1) cell over NHWC windows (B, T, H, W, C)
    (layers.py:291-335): a (kt, kh, kw) conv of `stride`, zero-padded by
    `padding` (default k//2 on each axis) on both sides of each axis, no
    bias; BatchNorm over the channels (train mode: the statistics of every
    frame and pixel of the batch, as flax's); leaky.  Returns (B, T', H',
    W', features).  Float only: the int8 3-D cells raise."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3, 3), stride=(1, 1, 1), padding=None,
                 dtype: torch.dtype | None = None, quant=None):
        super().__init__()
        if quant:
            raise NotImplementedError(f"the int8 3-D cells (quant={quant!r}) {_DEFERRED} 9a")
        if padding is None:
            padding = tuple(k // 2 for k in kernel)
        self.dtype = dtype or torch.float32
        self.Conv_0 = Conv3d(in_channels, features, kernel, stride, padding, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = leaky(self.BatchNorm_0(self.Conv_0(x.to(self.dtype).permute(0, 4, 1, 2, 3))))
        return y.permute(0, 2, 3, 4, 1)


class Conv21D(nn.Module):
    """The R(2+1)D factored cell (layers.py:369-401): a (1, k, k) cell of
    spatial stride `stride` and padding (0, p, p) to `mid` channels (default
    `features`), then a (k, 1, 1) cell of temporal stride `stride` and
    padding (p, 0, 0); each a `ConvBNLeaky3D` (`ConvBNLeaky3D_0`, `_1`).
    NHWC windows in and out."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, mid: Optional[int] = None,
                 padding: int = 1, stride: int = 1, dtype: torch.dtype | None = None, quant=None):
        super().__init__()
        m = features if mid is None else mid
        self.ConvBNLeaky3D_0 = ConvBNLeaky3D(in_channels, m, kernel=(1, kernel, kernel), stride=(1, stride, stride),
                                             padding=(0, padding, padding), dtype=dtype, quant=quant)
        self.ConvBNLeaky3D_1 = ConvBNLeaky3D(m, features, kernel=(kernel, 1, 1), stride=(stride, 1, 1),
                                             padding=(padding, 0, 0), dtype=dtype, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvBNLeaky3D_1(self.ConvBNLeaky3D_0(x))


def temporal_pad(x: torch.Tensor, padding: int = 1, zeros: bool = True) -> torch.Tensor:
    """(B, T, ...) padded along T by `padding` steps on each side: zeros, or
    copies of the first and last step (layers.py:71-81)."""
    first, last = x[:, :1], x[:, -1:]
    if zeros:
        first, last = torch.zeros_like(first), torch.zeros_like(last)
    reps = (1, padding) + (1,) * (x.dim() - 2)
    return torch.cat([first.repeat(reps), x, last.repeat(reps)], dim=1)


class Conv1DTemporal(nn.Module):
    """The depthwise temporal cell (layers.py:404-434): a (k, 1, 1) conv of
    `features` groups (one channel each) over NHWC windows (B, T, H, W, C =
    features), temporal stride and zero padding, no bias, zero kernel at
    init (`init_weights` leaves it at zero); BatchNorm; leaky."""

    def __init__(self, features: int, kernel: int = 3, padding: int = 0, stride: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.Conv_0 = Conv3d(features, features, (kernel, 1, 1), (stride, 1, 1), (padding, 0, 0), dtype=dtype,
                             groups=features)
        nn.init.zeros_(self.Conv_0.weight)
        self.Conv_0.zero_init = True
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = leaky(self.BatchNorm_0(self.Conv_0(x.to(self.dtype).permute(0, 4, 1, 2, 3))))
        return y.permute(0, 2, 3, 4, 1)


def _square_padding(kernel) -> int | tuple:
    """flax's k//2 padding of a (kh, kw) kernel as `Conv2d` takes it."""
    kh, kw = kernel
    return kh // 2 if kh == kw else (kw // 2, kw // 2, kh // 2, kh // 2)


class ConvGRUCell(nn.Module):
    """The conv-GRU cell (layers.py:547-573): biased convs `i2h` (input) and
    `h2h` (carry) to 3 x `channels`, split into the r, z, n gates:

      r = sigmoid(i_r + h_r);  z = sigmoid(i_z + h_z)
      n = tanh(i_n + r * h_n); h' = (1 - z) * n + z * h

    NCHW.  The convs compute in `dtype` from float32 parameters and the gate
    arithmetic stays in the convs' dtype, as flax's.  `step` takes the
    input's conv `xi` already made (`ConvRNN` makes it for every frame in
    one conv); on the `first` step the carry is zero and its conv is the
    bias alone."""

    n_gates = 3

    def __init__(self, in_channels: int, channels: int, kernel=(3, 3), dtype: torch.dtype | None = None):
        super().__init__()
        self.channels, self.dtype = channels, dtype or torch.float32
        pad = _square_padding(kernel)
        self.i2h = Conv2d(in_channels, self.n_gates * channels, tuple(kernel), padding=pad, bias=True, dtype=dtype)
        self.h2h = Conv2d(channels, self.n_gates * channels, tuple(kernel), padding=pad, bias=True, dtype=dtype)

    def zero_carry(self, x: torch.Tensor):
        """The zero carry of a frame batch `x` (B, C, H, W), in x's dtype."""
        b, _, h, w = x.shape
        return torch.zeros((b, self.channels, h, w), dtype=x.dtype, device=x.device).to(
            memory_format=torch.channels_last)

    def _h2h(self, h: torch.Tensor, like: torch.Tensor, first: bool) -> torch.Tensor:
        if first:
            return self.h2h._cast("bias", self.h2h.bias).view(1, -1, 1, 1).expand_as(like)
        return self.h2h(h.to(self.dtype))

    def step(self, carry, xi: torch.Tensor, first: bool = False):
        h = carry[0] if isinstance(carry, tuple) else carry
        return self.gates(xi, self._h2h(h, xi, first), carry)

    def gates(self, xi: torch.Tensor, hh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """The step's gate arithmetic from the convs of the input (`xi`) and
        of the carry (`hh`)."""
        ir, iz, i_n = xi.chunk(3, dim=1)
        hr, hz, h_n = hh.chunk(3, dim=1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h

    def forward(self, carry, x: torch.Tensor):
        """One step on a frame batch `x` (B, C, H, W) from `carry`."""
        return self.step(carry, self.i2h(x.to(self.dtype)))


class ConvLSTMCell(ConvGRUCell):
    """The conv-LSTM cell (layers.py:576-601): gates = i2h(x) + h2h(h) to 4 x
    `channels`, split into i, f, o, g; c' = f * c + i * g, h' = o *
    tanh(c').  The carry is (h, c)."""

    n_gates = 4

    def zero_carry(self, x: torch.Tensor):
        z = super().zero_carry(x)
        return z, z

    def gates(self, xi: torch.Tensor, hh: torch.Tensor, carry):
        _, c = carry
        i, f, o, g = (xi + hh).chunk(4, dim=1)
        i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), torch.tanh(g)
        c_new = f * c + i * g
        return o * torch.tanh(c_new), c_new


class ConvRNN(nn.Module):
    """k-step conv-GRU or conv-LSTM over NHWC windows (B, T, H, W, C) ->
    (B, T, H, W, `channels`) (layers.py:604-636): the carry starts at zeros
    in the input's dtype and each step's output is its h; with `bi`, a
    second cell (`bwd`) runs over the reversed window and the two
    directions average, (out + out_b) / 2.  The input convs of every frame
    run as one conv over the frames folded into the batch; the carry's conv
    runs once a step after the first."""

    def __init__(self, in_channels: int, channels: int, kernel=(3, 3), type: str = "gru", bi: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if type not in ("gru", "lstm"):
            raise ValueError(f"ConvRNN type must be 'gru' or 'lstm', got {type!r}")
        cell = ConvGRUCell if type == "gru" else ConvLSTMCell
        self.fwd = cell(in_channels, channels, kernel, dtype=dtype)
        self.bwd = cell(in_channels, channels, kernel, dtype=dtype) if bi else None

    def _run(self, cell: ConvGRUCell, x: torch.Tensor, reverse: bool) -> torch.Tensor:
        t = x.shape[1]
        xi = _nchw_frames(cell.i2h, x.to(cell.dtype))  # (B, T, G*C, H, W)
        carry = cell.zero_carry(x[:, 0].permute(0, 3, 1, 2))
        outs = [None] * t
        for n, i in enumerate(range(t - 1, -1, -1) if reverse else range(t)):
            carry = cell.step(carry, xi[:, i], first=n == 0)
            outs[i] = (carry[0] if isinstance(carry, tuple) else carry).permute(0, 2, 3, 1)
        return torch.stack(outs, dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self._run(self.fwd, x, reverse=False)
        if self.bwd is not None:
            out = self.average(out, self._run(self.bwd, x, reverse=True))
        return out

    @staticmethod
    def average(out: torch.Tensor, out_b: torch.Tensor) -> torch.Tensor:
        """The two directions' mean, in their dtype."""
        return (out + out_b) / 2.0


def _nchw_frames(module: Callable, x: torch.Tensor) -> torch.Tensor:
    """An NCHW module on every frame of an NHWC window (B, T, H, W, C) ->
    (B, T, C', H', W'), the frames folded into the batch."""
    b, t = x.shape[:2]
    y = module(x.flatten(0, 1).permute(0, 3, 1, 2))
    return y.reshape((b, t) + y.shape[1:])


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init in place: conv kernels N(0, 1/fan_in) (flax's
    lecun scale; a transposed conv's fan-in is its input channels times
    its taps), conv biases 0, BN at identity (scale 1, bias 0, mean 0,
    var 1).  Draws on the CPU from `generator`, so a seed gives the same
    weights on every device."""
    with torch.no_grad():
        for m in module.modules():
            if getattr(m, "zero_init", False):
                m.weight.zero_()
            elif isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear, nn.ConvTranspose2d)):
                fan_in = m.weight[0].numel()
                if isinstance(m, nn.ConvTranspose2d):
                    fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
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


def nhwc(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """An NCHW module or function on an NHWC tensor, per frame when 5-D."""
    if x.dim() == 5:
        return time_distributed(partial(nhwc, fn), x)
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


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
    `comp_mid` also compares the middle frame with itself: f1 and f2 are
    then views of one frame, the adjoint returns a gradient for each, and
    autograd adds them.  Each frame goes to `correlation` as a slice of the
    window (its batch stride is the window's), so the CUDA kernel reads it
    in place; on CUDA, t=3 without `comp_mid` (kernel_size 1, stride 1)
    goes to `CostVolumePair`, whose backward is one adjoint launch that
    writes the window's gradient, and every other comparison to
    `correlation` (K2 a volume, then for kernel_size > 1 the patch sum).  In
    train mode the gradient reaches each frame through its own channels and
    through the comparisons it takes part in (the middle frame through all
    of them), and returns to the window's dtype through the cast's
    backward."""

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
        x32 = x.to(CORR_DTYPE)
        if x32.device.type == "cuda" and t == 3 and not self.comp_mid and self.kernel_size == 1 and self.stride == 1:
            # K2 twice, and one adjoint launch for both volumes
            corrs = list(CostVolumePair.apply(x32, self.d, self.stride))
        else:
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
