"""int8 convolutions of the fused-int8 pipeline (port of
videoyolo_tpu/ops/pallas_conv.py:pallas_quant_downsample and of the int8 conv
in videoyolo_tpu/models/layers.py:quant_conv_cell).

`quant_downsample_plain` and `int8_conv_plain` are the plain PyTorch
versions.  The conv is exact: float64 sums of int8 products cast to int32
(|sum| <= 127^2 * 9 * 1024 < 2^53; float32 would not be, above 2^24).  The
epilogue follows the JAX package under jit, where XLA contracts `acc * scale
+ bias` into one fused multiply-add: it is computed in float64, where the
float32 product is exact, and rounded once to float32.

`quant_downsample` and `int8_conv` dispatch as the other ops of the port do:
a CUDA tensor goes to the CUDA kernel (`int8_conv_kernel`), a CPU tensor to
the plain version.

`int8_conv3d` is the 3-D int8 cell's conv (layers.py:355-363 of the JAX
package, XLA's int8 conv3d there): on the card it folds the kt time taps
into channels (output frame t' stacks its kt input frames, zero frames in
the time padding, on kt*C channels; the kernel reshaped to (F, kt*C, k, k))
and makes one launch of the int8 conv kernel over the B*T' frames.  The
int32 sums are exact whichever order adds them, so it equals the plain
version, a float64 conv3d, bit for bit.

Layouts: int8 activations (B, C, H, W), kernels (F, C, k, k), as the models
keep them (NHWC / OHWI in `channels_last` memory); pad k // 2.  The 3-D
conv takes NDHWC windows (B, T, H, W, C) and kernels (F, C, kt, k, k).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from . import int8_conv_kernel

LEAKY_SLOPE = 0.1


def requantize(y: torch.Tensor) -> torch.Tensor:
    """round (half to even), clip to +-127, int8."""
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as an FMA: the product of two float32
    values is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def int8_conv_exact(q: torch.Tensor, qkernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """int8 conv, pad k // 2, exact int32 sums (B, F, Ho, Wo)."""
    k = qkernel.shape[-1]
    return F.conv2d(q.double(), qkernel.double(), stride=stride, padding=k // 2).to(torch.int32)


def _channels(v: torch.Tensor) -> torch.Tensor:
    """(F,) or (B, F) -> broadcastable over (B, F, H, W)."""
    return v.reshape(v.shape + (1, 1)) if v.dim() == 2 else v.reshape(1, -1, 1, 1)


def dequant_leaky(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """leaky(acc * scale + bias) in float32 of int32 sums (B, F, H, W), the
    multiply-add rounded once; `scale` is (F,), or (B, F) for a scale per
    image."""
    return F.leaky_relu(fma_f32(y.float(), _channels(scale), _channels(bias)), LEAKY_SLOPE)


def int8_conv_plain(
    q: torch.Tensor,
    qkernel: torch.Tensor,
    stride: int = 1,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    oscale: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The direct int8 cell (layers.py:228-247): the raw int32 sums without
    `scale`; else y = leaky(acc * scale + bias), then int8 round(y / oscale)
    clipped with `oscale`, or y in `out_dtype`."""
    y = int8_conv_exact(q, qkernel, stride)
    if scale is None:
        return y
    out = dequant_leaky(y, scale, bias)
    if oscale is not None:
        return requantize(out / oscale)
    return out.to(out_dtype)


def quant_downsample_plain(
    q: torch.Tensor, qkernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    oscale: torch.Tensor,
) -> torch.Tensor:
    """K3's function (pallas_conv.py:87-108): the 3x3 / stride-2 conv, y =
    acc * scale + bias, leaky 0.1, int8 round(y * (1 / oscale)) clipped to
    +-127, the reciprocal rounded in float32 (pallas_conv.py:169)."""
    y = fma_f32(int8_conv_exact(q, qkernel, 2).float(), _channels(scale), _channels(bias))
    y = torch.where(y > 0, y, LEAKY_SLOPE * y)
    return requantize(y * torch.reciprocal(oscale))


def int8_conv(q, qkernel, stride=1, scale=None, bias=None, oscale=None, out_dtype=torch.float32):
    """`int8_conv_plain`'s function; the CUDA kernel computes it for CUDA
    tensors."""
    if q.device.type == "cuda":
        return int8_conv_kernel.int8_conv(q, qkernel, stride, scale, bias, oscale, out_dtype)
    return int8_conv_plain(q, qkernel, stride, scale, bias, oscale, out_dtype)


def _check3d(q: torch.Tensor, qkernel: torch.Tensor, stride, padding):
    f, c, kt, kh, kw = qkernel.shape
    if q.dim() != 5 or q.dtype != torch.int8 or q.shape[-1] != c:
        raise ValueError(f"int8_conv3d takes an int8 window (B, T, H, W, {c}), got {tuple(q.shape)} {q.dtype}")
    if kh != kw or kh % 2 == 0 or tuple(padding[1:]) != (kh // 2, kw // 2) or stride[1] != stride[2]:
        raise ValueError(f"int8_conv3d takes a square odd spatial kernel padded k // 2 with one spatial stride, got "
                         f"kernel {tuple(qkernel.shape[2:])}, stride {tuple(stride)}, padding {tuple(padding)}")


def _epilogue_nhwc(y: torch.Tensor, b: int, t_out: int, scale, bias, out_dtype) -> torch.Tensor:
    """int32 sums (B*T', F, H', W') -> (B, T', H', W', F): raw, or
    leaky(acc * scale + bias) in `out_dtype` (`scale` (F,) or one a window,
    (B, F))."""
    if scale is not None:
        if scale.dim() == 2:  # one scale a window: repeated over its T' frames
            scale = scale.repeat_interleave(t_out, dim=0)
        y = dequant_leaky(y, scale, bias).to(out_dtype)
    return y.permute(0, 2, 3, 1).reshape((b, t_out) + y.shape[2:] + y.shape[1:2])


def int8_conv3d_plain(q: torch.Tensor, qkernel: torch.Tensor, stride=(1, 1, 1), padding=(0, 0, 0), scale=None,
                      bias=None, out_dtype=torch.float32) -> torch.Tensor:
    """The 3-D int8 cell's conv, plain (layers.py:355-366): q (B, T, H, W,
    C) int8, qkernel (F, C, kt, kh, kw) int8, zero padding `padding` on
    (T, H, W) -> (B, T', H', W', F): the exact int32 sums (float64 sums of
    int8 products, exact below 2^53) without `scale`, else leaky(acc *
    scale + bias) rounded once, in `out_dtype`."""
    _check3d(q, qkernel, stride, padding)
    y = F.conv3d(q.permute(0, 4, 1, 2, 3).double(), qkernel.double(), stride=tuple(stride), padding=tuple(padding))
    b, _, t_out = y.shape[:3]
    y = y.to(torch.int32).permute(0, 2, 1, 3, 4).reshape((b * t_out, y.shape[1]) + y.shape[3:])
    return _epilogue_nhwc(y, b, t_out, scale, bias, out_dtype)


def fold_frames(q: torch.Tensor, kt: int, st: int, pt: int):
    """(B, T, H, W, C) -> ((B*T', kt*C, H, W) in channels_last memory, T'):
    output frame t' takes input frames t'*st - pt + j, j < kt, on channels
    j*C + c, with zero frames outside the window (the time padding)."""
    b, t, h, w, c = q.shape
    if pt:
        pad = q.new_zeros((b, pt, h, w, c))
        q = torch.cat([pad, q, pad], dim=1)
    t_out = (t + 2 * pt - kt) // st + 1
    if t_out < 1:
        raise ValueError(f"int8_conv3d: no output frame for T={t}, kt={kt}, stride {st}, padding {pt}")
    x = torch.stack([q[:, j : j + st * (t_out - 1) + 1 : st] for j in range(kt)], dim=4)
    return x.reshape(b * t_out, h, w, kt * c).permute(0, 3, 1, 2), t_out


def fold_kernel(qkernel: torch.Tensor) -> torch.Tensor:
    """(F, C, kt, kh, kw) -> (F, kt*C, kh, kw) in channels_last memory,
    channel j*C + c holding tap j of input channel c (`fold_frames`'s)."""
    f, c, kt, kh, kw = qkernel.shape
    return qkernel.permute(0, 3, 4, 2, 1).reshape(f, kh, kw, kt * c).contiguous().permute(0, 3, 1, 2)


def int8_conv3d(q, qkernel, stride=(1, 1, 1), padding=(0, 0, 0), scale=None, bias=None,
                out_dtype=torch.float32):
    """`int8_conv3d_plain`'s function; for CUDA tensors one launch of the
    int8 conv kernel over the B*T' output frames, the kt time taps folded
    into channels (`fold_frames`, `fold_kernel`): its fused epilogue for
    one scale, its raw sums and `dequant_leaky` for a scale a window."""
    if q.device.type != "cuda":
        return int8_conv3d_plain(q, qkernel, stride, padding, scale, bias, out_dtype)
    _check3d(q, qkernel, stride, padding)
    b = q.shape[0]
    x, t_out = fold_frames(q, qkernel.shape[2], stride[0], padding[0])
    k2 = fold_kernel(qkernel)
    if scale is not None and scale.dim() == 1:
        y = int8_conv_kernel.int8_conv(x, k2, stride[1], scale, bias, out_dtype=out_dtype)
        return _epilogue_nhwc(y, b, t_out, None, None, out_dtype)
    return _epilogue_nhwc(int8_conv_kernel.int8_conv(x, k2, stride[1]), b, t_out, scale, bias, out_dtype)


def quant_downsample(q, qkernel, scale, bias, oscale):
    """`quant_downsample_plain`'s function; K3 computes it for CUDA
    tensors."""
    if q.device.type == "cuda":
        return int8_conv_kernel.quant_downsample(q, qkernel, scale, bias, oscale)
    return quant_downsample_plain(q, qkernel, scale, bias, oscale)
