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

Layouts: int8 activations (B, C, H, W), kernels (F, C, k, k), as the models
keep them (NHWC / OHWI in `channels_last` memory); pad k // 2.
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


def quant_downsample(q, qkernel, scale, bias, oscale):
    """`quant_downsample_plain`'s function; K3 computes it for CUDA
    tensors."""
    if q.device.type == "cuda":
        return int8_conv_kernel.quant_downsample(q, qkernel, scale, bias, oscale)
    return quant_downsample_plain(q, qkernel, scale, bias, oscale)
