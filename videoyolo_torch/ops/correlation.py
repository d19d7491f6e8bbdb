"""Correlation / cost-volume op (port of videoyolo_tpu/ops/correlation.py).

Semantics (FlowNet / Caffe lineage, MXNet `Correlation`): for every
displacement (dy, dx) of a (2*(d//stride2)+1)^2 grid, the output channel is
the patch dot product of the two NHWC feature maps, normalised by the patch
size `kernel_size^2 * C`; f2 is zero outside the image.

`correlation_plain` is the plain PyTorch version, in the JAX package's XLA
order: pad, one shifted product per displacement summed over C, stack, the
k x k patch sum, divide, subsample.  `correlation` dispatches as the JAX
package does: kernel_size=1, stride1=1, multiply on CUDA tensors goes to
`CostVolume`, whose forward is the CUDA kernel
(`correlation_kernel.cost_volume`) and whose backward is the adjoint kernel
(`correlation_kernel.cost_volume_backward`), whether a gradient is taken or
not (`CostVolumePair` takes the Corr layer's two volumes of a window of 3
frames, with one adjoint launch for both); a CPU tensor, and every other
configuration on either device, to the plain version, which autograd
differentiates.  A kernel that fails to build
or launch raises: nothing on the card falls back to the plain version.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from .correlation_kernel import (
    cost_volume, cost_volume_backward, cost_volume_backward_plain, cost_volume_pair_backward,
    cost_volume_pair_backward_plain,
)

__all__ = ["CostVolume", "CostVolumePair", "correlation", "correlation_plain", "num_corr_channels"]


def num_corr_channels(max_displacement: int, stride2: int = 1) -> int:
    """Output channel count of `correlation` (the displacement grid size)."""
    steps = 2 * (max_displacement // stride2) + 1
    return steps * steps


def correlation_plain(
    f1: torch.Tensor,
    f2: torch.Tensor,
    max_displacement: int,
    kernel_size: int = 1,
    stride1: int = 1,
    stride2: int = 2,
    is_multiply: bool = True,
) -> torch.Tensor:
    """Cost volume between two NHWC feature maps (B, H, W, C) -> (B, H', W',
    D), D = (2*(max_displacement//stride2)+1)^2, H' = ceil(H/stride1).
    `is_multiply=False` gives the subtractive (absolute-difference) form."""
    if f1.shape != f2.shape:
        raise ValueError(f"correlation takes two maps of one shape, got {tuple(f1.shape)}, {tuple(f2.shape)}")
    _, h, w, c = f1.shape
    d, k = max_displacement, kernel_size
    pad = d + k // 2
    # NHWC: pad W and H, not C
    f2p = F.pad(f2, (0, 0, pad, pad, pad, pad))
    steps = d // stride2
    planes = []
    for dy in range(-steps, steps + 1):
        for dx in range(-steps, steps + 1):
            oy, ox = dy * stride2, dx * stride2
            shifted = f2p[:, pad + oy : pad + oy + h, pad + ox : pad + ox + w, :]
            prod = f1 * shifted if is_multiply else (f1 - shifted).abs()
            planes.append(prod.sum(dim=-1))
    out = torch.stack(planes, dim=-1)  # (B, H, W, D)
    if k > 1:
        # the k x k patch sum, zero-padded by k//2 (reduce_window in JAX)
        r = k // 2
        outp = F.pad(out, (0, 0, r, r, r, r))
        ho, wo = h + 2 * r - k + 1, w + 2 * r - k + 1
        out = sum(outp[:, i : i + ho, j : j + wo] for i in range(k) for j in range(k))
    out = out / float(k * k * c)
    if stride1 > 1:
        out = out[:, ::stride1, ::stride1]
    return out


class CostVolume(torch.autograd.Function):
    """The cost volume of kernel_size=1, stride1=1, multiply with its
    adjoint: `CostVolume.apply(f1, f2, max_displacement, stride2)`.  On CUDA
    tensors the forward is K2 and the backward the adjoint kernel; on CPU
    tensors their plain versions (`correlation_plain`,
    `cost_volume_backward_plain`).  f1 and f2 are saved as given (frame
    slices of a window stay views); the backward takes the output's gradient
    contiguous and returns dense gradients of f1 and f2."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement: int, stride2: int):
        ctx.save_for_backward(f1, f2)
        ctx.corr = (max_displacement, stride2)
        if f1.device.type == "cuda":
            return cost_volume(f1, f2, max_displacement, stride2)
        return correlation_plain(f1, f2, max_displacement, 1, 1, stride2)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        adjoint = cost_volume_backward if g.device.type == "cuda" else cost_volume_backward_plain
        gf1, gf2 = adjoint(g.contiguous(), f1, f2, *ctx.corr)
        return gf1, gf2, None, None


class CostVolumePair(torch.autograd.Function):
    """The two cost volumes of kernel_size=1, stride1=1, multiply that the
    Corr layer takes of a (B, 3, H, W, C) window, frames 0 and 2 against
    frame 1, with their adjoint in one launch:
    `CostVolumePair.apply(window, max_displacement, stride2)` -> (the volume
    of frame 0, the volume of frame 2).  On CUDA tensors the forward is two
    K2 launches and the backward one launch of the adjoint kernel
    (`cost_volume_pair_backward`), which writes the window's gradient whole:
    frame 1's is the sum of both volumes' gradients, added in the kernel, so
    autograd neither adds them nor scatters three frame gradients into
    zeroed windows.  On CPU tensors their plain versions."""

    @staticmethod
    def forward(ctx, window, max_displacement: int, stride2: int):
        ctx.save_for_backward(window)
        ctx.corr = (max_displacement, stride2)
        fa, fm, fb = window.unbind(1)
        if window.device.type == "cuda":
            return cost_volume(fa, fm, max_displacement, stride2), cost_volume(fb, fm, max_displacement, stride2)
        return (correlation_plain(fa, fm, max_displacement, 1, 1, stride2),
                correlation_plain(fb, fm, max_displacement, 1, 1, stride2))

    @staticmethod
    def backward(ctx, ga, gb):
        (window,) = ctx.saved_tensors
        b, _, h, w, _ = window.shape
        shape = (b, h, w, num_corr_channels(*ctx.corr))
        ga, gb = (torch.zeros(shape, device=window.device) if g is None else g.contiguous() for g in (ga, gb))
        adjoint = cost_volume_pair_backward if window.device.type == "cuda" else cost_volume_pair_backward_plain
        return adjoint(ga, gb, window, *ctx.corr), None, None


def correlation(
    f1: torch.Tensor,
    f2: torch.Tensor,
    max_displacement: int,
    kernel_size: int = 1,
    stride1: int = 1,
    stride2: int = 2,
    is_multiply: bool = True,
) -> torch.Tensor:
    """`correlation_plain`'s function; for kernel_size=1, stride1=1,
    multiply on CUDA tensors (float32) the kernels of `CostVolume` compute it
    and its gradient."""
    if kernel_size == 1 and stride1 == 1 and is_multiply and f1.device.type == "cuda":
        return CostVolume.apply(f1, f2, max_displacement, stride2)
    return correlation_plain(f1, f2, max_displacement, kernel_size, stride1, stride2, is_multiply)
