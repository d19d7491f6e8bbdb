"""Correlation / cost-volume op (port of videoyolo_tpu/ops/correlation.py).

Semantics (FlowNet / Caffe lineage, MXNet `Correlation`): for every
displacement (dy, dx) of a (2*(d//stride2)+1)^2 grid, the output channel is
the patch dot product of the two NHWC feature maps, normalised by the patch
size `kernel_size^2 * C`; f2 is zero outside the image.

`correlation_plain` is the plain PyTorch version, in the JAX package's XLA
order: pad, one shifted product per displacement summed over C, stack, the
k x k patch sum, divide, subsample.  `correlation` dispatches as the JAX
package does: kernel_size=1, stride1=1, multiply on a CUDA tensor goes to the
CUDA kernel (`correlation_kernel.cost_volume`); a CPU tensor, and every other
configuration on either device, to the plain version.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from .correlation_kernel import cost_volume

__all__ = ["correlation", "correlation_plain", "num_corr_channels"]


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


def correlation(
    f1: torch.Tensor,
    f2: torch.Tensor,
    max_displacement: int,
    kernel_size: int = 1,
    stride1: int = 1,
    stride2: int = 2,
    is_multiply: bool = True,
) -> torch.Tensor:
    """`correlation_plain`'s function; the CUDA kernel computes it for
    kernel_size=1, stride1=1, multiply on CUDA tensors (float32)."""
    if kernel_size == 1 and stride1 == 1 and is_multiply and f1.device.type == "cuda":
        return cost_volume(f1, f2, max_displacement, stride2)
    return correlation_plain(f1, f2, max_displacement, kernel_size, stride1, stride2, is_multiply)
