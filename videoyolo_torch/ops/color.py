"""On-device color maps (port of videoyolo_tpu/ops/color.py:22-39).

The host samples one (3, 4) affine matrix per image (augmentation and the
normalisation folded together) and ships uint8 pixels; the train step
applies the matrix on the device.
"""
from __future__ import annotations

import torch

__all__ = ["apply_color"]


def apply_color(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Per-image (3, 4) color matrices applied to [0, 255] pixels.

    x:   (B, H, W, 3) or (B, K, H, W, 3), any real dtype (uint8 typical)
    mat: (B, 3, 4): out_d = sum_c A[d, c] * in_c + b[d]
    Returns float32, already normalised.  The arithmetic is XLA's for the
    JAX package's HIGHEST-precision einsum: x0*A0 rounded, then x1*A1 and
    x2*A2 each added with one rounding (fused multiply-adds, done here in
    float64, where the products are exact), then b.  No matmul, so no TF32
    setting can round the pixels."""
    if x.dim() not in (4, 5):
        raise ValueError(f"expected 4D/5D image batch, got {tuple(x.shape)}")
    x = x.float()
    # (B, 1.., 4, 3): column c of the matrix as the last axis of each pixel
    m = mat.float().transpose(1, 2).reshape((mat.shape[0],) + (1,) * (x.dim() - 2) + (4, 3))
    acc = x[..., 0:1] * m[..., 0, :]
    for c in (1, 2):
        acc = (x[..., c:c + 1].double() * m[..., c, :].double() + acc.double()).float()
    return acc + m[..., 3, :]
