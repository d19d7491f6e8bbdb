"""Bounding-box math (port of videoyolo_tpu/ops/bbox.py:30-78).

Boxes are float tensors whose last axis is 4:
  corner format: (xmin, ymin, xmax, ymax)
  center format: (cx, cy, w, h)
"""
from __future__ import annotations

import torch

__all__ = ["corner_to_center", "center_to_corner", "pairwise_iou"]


def corner_to_center(boxes: torch.Tensor, split: bool = False):
    """(xmin,ymin,xmax,ymax) -> (cx,cy,w,h)."""
    xmin, ymin, xmax, ymax = boxes[..., :4].split(1, dim=-1)
    w = xmax - xmin
    h = ymax - ymin
    cx = xmin + w / 2
    cy = ymin + h / 2
    if split:
        return cx, cy, w, h
    return torch.cat([cx, cy, w, h], dim=-1)


def center_to_corner(boxes: torch.Tensor, split: bool = False):
    """(cx,cy,w,h) -> (xmin,ymin,xmax,ymax)."""
    cx, cy, w, h = boxes[..., :4].split(1, dim=-1)
    hw = w / 2
    hh = h / 2
    xmin = cx - hw
    ymin = cy - hh
    xmax = cx + hw
    ymax = cy + hh
    if split:
        return xmin, ymin, xmax, ymax
    return torch.cat([xmin, ymin, xmax, ymax], dim=-1)


def pairwise_iou(boxes_a, boxes_b, offset: float = 0.0, eps: float = 1e-15):
    """IoU between every box pair: (..., N, 4) x (..., M, 4) -> (..., N, M).

    `offset` is the reference convention w = xmax - xmin + offset; boxes that
    do not overlap have zero intersection."""
    a = boxes_a[..., :, None, :4]
    b = boxes_b[..., None, :, :4]
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:4], b[..., 2:4])
    valid = (tl < br).all(dim=-1)
    area_i = (br - tl + offset).prod(dim=-1) * valid
    area_a = (boxes_a[..., 2:4] - boxes_a[..., :2] + offset).prod(dim=-1)
    area_b = (boxes_b[..., 2:4] - boxes_b[..., :2] + offset).prod(dim=-1)
    union = area_a[..., :, None] + area_b[..., None, :] - area_i
    return area_i / torch.clamp(union, min=eps)
