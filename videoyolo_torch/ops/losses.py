"""The YOLOv3 loss (port of videoyolo_tpu/ops/losses.py:29-70).

Each component is a per-sample sum over the non-batch axes, shape (B,);
the train step takes the mean over the batch.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["sigmoid_bce", "weighted_l1", "yolo3_loss"]


def sigmoid_bce(pred: torch.Tensor, label: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted sigmoid binary cross-entropy from logits, summed over the
    non-batch axes: max(x, 0) - x*y + log(1 + exp(-|x|))."""
    loss = torch.maximum(pred, pred.new_zeros(())) - pred * label + torch.log1p(torch.exp(-pred.abs()))
    return (loss * weight).reshape(loss.shape[0], -1).sum(-1)


def weighted_l1(pred: torch.Tensor, label: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted L1, summed over the non-batch axes."""
    return ((pred - label).abs() * weight).reshape(pred.shape[0], -1).sum(-1)


def yolo3_loss(
    objness: torch.Tensor,  # (B, N, 1) logits
    box_centers: torch.Tensor,  # (B, N, 2) logits
    box_scales: torch.Tensor,  # (B, N, 2) raw
    cls_preds: torch.Tensor,  # (B, N, C) logits
    objness_t: torch.Tensor,
    center_t: torch.Tensor,
    scale_t: torch.Tensor,
    weight_t: torch.Tensor,
    class_t: torch.Tensor,
    class_mask: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Per-sample (B,) losses `obj`, `center`, `scale` and `cls`: the
    objectness BCE against hard 0/1 targets with ignored anchors (target
    -1) masked out and mixup ratios as weights; the center BCE and the
    scale L1 weighted by (2 - box area fraction) * objectness; the class
    BCE masked to matched anchors with non-ignored class rows."""
    weight_t = weight_t * objness_t
    hard_objness_t = torch.where(objness_t > 0, torch.ones_like(objness_t), objness_t)
    new_objness_mask = torch.where(objness_t > 0, objness_t, (objness_t >= 0).to(objness_t.dtype))
    return {
        "obj": sigmoid_bce(objness, hard_objness_t, new_objness_mask),
        "center": sigmoid_bce(box_centers, center_t, weight_t),
        "scale": weighted_l1(box_scales, scale_t, weight_t),
        "cls": sigmoid_bce(cls_preds, class_t, class_mask * objness_t),
    }
