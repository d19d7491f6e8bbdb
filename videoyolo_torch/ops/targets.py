"""YOLOv3 training targets on the device (port of
videoyolo_tpu/ops/targets.py:44-241).

The matching rules are the JAX package's (gluoncv's target generators):
  * each valid gt (a row without a negative coordinate) goes to the best of
    all 9 anchors by the IoU of zero-centred boxes, in the grid cell that
    holds its center on that anchor's level, the cell clamped to the grid
    (a center on the right or bottom edge lands in the last cell);
  * center targets are the sub-cell offsets, scale targets
    log(max(wh, 1) / anchor), weights 2 - w*h/(W*H); objectness is the mixup
    ratio if given, else 1; class rows are one-hot, or multi-hot rows copied
    as they are; everything else: class -1 (ignore), objectness 0;
  * when two gts land on one (cell, anchor) slot, the later gt wins.

Flat layout: the model's deep -> shallow concat, level l with grid
(H_l, W_l) and A anchors at flat index start_l + (y * W_l + x) * A + a.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .anchors import DEFAULT_ANCHORS, DEFAULT_STRIDES
from .bbox import corner_to_center, pairwise_iou

__all__ = ["flat_layout", "prefetch_targets", "dynamic_targets", "merge_targets"]


def flat_layout(input_hw: Tuple[int, int], anchors=DEFAULT_ANCHORS, strides=DEFAULT_STRIDES):
    """Static tables of the deep -> shallow flat prediction layout:
    (all_anchors (9, 2) deep-first, level_starts (L,), grid_hw (L, 2),
    strides_rev (L,), total N), numpy."""
    anchors_rev = list(anchors)[::-1]
    strides_rev = list(strides)[::-1]
    h, w = input_hw
    all_anchors = np.concatenate([np.asarray(a, np.float32).reshape(-1, 2) for a in anchors_rev], axis=0)
    grid_hw = np.asarray([(h // s, w // s) for s in strides_rev], np.int32)
    num_per_level = [gh * gw * (len(anchors_rev[l]) // 2) for l, (gh, gw) in enumerate(grid_hw)]
    starts = np.concatenate([[0], np.cumsum(num_per_level)[:-1]]).astype(np.int32)
    total = int(np.sum(num_per_level))
    return all_anchors, starts, grid_hw, np.asarray(strides_rev, np.int32), total


@functools.lru_cache(maxsize=32)
def _layout_tensors(input_hw, anchors, strides, device):
    """`flat_layout`'s tables on `device`, copied there once per input
    size: a copy from pageable host memory would wait for the card's queue
    on every step."""
    all_anchors, starts, grid_hw, _, total = flat_layout(input_hw, anchors, strides)
    return (torch.from_numpy(all_anchors).to(device), torch.from_numpy(starts).to(device, torch.int64),
            torch.from_numpy(grid_hw).to(device, torch.int64), total)


@torch.no_grad()
def prefetch_targets(
    gt_boxes: torch.Tensor,  # (B, M, 4) corner boxes in input pixels, -1 padded
    gt_ids: torch.Tensor,  # (B, M, 1) ids or (B, M, C) multi-hot
    gt_mixratio: torch.Tensor | None = None,  # (B, M, 1)
    *,
    input_hw: Tuple[int, int],
    num_classes: int,
    anchors=DEFAULT_ANCHORS,
    strides=DEFAULT_STRIDES,
):
    """Batched targets in the model's flat order: (objectness (B, N, 1),
    center (B, N, 2), scale (B, N, 2), weight (B, N, 2), class (B, N, C)),
    float32.

    Each gt is written to its slot once: the slot's winner (the latest gt
    landing there) is resolved first with a scatter-max of the gt index, so
    no scatter sees a duplicate index.  Invalid gts and losers go to a spare
    row N, sliced off at the end."""
    dev = gt_boxes.device
    all_anchors, starts, grid, total = _layout_tensors(tuple(input_hw), anchors, strides, dev)
    orig_h, orig_w = input_hw
    b, m = gt_boxes.shape[:2]
    apl = len(anchors[0]) // 2

    valid = (gt_boxes[..., :4] >= 0).all(dim=-1)  # (B, M)
    cx, cy, gw, gh = (t[..., 0] for t in corner_to_center(gt_boxes, split=True))

    # best anchor per gt: IoU of zero-centred boxes
    shift_gt = torch.stack([-0.5 * gw, -0.5 * gh, 0.5 * gw, 0.5 * gh], dim=-1)
    aw, ah = all_anchors[:, 0], all_anchors[:, 1]
    shift_anchor = torch.stack([-0.5 * aw, -0.5 * ah, 0.5 * aw, 0.5 * ah], dim=-1)
    match = pairwise_iou(shift_gt, shift_anchor).argmax(dim=-1)  # (B, M), first maximum

    level = match // apl
    local_a = match % apl
    gh_l = grid[level, 0].float()
    gw_l = grid[level, 1].float()
    # x / W as the JAX package computes it under jit: XLA turns a division by
    # a constant into a product with the constant's float32 reciprocal
    inv_w, inv_h = _f32_reciprocal(orig_w), _f32_reciprocal(orig_h)
    # clamp to the last cell (targets.py:97-109)
    loc_x = torch.minimum(torch.floor(cx * inv_w * gw_l).clamp_min(0), gw_l - 1).long()
    loc_y = torch.minimum(torch.floor(cy * inv_h * gh_l).clamp_min(0), gh_l - 1).long()
    flat = starts[level] + (loc_y * grid[level, 1] + loc_x) * apl + local_a
    flat = torch.where(valid, flat, total)

    # collision determinism: the later gt wins its slot, losers are dropped
    rank = torch.arange(m, device=dev).expand(b, m)
    winner = torch.full((b, total + 1), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(1, flat, rank, "amax")
    flat = torch.where(winner.gather(1, flat) == rank, flat, total)

    tx = cx * inv_w * gw_l - loc_x
    ty = cy * inv_h * gh_l - loc_y
    # XLA's log is its own float32 approximation: these can differ from it
    # by one ulp
    sx = torch.log(gw.clamp_min(1.0) / all_anchors[match, 0])
    sy = torch.log(gh.clamp_min(1.0) / all_anchors[match, 1])
    # 2 - w*h / W / H: XLA folds the two divisions into one product with
    # f32(1/W) * f32(1/H) and the subtraction into an FMA (rounded once)
    wt = (2.0 - (gw * gh).double() * float(np.float32(inv_w) * np.float32(inv_h))).float()
    obj = gt_mixratio[..., 0].float() if gt_mixratio is not None else torch.ones_like(wt)
    if gt_ids.shape[-1] == 1:  # one-hot; an id outside [0, C) gives a zero row
        cls_rows = (gt_ids[..., :1].to(torch.int32) == torch.arange(num_classes, device=dev)).float()
    else:
        cls_rows = gt_ids.float()  # multi-hot tree labels

    def scatter(rows, fill):
        out = torch.full((b, total + 1, rows.shape[-1]), fill, dtype=torch.float32, device=dev)
        out.scatter_(1, flat[..., None].expand(-1, -1, rows.shape[-1]), rows.float())
        return out[:, :total]

    return (
        scatter(obj[..., None], 0.0),
        scatter(torch.stack([tx, ty], -1), 0.0),
        scatter(torch.stack([sx, sy], -1), 0.0),
        scatter(torch.stack([wt, wt], -1), 0.0),
        scatter(cls_rows, -1.0),
    )


def _f32_reciprocal(n: int) -> float:
    return float(np.float32(1) / np.float32(n))


def dynamic_targets(box_preds: torch.Tensor, gt_boxes: torch.Tensor, ignore_iou_thresh: float = 0.7):
    """Ignore-mask objectness from the pred / gt IoU: (B, N, 1), -1 where a
    prediction's best IoU with a gt exceeds the threshold, else 0."""
    ious_max = pairwise_iou(box_preds, gt_boxes).amax(dim=-1, keepdim=True)
    return (ious_max > ignore_iou_thresh).float() * -1.0


@torch.no_grad()
def merge_targets(
    box_preds: torch.Tensor,
    gt_boxes: torch.Tensor,
    obj_t: torch.Tensor,
    centers_t: torch.Tensor,
    scales_t: torch.Tensor,
    weights_t: torch.Tensor,
    clas_t: torch.Tensor,
    num_classes: int,
    ignore_iou_thresh: float = 0.7,
    label_smooth: bool = False,
):
    """Prefetched targets over the dynamic ones, optional label smoothing
    (smoothing weight min(1/C, 1/40)).  Returns (objectness, center_t,
    scale_t, weight_t, class_t, class_mask), all without gradient."""
    box_preds = box_preds.detach()
    dyn_obj = dynamic_targets(box_preds, gt_boxes, ignore_iou_thresh)
    mask = obj_t > 0
    objectness = torch.where(mask, obj_t, dyn_obj)
    center_targets = torch.where(mask, centers_t, 0.0)
    scale_targets = torch.where(mask, scales_t, 0.0)
    weights = torch.where(mask, weights_t, 0.0)
    class_targets = torch.where(mask, clas_t, -1.0)
    if label_smooth:
        smooth_weight = min(1.0 / num_classes, 1.0 / 40)
        class_targets = torch.where(class_targets > 0.5, class_targets - smooth_weight, class_targets)
        class_targets = torch.where(
            (class_targets < -0.5) | (class_targets > 0.5), class_targets,
            torch.full_like(class_targets, smooth_weight),
        )
    class_mask = mask.float() * (class_targets >= 0)
    return objectness, center_targets, scale_targets, weights, class_targets, class_mask
