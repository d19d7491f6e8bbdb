"""Batched fixed-shape greedy NMS (port of videoyolo_tpu/ops/nms.py:33-131).

Semantics, as in the JAX package:
  * entries with `score <= valid_thresh` or `id < 0` are invalid;
  * only the top-`topk` valid entries (by score, descending) participate;
  * greedy suppression in score order: a box is suppressed when its IoU with
    a higher-scoring *kept* box of the same class is `> overlap_thresh`
    (`force_suppress` drops the class test);
  * output is front-packed in descending-score order, padded with -1 rows.

`nms_greedy_plain` is the plain PyTorch version of the greedy scan and the
reference for the CUDA kernel `nms_kernel.nms_greedy`; `box_nms` runs the
plain version on a CPU tensor and the kernel on a CUDA tensor.
"""
from __future__ import annotations

import torch

from .nms_kernel import nms_greedy

__all__ = ["box_nms"]


def _f32(x: float) -> float:
    # thresholds compare in float32, as in the JAX package and the kernel
    return torch.tensor(x, dtype=torch.float32).item()


def _iou_matrix(boxes: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """(..., K, 4) corner boxes -> (..., K, K) IoU matrix.  The order of the
    float operations is the kernel's (csrc/nms.cu): keep them in step."""
    tl = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    br = torch.minimum(boxes[..., :, None, 2:4], boxes[..., None, :, 2:4])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1], min=0.0
    )
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=eps)


def _candidates(dets: torch.Tensor, valid_thresh: float, topk: int, presorted: bool):
    """The top-`topk` valid rows of (B, N, 6) by score, descending, with the
    invalid rows sunk to the bottom; the rows as they are when `presorted`
    and no top-k cut applies."""
    n = dets.shape[1]
    k = min(topk, n) if topk > 0 else n
    if presorted and k == n:
        return dets
    valid = (dets[..., 1] > _f32(valid_thresh)) & (dets[..., 0] >= 0)
    sort_scores = torch.where(valid, dets[..., 1], torch.full_like(dets[..., 1], -torch.inf))
    _, order = torch.topk(sort_scores, k, dim=-1)
    return torch.gather(dets, 1, order[..., None].expand(-1, -1, 6))


def nms_greedy_plain(
    top: torch.Tensor,
    overlap_thresh: float = 0.45,
    valid_thresh: float = 0.01,
    post_nms: int = 100,
    force_suppress: bool = False,
):
    """Plain PyTorch version of the kernel `nms_kernel.nms_greedy`: greedy
    scan and front-pack over score-sorted (B, K, 6) rows.

    Returns `(packed (B, M, 6), keep (B, K) bool)`, M = min(post_nms, K)
    (K when post_nms <= 0)."""
    k = top.shape[1]
    keep = (top[..., 1] > _f32(valid_thresh)) & (top[..., 0] >= 0)
    col = torch.arange(k, device=top.device)
    suppress = (_iou_matrix(top[..., 2:6]) > _f32(overlap_thresh)) & (
        col[None, :] > col[:, None]
    )
    if not force_suppress:
        suppress &= top[..., :, None, 0] == top[..., None, :, 0]
    for i in range(k):
        keep &= ~(suppress[:, i] & keep[:, i, None])

    # front-pack kept rows (they are already in descending-score order)
    m = min(post_nms, k) if post_nms > 0 else k
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)[:, :m]
    rows = torch.gather(top, 1, order[..., None].expand(-1, -1, 6))
    kept = torch.gather(keep, 1, order)[..., None]
    return torch.where(kept, rows, torch.full_like(rows, -1.0)), keep


def _nms_single(
    dets: torch.Tensor,
    overlap_thresh: float,
    valid_thresh: float,
    topk: int,
    post_nms: int,
    force_suppress: bool,
    presorted: bool = False,
):
    """Plain PyTorch NMS over (B, N, 6) = (id, score, x1, y1, x2, y2).

    The counterpart of the JAX `_nms_single` under `jax.vmap`: the batch
    dimension is written out.  Returns `(packed (B, M, 6), keep (B, K) bool)`
    where `keep` is the greedy keep mask over the score-sorted top-K rows."""
    top = _candidates(dets, valid_thresh, topk, presorted)
    return nms_greedy_plain(top, overlap_thresh, valid_thresh, post_nms, force_suppress)


def box_nms(
    dets: torch.Tensor,
    overlap_thresh: float = 0.45,
    valid_thresh: float = 0.01,
    topk: int = 400,
    post_nms: int = 100,
    force_suppress: bool = False,
    presorted: bool = False,
) -> torch.Tensor:
    """Batched NMS: (B, N, 6) -> (B, post_nms, 6) with -1 padding.

    `presorted` (with topk <= 0) declares the rows already score-descending
    and skips the sort.  On a CUDA tensor the greedy scan and the pack run
    in the kernel (after the sort, when there is one); on a CPU tensor in
    the plain version."""
    top = _candidates(dets, valid_thresh, topk, presorted)
    if top.device.type == "cpu":
        return nms_greedy_plain(top, overlap_thresh, valid_thresh, post_nms, force_suppress)[0]
    return nms_greedy(
        top.contiguous(), overlap_thresh, valid_thresh, post_nms, force_suppress, return_keep=False
    )[0]
