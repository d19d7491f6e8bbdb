"""YOLOv3 detector (port of videoyolo_tpu/models/yolo3.py).

Eval-mode forward: (boxes (B, N, 4) pixels, scores (B, N, C)), levels in
deep -> shallow order; the post-processing (two-stage exact top-k, then
greedy NMS) works on those compact tensors.  Train mode returns the raw
heads the loss reads (`decode_predictions`).  Cells run NCHW in
`channels_last` memory; images and routes come in NHWC.  With `quant`
"fused" the model is the fused-int8 detector of ops/quantize.py:quantize_fused
(int8 from cell to cell, real-valued tips into the prediction convs); with
True / "dynamic" or "static" the int8 detector of
ops/quantize.py:quantize_static (int8 cells, real values in `dtype` between
them).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.anchors import DEFAULT_ANCHORS, DEFAULT_STRIDES, grid_offsets
from ..ops.nms import box_nms
from .darknet import DARKNET53_CHANNELS, Darknet53
from .layers import Conv2d, ConvBNLeaky, QTensor, quant_concat, remat, upsample2x

FPN_CHANNELS = (512, 256, 128)


class YOLODetectionBlock(nn.Module):
    """5-conv FPN block + 3x3 tip; returns (route, tip), NCHW.  In the
    fused-int8 modes the tip writes real values in `dtype` (`qout=False`):
    its one consumer is the prediction conv.  `real_input`: the block's
    input is real-valued (a fused model's routes from outside, the
    head-only model's), quantised by the first cell's `xscale`."""

    def __init__(self, in_channels: int, channel: int, dtype: torch.dtype | None = None, quant=None,
                 real_input: bool = False):
        super().__init__()
        if channel % 2:
            raise ValueError(f"channel must be even, got {channel}")
        cells = []
        cin = in_channels
        for n in range(2):
            cells += [
                ConvBNLeaky(cin, channel, kernel=1, dtype=dtype, quant=quant, real_input=real_input and n == 0),
                ConvBNLeaky(channel, 2 * channel, kernel=3, dtype=dtype, quant=quant),
            ]
            cin = 2 * channel
        cells.append(ConvBNLeaky(cin, channel, kernel=1, dtype=dtype, quant=quant))  # route
        cells.append(ConvBNLeaky(channel, 2 * channel, kernel=3, dtype=dtype, quant=quant, qout=False))  # tip
        for n, cell in enumerate(cells):
            self.add_module(f"ConvBNLeaky_{n}", cell)

    def forward(self, x: torch.Tensor):
        cells = list(self.children())
        for cell in cells[:-1]:
            x = cell(x)
        return x, cells[-1](x)


class YOLOOutput(nn.Module):
    """Prediction conv (with bias) + anchor decode for one FPN level."""

    def __init__(
        self, in_channels: int, num_classes: int, anchors: Sequence[Sequence[float]],
        stride: int, dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.stride = stride
        self.prediction = Conv2d(
            in_channels, len(anchors) * (5 + num_classes), 1, bias=True, dtype=dtype
        )
        # float32 whatever the model's dtype (373 is not a bf16 value);
        # not in the state_dict, as in the JAX package where anchors are
        # module attributes and not params
        self.register_buffer(
            "anchors", torch.tensor(anchors, dtype=torch.float32), persistent=False
        )

    def forward(self, tip: torch.Tensor):
        return decode_predictions(
            self.prediction(tip), self.anchors, self.stride, self.num_classes, self.training
        )


def decode_predictions(pred: torch.Tensor, anchors: torch.Tensor, stride: int, num_classes: int,
                       train: bool = False):
    """Anchor decode of a raw NCHW prediction map (B, A*(5+C), H, W), in
    float32 whatever the map's dtype:

      centers = (sigmoid(raw_xy) + grid_offsets) * stride
      scales  = exp(raw_wh) * anchors
      conf    = sigmoid(obj); class_score = sigmoid(cls) * conf
      bbox    = (cx - w/2, cy - h/2, cx + w/2, cy + h/2)

    Returns (bbox (B, HWA, 4), class_score (B, HWA, C), conf (B, HWA, 1)),
    rows in (y, x, anchor) order as in the JAX package; with `train`, the
    dict of `bbox` and the raw heads `raw_centers` (B, HWA, 2), `raw_scales`
    (B, HWA, 2), `objness` (B, HWA, 1) and `class_pred` (B, HWA, C)."""
    b, _, h, w = pred.shape
    num_anchors = anchors.shape[0]
    # NHWC first: (B, H, W, A*(5+C)) -> (B, HW, A, 5+C) is then a reshape
    pred = pred.permute(0, 2, 3, 1).reshape(b, h * w, num_anchors, 5 + num_classes).float()

    raw_centers = pred[..., 0:2]
    raw_scales = pred[..., 2:4]
    objness = pred[..., 4:5]
    class_pred = pred[..., 5:]

    offsets = grid_offsets(h, w, pred.device)[None, :, None, :]
    centers = (torch.sigmoid(raw_centers) + offsets) * float(stride)
    scales = torch.exp(raw_scales) * anchors[None, None]
    half = scales / 2.0
    bbox = torch.cat([centers - half, centers + half], dim=-1)

    if train:
        return {
            "bbox": bbox.reshape(b, -1, 4),
            "raw_centers": raw_centers.reshape(b, -1, 2),
            "raw_scales": raw_scales.reshape(b, -1, 2),
            "objness": objness.reshape(b, -1, 1),
            "class_pred": class_pred.reshape(b, -1, num_classes),
        }
    conf = torch.sigmoid(objness)
    class_score = torch.sigmoid(class_pred) * conf
    return bbox.reshape(b, -1, 4), class_score.reshape(b, -1, num_classes), conf.reshape(b, -1, 1)


class YOLOv3(nn.Module):
    """Full YOLOv3: backbone routes -> reverse-FPN -> per-level outputs.

    Call with an NHWC image batch (B, H, W, 3), or, with
    `use_backbone=False`, a tuple of three NHWC routes (r1, r2, r3), shallow
    to deep, whose channel counts are `route_channels`.

    Eval mode (`model.eval()`) returns (boxes (B, N, 4) pixels, scores
    (B, N, C)), or scores (B, N, 1) objectness if `agnostic`; with
    `return_levels`, the per-level (boxes, scores) pairs instead.  Train
    mode returns the dict of `decode_predictions(train=True)`, each level's
    heads concatenated deep -> shallow, all float32.

    `remat` (train mode): True rematerialises the whole backbone, "stem"
    its first three stages (layers.remat).

    `quant` "fused" (or its calibration twin "fused_calib") builds the
    fused-int8 model, which ops/quantize.py:quantize_fused converts from a
    float one (never initialised); `ds_conv` "pallas" sends the eligible
    downsamples to K3.  True / "dynamic" and "static" build the int8 model
    of ops/quantize.py:quantize_static.  Without the backbone, the first
    cell of each block quantises its real-valued input.  `init_kwargs` keeps the constructor's arguments, so
    the float model and its int8 twin are built alike."""

    def __init__(
        self,
        num_classes: int,
        anchors=DEFAULT_ANCHORS,  # shallow -> deep per level
        strides: Sequence[int] = DEFAULT_STRIDES,
        channels: Sequence[int] = FPN_CHANNELS,
        agnostic: bool = False,
        use_backbone: bool = True,
        route_channels: Sequence[int] = DARKNET53_CHANNELS[-3:],
        remat=False,
        s2d_stem: bool = False,
        pad_stem: bool = False,
        return_levels: bool = False,
        quant=None,
        ds_conv: str = "direct",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.init_kwargs = dict(
            num_classes=num_classes, anchors=anchors, strides=strides, channels=channels,
            agnostic=agnostic, use_backbone=use_backbone, route_channels=route_channels, remat=remat,
            s2d_stem=s2d_stem, pad_stem=pad_stem, return_levels=return_levels, quant=quant,
            ds_conv=ds_conv, dtype=dtype,
        )
        if remat not in (False, None, True, "full", "stem"):
            raise ValueError(f"remat must be False, True, 'full' or 'stem', got {remat!r}")
        self.quant = quant or None
        self.agnostic = agnostic
        self.use_backbone = use_backbone
        self.return_levels = return_levels
        self.dtype = dtype or torch.float32
        self.remat = remat
        if use_backbone:
            self.backbone = Darknet53(
                s2d_stem=s2d_stem, pad_stem=pad_stem, quant=quant, ds_conv=ds_conv, dtype=dtype,
                remat_stages=3 if remat == "stem" else 0,
            )
            route_channels = DARKNET53_CHANNELS[-3:]

        # deep -> shallow (anchors and strides reversed)
        anchors_rev = list(anchors)[::-1]
        strides_rev = list(strides)[::-1]
        cin = route_channels[-1]
        for i in range(3):
            self.add_module(f"block{i}", YOLODetectionBlock(cin, channels[i], dtype=dtype, quant=quant,
                                                            real_input=not use_backbone))
            pairs = [
                (anchors_rev[i][2 * j], anchors_rev[i][2 * j + 1])
                for j in range(len(anchors_rev[i]) // 2)
            ]
            self.add_module(
                f"output{i}",
                YOLOOutput(2 * channels[i], num_classes, pairs, strides_rev[i], dtype=dtype),
            )
            if i < 2:
                self.add_module(
                    f"transition{i}",
                    ConvBNLeaky(channels[i], channels[i + 1], kernel=1, dtype=dtype, quant=quant),
                )
                cin = channels[i + 1] + route_channels[1 - i]

    def forward(self, x):
        if not self.use_backbone:
            routes = tuple(x)
        elif self.remat and self.remat != "stem" and self.training and torch.is_grad_enabled():
            routes = remat(self.backbone, x)
        else:
            routes = self.backbone(x)
        if len(routes) != 3:
            raise ValueError(f"YOLOv3 takes three routes, got {len(routes)}")
        # an int8 cell quantises its real-valued input as it comes (the
        # JAX package's concat keeps a float32 route float32)
        routes = [
            r._replace(q=r.q.permute(0, 3, 1, 2)) if isinstance(r, QTensor)
            else (r if self.quant else r.to(self.dtype)).permute(0, 3, 1, 2)
            for r in routes
        ]

        level_outs = []
        y = routes[-1]
        for i in range(3):
            route, tip = getattr(self, f"block{i}")(y)
            level_outs.append(getattr(self, f"output{i}")(tip))
            if i < 2:
                y = getattr(self, f"transition{i}")(route)
                if isinstance(y, QTensor):
                    # int8: the repeat is exact on quantised values, and the
                    # concat rescales onto a common scale
                    y = quant_concat([y._replace(q=upsample2x(y.q)), routes[1 - i]])
                else:
                    y = torch.cat([upsample2x(y), routes[1 - i]], dim=1)

        if self.training:
            return {key: torch.cat([o[key] for o in level_outs], dim=1) for key in level_outs[0]}
        if self.return_levels:
            k = 2 if self.agnostic else 1
            return tuple((o[0], o[k]) for o in level_outs)
        boxes = torch.cat([o[0] for o in level_outs], dim=1)
        if self.agnostic:
            return boxes, torch.cat([o[2] for o in level_outs], dim=1)
        return boxes, torch.cat([o[1] for o in level_outs], dim=1)


def select_topk_candidates(
    boxes: torch.Tensor, scores: torch.Tensor, topk: int = 400,
    approx_recall: Optional[float] = None,
) -> torch.Tensor:
    """(B,N,4) boxes + (B,N,C) scores -> (B,K,6) (id, score, x1,y1,x2,y2),
    score-descending.

    Two-stage exact selection, as in the JAX package: the top-K boxes by
    their best class score, then the top-K (box, class) pairs within that
    pool.  Every pair of the flat top-K over N*C lies in the pool, so the
    result is the flat top-K's, modulo ties at the K-th value."""
    if approx_recall is not None:
        raise NotImplementedError("approx_recall uses the TPU's approx_max_k; the port is exact only")
    b, n, c = scores.shape
    k_boxes = min(topk, n)
    _, box_idx0 = torch.topk(scores.amax(dim=-1), k_boxes, dim=-1)
    pool_scores = torch.gather(scores, 1, box_idx0[..., None].expand(-1, -1, c))
    pool_boxes = torch.gather(boxes, 1, box_idx0[..., None].expand(-1, -1, 4))
    top_scores, flat_idx = torch.topk(
        pool_scores.reshape(b, k_boxes * c), min(topk, k_boxes * c), dim=-1
    )
    box_idx = flat_idx // c
    cls_idx = (flat_idx % c).to(boxes.dtype)
    top_boxes = torch.gather(pool_boxes, 1, box_idx[..., None].expand(-1, -1, 4))
    return torch.cat(
        [cls_idx[..., None], top_scores[..., None].to(boxes.dtype), top_boxes], dim=-1
    )


def flatten_detections(boxes: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """The reference per-class detection tensor (B, N*C, 6), class-major.
    Parity-test helper."""
    b, n, c = scores.shape
    ids = torch.arange(c, dtype=boxes.dtype, device=boxes.device)[None, :, None, None]
    ids = ids.expand(b, c, n, 1)
    sc = scores.permute(0, 2, 1)[..., None]  # (B,C,N,1)
    bx = boxes[:, None].expand(b, c, n, 4)
    return torch.cat([ids, sc, bx], dim=-1).reshape(b, c * n, 6)


def _nms_tail(cands, nms_thresh, post_nms, force_suppress):
    if 0 < nms_thresh < 1:
        result = box_nms(
            cands,
            overlap_thresh=nms_thresh,
            valid_thresh=0.01,
            topk=-1,  # candidates are already the top-k...
            presorted=True,  # ...in descending-score order
            post_nms=post_nms,
            force_suppress=force_suppress,
        )
    else:
        result = cands[:, : post_nms if post_nms > 0 else cands.shape[1]]
    return result[..., 0:1], result[..., 1:2], result[..., 2:6]


def postprocess(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    nms_thresh: float = 0.45,
    nms_topk: int = 400,
    post_nms: int = 100,
    force_suppress: bool = False,
    approx_recall: Optional[float] = None,
):
    """Candidates -> NMS -> (ids (B,P,1), scores (B,P,1), bboxes (B,P,4)).
    nms_thresh outside (0, 1) disables NMS; nms_topk <= 0 takes every (box,
    class) pair as a candidate."""
    topk = nms_topk if nms_topk > 0 else boxes.shape[1] * scores.shape[-1]
    cands = select_topk_candidates(boxes, scores, topk=topk, approx_recall=approx_recall)
    return _nms_tail(cands, nms_thresh, post_nms, force_suppress)


def postprocess_levels(
    level_outs,
    nms_thresh: float = 0.45,
    nms_topk: int = 400,
    post_nms: int = 100,
    force_suppress: bool = False,
):
    """Per-FPN-level candidate selection + NMS over `return_levels` output:
    each level's top-K pool, then the top-K of the merged pools (exact
    modulo ties at the K-th value)."""
    pools = [select_topk_candidates(b, s, topk=nms_topk) for b, s in level_outs]
    merged = torch.cat(pools, dim=1)  # (B, levels*K, 6)
    k = min(nms_topk, merged.shape[1])
    _, idx = torch.topk(merged[..., 1], k, dim=-1)
    cands = torch.gather(merged, 1, idx[..., None].expand(-1, -1, 6))
    return _nms_tail(cands, nms_thresh, post_nms, force_suppress)


def postprocess_tout(boxes: torch.Tensor, scores: torch.Tensor, **kwargs):
    """`postprocess` that also takes per-timestep outputs (models/yolo3.py:416-448):
    (B, T, N, ...) boxes and scores fold T into the batch for the top-k and
    NMS, and the detections unfold to (B, T, P, ...).  (B, N, ...) inputs
    go straight to `postprocess`; `kwargs` are its keywords."""
    if boxes.dim() == 4:
        b, t = boxes.shape[:2]
        dets = postprocess(boxes.flatten(0, 1), scores.flatten(0, 1), **kwargs)
        return tuple(a.reshape((b, t) + a.shape[1:]) for a in dets)
    return postprocess(boxes, scores, **kwargs)
