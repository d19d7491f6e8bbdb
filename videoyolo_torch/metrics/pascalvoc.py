"""Pascal VOC mAP metrics (a numpy copy of videoyolo_tpu/metrics/pascalvoc.py:32-190).

  * `VOCMApMetric`: streaming per-class buffers, greedy IoU matching with
    difficult handling, integrated AP, cross-dataset `class_map`;
  * `VOC07MApMetric`: 11-point interpolated AP;
  * `VOCMApMetricTemporal`: one VOCMApMetric per timestep of a window, for
    per-timestep (t_out) outputs.

Protocol: reset() / update(preds, gts) / get() -> (names, values), fed with
numpy arrays (post-NMS detections brought to the host).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

from ..ops.bbox import np_bbox_iou

__all__ = ["VOCMApMetric", "VOC07MApMetric", "VOCMApMetricTemporal"]


def _as_numpy(x):
    if isinstance(x, (list, tuple)):
        # keep per-image None (missing difficult flags) as None — asarray
        # would wrap it into a 0-d object array and defeat the `is None` check
        return [None if a is None else np.asarray(a) for a in x]
    return np.asarray(x)


def _match_class(pred_boxes, pred_scores, gt_boxes, gt_difficult, iou_thresh):
    """Greedy VOC matching for one class of one image, vectorised.

    Predictions are processed in descending score order; each is assigned
    its max-IoU ground truth when IoU >= thresh.  Match codes per the VOC
    protocol:  1 = first claim of a non-difficult gt (TP), 0 = no gt / low
    IoU / gt already claimed (FP), -1 = assigned to a difficult gt (ignored).

    Returns (scores_sorted, match_codes) aligned arrays.
    """
    order = np.argsort(-pred_scores, kind="stable")
    boxes = pred_boxes[order]
    scores = pred_scores[order]
    n = len(boxes)
    if n == 0:
        return scores, np.zeros(0, np.int8)
    match = np.zeros(n, np.int8)
    if len(gt_boxes) == 0:
        return scores, match

    iou = np_bbox_iou(boxes, gt_boxes)
    gt_idx = iou.argmax(axis=1)
    assigned = iou[np.arange(n), gt_idx] >= iou_thresh

    # every claim of a difficult gt is ignored, first or not (difficulty is
    # a property of the gt, so order within that gt never matters)
    difficult = assigned & (gt_difficult[gt_idx] != 0)
    match[difficult] = -1

    # among the rest, the highest-scored claim of each gt is the TP; later
    # claims of the same gt are FPs.  The array is already in score order,
    # so np.unique's return_index IS the first-claim index per gt.
    masked_idx = np.where(assigned, gt_idx, -1)
    uniq, first = np.unique(masked_idx, return_index=True)
    wins = np.zeros(n, bool)
    wins[first[uniq >= 0]] = True
    match[wins & assigned & ~difficult] = 1
    return scores, match


class VOCMApMetric:
    """Mean AP for detection with VOC-style greedy matching."""

    def __init__(self, iou_thresh: float = 0.5, class_names: Optional[Sequence[str]] = None,
                 class_map: Optional[Sequence[int]] = None):
        self.iou_thresh = iou_thresh
        self.class_names = list(class_names) if class_names is not None else None
        self.class_map = class_map
        if self.class_names is None:
            self.name = "VOCMeanAP"
            self.num = None
        else:
            self.name = self.class_names + ["mAP"]
            self.num = len(self.class_names) + 1
        self.reset()

    # --- streaming state ------------------------------------------------

    def reset(self):
        self._n_pos = defaultdict(int)
        self._score = defaultdict(list)  # per-class list of array chunks
        self._match = defaultdict(list)

    def update(self, pred_bboxes, pred_labels, pred_scores,
               gt_bboxes, gt_labels, gt_difficults=None, **kwargs):
        """All args (B, N, ...) arrays or lists of per-image arrays; -1 rows
        are padding."""
        if gt_difficults is None:
            gt_difficults = [None] * len(_as_numpy(gt_labels))

        args = [_as_numpy(x) for x in
                (pred_bboxes, pred_labels, pred_scores, gt_bboxes, gt_labels, gt_difficults)]
        for p_box, p_lab, p_sc, g_box, g_lab, g_dif in zip(*args):
            keep = np.flatnonzero(p_lab.reshape(-1) >= 0)
            p_box = p_box.reshape(-1, p_box.shape[-1])[keep]
            p_lab = p_lab.reshape(-1)[keep].astype(int)
            p_sc = p_sc.reshape(-1)[keep]

            g_lab = g_lab.reshape(-1)
            if self.class_map is not None:
                cmap = np.asarray(self.class_map)
                g_lab = np.where(g_lab >= 0, cmap[g_lab.astype(int)], g_lab)
            keep = np.flatnonzero(g_lab >= 0)
            g_box = g_box.reshape(-1, g_box.shape[-1])[keep]
            g_lab = g_lab[keep].astype(int)
            g_dif = (
                np.zeros(len(keep)) if g_dif is None else g_dif.reshape(-1)[keep]
            )

            for cls in np.unique(np.concatenate([p_lab, g_lab])):
                pm, gm = p_lab == cls, g_lab == cls
                self._n_pos[cls] += int((g_dif[gm] == 0).sum())
                scores, codes = _match_class(
                    p_box[pm], p_sc[pm], g_box[gm], g_dif[gm], self.iou_thresh
                )
                self._score[cls].append(scores)
                self._match[cls].append(codes)

    # --- results ----------------------------------------------------------

    def _class_ap(self, cls):
        """(recall, precision, AP) for one class from the streamed chunks."""
        scores = np.concatenate(self._score[cls]) if self._score[cls] else np.zeros(0)
        codes = np.concatenate(self._match[cls]) if self._match[cls] else np.zeros(0, np.int8)
        order = np.argsort(-scores, kind="stable")
        codes = codes[order]
        tp = np.cumsum(codes == 1)
        fp = np.cumsum(codes == 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = tp / (tp + fp)
        rec = tp / self._n_pos[cls] if self._n_pos[cls] > 0 else None
        if rec is None:
            return None, prec, np.nan
        return rec, prec, self._average_precision(rec, prec)

    def _average_precision(self, rec, prec):
        """Area under the interpolated PR curve (VOC >=2010 style)."""
        mrec = np.concatenate(([0.0], rec, [1.0]))
        mpre = np.concatenate(([0.0], np.nan_to_num(prec), [0.0]))
        # interpolate: precision at recall r = max precision at recall >= r
        mpre = np.maximum.accumulate(mpre[::-1])[::-1]
        steps = np.flatnonzero(np.diff(mrec))
        return float(np.sum((mrec[steps + 1] - mrec[steps]) * mpre[steps + 1]))

    def get(self):
        aps = {cls: self._class_ap(cls)[2] for cls in self._n_pos}
        mean_ap = float(np.nanmean(list(aps.values()))) if aps else float("nan")
        if self.num is None:
            return (self.name, mean_ap)
        names = [str(n) for n in self.name]
        per_class = [aps.get(i, float("nan")) for i in range(self.num - 1)]
        if self.class_map:
            # cross-dataset eval: class i of this metric reads the AP of the
            # model-space class it maps to
            per_class = [
                float("nan") if self.class_map[i] < 0 else aps.get(self.class_map[i], float("nan"))
                for i in range(self.num - 1)
            ]
        return names, per_class + [mean_ap]


class VOC07MApMetric(VOCMApMetric):
    """11-point interpolated AP."""

    def _average_precision(self, rec, prec):
        prec = np.nan_to_num(prec)
        total = 0.0
        for t in np.linspace(0.0, 1.0, 11):
            above = prec[rec >= t]
            total += float(above.max()) if above.size else 0.0
        return total / 11.0


class VOCMApMetricTemporal:
    """Per-timestep VOC mAP (videoyolo_tpu/metrics/pascalvoc.py:193-232):
    one VOCMApMetric a timestep t of the window.  `update` takes length-t
    lists of per-timestep batch arrays, `update_t` one timestep's; `get`
    names each value `t{i}:<name>`."""

    def __init__(self, t: int, iou_thresh: float = 0.5, class_names=None, class_map=None):
        self._t = t
        self._metrics = [VOCMApMetric(iou_thresh=iou_thresh, class_names=class_names, class_map=class_map)
                         for _ in range(t)]

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update_t(self, t_idx: int, *args, **kwargs):
        self._metrics[t_idx].update(*args, **kwargs)

    def update(self, pred_bboxes, pred_labels, pred_scores, gt_bboxes, gt_labels, gt_difficults=None):
        for ti in range(self._t):
            self._metrics[ti].update(pred_bboxes[ti], pred_labels[ti], pred_scores[ti], gt_bboxes[ti], gt_labels[ti],
                                     None if gt_difficults is None else gt_difficults[ti])

    def get(self):
        names, values = [], []
        for ti, m in enumerate(self._metrics):
            n, v = m.get()
            if isinstance(n, list):
                names += [f"t{ti}:{x}" for x in n]
                values += list(v)
            else:
                names.append(f"t{ti}:{n}")
                values.append(v)
        return names, values
