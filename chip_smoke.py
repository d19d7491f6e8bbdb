#!/usr/bin/env python3
"""Drive the PyTorch port's detect paths on one NVIDIA card and hold its
kernels against their plain PyTorch versions.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card

Phases; any failure exits non-zero:
  1. device: the card's name and power limit, torch and CUDA versions, the
     TF32 switches (set off, so float32 means float32);
  2. build: the NMS kernel (videoyolo_torch/csrc/nms.cu), the cost-volume
     kernel (videoyolo_torch/csrc/correlation.cu) and the int8 conv kernels
     (videoyolo_torch/csrc/int8_conv.cu: K3 and the direct int8 cell), one
     nvcc each, started together, for sm_90a; no cost-volume instance that
     the plan gives a case of CORR_CASES may spill, and the main path's
     instances must hold 16-byte shared loads and 16-byte cp.async copies
     in their SASS;
  3. kernels vs plain, on the card: the NMS kernels (a mask launch and a
     scan launch a call) against ops/nms.py:nms_greedy_plain at the main
     path's shape and on edge cases, K above the old cap of 1,024 up to 8,192
     among them, a K that is no multiple of 64, an image with no valid row
     and an IoU exactly at the threshold (keep masks and packed rows, with
     and without the keep mask written, equal bit for bit); then K1's time
     at B=128 and B=1 on synthetic candidates, per call and with the launch
     queue kept full, and each launch alone; the cost-volume kernel against
     ops/correlation.py:correlation_plain in float32 at the three levels of
     slice 2 and on edge cases, the register tile's ragged edges among them
     (allclose rtol=atol=1e-5: the same products, summed over C in another
     order); K3 and the int8 conv kernel against
     ops/int8_conv.py's plain versions, bit for bit, at K3's four 416-px
     cells, at every cell kind of the int8 model and on edge cases that
     reach each route's ragged edges (a mismatch names its first differing
     output pixel and channel); the SASS of the int8 library must hold
     128-bit global stores in every route's kernels;
  4. slice 1: Detector(YoloConfig(num_classes=20, pad_stem=True), bf16) at
     416 px with seeded random weights answers requests of B=1, 8 and 128;
     the NMS kernel's launch count must rise by one per request, the outputs
     must be in range, and the B=128 detections must equal the plain NMS's
     on the same candidates; K1's times on the model's candidates at B=128
     and B=1; `postprocess(nms_topk=-1)` on the model's outputs at 64 px
     (5,040 candidates an image, B=2) on the card against the same call on
     the CPU; then the detect step's times, and one request through the
     entry point `python -m videoyolo_torch.detect`;
  5. slice 2: Detector(YoloConfig(num_classes=20, k=3, k_join_pos="late",
     corr_pos="early", corr_d=4), bf16) at 416 px with seeded random weights
     answers requests of B=1, 8 and 32 windows of 3 frames; the cost-volume
     kernel must launch 6 times per request and the NMS kernel once, the
     outputs must be in range, the kernel must match its plain version on
     the model's own routes (and round to the same bf16 or its neighbour),
     and the bf16 head on the kernel's routes must agree with the head on
     the plain version's routes within a stated tolerance; then the step's
     times, the kernel's time per level against its plain version and its
     bound with the level's plan (R, group, CTAs, live share), and one
     request through the entry point with the temporal flags;
  6. slice 3: Detector(YoloConfig(num_classes=20, pad_stem=True), bf16,
     quantize="int8") at 416 px with seeded random weights calibrated on 8
     seeded images answers requests of B=1, 8 and 128 with ds_conv="pallas"
     and B=128 with "direct"; per request K3 must launch 4 times and the
     int8 conv kernel 68 ("pallas"), or 0 and 72 ("direct"), and the NMS
     kernel once, each int8 launch on the route its shape calls for
     (ROUTE_LAUNCHES); every int8 cell output, route and bf16 tip of two images
     of the B=8 request must equal the same model's on the CPU with the plain
     versions bit for bit, and the B=128 detections the plain NMS's; then
     the step's times in both modes, K3's time per cell and the int8 conv
     kernel's per request against their bounds and plain versions (and
     torch._int_mm on the 1x1 cells), a table per class of cells (kernel
     ms, bound ms, route), and one request through the entry point with
     --quantize int8;
  7. reference: the same weights in float32 on the card and on the CPU agree
     on a small input, for slices 1, 2 and 3 (slice 3: every int8 tensor
     equal);
  8. profile: the device's busy share and top kernels of slice 1's step at
     B=128 and B=1, of slice 2's at B=32 and of slice 3's at B=128;
  9. slice 4, training (the detectors of phases 4-6 freed first): the train
     step of YOLOv3(num_classes=20, bf16, s2d_stem=True) at 416 px, B=48,
     uint8 pixels with per-image color maps and gt padded to 56 rows (the
     JAX package's timed step, bench.py:368-410) from a seeded init: images/s
     as the median of 10 steps after 3 warm ones (CUDA events), the peak
     memory, one profiled step (idle share, top device ops), and the same
     step with the standard stem; one float32 step of the same model at
     128 px, B=4 on the card and on the CPU from the same weights and batch
     (losses, each leaf's update and the BN statistics within the stated
     TRAIN_TOL); the overfit run of `videoyolo_torch.overfit` (bf16, 160 px,
     B=8, 400 steps), which must pass the JAX package's rule; its checkpoint
     written by `save_params`, loaded into a fresh model, whose eval step's
     detections must equal the trained model's bit for bit, K1 launched once
     an eval (counted); then a profiled overfit step (device ops a step, the
     host's share).
The line before last lists every kernel; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from videoyolo_torch import detect, overfit
from videoyolo_torch.data.transforms import MEAN, STD, to_normalized
from videoyolo_torch.models.factory import YoloConfig
from videoyolo_torch.models.layers import ConvBNLeaky, QTensor, QuantResidual, init_weights
from videoyolo_torch.models.yolo3 import YOLOv3, postprocess, select_topk_candidates
from videoyolo_torch.ops import correlation_kernel, cuda_build, int8_conv_kernel, nms_kernel
from videoyolo_torch.ops.correlation import correlation_plain, num_corr_channels
from videoyolo_torch.ops.correlation_kernel import cost_volume
from videoyolo_torch.ops.int8_conv import int8_conv_plain, quant_downsample_plain
from videoyolo_torch.ops.int8_conv_kernel import int8_conv, quant_downsample
from videoyolo_torch.ops.quantize import replace_quant
from videoyolo_torch.ops.nms import nms_greedy_plain
from videoyolo_torch.ops.nms_kernel import nms_greedy
from videoyolo_torch.profiling import cuda_time_ms, queued_ms
from videoyolo_torch.serving import NMS_THRESH, NMS_TOPK, Detector
from videoyolo_torch.train.checkpoint import load_into, load_variables
from videoyolo_torch.train.lr import lr_schedule
from videoyolo_torch.train.step import create_train_state, make_eval_step, make_train_step

SIZE = 416
NUM_CLASSES = 20
POST_NMS = 100
VALID_THRESH = 0.01
REQUEST_BATCHES = (1, 8, 128)
# slice 2: windows of 3 frames, the correlation on the routes (d=4)
WINDOW = 3
SLICE2 = dict(num_classes=NUM_CLASSES, k=WINDOW, k_join_pos="late", corr_pos="early", corr_d=4)
WINDOW_BATCHES = (1, 8, 32)
CORR_LAUNCHES = 6  # per request: two cost volumes at each of three levels
CORR_TOL = dict(rtol=1e-5, atol=1e-5)  # the same products, summed over C in another order
# slice 2, kernel vs plain correlation under the bf16 model.  The head sees
# the routes in bf16, where the two differ only where a float32 value lies
# within its rounding difference of a bf16 rounding step: such a value
# lands on the neighbouring bf16 (checked exactly).  The random weights'
# head amplifies each such step (its activations grow through the blocks;
# raw boxes reach 1e12 px), so many outputs move a little.  Tolerances on
# the max and the mean abs difference, boxes clipped to the image as the
# Detector returns them; measured at about 2.5x (max) and 5x (mean) below
HEAD_TOL = dict(boxes=dict(max=64.0, mean=0.2), scores=dict(max=0.1, mean=1e-3))
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# float operations per box (2 sub, 2 clamp, mul) and per IoU pair (2 max,
# 2 min, 2 sub, 2 clamp, mul, add, sub, max, div, compare)
AREA_OPS = 5
IOU_OPS = 14
INT8_OPS = 1979e12  # dense int8 tensor-core peak
# K3 (videoyolo_tpu/ops/pallas_conv.py:116): the int8 3x3/s2 downsample cells
# it takes in the 416-px int8 detect step (input rows <= 208,
# videoyolo_tpu/models/layers.py:149-160), as (input H = W, C, F)
K3_CELLS = ((208, 64, 128), (104, 128, 256), (52, 256, 512), (26, 512, 1024))
# slice 3: fused-int8 YOLOv3 in bf16, calibrated on 8 seeded images
CALIB_IMAGES = 8
# (K3, int8 conv, NMS) launches per request
INT8_LAUNCHES = {"pallas": (4, 68, 1), "direct": (0, 72, 1)}
# the same by route, (K3's, the int8 conv's): the stem (C = 4) takes
# mma_word, every other cell wgmma
ROUTE_LAUNCHES = {"pallas": ({"wgmma": 4}, {"wgmma": 67, "mma_word": 1}),
                  "direct": ({}, {"wgmma": 71, "mma_word": 1})}
CPU_IMAGES = 8  # images of the B=8 request held against the CPU model: all of them
# the int8 conv kernel on the card: (name, B, H, C, F, kernel, stride), one
# case per cell kind of the model, then edge cases
CONV_CASES = [
    ("stem_416x416x4_k3", 8, 416, 4, 32, 3, 1),
    ("downsample_416x416x32_k3s2", 8, 416, 32, 64, 3, 2),
    ("expand_208x208x32_k3", 8, 208, 32, 64, 3, 1),
    ("reduce_52x52x256_k1", 8, 52, 256, 128, 1, 1),
    ("head_26x26x768_k1", 8, 26, 768, 256, 1, 1),
    ("tip_13x13x512_k3", 8, 13, 512, 1024, 3, 1),
    ("B1_13x13x1024_k1", 1, 13, 1024, 512, 1, 1),
    ("C3_F40_k3", 2, 40, 3, 40, 3, 1),
    ("C8_k1", 2, 26, 8, 16, 1, 1),
    ("F75_k1", 2, 13, 64, 75, 1, 1),
    ("C16_F40_k3", 2, 26, 16, 40, 3, 1),
    ("deep_13x13x1024_F1024_k1", 8, 13, 1024, 1024, 1, 1),
    ("stage1_208x208x64_F32_k1", 2, 208, 64, 32, 1, 1),
    ("C144_F130_k3", 2, 13, 144, 130, 3, 1),
]
# K3 edge cases: (name, B, H, C, F)
K3_EDGE = [("B1_26x26x512", 1, 26, 512, 1024), ("C3_F5", 2, 26, 3, 5), ("C4_F24", 2, 26, 4, 24),
           ("F40", 2, 52, 64, 40)]


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def candidates(rs, b, k, classes=NUM_CLASSES):
    """(B, K, 6) score-descending rows over a 416-px image, from numpy."""
    scores = np.sort(rs.rand(b, k))[:, ::-1].astype(np.float32)
    ids = rs.randint(0, classes, (b, k)).astype(np.float32)
    xy = rs.rand(b, k, 2).astype(np.float32) * 0.8 * SIZE
    wh = rs.rand(b, k, 2).astype(np.float32) * 150 + 4
    return np.concatenate([ids[..., None], scores[..., None], xy, xy + wh], -1)


def kernel_cases(rs):
    main = candidates(rs, 128, 400)
    low = candidates(rs, 16, 400)
    low[:, 300:, 1] = 0.005
    low[:, 250, 1] = np.float32(VALID_THRESH)  # at the threshold: invalid
    neg = candidates(rs, 16, 400)
    neg[:, ::7, 0] = -1.0
    same = candidates(rs, 8, 400)
    same[:, :, 2:6] = same[:, :1, 2:6]
    none = candidates(rs, 4, 400)
    none[1, :, 1] = 0.005  # image 1: every score below the threshold
    none[2, :, 0] = -1.0  # image 2: every id invalid
    # two boxes of area 2 overlapping in area 1: IoU 1/3 exactly, which does
    # not suppress at a threshold of float32(1/3) (strict >)
    third = np.array([[[0, 0.9, 0, 0, 2, 1], [0, 0.8, 1, 0, 3, 1]]], np.float32)
    # (name, dets, post_nms, force_suppress, overlap threshold)
    return [
        ("main_B128_K400", main, POST_NMS, False, NMS_THRESH),
        ("force_suppress", candidates(rs, 16, 400), POST_NMS, True, NMS_THRESH),
        ("below_valid_thresh", low, -1, False, NMS_THRESH),
        ("negative_ids", neg, POST_NMS, False, NMS_THRESH),
        ("no_valid_row", none, POST_NMS, False, NMS_THRESH),
        ("K1", candidates(rs, 4, 1), POST_NMS, False, NMS_THRESH),
        ("K45", candidates(rs, 8, 45, classes=3), -1, False, NMS_THRESH),
        ("K1000_3_classes", candidates(rs, 4, 1000, classes=3), POST_NMS, False, NMS_THRESH),
        ("K1024", candidates(rs, 8, 1024), -1, False, NMS_THRESH),
        ("K1024_force", candidates(rs, 4, 1024), POST_NMS, True, NMS_THRESH),
        ("K1025", candidates(rs, 4, 1025), -1, False, NMS_THRESH),
        ("K1025_force", candidates(rs, 4, 1025), POST_NMS, True, NMS_THRESH),
        ("K2048", candidates(rs, 2, 2048), POST_NMS, False, NMS_THRESH),
        ("K2048_force", candidates(rs, 2, 2048), -1, True, NMS_THRESH),
        ("K8192_B1", candidates(rs, 1, 8192), POST_NMS, False, NMS_THRESH),
        ("identical_boxes", same, -1, False, NMS_THRESH),
        ("identical_boxes_force", same, POST_NMS, True, NMS_THRESH),
        ("iou_at_threshold", third, -1, False, float(np.float32(1 / 3))),
        ("iou_above_threshold", third, -1, False, float(np.nextafter(np.float32(1 / 3), np.float32(0)))),
    ]


# (name, B, H, W, C, d, stride2): the three levels of slice 2 at B=32, then
# edge cases; every pair is two frames of a (B, 3, H, W, C) window, taken by
# their batch stride as the Corr layer passes them
CORR_CASES = [
    ("level1_52x52x256", 32, 52, 52, 256, 4, 1),
    ("level2_26x26x512", 32, 26, 26, 512, 4, 1),
    ("level3_13x13x1024", 32, 13, 13, 1024, 4, 1),
    ("d2", 8, 26, 26, 512, 2, 1),
    ("d4_stride2", 8, 26, 26, 512, 4, 2),
    ("flownetc_d20_stride2", 4, 64, 64, 32, 20, 2),
    ("d0", 8, 26, 26, 512, 0, 1),
    ("B1", 1, 52, 52, 256, 4, 1),
    ("13x11", 4, 13, 11, 64, 4, 1),
    ("C1", 4, 20, 20, 1, 4, 1),
    ("C3", 4, 20, 20, 3, 4, 1),
    # the register tile's ragged edges: W not a multiple of R or of the tile,
    # C = 4 (one 16-byte unit), 6 (4-byte copies) and 1028 (a last chunk of
    # 4), a ragged last group of displacement columns (steps 11 in groups of
    # 7), one image of the smallest level
    ("W50", 4, 50, 50, 64, 4, 1),
    ("C4", 4, 20, 20, 4, 4, 1),
    ("C6", 4, 20, 20, 6, 4, 1),
    ("C1028", 2, 13, 13, 1028, 4, 1),
    ("d5_ragged_group", 2, 26, 26, 64, 5, 1),
    ("B1_13x13x1024", 1, 13, 13, 1024, 4, 1),
]


def nms_bound(cands: torch.Tensor, m: int, force: bool, keep: bool):
    """Least time (ms) an H100 could take for the NMS of these candidates:
    bytes (each input read once, each output written once: the packed rows,
    and the keep mask when `keep`) over HBM bandwidth vs the float work these
    candidates need (areas, and the IoU of every upper-triangle pair that the
    class test lets through) over the float32 peak.  Returns (ms, "bytes" |
    "operations")."""
    b, k, _ = cands.shape
    nbytes = b * k * 6 * 4 + b * m * 6 * 4 + (b * k * 4 if keep else 0)
    ids = cands[..., 0]
    pairs = torch.ones(k, k, dtype=torch.bool, device=cands.device).triu(1)[None]
    if not force:
        pairs = pairs & (ids[:, :, None] == ids[:, None, :])
    ops = AREA_OPS * b * k + IOU_OPS * int(pairs.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def corr_times(b, h, w, c, d, stride2):
    """(bytes time, operations time) in ms of one cost volume on an H100:
    f1 and f2 read once and the (B, H, W, D) output written once, against a
    multiply and an add for every product whose f2 pixel lies inside the
    image (the zero padding needs none) and a divide per output."""
    steps = d // stride2
    offsets = [i * stride2 for i in range(-steps, steps + 1)]
    n_disp = len(offsets) ** 2
    nbytes = (2 * b * h * w * c + b * h * w * n_disp) * 4
    inside = sum(max(0, h - abs(dy)) for dy in offsets) * sum(max(0, w - abs(dx)) for dx in offsets)
    ops = 2 * b * c * inside + b * h * w * n_disp
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3


def int8_conv_times(b, h, w, c, f, k, stride, out_bytes=1):
    """(bytes time, operations time) in ms of one int8 conv (pad k // 2) on
    an H100: the int8 input, the (F, k, k, C) int8 weights, scale and bias
    read once and the output written once, against 2*k*k*C int8 operations
    per output value over the int8 peak."""
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1
    out = b * ho * wo * f
    nbytes = b * h * w * c + f * k * k * c + 8 * f + out * out_bytes
    return nbytes / HBM_BYTES_PER_S * 1e3, 2 * out * k * k * c / INT8_OPS * 1e3


def bound(times):
    """(ms, "bytes" | "operations") of launches whose (bytes ms, operations
    ms) are `times`: the sum of each launch's own bound (the larger of its
    two), since launches in sequence cannot overlap one bound by bytes with
    one bound by operations; named after the kind that binds most of it."""
    by_bytes = sum(tb for tb, to in times if tb >= to)
    by_ops = sum(to for tb, to in times if tb < to)
    return by_bytes + by_ops, ("bytes" if by_bytes >= by_ops else "operations")


def median_ms(fn, iters, warmup=3):
    return statistics.median(cuda_time_ms(fn, iters=iters, warmup=warmup))


def nms_times(d):
    """K1's times on score-sorted candidates `d` as the main path calls it
    (no keep mask written): `ms`, the median of CUDA events around each call
    (a call that the host launches slower than the card runs it shows the
    host's time); `queued_ms`, the device's time a call with the queue kept
    full; `mask_ms` and `scan_ms`, each launch alone, queued."""
    b, k, _ = d.shape
    pl = nms_kernel.plan(b, k)
    mask = torch.empty((b, k, pl.words), dtype=torch.int64, device=d.device)
    packed = torch.empty((b, min(POST_NMS, k), 6), device=d.device)
    stream = torch.cuda.current_stream().cuda_stream
    out = dict(ms=median_ms(lambda: nms_greedy(d, NMS_THRESH, VALID_THRESH, POST_NMS, return_keep=False), 50),
               queued_ms=queued_ms(lambda: nms_greedy(d, NMS_THRESH, VALID_THRESH, POST_NMS, return_keep=False)))
    out["mask_ms"] = queued_ms(lambda: nms_kernel.launch_mask(d, mask, pl, NMS_THRESH, False, stream))
    out["scan_ms"] = queued_ms(lambda: nms_kernel.launch_scan(d, mask, packed, None, pl, VALID_THRESH, stream))
    return out


def print_nms_times(label, d, t, card, plain_ms=None):
    b_ms, b_by = nms_bound(d, POST_NMS, False, keep=False)
    print(f"nms {label} B={d.shape[0]} K={d.shape[1]} on {card}: kernel {t['ms']:.4f} ms a call "
          f"({t['queued_ms']:.4f} queued: mask {t['mask_ms']:.4f} + scan {t['scan_ms']:.4f})"
          + (f", plain {plain_ms:.3f} ms" if plain_ms is not None else "")
          + f", bound {b_ms:.3g} ms ({b_by})")
    return b_ms, b_by


def plain_corr(corr, x):
    """The Corr layer (keep='all') with the plain correlation in the
    kernel's place: the time-folded frames, then each cost volume."""
    b, t, h, w, c = x.shape
    x32 = x.float()
    mid = t // 2
    vols = [correlation_plain(x32[:, i], x32[:, mid], corr.d, 1, 1, 1) for i in range(t) if i != mid]
    return torch.cat([x32.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)] + vols, dim=-1)


def bf16_steps(a, b):
    """How many bf16 rounding steps apart two float32 tensors round, per
    element (the bf16 bit patterns read as ordered integers)."""
    def ordered(x):
        bits = x.bfloat16().view(torch.int16).int()
        return torch.where(bits < 0, -32768 - bits, bits)
    return (ordered(a) - ordered(b)).abs()


def check_detections(label, outs, batches):
    """Range checks of a Detector's outputs (ids, scores, boxes per request)."""
    for (ids, sc, bb), b in zip(outs, batches):
        check(ids.shape == sc.shape == (b, POST_NMS, 1), f"{label} B={b}: ids/scores {tuple(ids.shape)}")
        check(bb.shape == (b, POST_NMS, 4), f"{label} B={b}: boxes {tuple(bb.shape)}")
        check(all(bool(torch.isfinite(t).all()) for t in (ids, sc, bb)), f"{label} B={b}: non-finite output")
        check(bool(((ids >= -1) & (ids < NUM_CLASSES) & (ids == ids.round())).all()), f"{label} B={b}: ids")
        kept = ids >= 0
        check(bool(((sc > VALID_THRESH) & (sc <= 1))[kept].all()), f"{label} B={b}: kept scores")
        check(bool((sc[~kept] == -1).all()), f"{label} B={b}: padding scores")
        check(bool(((bb >= 0) & (bb <= SIZE)).all()), f"{label} B={b}: boxes outside [0, {SIZE}]")
        n = int(kept.sum())
        check(n > 0, f"{label} B={b}: no detections")
        print(f"{label} request B={b}: {n} detections ({n / b:.1f} each), outputs in range")


def check_entry_point(preds, n):
    check(len(preds) == n, f"entry point: detections for {len(preds)} of {n} inputs")
    entries = [e for v in preds.values() for e in v]
    check(bool(entries) and all(
        0 <= e[0] < NUM_CLASSES and VALID_THRESH < e[1] <= 1 and all(0 <= v <= 1 for v in e[2:])
        for e in entries
    ), "entry point: detections out of range")
    return entries


def build_kernels():
    """Every kernel source, one nvcc each, started together.  Returns each
    wrapper module's (library, ptxas report)."""
    t0 = time.perf_counter()
    sources = (nms_kernel, correlation_kernel, int8_conv_kernel)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        builds = list(pool.map(lambda k: k.build(), sources))
    print(f"built {', '.join(lib.name for lib, _ in builds)} in {time.perf_counter() - t0:.1f} s")
    for lib, ptxas in builds:
        for line in ptxas.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling", "wgmma", "warning")):
                print(f"  ptxas {lib.name.split('_')[0]}: {line.strip()}")
    return dict(zip(sources, builds))


def check_corr_build(ptxas):
    """The cost-volume library: no ptxas spill in any kernel instance the
    plan gives a case of CORR_CASES, and 16-byte shared loads (LDS.128) and
    16-byte staging copies (LDGSTS ... .128) in the SASS of the main path's
    instances (the three levels, the first cases).  Returns the main path's
    instances."""
    plans = [correlation_kernel.plan(b, h, w, c, d, s2) for _, b, h, w, c, d, s2 in CORR_CASES]
    used = {(pl.r, pl.gx, pl.gy) for pl in plans}
    main = {(pl.r, pl.gx, pl.gy) for pl in plans[:3]}
    report = {}
    for name, body in re.findall(r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry function|\Z)", ptxas, re.S):
        inst = re.search(r"cost_volume_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        regs = re.search(r"Used (\d+) registers", body)
        if inst and spill and regs:
            report[tuple(map(int, inst.groups()))] = (int(regs.group(1)), int(spill.group(1)) + int(spill.group(2)))
    for inst in sorted(used):
        check(inst in report, f"cost volume ptxas: no report for the instance (R, GX, GY) = {inst}")
        regs, spilled = report[inst]
        check(spilled == 0, f"cost volume ptxas: the instance (R, GX, GY) = {inst} spills {spilled} bytes")
        print(f"cost volume instance (R, GX, GY) = {inst}{' (main path)' if inst in main else ''}: "
              f"{regs} registers, no spills")
    sass = cuda_build.sass(correlation_kernel.build()[0])
    kernels = re.findall(r"Function : (\S*cost_volume_kernelILi(\d+)ELi(\d+)ELi(\d+)E\S*)\n(.*?)(?=Function :|\Z)",
                         sass, re.S)
    seen = set()
    for name, r, gx, gy, body in kernels:
        inst = (int(r), int(gx), int(gy))
        if inst not in main:
            continue
        seen.add(inst)
        lines = [ln.strip() for ln in body.splitlines()]
        for pattern, what in ((r"\bLDS\.128\b", "a 16-byte shared load"),
                              (r"\bLDGSTS\.E[\w.]*\.128\b", "a 16-byte staging copy")):
            hits = [ln for ln in lines if re.search(pattern, ln)]
            check(hits, f"cost volume SASS: no {what} in the main path's instance {inst} ({name})")
            print(f"cost volume SASS, instance {inst}: {len(hits)}x {what}, e.g. {' '.join(hits[0].split()[:6])}")
    check(seen == main, f"cost volume SASS: main path instances {sorted(main)}, found {sorted(seen)}")
    return main


def check_int8_sass():
    """The int8 library's SASS: every kernel stores its output 16 bytes at a
    time (STG.E.128), and the wgmma route's kernels multiply with Hopper's
    warpgroup MMA (IGMMA).  Prints one line of each per route."""
    sass = cuda_build.sass(int8_conv_kernel.build()[0])
    kernels = re.findall(r"Function : (\S*int8_(?:conv|downsample)_kernelILi(\d)E\S*)\n(.*?)(?=Function :|\Z)",
                         sass, re.S)
    routes = {str(v): k for k, v in int8_conv_kernel.ROUTE_IDS.items()}
    check(kernels, "int8 SASS: no kernel found")
    shown = set()
    for name, route_id, body in kernels:
        route = routes[route_id]
        lines = [ln.strip() for ln in body.splitlines()]
        wanted = [("STG.E.128", "a 128-bit global store")] + ([("GMMA", "a warpgroup MMA")] if route == "wgmma" else [])
        for op, what in wanted:
            hits = [ln for ln in lines if op in ln]
            check(hits, f"int8 SASS: no {what} ({op}) in {name}")
            if (route, op) not in shown:
                shown.add((route, op))
                print(f"int8 SASS, route {route} ({name}): {' '.join(hits[0].split()[:6])}")
    print(f"int8 SASS: {len(kernels)} kernels, each with 128-bit global stores, the wgmma route's with IGMMA")


def first_difference(out, ref):
    """(output pixel m, channel n) of the first differing value of two
    (B, F, H, W) outputs, in NHWC order; None where none differs."""
    if out.shape != ref.shape:
        return None
    diff = (out != ref).permute(0, 2, 3, 1).reshape(-1, out.shape[1]).nonzero()
    return tuple(int(v) for v in diff[0]) if len(diff) else None


def check_nms_kernel(rs, dev, card):
    """Phase 3, NMS: bit for bit against the plain version; then K1's times
    on synthetic candidates at B=128 and B=1.  Returns (max abs error,
    cases, {"B128": times, "B1": times})."""
    max_err, kept = 0.0, {}
    cases = kernel_cases(rs)
    for name, dets, post, force, thresh in cases:
        d = torch.from_numpy(np.ascontiguousarray(dets)).to(dev)
        packed, keep = nms_greedy(d, thresh, VALID_THRESH, post, force)
        packed_only, no_keep = nms_greedy(d, thresh, VALID_THRESH, post, force, return_keep=False)
        ref_packed, ref_keep = nms_greedy_plain(d, thresh, VALID_THRESH, post, force)
        torch.cuda.synchronize()
        check(torch.equal(keep.bool(), ref_keep), f"{name}: keep masks differ")
        check(torch.equal(packed, ref_packed), f"{name}: packed rows differ")
        check(no_keep is None and torch.equal(packed_only, ref_packed),
              f"{name}: packed rows differ without the keep mask")
        max_err = max(max_err, float((packed - ref_packed).abs().max()))
        kept[name] = int(keep.sum())
        print(
            f"nms {name}: B={d.shape[0]} K={d.shape[1]} force={force}: "
            f"{float(keep.sum(1).float().mean()):.1f} kept/image, equal"
        )
    check((kept["iou_at_threshold"], kept["iou_above_threshold"]) == (2, 1),
          f"nms: IoU 1/3 must keep both boxes at float32(1/3) and one just below it, kept {kept}")
    # timed as the main path calls it (box_nms): no keep mask written
    d = torch.from_numpy(np.ascontiguousarray(cases[0][1])).to(dev)
    times = {}
    for label, x in (("B128", d), ("B1", d[:1].contiguous())):
        times[label] = nms_times(x)
        p_ms = median_ms(lambda: nms_greedy_plain(x, NMS_THRESH, VALID_THRESH, POST_NMS), 20)
        print_nms_times("synthetic", x, times[label], card, p_ms)
    return max_err, len(cases), times


def check_corr_kernel(dev):
    """Phase 3, cost volume: allclose to the plain version in float32 on
    every case of CORR_CASES.  Returns the max abs error."""
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for name, b, h, w, c, d, s2 in CORR_CASES:
        window = torch.randn(b, WINDOW, h, w, c, generator=gen, device=dev)
        f1, f2 = window[:, 0], window[:, 1]
        out = cost_volume(f1, f2, d, s2)
        ref = correlation_plain(f1, f2, d, 1, 1, s2)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(out.shape == ref.shape == (b, h, w, num_corr_channels(d, s2)),
              f"cost volume {name}: shape {tuple(out.shape)}")
        check(bool(torch.allclose(out, ref, **CORR_TOL)), f"cost volume {name}: max abs error {err}")
        max_err = max(max_err, err)
        print(f"cost volume {name}: B={b} {h}x{w}x{c} d={d} stride2={s2}: max abs error {err:.3g}, allclose")
    return max_err


def int8_case(gen, dev, b, h, c, f, k):
    """A random int8 cell on the card: input (B, C, H, H) and kernel (F, C,
    k, k) in channels_last memory, scale and bias as a calibrated cell has
    them (y about N(0, 1)), oscale 0.02 (a few percent of outputs clip)."""
    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    q = i8(b, h, h, c).permute(0, 3, 1, 2)
    qk = i8(f, k, k, c).permute(0, 3, 1, 2)
    # an int8 product of two uniform values has a standard deviation of ~5376
    scale = (torch.rand(f, generator=gen, device=dev) + 0.5) / (5376.0 * (k * k * c) ** 0.5)
    bias = torch.randn(f, generator=gen, device=dev) * 0.1
    return q, qk, scale, bias, torch.tensor(0.02, device=dev)


def check_int8_kernels(dev):
    """Phase 3, int8: K3 at its four 416-px cells (B=8) and edge cases, and
    the int8 conv kernel at each cell kind with each epilogue, bit for bit
    against the plain versions.  Returns (cases, K3's max abs error, the
    int8 conv's max abs error)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    n, errs = 0, [0.0, 0.0]
    k3 = [(f"{h}x{h}x{c}->{f}", 8, h, c, f) for h, c, f in K3_CELLS] + K3_EDGE
    for name, b, h, c, f in k3:
        q, qk, scale, bias, oscale = int8_case(gen, dev, b, h, c, f, 3)
        out = quant_downsample(q, qk, scale, bias, oscale)
        ref = quant_downsample_plain(q, qk, scale, bias, oscale)
        torch.cuda.synchronize()
        check(out.shape == ref.shape == (b, f, (h + 1) // 2, (h + 1) // 2), f"K3 {name}: shape {tuple(out.shape)}")
        check(torch.equal(out, ref), f"K3 {name}: {int((out != ref).sum())} values differ from the plain version, "
              f"the first at (m, n) = {first_difference(out, ref)}")
        errs[0] = max(errs[0], float((out.double() - ref.double()).abs().max()))
        n += 1
        print(f"K3 {name} B={b}: equal to the plain version bit for bit "
              f"({float((ref.abs() == 127).float().mean()):.4f} clipped)")
    for name, b, h, c, f, k, stride in CONV_CASES:
        q, qk, scale, bias, oscale = int8_case(gen, dev, b, h, c, f, k)
        for epi, kw in (("int8", dict(scale=scale, bias=bias, oscale=oscale)),
                        ("bf16", dict(scale=scale, bias=bias, out_dtype=torch.bfloat16)),
                        ("float32", dict(scale=scale, bias=bias)), ("int32", {})):
            out = int8_conv(q, qk, stride, **kw)
            ref = int8_conv_plain(q, qk, stride, **kw)
            torch.cuda.synchronize()
            check(out.dtype == ref.dtype and out.shape == ref.shape, f"int8 conv {name} {epi}: {out.dtype} {tuple(out.shape)}")
            check(torch.equal(out, ref), f"int8 conv {name} {epi}: {int((out != ref).sum())} values differ, "
                  f"the first at (m, n) = {first_difference(out, ref)}")
            errs[1] = max(errs[1], float((out.double() - ref.double()).abs().max()))
            n += 1
        pl = int8_conv_kernel.plan(b, h, h, c, f, k, stride,
                                   int8_conv_kernel.alignment(c, q.data_ptr(), qk.data_ptr()))
        print(f"int8 conv {name} B={b} stride {stride} ({pl.route}, BN={pl.bn}, BK={pl.bk}): int8 / bf16 / float32 / int32 "
              "epilogues equal to the plain version bit for bit")
    return n, errs[0], errs[1]


def check_all_pairs(det, rs, dev):
    """`postprocess(nms_topk=-1)`, every (box, class) pair a candidate, on
    the slice-1 model's outputs for two 64-px images (252 boxes x 20
    classes = 5,040 candidates an image), on the card and on the CPU.  The
    card's detections must equal the plain NMS's on the card's candidates,
    and the CPU's where the two top-k orders agree; where they differ, they
    may differ only in the order of tied scores (the top-k is exact modulo
    ties).  Returns the max abs error."""
    x = torch.from_numpy(rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)).to(dev)
    with torch.inference_mode():
        boxes, scores = det.model(to_normalized(x, dtype=det.dtype))
        k = boxes.shape[1] * scores.shape[-1]
        before = nms_greedy.launches
        ids, sc, bb = postprocess(boxes, scores, nms_thresh=NMS_THRESH, nms_topk=-1, post_nms=POST_NMS)
        launched = nms_greedy.launches - before
        cands = select_topk_candidates(boxes, scores, topk=k).cpu()
        boxes, scores = boxes.cpu(), scores.cpu()
        cpu = postprocess(boxes, scores, nms_thresh=NMS_THRESH, nms_topk=-1, post_nms=POST_NMS)
        cpu_cands = select_topk_candidates(boxes, scores, topk=k)
    check(k == 5040 and cands.shape == (2, k, 6) and launched == 1,
          f"all pairs: {k} candidates {tuple(cands.shape)}, {launched} NMS calls")
    ref, ref_keep = nms_greedy_plain(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
    card = torch.cat([ids, sc, bb], -1).cpu()
    check(torch.equal(card, ref), "all pairs: the card's detections differ from the plain NMS on its candidates")
    ties = sum(int(c[:, 1].numel() - c[:, 1].unique().numel()) for c in cands)
    if torch.equal(cands, cpu_cands):
        check(all(torch.equal(a.cpu(), b) for a, b in zip((ids, sc, bb), cpu)),
              "all pairs: the card's detections differ from the CPU's")
        agree = "the CPU's top-k order, and its detections"
    else:
        check(torch.equal(cands[..., 1], cpu_cands[..., 1]) and all(
            sorted(map(tuple, a.tolist())) == sorted(map(tuple, b.tolist())) for a, b in zip(cands, cpu_cands)),
            "all pairs: the card's candidates differ from the CPU's beyond the order of tied scores")
        agree = "the CPU's candidates up to the order of tied scores"
    print(f"all pairs at 64 px, B=2: {k} candidates an image ({ties} tied scores), one NMS call on the card; "
          f"{int(ref_keep.sum())} kept; detections equal the plain NMS's on the card's candidates; "
          f"candidates equal {agree}")
    return float((card - ref).abs().max())


def serve_slice1(rs, dev, card, nms_ms):
    """Phase 4.  Returns (detector, B=128 batch, B=1 batch, NMS launches,
    max abs error); K1's figures on the model's candidates go into
    `nms_ms`."""
    t0 = time.perf_counter()
    det = Detector(
        YoloConfig(num_classes=NUM_CLASSES, pad_stem=True), dtype=torch.bfloat16,
        data_shape=SIZE, device="cuda", seed=0,
    )
    print(f"Detector built on {det.device} in {time.perf_counter() - t0:.1f} s")
    requests = [rs.randint(0, 256, (b, SIZE, SIZE, 3)).astype(np.uint8) for b in REQUEST_BATCHES]
    nms_greedy.launches = 0
    outs = [det(x) for x in requests]
    torch.cuda.synchronize()
    launches = nms_greedy.launches
    check(launches == len(requests), f"NMS kernel launches {launches}, requests {len(requests)}")
    check_detections("slice 1", outs, REQUEST_BATCHES)
    print(f"NMS kernel launches over {len(requests)} requests: {launches}")

    # the B=128 request again, step by step: plain NMS on the same candidates
    x128 = torch.from_numpy(requests[-1]).to(dev)
    with torch.inference_mode():
        xn = to_normalized(x128, dtype=det.dtype)
        boxes, scores = det.model(xn)
        cands = select_topk_candidates(boxes, scores, topk=NMS_TOPK)
        packed, keep = nms_greedy(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
        ref_packed, ref_keep = nms_greedy_plain(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
    check(torch.equal(keep.bool(), ref_keep) and torch.equal(packed, ref_packed),
          "B=128 model candidates: kernel and plain NMS differ")
    ids, sc, bb = outs[-1]
    check(
        torch.equal(ids, ref_packed[..., 0:1]) and torch.equal(sc, ref_packed[..., 1:2])
        and torch.equal(bb, ref_packed[..., 2:6].clamp(0, SIZE)),
        "B=128 request: detections differ from the plain NMS on the same candidates",
    )
    max_err = float((packed - ref_packed).abs().max())
    print(f"B=128 request: detections equal the plain NMS's on the same candidates "
          f"({int(ref_keep.sum())} kept of {ref_keep.numel()})")

    t = nms_times(cands)
    p_ms = median_ms(lambda: nms_greedy_plain(cands, NMS_THRESH, VALID_THRESH, POST_NMS), 20)
    b_ms, b_by = print_nms_times("model candidates", cands, t, card, p_ms)
    k_ms = t["ms"]
    nms_ms.update(plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, **t)

    x1 = torch.from_numpy(requests[0]).to(dev)
    with torch.inference_mode():
        cands1 = select_topk_candidates(*det.model(to_normalized(x1, dtype=det.dtype)), topk=NMS_TOPK)
    t1 = nms_times(cands1)
    b1_ms, _ = print_nms_times("model candidates", cands1, t1, card)
    nms_ms["B1"] = dict(bound_ms=b1_ms, **t1)
    max_err = max(max_err, check_all_pairs(det, rs, dev))

    with torch.inference_mode():
        t_fwd = median_ms(lambda: det.model(xn), 10)
        t_sel = median_ms(lambda: select_topk_candidates(boxes, scores, topk=NMS_TOPK), 20)
    t128 = median_ms(lambda: det(x128), 10)
    t1 = median_ms(lambda: det(x1), 30, warmup=5)
    print(
        f"detect B=128 at {SIZE} px bf16 on {card}: {128 / t128 * 1e3:.1f} images/s "
        f"({t128:.3f} ms/batch: forward {t_fwd:.3f}, top-k select {t_sel:.3f}, "
        f"NMS kernel {k_ms:.4f})"
    )
    print(f"detect B=1 at {SIZE} px bf16 on {card}: {t1:.3f} ms/request")

    # the entry point, as a user runs it: one request of 8 images
    before = nms_greedy.launches
    preds = detect.main(["--data_shape", str(SIZE), "--batch_size", "8", "--num_requests", "1",
                         "--seed", "1", "--dtype", "bf16"])
    check(nms_greedy.launches - before == 1,
          f"entry point: {nms_greedy.launches - before} NMS kernel launches for 1 request")
    entries = check_entry_point(preds, 8)
    print(f"entry point: {len(entries)} normalised detections over 8 images, in range")
    return det, x128, x1, launches, max_err


def serve_slice2(rs, dev, card):
    """Phase 5.  Returns (detector, B=32 windows, cost-volume and NMS
    launches over the requests, the cost volume's figures, max abs error)."""
    t0 = time.perf_counter()
    det = Detector(YoloConfig(**SLICE2), dtype=torch.bfloat16, data_shape=SIZE, device="cuda", seed=0)
    print(f"slice 2 Detector built on {det.device} in {time.perf_counter() - t0:.1f} s")
    requests = [
        rs.randint(0, 256, (b, WINDOW, SIZE, SIZE, 3)).astype(np.uint8) for b in WINDOW_BATCHES
    ]
    cost_volume.launches = 0
    nms_greedy.launches = 0
    outs, made = [], []
    for x in requests:
        before = cost_volume.launches, nms_greedy.launches
        outs.append(det(x))
        made.append((cost_volume.launches - before[0], nms_greedy.launches - before[1]))
    torch.cuda.synchronize()
    corr_launches, nms_launches = cost_volume.launches, nms_greedy.launches
    check(all(m == (CORR_LAUNCHES, 1) for m in made),
          f"slice 2: launches (cost volume, NMS) per request {made}")
    check_detections("slice 2", outs, WINDOW_BATCHES)
    print(f"slice 2 kernel launches over {len(requests)} requests: cost volume {corr_launches}, "
          f"NMS {nms_launches}")

    # the B=32 request again, step by step: the kernel's routes against the
    # plain version's, and the head on each
    m = det.model
    x32 = torch.from_numpy(requests[-1]).to(dev)
    max_err = 0.0
    with torch.inference_mode():
        xn = to_normalized(x32, dtype=det.dtype)
        frames = m.frame_routes(xn)
        k_routes = [m.corr(r) for r in frames]
        p_routes = [plain_corr(m.corr, r) for r in frames]
        for level, (kr, pr) in enumerate(zip(k_routes, p_routes)):
            err = float((kr - pr).abs().max())
            check(bool(torch.allclose(kr, pr, **CORR_TOL)),
                  f"slice 2 level {level} routes: kernel vs plain max abs error {err}")
            max_err = max(max_err, err)
            print(f"slice 2 B=32 level {level} route {tuple(kr.shape)} float32: kernel vs plain "
                  f"max abs error {err:.3g}, allclose")
        steps = [bf16_steps(kr, pr) for kr, pr in zip(k_routes, p_routes)]
        flips = [int((st > 0).sum()) for st in steps]
        check(all(int(st.max()) <= 1 for st in steps),
              "slice 2 B=32 routes: a kernel value rounds more than one bf16 step from the plain one")
        print(f"slice 2 B=32 routes in bf16: {sum(flips)} of {sum(r.numel() for r in k_routes)} values "
              f"round to the neighbouring bf16 with the kernel (per level {flips}), the rest to the same")
        heads = [m.head(k_routes), m.head(p_routes)]
    for i, name in enumerate(("boxes", "scores")):
        kern, plain = (h[i].clamp(0, SIZE) if name == "boxes" else h[i] for h in heads)
        err = (kern - plain).abs()
        e_max, e_mean, tol = float(err.max()), float(err.mean()), HEAD_TOL[name]
        print(f"slice 2 B=32 {name} {tuple(kern.shape)}, kernel vs plain routes: max abs {e_max:.3g} "
              f"(tol {tol['max']}), mean abs {e_mean:.3g} (tol {tol['mean']}), "
              f"{float((err == 0).float().mean()):.4f} equal")
        check(e_max <= tol["max"] and e_mean <= tol["mean"],
              f"slice 2 B=32 {name}: kernel vs plain routes, max {e_max}, mean {e_mean}")

    # times: the step, the forward, and the kernel per level on the model's routes
    x1 = torch.from_numpy(requests[0]).to(dev)
    with torch.inference_mode():
        t_fwd = median_ms(lambda: m(xn), 10)
    t32 = median_ms(lambda: det(x32), 10)
    t1 = median_ms(lambda: det(x1), 30, warmup=5)
    levels = []
    for r in frames:
        b, _, h, w, c = r.shape
        with torch.inference_mode():
            f = r.float()  # the frames as the Corr layer hands them over
            f1, f2 = f[:, 0], f[:, 1]
            k_ms = median_ms(lambda: cost_volume(f1, f2, SLICE2["corr_d"], 1), 50)
            p_ms = median_ms(lambda: correlation_plain(f1, f2, SLICE2["corr_d"], 1, 1, 1), 10)
        t_bytes, t_ops = corr_times(b, h, w, c, SLICE2["corr_d"], 1)
        pl = correlation_kernel.plan(b, h, w, c, SLICE2["corr_d"], 1, correlation_kernel.aligned(f1, f2))
        levels.append(dict(shape=[b, h, w, c], ms=k_ms, plain_ms=p_ms, bytes_ms=t_bytes, ops_ms=t_ops,
                           plan=dict(r=pl.r, gx=pl.gx, gy=pl.gy, tile=list(pl.tile), threads=pl.threads,
                                     copy=pl.copy, ctas=pl.ctas, live=pl.live)))
        print(
            f"cost volume B={b} {h}x{w}x{c} d={SLICE2['corr_d']} on {card}: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.3f} ms, bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, "
            f"operations {t_ops:.4f}); plan R={pl.r}, group {pl.gy}x{pl.gx}, tile {pl.tile[0]}x{pl.tile[1]}, "
            f"{pl.threads} threads, {pl.copy}-byte copies, {pl.ctas} CTAs, {pl.live:.3f} of the pixel slots live"
        )
    per_request = 2  # two cost volumes per level and request
    figures = dict(
        ms=per_request * sum(lv["ms"] for lv in levels),
        plain_ms=per_request * sum(lv["plain_ms"] for lv in levels),
        bound_ms=per_request * sum(max(lv["bytes_ms"], lv["ops_ms"]) for lv in levels),
        bound_by=("bytes" if sum(lv["bytes_ms"] for lv in levels) >= sum(lv["ops_ms"] for lv in levels)
                  else "operations"),
        levels=levels,
    )
    print(
        f"slice 2 B=32 windows of {WINDOW} at {SIZE} px bf16 on {card}: {32 / t32 * 1e3:.1f} windows/s, "
        f"{32 * WINDOW / t32 * 1e3:.1f} frames/s ({t32:.3f} ms/request: forward {t_fwd:.3f}, "
        f"cost volume {figures['ms']:.4f} over {CORR_LAUNCHES} launches)"
    )
    print(f"slice 2 B=1 window at {SIZE} px bf16 on {card}: {t1:.3f} ms/request")

    # the entry point, as a user runs it: one request of 8 windows
    before = cost_volume.launches, nms_greedy.launches
    preds = detect.main(["--data_shape", str(SIZE), "--batch_size", "8", "--num_requests", "1",
                         "--seed", "1", "--dtype", "bf16", "--window", str(WINDOW), "--k_join_pos", "late",
                         "--corr_pos", "early", "--corr_d", str(SLICE2["corr_d"])])
    made = cost_volume.launches - before[0], nms_greedy.launches - before[1]
    check(made == (CORR_LAUNCHES, 1), f"slice 2 entry point: launches (cost volume, NMS) {made}")
    entries = check_entry_point(preds, 8)
    print(f"slice 2 entry point: {len(entries)} normalised detections over 8 windows, in range, "
          f"{made[0]} cost-volume and {made[1]} NMS launches")
    return det, x32, corr_launches, nms_launches, figures, max_err


def route_delta(kernel, before):
    """The launches by route of an int8 wrapper since `before`, those that
    moved."""
    return {r: n - before[r] for r, n in kernel.route_launches.items() if n != before[r]}


# the classes of int8 cells in the per-class table, by (kernel, stride, C,
# output dtype, K3)
def cell_class(cl, k3):
    b, h, w, c, f, k, s = cl["shape"]
    if k3:
        return "K3's cells, k3 s2"
    if c % 16 and k == 3:
        return f"stem, C {c}, k3"
    if s == 2:
        return "downsample, k3 s2 (direct)"
    if k == 1:
        return "1x1"
    return "3x3 s1, bf16 out (tips)" if cl["dtype"] == "bfloat16" else "3x3 s1, int8 out"


def class_table(conv_cells, k3_cells, card):
    """Per class of cells of one B=128 request: launches, kernel ms, bound
    ms (each launch's own, summed), route and N tiles.  Printed; returned as
    a list for the kernels line."""
    rows = {}
    for cells, k3 in ((conv_cells, False), (k3_cells, True)):
        for cl in cells:
            row = rows.setdefault(cell_class(cl, k3), dict(cells=0, ms=0.0, times=[], routes=set(), bn=set()))
            row["cells"] += 1
            row["ms"] += cl["ms"]
            row["times"].append(cl["times"])
            row["routes"].add(cl["route"])
            row["bn"].add(cl["bn"])
    table = []
    print(f"int8 cells by class at B=128 on {card}:")
    for name, row in rows.items():
        b_ms, b_by = bound(row["times"])
        entry = dict(cls=name, cells=row["cells"], ms=row["ms"], bound_ms=b_ms, bound_by=b_by,
                     routes=sorted(row["routes"]), bn=sorted(row["bn"]))
        table.append(entry)
        print(f"  {name:28s} {row['cells']:3d} cells  kernel {row['ms']:8.4f} ms  bound {b_ms:7.4f} ms ({b_by})  "
              f"{row['ms'] / b_ms:5.1f}x  route {'/'.join(entry['routes'])} BN {'/'.join(map(str, entry['bn']))}")
    return table


def cell_outputs(model, x):
    """Every int8 cell's and residual join's output of one forward, on the
    CPU, by module name (QTensors as (q, s))."""
    outs = {}

    def keep(name):
        def hook(_mod, _inp, out):
            outs[name] = (out.q.cpu(), out.s.cpu()) if isinstance(out, QTensor) else (out.cpu(), None)
        return hook

    hooks = [m.register_forward_hook(keep(n)) for n, m in model.named_modules()
             if isinstance(m, (ConvBNLeaky, QuantResidual))]
    try:
        with torch.inference_mode():
            result = model(x)
    finally:
        for h in hooks:
            h.remove()
    return outs, result


def cpu_twin(model):
    """The same int8 model on the CPU, where its convs run the plain
    versions."""
    twin = replace_quant(model, model.init_kwargs["quant"])
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    return twin.to(memory_format=torch.channels_last)


def compare_cells(label, card_outs, cpu_outs):
    check(card_outs.keys() == cpu_outs.keys() and len(card_outs) == 95,
          f"{label}: {len(card_outs)} cell outputs on the card, {len(cpu_outs)} on the CPU")
    for name, (a, sa) in card_outs.items():
        b, sb = cpu_outs[name]
        check(a.dtype == b.dtype and torch.equal(a, b) and (sa is None or torch.equal(sa, sb)),
              f"{label}: {name} differs between the card and the CPU")
    n_int8 = sum(a.dtype == torch.int8 for a, _ in card_outs.values())
    return n_int8, sum(a.numel() for a, _ in card_outs.values())


class CallRecorder:
    """Records the calls of a kernel wrapper in `module` during a block,
    passing them through (the wrapper counts its launches on the name it is
    bound to, so the count moves with it)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def record(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.orig(*args, **kwargs)

        record.launches = self.orig.launches
        record.route_launches = self.orig.route_launches  # one dict, counted in place
        self.record = record
        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        self.orig.launches = self.record.launches
        setattr(self.module, self.name, self.orig)


def serve_slice3(rs, dev, card):
    """Phase 6.  Returns (detector, B=128 batch, launches over the requests
    (K3, int8 conv, NMS), K3's figures, the int8 conv kernel's figures,
    cases compared)."""
    calib = [rs.randint(0, 256, (CALIB_IMAGES, SIZE, SIZE, 3)).astype(np.uint8)]
    dets = {}
    for ds in INT8_LAUNCHES:
        t0 = time.perf_counter()
        dets[ds] = Detector(
            YoloConfig(num_classes=NUM_CLASSES, pad_stem=True), dtype=torch.bfloat16, data_shape=SIZE,
            device="cuda", seed=0, quantize="int8", calibration=calib, ds_conv=ds,
        )
        torch.cuda.synchronize()
        print(f"slice 3 Detector (ds_conv={ds!r}) quantised and calibrated on {CALIB_IMAGES} images "
              f"on {dets[ds].device} in {time.perf_counter() - t0:.1f} s")
    states = [d.model.state_dict() for d in dets.values()]
    check(states[0].keys() == states[1].keys() and all(torch.equal(states[0][k], states[1][k]) for k in states[0]),
          "slice 3: the two calibrations gave different int8 models")
    requests = [rs.randint(0, 256, (b, SIZE, SIZE, 3)).astype(np.uint8) for b in REQUEST_BATCHES]
    runs = [("pallas", x) for x in requests] + [("direct", requests[-1])]
    counters = (quant_downsample, int8_conv, nms_greedy)
    for c in counters:
        c.launches = 0
    for c in counters[:2]:
        c.route_launches.update(dict.fromkeys(c.route_launches, 0))
    outs, made, routed = [], [], []
    for ds, x in runs:
        before = [c.launches for c in counters]
        routes_before = [dict(c.route_launches) for c in counters[:2]]
        outs.append(dets[ds](x))
        made.append(tuple(c.launches - b for c, b in zip(counters, before)))
        routed.append(tuple(route_delta(c, b) for c, b in zip(counters[:2], routes_before)))
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    route_launches = tuple(dict(c.route_launches) for c in counters[:2])
    check(made == [INT8_LAUNCHES[ds] for ds, _ in runs],
          f"slice 3: launches (K3, int8 conv, NMS) per request {made}")
    check(routed == [ROUTE_LAUNCHES[ds] for ds, _ in runs],
          f"slice 3: launches by route (K3, int8 conv) per request {routed}")
    check_detections("slice 3", outs[:3], REQUEST_BATCHES)
    check_detections("slice 3 direct", outs[3:], REQUEST_BATCHES[-1:])
    print(f"slice 3 kernel launches over {len(runs)} requests (B=1, 8, 128 with ds_conv='pallas', "
          f"B=128 with 'direct'): K3 {launches[0]}, int8 conv {launches[1]}, NMS {launches[2]}; "
          f"per request {made}; by route (K3, int8 conv) per request {routed}")

    # two images of the B=8 request: every cell output on the card against
    # the same model on the CPU (plain versions)
    det = dets["pallas"]
    with torch.inference_mode():
        x8 = det._normalized(torch.from_numpy(requests[1][:CPU_IMAGES]).to(dev))
    card_outs, _ = cell_outputs(det.model, x8)
    t0 = time.perf_counter()
    cpu_outs, _ = cell_outputs(cpu_twin(det.model), x8.cpu())
    n_int8, n_values = compare_cells("slice 3 B=8 request", card_outs, cpu_outs)
    print(f"slice 3 B=8 request, images 0-{CPU_IMAGES - 1} at {SIZE} px: all 95 cell and join outputs "
          f"({n_int8} int8, the 3 bf16 tips; {n_values} values, the routes among them) equal to the "
          f"CPU model's (plain versions, {time.perf_counter() - t0:.1f} s) bit for bit")

    # the B=128 request: the detections against the plain NMS on the same
    # candidates; the int8 convs' arguments, recorded for the timings
    x128 = torch.from_numpy(requests[-1]).to(dev)
    with torch.inference_mode(), CallRecorder(int8_conv_kernel, "int8_conv") as convs, \
            CallRecorder(int8_conv_kernel, "quant_downsample") as k3s:
        boxes, scores = det.model(det._normalized(x128))
        cands = select_topk_candidates(boxes, scores, topk=NMS_TOPK)
        ref_packed, _ = nms_greedy_plain(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
    ids, sc, bb = outs[2]
    check(torch.equal(ids, ref_packed[..., 0:1]) and torch.equal(sc, ref_packed[..., 1:2])
          and torch.equal(bb, ref_packed[..., 2:6].clamp(0, SIZE)),
          "slice 3 B=128 request: detections differ from the plain NMS on the same candidates")
    print("slice 3 B=128 request: detections equal the plain NMS's on the same candidates")
    check((len(k3s.calls), len(convs.calls)) == INT8_LAUNCHES["pallas"][:2], "slice 3: recorded calls")

    t128 = {ds: median_ms(lambda d=d: d(x128), 10) for ds, d in dets.items()}
    x1 = torch.from_numpy(requests[0]).to(dev)
    t1 = median_ms(lambda: det(x1), 30, warmup=5)
    for ds, ms in t128.items():
        print(f"slice 3 detect B=128 at {SIZE} px int8 (bf16 tips) ds_conv={ds!r} on {card}: "
              f"{128 / ms * 1e3:.1f} images/s ({ms:.3f} ms/request)")
    print(f"slice 3 detect B=1 at {SIZE} px int8 ds_conv='pallas' on {card}: {t1:.3f} ms/request")

    # K3 per cell and the int8 conv kernel per request, on the recorded
    # arguments, against their bounds and plain versions
    def figures(calls, kernel, plain, label):
        cells = []
        for args, kwargs in calls:
            q, qk = args[0], args[1]
            stride = 2 if kernel is int8_conv_kernel.quant_downsample else args[2]
            b, c, h, w = q.shape
            f, _, k, _ = qk.shape
            pl = int8_conv_kernel.plan(b, h, w, c, f, k, stride,
                                       int8_conv_kernel.alignment(c, q.data_ptr(), qk.data_ptr()))
            with torch.inference_mode():
                out = kernel(*args, **kwargs)
                ms = median_ms(lambda: kernel(*args, **kwargs), 5, warmup=2)
                p_ms = median_ms(lambda: plain(*args, **kwargs), 1, warmup=0)
            cells.append(dict(shape=[b, h, w, c, f, k, stride], ms=ms, plain_ms=p_ms, route=pl.route, bn=pl.bn,
                              dtype=str(out.dtype).split(".")[-1],
                              times=int8_conv_times(b, h, w, c, f, k, stride, out.element_size())))
        b_ms, b_by = bound([cl["times"] for cl in cells])
        fig = dict(ms=sum(cl["ms"] for cl in cells), plain_ms=sum(cl["plain_ms"] for cl in cells),
                   bound_ms=b_ms, bound_by=b_by)
        print(f"{label} at B=128 on {card}: {fig['ms']:.4f} ms per request over {len(cells)} launches, "
              f"plain {fig['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        return fig, cells

    k3, k3_cells = figures(k3s.calls, int8_conv_kernel.quant_downsample, quant_downsample_plain, "K3")
    for cl in k3_cells:
        b, h, w, c, f, _, _ = cl["shape"]
        c_ms, c_by = bound([cl["times"]])
        print(f"  K3 B={b} {h}x{w}x{c}->{f}: kernel {cl['ms']:.4f} ms, plain {cl['plain_ms']:.3f} ms, "
              f"bound {c_ms:.4f} ms ({c_by}), library: none (no PyTorch call computes a strided int8 conv "
              "on CUDA)")
    k3["cells"] = [dict(shape=cl["shape"][:5], ms=cl["ms"], plain_ms=cl["plain_ms"],
                        bound_ms=bound([cl["times"]])[0]) for cl in k3_cells]
    conv, conv_cells = figures(convs.calls, int8_conv_kernel.int8_conv, int8_conv_plain, "int8 conv kernel")
    ones = [(args, cl) for (args, _), cl in zip(convs.calls, conv_cells) if cl["shape"][5] == 1]
    int_mm = 0.0
    for args, _ in ones:
        q, qk = args[0], args[1]
        a = q.permute(0, 2, 3, 1).reshape(-1, q.shape[1])
        wt = qk.reshape(qk.shape[0], -1).t()
        int_mm += median_ms(lambda: torch._int_mm(a, wt), 5, warmup=2)
    conv.update(ms_1x1=sum(cl["ms"] for _, cl in ones), int_mm_1x1_ms=int_mm, cells_1x1=len(ones))
    print(f"  int8 conv kernel, its {len(ones)} 1x1 cells: {conv['ms_1x1']:.4f} ms; torch._int_mm on the "
          f"same products (int32 out, no epilogue): {int_mm:.4f} ms")
    for cl in sorted(conv_cells, key=lambda cl: -cl["ms"])[:5]:
        b, h, w, c, f, k, s = cl["shape"]
        print(f"  int8 conv top: B={b} {h}x{w}x{c}->{f} k{k} s{s} ({cl['route']}, BN={cl['bn']}): "
              f"{cl['ms']:.4f} ms (bound {bound([cl['times']])[0]:.4f} ms)")
    classes = class_table(conv_cells, k3_cells, card)
    conv.update(route_launches=route_launches[1], classes=classes)
    k3.update(route_launches=route_launches[0])

    # the entry point, as a user runs it: one request of 8 images, calibrated
    # on it (the first two request batches; there is one)
    before = [c.launches for c in counters]
    routes_before = dict(int8_conv.route_launches)
    preds = detect.main(["--data_shape", str(SIZE), "--batch_size", "8", "--num_requests", "1",
                         "--seed", "1", "--dtype", "bf16", "--quantize", "int8"])
    made = tuple(c.launches - b for c, b in zip(counters, before))
    check(made == (0, 2 * INT8_LAUNCHES["direct"][1], 1),
          f"slice 3 entry point: launches (K3, int8 conv, NMS) {made} for one calibration batch and one request")
    routed = route_delta(int8_conv, routes_before)
    check(routed == {r: 2 * n for r, n in ROUTE_LAUNCHES["direct"][1].items()},
          f"slice 3 entry point: int8 conv launches by route {routed}")
    entries = check_entry_point(preds, 8)
    print(f"slice 3 entry point (--quantize int8): {len(entries)} normalised detections over 8 images, in "
          f"range; launches (K3, int8 conv, NMS) {made}, int8 conv by route {routed}: one calibration pass and "
          "one request")
    return det, x128, launches, k3, conv, len(card_outs)


def check_reference(rs):
    """Phase 7: float32 on the card vs on the CPU, same weights."""
    small = torch.from_numpy(rs.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8))
    d32 = Detector(YoloConfig(num_classes=NUM_CLASSES, pad_stem=True), data_shape=128, device="cuda", seed=0,
                   quantize="int8", calibration=[small])
    with torch.inference_mode():
        x = d32._normalized(small.to("cuda"))
    card_outs, (_, card_scores) = cell_outputs(d32.model, x)
    cpu_outs, (_, cpu_scores) = cell_outputs(cpu_twin(d32.model), x.cpu())
    n_int8, _ = compare_cells("slice 3 float32 at 128 px", card_outs, cpu_outs)
    err = float((card_scores.cpu() - cpu_scores).abs().max())
    check(bool(torch.allclose(card_scores.cpu(), cpu_scores, rtol=1e-3, atol=1e-3)),
          f"slice 3 float32 scores on the card vs the CPU: max error {err}")
    print(f"reference slice 3: float32 int8 model at 128 px, card vs CPU: {n_int8} int8 cell outputs and the "
          f"float32 tips equal, scores max abs error {err:.3g} (allclose rtol=atol=1e-3: the prediction conv)")
    for label, cfg, shape in (
        ("slice 1", YoloConfig(num_classes=NUM_CLASSES, pad_stem=True), (2, 128, 128, 3)),
        ("slice 2", YoloConfig(**SLICE2), (1, WINDOW, 128, 128, 3)),
    ):
        small = torch.from_numpy(rs.randint(0, 256, shape).astype(np.uint8))
        raw = []
        for device in ("cuda", "cpu"):
            d32 = Detector(cfg, data_shape=128, device=device, seed=0)
            with torch.inference_mode():
                raw.append([t.cpu() for t in d32.model(to_normalized(small.to(device)))])
        for name, a, r in zip(("boxes", "scores"), raw[0], raw[1]):
            err = float((a - r).abs().max())
            check(bool(torch.allclose(a, r, rtol=1e-3, atol=1e-3)),
                  f"{label} float32 {name} on the card vs the CPU: max error {err}")
            print(f"reference {label}: float32 {name} card vs CPU at 128 px: max abs error {err:.3g} "
                  "(allclose rtol=atol=1e-3: other conv algorithms, other summation orders)")


def profile_steps(steps, card):
    """Phase 8: device busy share, launches and top kernels of each step."""
    from torch.profiler import ProfilerActivity, profile

    for label, det, x, n, top in steps:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                det(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        if busy_ms == 0:
            print(f"profile {label}: the profiler recorded no device time; busy share not measured")
            continue
        print(
            f"profile {label} x{n} on {card} (profiler on): wall {wall_ms / n:.3f} ms/step, "
            f"device busy {busy_ms / n:.3f} ms/step, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}, "
            f"{sum(e.count for e in events) // n} device ops/step"
        )
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
            print(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms/step  "
                  f"{e.count // n:4d}x  {e.key[:90]}")


TRAIN_BATCH = 48  # the JAX package's timed train step (bench.py:148)
TRAIN_ROWS = 56  # the loader's padded gt rows
OVERFIT_CLASSES = 3
# card vs CPU, one float32 train step at 128 px, B=4: other conv algorithms
# and summation orders, and BatchNorm in train mode amplifies rounding into
# some leaves' updates (on the CPU, that step in float32 lands up to 0.106
# of a leaf's largest update from the same step in float64, 0.005 in L2 over
# all leaves, the BN statistics within 2.2e-6)
TRAIN_TOL = dict(loss_rtol=1e-4, leaf=0.5, l2=0.05, stats_rtol=1e-3, stats_atol=1e-5)


def train_batch(rs, b, size, device):
    """The JAX package's timed train batch (bench.py:368-410): uint8 pixels,
    normalize-only (3, 4) color maps, gt row 0 [10, 10, 100, 100] class 1,
    padded to TRAIN_ROWS rows."""
    gtb = np.full((b, TRAIN_ROWS, 4), -1, np.float32)
    gti = np.full((b, TRAIN_ROWS, 1), -1, np.float32)
    gtb[:, 0] = [10, 10, 100, 100]
    gti[:, 0, 0] = 1
    mean = np.array(MEAN, np.float32) * 255.0
    std = np.array(STD, np.float32) * 255.0
    cmat = np.concatenate([np.diag(1.0 / std), (-mean / std)[:, None]], axis=1).astype(np.float32)
    batch = {"image": rs.randint(0, 255, (b, size, size, 3)).astype(np.uint8), "gt_boxes": gtb, "gt_ids": gti,
             "color": np.broadcast_to(cmat, (b, 3, 4)).copy()}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def time_train_step(dev, card, s2d_stem: bool, profile: bool):
    """The B=48 416-px bf16 train step from a seeded init: (median ms,
    peak bytes, the last step's losses)."""
    model = YOLOv3(num_classes=NUM_CLASSES, dtype=torch.bfloat16, s2d_stem=s2d_stem)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev, memory_format=torch.channels_last)
    state = create_train_state(model, lr_schedule("step", 1e-3, steps_per_epoch=100, epochs=10))
    step = make_train_step(model, num_classes=NUM_CLASSES)
    batch = train_batch(np.random.RandomState(0), TRAIN_BATCH, SIZE, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = statistics.median(cuda_time_ms(lambda: step(state, batch), iters=10, warmup=3))
    peak = torch.cuda.max_memory_allocated()
    losses = {k: float(v) for k, v in step(state, batch).items()}
    check(all(np.isfinite(v) for v in losses.values()), f"train step losses not finite: {losses}")
    stem = "s2d stem" if s2d_stem else "standard stem"
    print(f"slice 4 train step B={TRAIN_BATCH} at {SIZE} px bf16, {stem}, on {card}: "
          f"{TRAIN_BATCH / ms * 1e3:.1f} images/s ({ms:.3f} ms/step, median of 10 after 3 warm), "
          f"peak memory {peak / 2**30:.2f} GiB, losses after {state.step} steps "
          + ", ".join(f"{k} {v:.4g}" for k, v in losses.items()))
    if profile:
        profile_steps([(f"slice 4 train B={TRAIN_BATCH} {stem}", lambda _: step(state, batch), None, 1, 14)], card)
    return ms, peak, losses


def check_train_card_vs_cpu():
    """One float32 train step of the full-width s2d-stem model at 128 px,
    B=4, on the card and on the CPU from the same weights and batch."""
    model = YOLOv3(num_classes=NUM_CLASSES, s2d_stem=True)
    init_weights(model, torch.Generator().manual_seed(1))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for device in ("cuda", "cpu"):
        model.load_state_dict(start)
        model.to(device, memory_format=torch.channels_last)
        state = create_train_state(model, lr_schedule("step", 1e-3, steps_per_epoch=100, epochs=10))
        losses = make_train_step(model, num_classes=NUM_CLASSES)(state, train_batch(np.random.RandomState(1), 4, 128, device))
        runs.append(({k: float(v) for k, v in losses.items()},
                     {k: v.detach().double().cpu() for k, v in model.state_dict().items()}))
    (card_loss, card), (cpu_loss, cpu) = runs
    before = {k: v.double() for k, v in start.items()}
    for k in cpu_loss:
        check(abs(card_loss[k] - cpu_loss[k]) <= TRAIN_TOL["loss_rtol"] * abs(cpu_loss[k]),
              f"float32 train step card vs CPU: loss {k} {card_loss[k]} vs {cpu_loss[k]}")
    stats = [k for k in cpu if k.endswith(("running_mean", "running_var"))]
    params = [k for k in cpu if k not in stats and not k.endswith("num_batches_tracked")]
    leaf = {k: float(((card[k] - before[k]) - (cpu[k] - before[k])).abs().max()
                     / (cpu[k] - before[k]).abs().max().clamp_min(1e-30)) for k in params}
    num = sum(float(((card[k] - cpu[k])).pow(2).sum()) for k in params)
    den = sum(float((cpu[k] - before[k]).pow(2).sum()) for k in params)
    l2 = (num / den) ** 0.5
    worst = max(leaf, key=leaf.get)
    stats_err = max(float((card[k] - cpu[k]).abs().max()) for k in stats)
    check(leaf[worst] <= TRAIN_TOL["leaf"] and l2 <= TRAIN_TOL["l2"],
          f"float32 train step card vs CPU: worst leaf update {worst} {leaf[worst]:.3g}, L2 {l2:.3g}")
    check(all(torch.allclose(card[k], cpu[k], rtol=TRAIN_TOL["stats_rtol"], atol=TRAIN_TOL["stats_atol"])
              for k in stats), f"float32 train step card vs CPU: BN statistics differ by {stats_err:.3g}")
    print(f"slice 4 float32 train step at 128 px B=4, card vs CPU: losses within rtol "
          f"{max(abs(card_loss[k] - cpu_loss[k]) / abs(cpu_loss[k]) for k in cpu_loss):.2e}, the update "
          f"{l2:.2e} apart in L2, worst leaf {leaf[worst]:.3g} of its largest update ({worst}), median leaf "
          f"{statistics.median(leaf.values()):.2e}, BN statistics max abs error {stats_err:.3g} ({TRAIN_TOL})")


def train_slice4(dev, card):
    """Phase 9.  Returns (the phase's figures, K1's launches on the
    training path: the overfit run's eval and the round trip's two)."""
    figures = {}
    ms, peak, _ = time_train_step(dev, card, s2d_stem=True, profile=True)
    figures.update(train_ms=ms, train_images_s=TRAIN_BATCH / ms * 1e3, peak_gib=peak / 2**30)
    torch.cuda.empty_cache()
    ms_std, peak_std, _ = time_train_step(dev, card, s2d_stem=False, profile=False)
    figures.update(train_ms_standard_stem=ms_std, peak_gib_standard_stem=peak_std / 2**30)
    print(f"slice 4 train step B={TRAIN_BATCH} at {SIZE} px bf16 on {card}: s2d stem "
          f"{TRAIN_BATCH / ms * 1e3:.1f} images/s, standard stem {TRAIN_BATCH / ms_std * 1e3:.1f} images/s")
    torch.cuda.empty_cache()
    check_train_card_vs_cpu()

    with tempfile.TemporaryDirectory() as tmp:
        nms_greedy.launches = 0
        rec, model = overfit.run(overfit.parse_args(
            ["--out", f"{tmp}/overfit_yolov3.json", "--save_prefix", f"{tmp}/yolo3"]))
        check(rec["pass"], f"overfit run fails the JAX package's rule: {rec}")
        fresh = load_into(YOLOv3(num_classes=OVERFIT_CLASSES, dtype=torch.bfloat16),
                          load_variables(rec["checkpoint"])).to(dev, memory_format=torch.channels_last)
        images = torch.from_numpy(overfit.synth_set(OVERFIT_CLASSES)[0]).to(dev)
        trained, reloaded = make_eval_step(model)(images), make_eval_step(fresh)(images)
        torch.cuda.synchronize()
        k1 = nms_greedy.launches
    check(k1 == 3, f"K1 launches on the training path: {k1}, expected 3 (one an eval)")
    check(all(torch.equal(a, b) for a, b in zip(trained, reloaded)),
          "the checkpoint's eval detections differ from the trained model's")
    print(f"slice 4 overfit (bf16, 160 px, B=8, 400 steps) on {card}: passes the JAX package's rule; "
          f"loss {rec['loss_first']:.2f} -> {rec['loss_last']:.4f}, mean top-1 IoU {rec['mean_top1_iou']:.4f}, "
          f"class accuracy {rec['top1_class_acc']}, {rec['step_ms']:.2f} ms/step on the host's clock")
    print(f"slice 4 checkpoint round trip: save_params -> load_variables -> a fresh model; eval detections "
          f"equal bit for bit ({int((reloaded[0] >= 0).sum())} rows); K1 launches on the path: {k1}")
    print("overfit record: " + json.dumps(rec))

    # the overfit step's host cost: one B=8 160-px step of the trained model
    state = create_train_state(model, lr_schedule("constant", 0.0, steps_per_epoch=1, epochs=1))
    step = make_train_step(model, num_classes=OVERFIT_CLASSES)
    images_np, gtb, gti = overfit.synth_set(OVERFIT_CLASSES)
    batch = {"image": images, "gt_boxes": torch.from_numpy(gtb).to(dev), "gt_ids": torch.from_numpy(gti).to(dev)}
    step_ms = median_ms(lambda: step(state, batch), 20)
    q_ms = queued_ms(lambda: step(state, batch), iters=20)
    print(f"slice 4 overfit step B=8 at 160 px bf16 on {card}: {step_ms:.3f} ms with events around each step, "
          f"{q_ms:.3f} ms with the launch queue full")
    profile_steps([("slice 4 overfit step B=8 160 px", lambda _: step(state, batch), None, 5, 6)], card)
    figures.update(overfit=rec, overfit_step_ms=step_ms, overfit_step_queued_ms=q_ms)
    return figures, k1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()} limit)"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
    )

    # 2. build
    builds = build_kernels()
    check_corr_build(builds[correlation_kernel][1])
    check_int8_sass()

    # 3. the kernels against their plain versions
    rs = np.random.RandomState(0)
    nms_err, nms_cases, nms_synthetic = check_nms_kernel(rs, dev, card)
    corr_err = check_corr_kernel(dev)
    int8_cases, k3_err, conv_err = check_int8_kernels(dev)

    # 4. slice 1: the detect path at 416 px, bf16
    nms_ms = {}
    det1, x128, x1, nms_launches, err = serve_slice1(rs, dev, card, nms_ms)
    nms_err = max(nms_err, err)

    # 5. slice 2: YOLOv3T windows with early correlation at 416 px, bf16
    det2, x32, corr_launches, nms_launches2, corr, err = serve_slice2(rs, dev, card)
    corr_err = max(corr_err, err)

    # 6. slice 3: fused-int8 YOLOv3 at 416 px, bf16 tips
    det3, x128_3, int8_launches, k3, conv, cells3 = serve_slice3(rs, dev, card)

    # 7. reference
    check_reference(rs)

    # 8. profile
    profile_steps([("slice 1 B=128", det1, x128, 3, 8), ("slice 1 B=1", det1, x1, 20, 4),
                   ("slice 2 B=32", det2, x32, 3, 10), ("slice 3 B=128", det3, x128_3, 3, 10)], card)

    # 9. slice 4: training
    del det1, det2, det3, x128, x1, x32, x128_3
    torch.cuda.empty_cache()
    train_figures, k1_slice4 = train_slice4(dev, card)

    kernels = [
        {
            "name": "nms_greedy",
            "route": "cuda",
            "source": "videoyolo_torch/csrc/nms.cu",
            "replaces": "videoyolo_tpu/ops/pallas_nms.py:99",
            "launches": nms_launches,
            "max_abs_err": nms_err,
            **nms_ms,
            "library_ms": None,
            "match": True,
            "cases": nms_cases + 2,
            "per": "one call (B=128 model candidates, K=400): two CUDA launches, mask and scan",
            "synthetic": nms_synthetic,
            "launches_slice2": nms_launches2,
            "launches_slice4": k1_slice4,
        },
        {
            "name": "cost_volume",
            "route": "cuda",
            "source": "videoyolo_torch/csrc/correlation.cu",
            "replaces": "videoyolo_tpu/ops/pallas_correlation.py:63",
            "launches": corr_launches,
            "max_abs_err": corr_err,
            "ms": corr["ms"],
            "plain_ms": corr["plain_ms"],
            "bound_ms": corr["bound_ms"],
            "bound_by": corr["bound_by"],
            "library_ms": None,
            "match": True,
            "cases": len(CORR_CASES) + 3,
            "per": f"one B=32 request: {CORR_LAUNCHES} launches",
            "levels": corr["levels"],
        },
        {
            "name": "quant_downsample",
            "route": "cuda",
            "source": "videoyolo_torch/csrc/int8_conv.cu",
            "replaces": "videoyolo_tpu/ops/pallas_conv.py:116",
            "launches": int8_launches[0],
            "max_abs_err": k3_err,
            **{k: k3[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "match": True,
            "per": "one B=128 request: 4 launches",
            "route_launches": k3["route_launches"],
            "cells": k3["cells"],
        },
        {
            "name": "int8_conv",
            "route": "cuda",
            "source": "videoyolo_torch/csrc/int8_conv.cu",
            "replaces": "videoyolo_tpu/models/layers.py:229 (XLA's int8 conv_general_dilated, no TPU kernel)",
            "launches": int8_launches[1],
            "max_abs_err": conv_err,
            **{k: conv[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "match": True,
            "cases": int8_cases + cells3,
            "per": "one B=128 request with ds_conv='pallas': 68 launches",
            **{k: conv[k] for k in ("ms_1x1", "int_mm_1x1_ms", "cells_1x1", "route_launches", "classes")},
        },
    ]
    print(json.dumps({"slice4_training": train_figures}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
