#!/usr/bin/env python3
"""Drive the PyTorch port's detect and train paths on one NVIDIA card and
hold its kernels against their plain PyTorch versions.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card

Phases; any failure exits non-zero:
  1. device: the card's name and power limit, torch and CUDA versions, the
     TF32 switches (set off, so float32 means float32);
  2. build: the NMS kernel (videoyolo_torch/csrc/nms.cu), the cost-volume
     kernel (videoyolo_torch/csrc/correlation.cu) and the int8 conv kernels
     (videoyolo_torch/csrc/int8_conv.cu: K3 and the direct int8 cell), one
     nvcc each, started together, for sm_90a; no cost-volume instance that
     the plan gives a case of CORR_CASES may spill, nor any instance of its
     adjoint, and the main path's instances must hold 16-byte shared loads
     and 16-byte cp.async copies in their SASS;
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
 10. slice 5, data from disk: the host probe (g++, libjpeg, nvJPEG, cores)
     and the decoder the JPEG core (videoyolo_torch/csrc/loader.cc) was
     built with; its pixels of two reference files against the libjpeg
     build's (tests/data/jpeg_writer_libjpeg.npz); a synthetic VOC tree in
     a temp dir (16 distinct 500x375 JPEGs from the numpy baseline writer
     below, under 480 trainval and 256 test names, an XML of 1-4 objects
     each); the loader's train batches/s at B=48, 416 and 608 px, and
     inference batches at B=128, 416 px; the train twin
     (`videoyolo_torch.train_yolov3`, bf16, B=48, 416 px, one epoch, then
     validation with K1 counted) with its samples/s and the share of the
     epoch spent waiting on the prefetcher; its checkpoint through the detect
     twin's --model_path (`videoyolo_torch.detect --dataset voc`, bf16,
     B=128): K1 counted, voc.txt written, the first batch's detections
     equal to the trained model's eval step bit for bit, and a second run
     read from the cache with no K1 launch; a darknet53 `.params` from the
     port's writer through --pretrained_base_path (loaded leaves equal to
     those written) in a 20-step random-shape run, each shape's first step
     reported apart.
 11. slice 6, COCO, ImageNet-DET and ImageNet-VID from disk: synthetic trees
     in a temp dir from the numpy writer (COCO: 16 distinct 640x480 JPEGs
     under 480 train2017 and 256 val2017 names, the 80 categories under
     their json ids 1-90, 1-4 objects an image, crowds and boxes under any
     minimum area among them, a val image in 32 without boxes; DET: 64 val
     .JPEGs; VID: 4 val snippets of 32 640x360 frames whose 1-3 boxes move
     in straight lines, every frame with a box; and phase 10's VOC tree);
     the per-sample route's tiles (native.crop_resize_pad on nvJPEG's
     pixels) against the core's file route bit for bit, 20 COCO plans and
     two VOC batches through each route; the train loader's images/s at
     B=48, 416 px: the native VOC route and the per-sample route on COCO
     without and with mixup; the train twin on COCO with --mixup (bf16,
     B=48, random shapes, one epoch, validated with the COCO metric, K1
     counted); the detect twin (bf16, B=128) on COCO from that checkpoint
     (--metrics coco,voc), on DET (voc) and on VID frames (vid, --every 2)
     with seeded random weights, K1 counted on each; the checkpoint read
     back: its model's raw boxes and scores and its first batch's
     detections equal the trained model's bit for bit; the warm detect loop
     on each dataset (80, 200 and 30 classes, 512 JPEGs each).
 12. slice 7, VID windows and YOLOv3T training: K2's adjoint (the backward
     kernel of videoyolo_torch/csrc/correlation.cu, built in phase 2 with
     no ptxas spill in any of its instances) against
     ops/correlation_kernel.py's plain adjoint at the train step's three
     levels at B=16 and B=1 and on edge cases (ragged tiles, C=20, d=0, a
     ragged displacement group, misaligned frames), every pair two frames
     of a window taken with its batch stride (allclose rtol=atol=1e-5), each
     with its plan (correlation_kernel.plan_backward), and the pair launch
     of each case's window against the plain pair and, bit for bit, against
     two one-volume launches; the Corr output of the slice model (YOLOv3T, 30
     classes, k=3, late join, early correlation d=4) carrying CostVolume's
     backward (CostVolumePair: one adjoint launch for both volumes) and the
     stage-1 stem getting a non-zero gradient from the cost volumes alone;
     one float32 window train step (128 px, B=2 windows) on the card
     against the CPU within TRAIN_TOL; the B=16-window 416-px bf16 train
     step timed as in phase 9 (windows/s, frames/s, peak memory, a profiled
     step's idle share), K2 launched 6 times forward and its adjoint 3
     times a step (one launch a level for the pair of volumes), each
     level's forward and pair adjoint timed on the step's routes against
     the pair's bound and plain version, with its plan; `overfit --config
     k3` to the JAX rule; a VID tree of 6 train and 4 val snippets
     (640x360), the window loaders' rates, the train twin with --window 3,1
     one epoch (B=16, validated on windows), the detect twin (B=32 windows)
     from its checkpoint with the raw outputs and the first batch's
     detections bit-equal to the trained model's, and a warm windowed
     detect loop beside the step alone; K1 and K2 counted on each path.
 13. slice 9, YOLOv3Temporal t=5: K2, the kernel_size=3 correlation (K2,
     then the 3x3 patch sum) and its gradient (K2's adjoint) against their
     plain versions at the pyramid's shapes (52x52x256, d=4, B=16, 8 and 1
     windows; each frame of a (B, 5) window against the middle one, and the
     middle one against itself, f1 and f2 one tensor); Detector(YoloConfig(
     num_classes=20, temporal=True, t_out=True, corr_pos="early",
     corr_d=4), bf16) at 416 px (bench.py:462-471) answers B=1, 4 and 16
     windows of 5 frames, K2 5 times and K1 once a request, outputs (B, 5,
     100, .) in range; its Corr output on the model's own stage-1 features
     and its bf16 heads against the plain correlation's, K1 on the 80 folded
     images against the plain NMS; windows/s and frames/s at B=16, B=1
     latency, K2 and the patch sum timed, a profiled request; the funnel
     (t_out=False) at B=16, one K1 call and no K2; one request through the
     entry point with --temp --mult_out; a float32 t_out train step (128
     px, one window) card vs CPU within TRAIN_TOL; the B=8-window 416-px
     bf16 t_out train step (YoloConfig(num_classes=30, temporal=True,
     t_out=True, corr_d=4), per-timestep gt) timed as in phase 9, K2 and
     its adjoint 5 launches each a step, each timed at the step's shape,
     the adjoint of the middle frame against itself (two gradients, not
     aliased); `overfit --config t5` to the JAX rule; phase 12's VID tree
     as windows of 5 with per-frame labels: the train twin with --window
     5,1 --temp --mult_out one epoch (B=8, validated with
     VOCMApMetricTemporal), the detect twin (B=16) from its checkpoint
     writing pred_o0..pred_o4 and vid.txt, voc.txt; K1 and K2 counted on
     each path; a `{"slice9_t5": ...}` line.
 14. slice 10, the combined class-tree dataset and YouTube-BB: `overfit
     --config tree` (7 tree nodes, multi-hot rows) to the JAX rule; the
     detect step alone at B=128 on the 80-class head and the tree's 285
     (images/s; the 285-class request split into head, decode, top-k and
     K1, K1 bit-equal to the plain NMS on its candidates, a profiled
     request); synthetic trees (phase 10's VOC, phase 11's COCO, DET with a
     train split of 64, VID with 2 train and 2 val snippets, and YouTube-BB:
     8 train and 4 val clips of 12 640x360 frames 1 s apart, fractional
     boxes, every 6th frame absent); the train twin on
     voc,coco,det,vid,yt (the 285-class head, multi-hot labels, bf16,
     B=48, one epoch, validated on the tree's duplicates; images/s past
     the first step, wait share); the detect twin on comb from its
     checkpoint (B=128, --hier_level 10; the first batch bit-equal to the
     trained model's eval step, K1 bit-equal to the plain NMS on the
     trained model's candidates, the hierarchical NMS's host seconds);
     `--dataset voc --trained_on comb` (the class map); the train twin on
     YouTube-BB windows of 3 (YOLOv3T, 23 classes, late join, early
     correlation d=4, B=16 windows, one epoch: K2 6 and its adjoint 3 a
     step) and the detect twin on them (B=32, bit-equal); K1 and K2 counted
     on each path; a `{"slice10_comb": ...}` line.
 15. slice 11, data-parallel training (BASELINE config 3: VOC, mixup,
     syncbn; the earlier phases' memory freed first): (a) two ranks on the
     one card in a gloo group (CUDA tensors through the host; NCCL refuses
     two ranks on one device), started by this script (`--dp-rank`), joined
     with a timeout and killed on any failure: full-width
     YOLOv3(num_classes=20) at 416 px, mixup ratios and colour maps, B=4 a
     rank (global 8), BN over the global batch, the gradients averaged;
     after 2 float64 steps the losses, parameters and BN statistics within
     TRAIN_TOL of the one-process step on the global batch of 8 on the
     card, then the same with accum_steps=2 against the batch reordered as
     the ranks' micro-batches make it; after 2 float32 steps the losses,
     the update (L2, worst leaf) and the statistics within DP_FLOAT32_FLOOR
     times the one-process step's distance from itself on the rows
     reversed; the two ranks' states equal; sync_flag / sync_any across
     them; each step's ms (gloo's host-staged all-reduce is no target); (b)
     a NCCL group of one at slice 4's B=48, 416 px, bf16 step: the train
     step in the group (which averages no gradients in a group of one)
     bit-equal to the plain step over 3 steps (cuDNN deterministic for the
     comparison; the plain step run twice as a control), both timed as in
     phase 9 with their peak memory; `average_gradients` called on its
     gradients, NCCL's all-reduce of them, changing no bit, and timed; (c)
     `python -m torch.distributed.run --nproc_per_node 1` on the train twin
     with --mixup --syncbn on phase 10's VOC tree (B=48, 416 px, bf16, one
     epoch, validated, K1 counted in the rank by a runner, `--twin-rank`,
     that calls the twin's `main`), one checkpoint written; then `-m
     videoyolo_torch.train_yolov3` for three epochs, a SIGTERM to the rank
     after its first step, which must leave `<prefix>_0000.params`, no
     validation and exit 0; a `{"slice11_dp": ...}` line and
     `launches_slice11` in the kernels line;
 16. slice 12, streaming (videoyolo_torch/streaming.py): (a) the JAX bench's
     stream model (bench.py:479-522: YOLOv3T k=3, late max join, 20
     classes), bf16, 416 px, B=32 streams of distinct seeded frames through
     the tip split: K1 once and K2 never a step, the raw (boxes, scores) of
     the reset and 3 steps within HEAD_TOL of the same model's windowed
     forward on the same windows, K1 bit-equal to the plain NMS on the
     stream's candidates, frames/s over 10 steps after 3 warm (CUDA events)
     beside the windowed Detector on B=32 windows, peak memory, the idle
     share of 5 profiled steps; (b) slice 2's model through the route
     split, B=32: K2 6 and K1 1 a step, HEAD_TOL, frames/s beside its
     windowed step; (c) the t=5 pyramid (T5) through the stage-1 split,
     B=16 streams: K2 5 and K1 1 (on the 80 folded frames) a step, outputs
     (16, 5, 100, .), HEAD_TOL, frames/s; (d) the plain t_out path (route split) and the
     funnel (stage-1 split) at B=2, HEAD_TOL and K1; (e) float32, 128 px,
     B=2 streams of (a)-(d)'s models: every trail step's detections and
     every center frame's within rtol=atol=1e-4 of the windowed Detector's,
     the center anchor yielding each frame once, in order; (f) the detect
     twin with --stream on two snippets of phase 12's VID tree (trail,
     center, and --temp --mult_out --window 5,1 with the pyramid): one
     pred/ file a frame, K1 (and K2) counted, the cache bit-equal to an
     in-process StreamingDetector fed the same decoded frames with a reset
     at each snippet; one synthetic --stream request through the entry
     point; a `{"slice12_stream": ...}` line and `launches_slice12` in the
     kernels line;
 17. slice 13, the conv-RNN and the 3D / 2+1D blocks (models/layers.py
     ConvRNN, Conv21D; models/yolo3_temporal.py), YOLOv3T at 416 px, bf16,
     30 VID classes, k=3 (the JAX package's rnn profile,
     tools/prof_temporal.py:141-150): (a) B=16 windows through the Detector
     for the tip GRU with the late max join, the output GRU, the tip GRU
     with the late correlation d=4 (no join; K2 6 a request on the GRU's
     outputs, within rtol=atol=1e-5 of the plain correlation, the bf16
     heads on them within HEAD_TOL of the heads on the plain one), '3'
     blocks (mean) and '21' blocks (max): K1 once a request and bit-equal
     to the plain NMS on the model's candidates, ms and windows/s (median
     of 10 after 3 warm, CUDA events), peak memory, one profiled request
     with the GRU gates' and the directions' mean's device time; (b) each
     model in float32 at 128 px, card vs CPU within rtol=atol=1e-3; (c) B=16
     streams of the output GRU (tip split) and the tip GRU (route split):
     the reset and 3 steps within HEAD_TOL of the windowed forward,
     frames/s beside the windowed rate, and in float32 at 128 px every
     trail step within 1e-4 of the windowed Detector; (d) a float32 window
     train step at 128 px card vs CPU (TRAIN_TOL) and the B=8-window bf16
     step (median of 10 after 3 warm, peak memory, a profiled step) of the
     tip GRU with the late correlation (K2 6 and K2' 3 a step) and of the
     '21' blocks; (e) the train twin with --rnn_pos late --k_join_pos late
     --corr_pos late --corr_d 4 (the factory's late max join pre-empts the
     correlation: K2 0) three steps on phase 12's VID tree (two of its val
     snippets), then the detect
     twin on its checkpoint, raw outputs and the first batch's detections
     bit-equal to the trained model's; a `{"slice13_rnn_3d": ...}` line and
     `launches_slice13` in the kernels line;
 18. slice 14, the 3D / 2+1D and hierarchical DarkNet backbones
     (models/darknet3d.py, h_darknet.py, inflate.py; the factory's
     new_model), 416 px, bf16, 30 VID classes: (a) B=16 windows through the
     Detector for Darknet3D (2,3,3,2,2,2) and (2,21,21,2,2,2) with the
     funnel at k=5 and HDarknet (3,3,1,1,1) with the max and the conv merge
     at t=9 (the merges' kernels drawn from the seed): K1 once a request and
     bit-equal to the plain NMS on the model's candidates, ms and windows/s
     (median of 10 after 3 warm, CUDA events), peak memory, one profiled
     request with the depthwise temporal convs' device time; (b) each model
     in float32 at 128 px, card vs CPU within rtol=atol=1e-3; (c) a float32
     train step on B=2 windows at 128 px card vs CPU (TRAIN_TOL) and the
     B=8-window bf16 step (median of 10 after 3 warm, peak memory, a
     profiled step) of the 3-D Darknet3D and the max HDarknet; (d) the
     train twin three steps with --new_model --conv_types 2,3,3,2,2,2
     --window 5,1 and --pretrained_base_path of a written darknet53
     `.params` (the inflate branch), and with --hier 3,3,1,1,1 --window 9,1
     on a VID tree, the detect twin on each checkpoint (raw outputs and the
     first batch's detections bit-equal to the trained model's), and
     `--stream --new_model` refused; a `{"slice14_backbones": ...}` line and
     `launches_slice14` in the kernels line;
 19. slice 15, the two-stream FlowNet family (models/flownet.py,
     ts_darknet.py, flownet_utils.py; the factory's motion_stream), 384 px
     (FlowNetS takes multiples of 64), 30 VID classes: (a) B=16 windows of 3
     in bf16 through the Detector for the ungated model and the "add" and
     "mul" gates: K1 once a request and bit-equal to the plain NMS on the
     model's candidates, no K2, ms and windows/s (median of 10 after 3
     warm, CUDA events), peak memory, one profiled request with the FlowNet
     stream's (`TwoStreamDarknet.motion`) and Darknet-53's (`appearance`)
     device time and the profile's device time over the request's
     CUDA-event time; (b) each model in float32 at 128 px, card vs CPU
     within rtol=atol=1e-3; (c) K2 at FlowNetC's level, (16, 48, 48, 256)
     and (1, 48, 48, 256) at d=20, stride2=2, within rtol=atol=1e-5 of the
     plain version, its ms, bound and plain ms; FlowNetC's and FlowNetS's
     float32 flows of written frames through `flownet_utils` card vs CPU
     (1e-3), K2 one launch a FlowNetC call, `process_imagedir`'s `.flo`
     files, `process_two_images` timed; (d) a float32 train step of the
     "add" model on B=2 windows at 128 px card vs CPU (TRAIN_TOL) and its
     B=8-window bf16 step (median of 10 after 3 warm, peak memory, a
     profiled step); (e) the train twin three steps with --motion_stream
     flownet --stream_gating add --window 3,1 --data_shape 384
     --no_random_shape on a VID tree, the detect twin on its checkpoint
     (raw outputs and the first batch's detections bit-equal to the trained
     model's); (f) the twins' refusals (a data shape not a multiple of 64,
     random shapes, --stream, --pretrained_cnn with --stream_gating); no
     K2' or int8 launch in the phase; a `{"slice15_two_stream": ...}` line
     and `launches_slice15` in every kernel's entry of the kernels line.
A `{"phase_end_s": ...}` line gives each phase's end in seconds from the
start.  The line before last lists every kernel; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import copy
import json
import logging
import math
import os
import random
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from videoyolo_torch import detect, native, overfit, train_yolov3
from videoyolo_torch.data.base import load_names, read_image
from videoyolo_torch.data.detectset import DetectSet
from videoyolo_torch.data.imgnetdet import ImageNetDetection
from videoyolo_torch.data.imgnetvid import ImageNetVidDetection
from videoyolo_torch.data.loader import DetectionLoader
from videoyolo_torch.data.mscoco import COCODetection
from videoyolo_torch.data.pascalvoc import VOCDetection
from videoyolo_torch.data.prefetch import device_prefetch
from videoyolo_torch.data.youtubebb import YouTubeBBDetection
from videoyolo_torch.data.transforms import (
    MEAN,
    STD,
    MixupDetection,
    YOLO3DefaultTrainTransform,
    YOLO3VideoInferenceTransform,
    YOLO3VideoTrainTransform,
    to_normalized,
)
from videoyolo_torch.models.darknet import Darknet53
from videoyolo_torch.models import flownet_utils
from videoyolo_torch.models.factory import YoloConfig, build_model
from videoyolo_torch.models.flownet import CORR_D, CORR_STRIDE2, FlowNetC, FlowNetS
from videoyolo_torch.models.layers import ConvBNLeaky, QTensor, QuantResidual, init_weights, time_distributed
from videoyolo_torch.models.yolo3 import YOLOv3, decode_predictions, postprocess, select_topk_candidates
from videoyolo_torch.models.ts_darknet import TwoStreamDarknet
from videoyolo_torch.models.yolo3_temporal import YOLOv3T
from videoyolo_torch.ops import correlation_kernel, cuda_build, int8_conv_kernel, nms_kernel
from videoyolo_torch.ops.correlation import correlation, correlation_plain, num_corr_channels, patch_correlation
from videoyolo_torch.ops.color import apply_color
from videoyolo_torch.ops.correlation_kernel import (
    cost_volume, cost_volume_backward, cost_volume_backward_plain, cost_volume_pair_backward,
    cost_volume_pair_backward_plain,
)
from videoyolo_torch.ops.int8_conv import int8_conv_plain, quant_downsample_plain
from videoyolo_torch.ops.int8_conv_kernel import int8_conv, quant_downsample
from videoyolo_torch.ops.quantize import replace_quant
from videoyolo_torch.ops.nms import nms_greedy_plain
from videoyolo_torch.ops.nms_kernel import nms_greedy
from videoyolo_torch.parallel import mesh, multihost
from videoyolo_torch.profiling import cuda_time_ms, queued_ms
from videoyolo_torch.serving import NMS_THRESH, NMS_TOPK, Detector, collect_boxes
from videoyolo_torch.streaming import StreamingDetector, stream_frames
from videoyolo_torch.train.checkpoint import load_into, load_variables, variables_of
from videoyolo_torch.train.lr import lr_schedule
from videoyolo_torch.train.step import average_gradients, create_train_state, make_eval_step, make_train_step
from videoyolo_torch.utils import gluon_import
from videoyolo_torch.utils.flax_bridge import walk

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


def check_detections(label, outs, batches, classes=NUM_CLASSES):
    """Range checks of a Detector's outputs (ids, scores, boxes per request)."""
    for (ids, sc, bb), b in zip(outs, batches):
        check(ids.shape == sc.shape == (b, POST_NMS, 1), f"{label} B={b}: ids/scores {tuple(ids.shape)}")
        check(bb.shape == (b, POST_NMS, 4), f"{label} B={b}: boxes {tuple(bb.shape)}")
        check(all(bool(torch.isfinite(t).all()) for t in (ids, sc, bb)), f"{label} B={b}: non-finite output")
        check(bool(((ids >= -1) & (ids < classes) & (ids == ids.round())).all()), f"{label} B={b}: ids")
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
    plan gives a case of CORR_CASES, nor in any instance of the adjoint, and
    16-byte shared loads (LDS.128) and
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
    # the adjoint: every instance (R, GX) the kernel has, spill-free
    adjoint = {}
    for name, body in re.findall(r"Compiling entry function '(\S*cost_volume_backward_kernelILi(?:\d+)ELi(?:\d+)E\S*)'"
                                 r"(.*?)(?=Compiling entry function|\Z)", ptxas, re.S):
        inst = tuple(map(int, re.search(r"cost_volume_backward_kernelILi(\d+)ELi(\d+)E", name).groups()))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        regs = re.search(r"Used (\d+) registers", body)
        check(spill is not None and regs is not None and int(spill.group(1)) + int(spill.group(2)) == 0,
              f"cost volume ptxas: the adjoint's instance (R, GX) = {inst} spills ({body.strip()[:200]})")
        adjoint[inst] = int(regs.group(1))
    want = {(r, gx) for r in correlation_kernel.BACKWARD_R for gx in correlation_kernel.GROUP_X}
    check(set(adjoint) == want, f"cost volume ptxas: adjoint instances {sorted(adjoint)}, expected {sorted(want)}")
    print(f"cost volume adjoint: {len(adjoint)} instances (R, GX), no spills; registers {adjoint}")
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
    """Phase 8: device busy share, launches and top kernels of each step.
    Returns {label: {wall_ms, busy_ms, idle_share, ops}} a step."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
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
        out[label] = {"wall_ms": wall_ms / n, "busy_ms": busy_ms / n, "idle_share": max(0.0, 1 - busy_ms / wall_ms),
                      "ops": sum(e.count for e in events) // n}
    return out


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


def check_train_card_vs_cpu(label, model, batch_fn, num_classes, what):
    """One float32 train step of a full-width model on the card and on the
    CPU from the same weights (seed 1) and batch (`batch_fn(device)`)."""
    init_weights(model, torch.Generator().manual_seed(1))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for device in ("cuda", "cpu"):
        model.load_state_dict(start)
        model.to(device, memory_format=torch.channels_last)
        state = create_train_state(model, lr_schedule("step", 1e-3, steps_per_epoch=100, epochs=10))
        losses = make_train_step(model, num_classes=num_classes)(state, batch_fn(device))
        runs.append(({k: float(v) for k, v in losses.items()},
                     {k: v.detach().double().cpu() for k, v in model.state_dict().items()}))
    (card_loss, card), (cpu_loss, cpu) = runs
    return check_train_states(f"{label} float32 train step at {what}, card vs CPU", [card_loss], [cpu_loss], card,
                              cpu, {k: v.double() for k, v in start.items()})


def train_state_errors(losses, ref_losses, got, ref, before):
    """How far a run's losses a step and its state after the steps (double,
    on the CPU) lie from a reference run from the same `before`: the losses'
    largest relative error, each parameter's update error over its largest
    update (the worst and the median), the update's relative L2 error, and
    the BN statistics' largest absolute error."""
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    params = [k for k in ref if k not in stats and not k.endswith("num_batches_tracked")]
    leaf = {k: float(((got[k] - before[k]) - (ref[k] - before[k])).abs().max()
                     / (ref[k] - before[k]).abs().max().clamp_min(1e-30)) for k in params}
    num = sum(float(((got[k] - ref[k])).pow(2).sum()) for k in params)
    den = sum(float((ref[k] - before[k]).pow(2).sum()) for k in params)
    worst = max(leaf, key=leaf.get)
    return {"loss_rtol": max(abs(m[k] - r[k]) / abs(r[k]) for m, r in zip(losses, ref_losses) for k in r),
            "l2": (num / den) ** 0.5, "worst_leaf": leaf[worst], "worst_leaf_name": worst,
            "median_leaf": statistics.median(leaf.values()),
            "stats_err": max(float((got[k] - ref[k]).abs().max()) for k in stats)}


def check_train_states(label, losses, ref_losses, got, ref, before):
    """Losses a step and the state after the steps (double, on the CPU)
    against a reference run from the same `before`, within TRAIN_TOL."""
    for m, r in zip(losses, ref_losses):
        for k in r:
            check(abs(m[k] - r[k]) <= TRAIN_TOL["loss_rtol"] * abs(r[k]), f"{label}: loss {k} {m[k]} vs {r[k]}")
    e = train_state_errors(losses, ref_losses, got, ref, before)
    check(e["worst_leaf"] <= TRAIN_TOL["leaf"] and e["l2"] <= TRAIN_TOL["l2"],
          f"{label}: worst leaf update {e['worst_leaf_name']} {e['worst_leaf']:.3g}, L2 {e['l2']:.3g}")
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    check(all(torch.allclose(got[k], ref[k], rtol=TRAIN_TOL["stats_rtol"], atol=TRAIN_TOL["stats_atol"])
              for k in stats), f"{label}: BN statistics differ by {e['stats_err']:.3g}")
    print(f"{label}: losses within rtol {e['loss_rtol']:.2e}, the update {e['l2']:.2e} apart in L2, worst leaf "
          f"{e['worst_leaf']:.3g} of its largest update ({e['worst_leaf_name']}), median leaf "
          f"{e['median_leaf']:.2e}, BN statistics max abs error {e['stats_err']:.3g} ({TRAIN_TOL})")
    return {k: e[k] for k in ("loss_rtol", "l2", "worst_leaf", "stats_err")}


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
    check_train_card_vs_cpu("slice 4", YOLOv3(num_classes=NUM_CLASSES, s2d_stem=True),
                            lambda device: train_batch(np.random.RandomState(1), 4, 128, device), NUM_CLASSES,
                            "128 px B=4")

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


# ---------------------------------------------------------------------------
# phase 10: slice 5, data from disk
# ---------------------------------------------------------------------------

VOC_IMAGES = 16  # distinct images, written under every name of the tree
VOC_W, VOC_H = 500, 375
VOC_SPLITS = {(2007, "trainval"): 240, (2012, "trainval"): 240, (2007, "test"): 256}
VOC_TEST = VOC_SPLITS[(2007, "test")]
TWIN_BATCH = 48  # the train twin's batch, as phase 9's train step
DETECT_BATCH = 128  # the detect twin's batch, as slice 1's B=128 request
LOADER_PASSES = 4  # passes over the trainval split for the loader's steady rates
DETECT_PASSES = 8  # passes over the test split for the inference loader and the detect loop
# the libjpeg build's pixels of two of the tree's images, decoded where
# libjpeg is (tests/test_torch_data.py holds the file against that build)
LIBJPEG_REF = Path(__file__).resolve().parent / "tests" / "data" / "jpeg_writer_libjpeg.npz"
LIBJPEG_REF_IMAGES = (0, 5)

# a baseline JPEG writer (4:2:0, the standard luminance Huffman tables for
# every component), because the card's machine has neither cv2 nor PIL
_ZIGZAG = np.array(sorted(range(64), key=lambda n: (n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2 else -(n // 8))))
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
_DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_VALS = list(range(12))
_AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_HEAD = [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
            0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
            0x24, 0x33, 0x62, 0x72, 0x82]
_AC_VALS = _AC_HEAD + sorted({(r << 4) | s for r in range(16) for s in range(1, 11)} - set(_AC_HEAD))
_DCT = np.array([[np.sqrt((1 if k == 0 else 2) / 8) * np.cos((2 * n + 1) * k * np.pi / 16) for n in range(8)]
                 for k in range(8)])


def _huffman_codes(bits, vals):
    """A table's (code, length) of each symbol, as 256-entry arrays."""
    codes, lengths = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(bits, start=1):
        for _ in range(n):
            codes[vals[k]], lengths[vals[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return codes, lengths


_DC_CODES, _AC_CODES = _huffman_codes(_DC_BITS, _DC_VALS), _huffman_codes(_AC_BITS, _AC_VALS)


def _quantised_blocks(plane, q):
    h, w = plane.shape
    b = (plane - 128.0).reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ij,abjk,lk->abil", _DCT, b, _DCT)
    return np.round(coef.reshape(h // 8, w // 8, 64) / q).astype(np.int64)[..., _ZIGZAG]


def _magnitudes(v):
    """Each value's size category and its `size` bits (one's complement
    below zero), as arrays."""
    size = np.zeros(v.shape, np.int64)
    nz = v != 0
    size[nz] = np.floor(np.log2(np.abs(v[nz]))).astype(np.int64) + 1
    return size, np.where(v > 0, v, v + (1 << size) - 1)


def _scan_bits(blocks, comps):
    """The entropy-coded scan of `blocks` (N, 64) zigzag coefficients in
    scan order, `comps` each block's component: per block its DC
    difference, each nonzero AC coefficient after a ZRL (0xF0) for each 16
    zeros before it, and an EOB unless coefficient 63 is nonzero; packed
    MSB first, padded with ones, 0xFF stuffed."""
    n = len(blocks)
    dc = blocks[:, 0].copy()
    for c in np.unique(comps):  # each component predicts from its own previous block
        sel = np.flatnonzero(comps == c)
        dc[sel] = np.diff(blocks[sel, 0], prepend=0)
    size, bits = _magnitudes(dc)
    items = [(np.arange(n), np.zeros(n, np.int64), np.zeros(n, np.int64),
              (_DC_CODES[0][size] << size) | bits, _DC_CODES[1][size] + size)]
    b, k = np.nonzero(blocks[:, 1:])
    k = k + 1
    first = np.r_[True, b[1:] != b[:-1]]
    last = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - last - 1
    size, bits = _magnitudes(blocks[b, k])
    sym = ((run % 16) << 4) | size
    items.append((b, k, np.full(len(b), 3), (_AC_CODES[0][sym] << size) | bits, _AC_CODES[1][sym] + size))
    for z in range(3):  # the ZRLs before a coefficient: up to 3 (run <= 62)
        sel = run // 16 > z
        items.append((b[sel], k[sel], np.full(int(sel.sum()), z), np.full(int(sel.sum()), _AC_CODES[0][0xF0]),
                      np.full(int(sel.sum()), _AC_CODES[1][0xF0])))
    ends = np.ones(n, bool)
    ends[b[k == 63]] = False
    eob = np.flatnonzero(ends)
    items.append((eob, np.full(len(eob), 64), np.zeros(len(eob), np.int64), np.full(len(eob), _AC_CODES[0][0x00]),
                  np.full(len(eob), _AC_CODES[1][0x00])))
    blk, pos, sub, value, length = (np.concatenate(col) for col in zip(*items))
    order = np.lexsort((sub, pos, blk))
    value, length = value[order], length[order]
    item = np.repeat(np.arange(len(value)), length)
    offset = np.arange(len(item)) - np.repeat(np.cumsum(length) - length, length)
    stream = (value[item] >> (length[item] - 1 - offset)) & 1
    stream = np.concatenate([stream, np.ones(-len(stream) % 8, np.int64)])
    return np.packbits(stream.astype(np.uint8)).tobytes().replace(b"\xff", b"\xff\x00")


def encode_jpeg(rgb: np.ndarray, quality: int = 90) -> bytes:
    """(H, W, 3) uint8 RGB -> the bytes of a baseline JFIF file (4:2:0, the
    standard tables), the scan coded in numpy array passes."""
    rgb = np.asarray(rgb, np.float64)
    h, w = rgb.shape[:2]
    s = 5000 / quality if quality < 50 else 200 - 2 * quality
    ql = np.clip((_Q_LUMA * s + 50) // 100, 1, 255).astype(np.int64)
    qc = np.clip((_Q_CHROMA * s + 50) // 100, 1, 255).astype(np.int64)
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    rgb = np.pad(rgb, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    half = lambda p: p.reshape(hp // 2, 2, wp // 2, 2).mean(axis=(1, 3))  # noqa: E731
    planes = (_quantised_blocks(y, ql), _quantised_blocks(half(cb), qc), _quantised_blocks(half(cr), qc))
    # scan order: each 16x16 MCU's four Y blocks (row by row), then Cb, then Cr
    my, mx = hp // 16, wp // 16
    luma = planes[0].reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
    mcus = np.concatenate([luma, planes[1][:, :, None], planes[2][:, :, None]], axis=2).reshape(-1, 64)
    scan = _scan_bits(mcus, np.tile([0, 0, 0, 0, 1, 2], my * mx))

    def segment(marker, payload):
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    dqt = bytes([0]) + bytes(ql[_ZIGZAG].tolist()) + bytes([1]) + bytes(qc[_ZIGZAG].tolist())
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = bytes([0x00] + _DC_BITS + _DC_VALS + [0x10] + _AC_BITS + _AC_VALS)
    sos = bytes([3, 1, 0x00, 2, 0x00, 3, 0x00, 0, 63, 0])
    return (b"\xff\xd8" + segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00") + segment(0xDB, dqt)
            + segment(0xC0, sof) + segment(0xC4, dht) + segment(0xDA, sos) + scan + b"\xff\xd9")


def encode_jpegs(images) -> list:
    """`encode_jpeg` of each (image, boxes) pair's image, in a thread pool
    (the array passes release the interpreter lock)."""
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        return list(pool.map(lambda item: encode_jpeg(item[0]), images))


def _background(rs, h: int, w: int) -> np.ndarray:
    """A smooth gradient from three random colours, in integer arithmetic
    only (the same pixels on any machine), (h, w, 3) int64."""
    c = rs.randint(0, 256, (3, 3)).astype(np.int64)
    yy, xx = np.mgrid[0:h, 0:w]
    return ((c[0] * (w - 1 - xx[..., None]) + c[1] * xx[..., None]) * (h - 1 - yy[..., None])
            + c[2] * (w - 1) * yy[..., None]) // ((w - 1) * (h - 1))


def synth_image(seed: int, h: int, w: int, n_classes: int):
    """A smooth background with 1-4 solid boxes, and its boxes as (x0, y0,
    x1, y1, class)."""
    rs = np.random.RandomState(seed)
    img = _background(rs, h, w)
    boxes = []
    for _ in range(rs.randint(1, 5)):
        bw, bh = rs.randint(40, 200), rs.randint(40, 160)
        x0, y0 = rs.randint(0, w - bw), rs.randint(0, h - bh)
        img[y0:y0 + bh, x0:x0 + bw] = rs.randint(0, 256, 3)
        boxes.append((int(x0), int(y0), int(x0 + bw), int(y0 + bh), int(rs.randint(0, n_classes))))
    return img.astype(np.uint8), boxes


def synth_voc_image(k: int):
    """Image k of the synthetic VOC tree (VOC_W x VOC_H, the 20 classes)."""
    return synth_image(1000 + k, VOC_H, VOC_W, NUM_CLASSES)


def write_voc_tree(root: str):
    """A VOC tree under `root`/PascalVOC/VOCdevkit: the VOC_IMAGES images
    written in turn under the names of each split of VOC_SPLITS, each name
    with its own XML of the image's 1-4 boxes (every fifth name marks its
    first object difficult); returns the JPEGs' mean size in bytes."""
    images = [synth_voc_image(k) for k in range(VOC_IMAGES)]
    jpegs = encode_jpegs(images)
    classes = load_names("pascalvoc")
    n = 0
    for (year, split), count in VOC_SPLITS.items():
        vroot = os.path.join(root, "PascalVOC", "VOCdevkit", f"VOC{year}")
        for d in ("ImageSets/Main", "Annotations", "JPEGImages"):
            os.makedirs(os.path.join(vroot, d), exist_ok=True)
        names = []
        for i in range(count):
            name = f"{year}_{split}_{i:06d}"
            k, n = n % VOC_IMAGES, n + 1
            with open(os.path.join(vroot, "JPEGImages", name + ".jpg"), "wb") as f:
                f.write(jpegs[k])
            objs = "".join(
                f"<object><name>{classes[c]}</name><difficult>{int(j == 0 and i % 5 == 0)}</difficult>"
                f"<bndbox><xmin>{x0 + 1}</xmin><ymin>{y0 + 1}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox>"
                "</object>"
                for j, (x0, y0, x1, y1, c) in enumerate(images[k][1]))
            with open(os.path.join(vroot, "Annotations", name + ".xml"), "w") as f:
                f.write(f"<annotation><size><width>{VOC_W}</width><height>{VOC_H}</height><depth>3</depth></size>"
                        f"{objs}</annotation>")
            names.append(name)
        with open(os.path.join(vroot, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return sum(len(j) for j in jpegs) / len(jpegs)


def probe_host():
    """What the host offers the JPEG core: g++, libjpeg, nvJPEG, cores."""
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60).stdout.splitlines()
    ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True, timeout=60).stdout
    return {
        "g++": gxx[0] if gxx else None,
        "jpeglib.h": native._have_libjpeg(),
        "libjpeg.so": "libjpeg.so" in ldconfig,
        "nvjpeg.h": (native.CUDA_HOME / "include" / "nvjpeg.h").exists(),
        "libnvjpeg.so": (native.CUDA_HOME / "lib64" / "libnvjpeg.so").exists(),
        "cpu_count": os.cpu_count(),
    }


def libjpeg_reference():
    """The arrays of LIBJPEG_REF from the libjpeg build: for each image of
    LIBJPEG_REF_IMAGES the writer's file and the decoded pixels less the
    source pixels (int16).  Write the file with
    `python -c "import chip_smoke as c; c.write_libjpeg_reference()"`
    where the core builds with libjpeg."""
    check(native.decoder() == "libjpeg", f"the reference needs the libjpeg build, not {native.decoder()}")
    out = {"count": np.array(len(LIBJPEG_REF_IMAGES)), "image": np.array(LIBJPEG_REF_IMAGES)}
    with tempfile.TemporaryDirectory() as tmp:
        for k, i in enumerate(LIBJPEG_REF_IMAGES):
            src = synth_voc_image(i)[0]
            raw = encode_jpeg(src)
            with open(f"{tmp}/{k}.jpg", "wb") as f:
                f.write(raw)
            out[f"jpeg{k}"] = np.frombuffer(raw, np.uint8)
            out[f"diff{k}"] = native.decode(f"{tmp}/{k}.jpg").astype(np.int16) - src
    return out


def write_libjpeg_reference():
    np.savez_compressed(LIBJPEG_REF, **libjpeg_reference())


def decoder_vs_libjpeg():
    """The built decoder's pixels of the reference files against the
    libjpeg build's (LIBJPEG_REF)."""
    ref = np.load(LIBJPEG_REF)
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(int(ref["count"])):
            src = synth_voc_image(int(ref["image"][k]))[0]
            raw = ref[f"jpeg{k}"].tobytes()
            path = f"{tmp}/ref{k}.jpg"
            with open(path, "wb") as f:
                f.write(raw)
            got = native.decode(path).astype(np.int16)
            lib = src.astype(np.int16) + ref[f"diff{k}"]
            d = np.abs(got - lib)
            out.append({"image": int(ref["image"][k]), "max_abs": int(d.max()), "mean_abs": float(d.mean()),
                        "equal_share": float((d == 0).mean()),
                        "writer_bytes_equal": encode_jpeg(src) == raw})
    return out


def _arrivals(loader):
    """(seconds to the first batch, batches/s over the second half of the
    pass: the first half holds the burst of batches decoded while the
    first was awaited) of one pass."""
    t0 = time.perf_counter()
    times = [time.perf_counter() for _ in loader]
    h = len(times) // 2
    return times[0] - t0, (len(times) - 1 - h) / (times[-1] - times[h])


def time_loaders(root: str, workers: int, card: str):
    """Host throughput of the loader's two routes on the tree (LOADER_PASSES
    or DETECT_PASSES passes over the split in one iteration: the first
    batch's latency apart from the steady rate), the train plans alone, and
    the core's decode."""
    figures = {}
    train = VOCDetection(root=f"{root}/PascalVOC/VOCdevkit", splits=[(2007, "trainval"), (2012, "trainval")])
    order = np.random.RandomState(0).permutation(np.tile(np.arange(len(train)), LOADER_PASSES))
    for size in (416, 608):
        rs, rnd = np.random.RandomState(0), random.Random(0)
        loader = DetectionLoader(
            train, TWIN_BATCH, last_batch="discard", num_workers=workers, sampler=lambda epoch: order,
            num_samples=len(order), transform_factory=lambda w, h: YOLO3DefaultTrainTransform(w, h, rs, rnd),
            shape_sizes=[size])
        first, rate = _arrivals(loader)
        figures[f"train_b{TWIN_BATCH}_{size}"] = {"first_batch_s": first, "batches_s": rate,
                                                  "images_s": rate * TWIN_BATCH, "batches": len(loader)}
    tf = YOLO3DefaultTrainTransform(SIZE, SIZE, np.random.RandomState(1), random.Random(1))
    t0 = time.perf_counter()
    for i in range(len(train)):
        label, (w, h) = train.label_and_size(i)
        tf.plan(label, int(w), int(h))
    figures["plan_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / len(train)
    test = detect_files(root)
    loader = DetectionLoader(test, DETECT_BATCH, num_workers=workers, native_decode=(SIZE, SIZE))
    first, rate = _arrivals(loader)
    figures[f"inference_b{DETECT_BATCH}_{SIZE}"] = {"first_batch_s": first, "batches_s": rate,
                                                    "images_s": rate * DETECT_BATCH, "batches": len(loader)}
    paths = [test.sample_path(i) for i in range(min(VOC_IMAGES, len(test)))]
    for threads in (1, workers):
        t0 = time.perf_counter()
        native.load_batch(paths, SIZE, SIZE, threads=threads)
        figures[f"decode_resize_ms_per_image_{threads}_threads"] = (time.perf_counter() - t0) * 1e3 / len(paths)
    t0 = time.perf_counter()
    for p in paths:
        native.decode(p)
    figures["decode_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / len(paths)
    for k, v in figures.items():
        print(f"slice 5 loader {k} on {card}'s host ({workers} workers): {v}")
    return figures


def detect_files(root: str) -> DetectSet:
    """The test split's files DETECT_PASSES times over, for steady rates."""
    test = VOCDetection(root=f"{root}/PascalVOC/VOCdevkit", splits=[(2007, "test")], inference=True)
    return DetectSet([test.sample_path(i) for i in range(len(test))] * DETECT_PASSES)


def write_darknet53_params(path: str, seed: int):
    """A seeded Darknet53 written as gluoncv's darknet53 `.params` (its
    conv{K} / batchnorm{K} names, OIHW); returns the variables written."""
    base = Darknet53()
    init_weights(base, torch.Generator().manual_seed(seed))
    v = variables_of(base)
    out = {}
    for k, (conv_path, bn_path) in enumerate(gluon_import._flax_darknet_conv_paths()):
        out[f"darknetv30_conv{k}_weight"] = np.transpose(gluon_import._get(v["params"], conv_path)["kernel"],
                                                         (3, 2, 0, 1))
        bn, st = gluon_import._get(v["params"], bn_path), gluon_import._get(v["batch_stats"], bn_path)
        for name, leaf in (("gamma", bn["scale"]), ("beta", bn["bias"]), ("running_mean", st["mean"]),
                           ("running_var", st["var"])):
            out[f"darknetv30_batchnorm{k}_{name}"] = leaf
    gluon_import.write_mxnet_params(path, out)
    return v


@contextlib.contextmanager
def logged_speed():
    """Collect the train twin's "Speed:" and "done in" log lines while in the
    block."""
    lines = []

    class Speed(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "Speed:" in msg or "done in" in msg:
                lines.append(msg)

    root_logger = logging.getLogger()
    handler, level = Speed(), root_logger.level
    root_logger.addHandler(handler)
    root_logger.setLevel(logging.INFO)
    try:
        yield lines
    finally:
        root_logger.removeHandler(handler)
        root_logger.setLevel(level)


def _step_summary(steps):
    """(images/s, wait share) over the steps after each shape's first, and
    the first steps of each shape apart."""
    firsts, rest, seen = [], [], set()
    for shape, secs, wait in steps:
        (rest if shape in seen else firsts).append((shape, secs, wait))
        seen.add(shape)
    secs = sum(s for _, s, _ in rest)
    return {
        "steady_images_s": len(rest) * TWIN_BATCH / secs if secs else None,
        "steady_wait_share": sum(w for _, _, w in rest) / secs if secs else None,
        "steady_steps": len(rest),
        "first_steps": [{"shape": s, "ms": t * 1e3, "wait_ms": w * 1e3} for s, t, w in firsts],
    }


def data_slice5(dev, card):
    """Phase 10.  Returns (the phase's figures, K1's launches on the slice 5
    paths)."""
    figures = {"probe": probe_host()}
    print(f"slice 5 probe: {json.dumps(figures['probe'])}")
    figures["decoder"] = native.decoder()
    print(f"slice 5 JPEG core built with {figures['decoder']} (videoyolo_torch/csrc/loader.cc, native.py)")
    figures["decoder_vs_libjpeg"] = decoder_vs_libjpeg()
    for r in figures["decoder_vs_libjpeg"]:
        print(f"slice 5 {figures['decoder']} pixels vs the libjpeg build's, image {r['image']} "
              f"({VOC_W}x{VOC_H}): max abs {r['max_abs']}, mean abs {r['mean_abs']:.4f}, "
              f"equal share {r['equal_share']:.4f}; the writer's bytes equal the reference's: "
              f"{r['writer_bytes_equal']}")
    workers = os.cpu_count() or 1
    k1 = {}
    with logged_speed() as speed:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            figures["jpeg_bytes_mean"] = write_voc_tree(tmp)
            figures["tree_s"] = time.perf_counter() - t0
            print(f"slice 5 VOC tree: {VOC_IMAGES} distinct {VOC_W}x{VOC_H} JPEGs "
                  f"({figures['jpeg_bytes_mean']:.0f} bytes each) under {sum(VOC_SPLITS.values())} names, "
                  f"written in {figures['tree_s']:.1f} s")
            figures["loader"] = time_loaders(tmp, workers, card)

            # the train twin: bf16, B=48, 416 px fixed, one epoch, validated
            exp = f"{tmp}/exp"
            argv = ["--dataset_root", tmp, "--batch_size", str(TWIN_BATCH), "--data_shape", str(SIZE),
                    "--no_random_shape", "--epochs", "1", "--nopretrained_cnn", "--dtype", "bf16",
                    "--save_prefix", "0000", "--experiment_root", exp, "--save_interval", "1",
                    "--log_interval", "1", "--num_workers", str(workers)]
            nms_greedy.launches = 0
            model, stats = train_yolov3.main(argv)
            torch.cuda.synchronize()
            k1["train_twin_validation"] = nms_greedy.launches
            n_val = -(-VOC_TEST // TWIN_BATCH)
            check(k1["train_twin_validation"] == n_val,
                  f"K1 launches in the train twin's validation: {k1['train_twin_validation']}, expected {n_val}")
            ep = stats["epochs"][0]
            twin = {"samples_s": ep["samples_s"], "wait_share": ep["wait_s"] / ep["seconds"],
                    "steps": len(ep["steps"]), **_step_summary(ep["steps"]), "val": stats["val"],
                    "logged": list(speed)}
            figures["train_twin"] = twin
            print(f"slice 5 train twin (bf16, B={TWIN_BATCH}, {SIZE} px, one epoch of {ep['samples']} images) on "
                  f"{card}: {ep['samples_s']:.1f} samples/s over the epoch, {twin['steady_images_s']:.1f} after "
                  f"the first step, waiting on the prefetcher {twin['wait_share']:.3f} of the epoch "
                  f"({twin['steady_wait_share']:.3f} after the first step); validation "
                  f"{stats['val'][0]['seconds']:.2f} s, mAP {stats['val'][0]['map']:.4f}")
            for line in speed:
                print(f"  logged: {line}")
            ckpt = f"{exp}/0000/yolo3_darknet53_voc_0000.params"
            check(os.path.exists(ckpt), f"the train twin wrote no checkpoint {ckpt}")

            # the detect twin on the test split from the checkpoint, then its
            # cached run
            argv_d = ["--dataset", "voc", "--dataset_root", tmp, "--data_shape", str(SIZE), "--batch_size",
                      str(DETECT_BATCH), "--dtype", "bf16", "--model_path", ckpt, "--save_dir", f"{tmp}/res",
                      "--save_prefix", "run", "--num_workers", str(workers)]
            runs = []
            for label in ("detect", "cached"):
                nms_greedy.launches = 0
                t0 = time.perf_counter()
                preds = detect.main(argv_d)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0, nms_greedy.launches, preds))
            k1["detect_twin"], k1["detect_twin_cached"] = runs[0][1], runs[1][1]
            n_det = -(-VOC_TEST // DETECT_BATCH)
            check(runs[0][1] == n_det, f"K1 launches in the detect twin: {runs[0][1]}, expected {n_det}")
            check(runs[1][1] == 0, f"the cached detect run launched K1 {runs[1][1]} times, expected 0")
            check(os.path.exists(f"{tmp}/res/run/voc.txt"), "the detect twin wrote no voc.txt")
            test = VOCDetection(root=f"{tmp}/PascalVOC/VOCdevkit", splits=[(2007, "test")], inference=True)
            all_paths = [test.sample_path(i) for i in range(len(test))]
            check(all(runs[0][2].get(p, []) == runs[1][2].get(p, []) for p in all_paths),
                  "the cached run's predictions differ from the detect run's")
            figures["detect_twin"] = {"images_s_disk_to_voc_txt": VOC_TEST / runs[0][0], "seconds": runs[0][0],
                                      "cached_seconds": runs[1][0], "voc_txt": open(f"{tmp}/res/run/voc.txt").read()[-40:]}
            # the detect loop alone, warm, over the test files DETECT_PASSES
            # times: JPEG on disk to predictions
            cfg = YoloConfig(num_classes=NUM_CLASSES)
            twin = Detector(cfg, detect.load_model_variables(ckpt, cfg), dtype=torch.bfloat16, data_shape=SIZE)
            files = detect_files(tmp)
            for label in ("warm", "timed"):
                nms_greedy.launches = 0
                t0 = time.perf_counter()
                detect.detect_dataset(twin, files, DetectionLoader(files, DETECT_BATCH, num_workers=workers,
                                                                   native_decode=(SIZE, SIZE)))
                torch.cuda.synchronize()
                loop_s = time.perf_counter() - t0
            k1["detect_loop"] = nms_greedy.launches
            check(k1["detect_loop"] == -(-len(files) // DETECT_BATCH), f"K1 launches in the detect loop: {k1}")
            # what bounds it: the loader with the copies to the card and no
            # step, and the step alone on a batch already on the card
            t0 = time.perf_counter()
            for batch in device_prefetch(iter(DetectionLoader(files, DETECT_BATCH, num_workers=workers,
                                                              native_decode=(SIZE, SIZE))), dev, keys=("image",)):
                last = batch["image"]
            torch.cuda.synchronize()
            copy_s = time.perf_counter() - t0
            step_ms = median_ms(lambda: twin(last), 10)
            figures["detect_twin"].update(loop_images_s=len(files) / loop_s, loader_copy_images_s=len(files) / copy_s,
                                          step_images_s=DETECT_BATCH / step_ms * 1e3)
            print(f"slice 5 detect loop (bf16, B={DETECT_BATCH}, {SIZE} px, warm) on {card}: {len(files)} JPEGs "
                  f"to predictions in {loop_s:.3f} s, {len(files) / loop_s:.1f} images/s; the loader with its "
                  f"copies to the card and no step {len(files) / copy_s:.1f} images/s; the step alone "
                  f"{step_ms:.3f} ms a batch ({DETECT_BATCH / step_ms * 1e3:.1f} images/s)")
            print(f"slice 5 detect twin (bf16, B={DETECT_BATCH}, {SIZE} px) on {card}: {VOC_TEST} JPEGs to "
                  f"voc.txt in {runs[0][0]:.2f} s ({VOC_TEST / runs[0][0]:.1f} images/s, model load included), "
                  f"K1 launched {runs[0][1]} times; cached run {runs[1][0]:.2f} s, K1 launched 0 times")

            # the checkpoint's detections through the twin against the
            # trained model's eval step on the first batch, bit for bit; and
            # the raw scores of a Detector loaded as the twin loads it
            paths = all_paths[:DETECT_BATCH]
            images = torch.from_numpy(native.load_batch(paths, SIZE, SIZE)[0]).to(dev)
            ids, sc, bb = (a.cpu().numpy() for a in make_eval_step(model)(images))
            ref = {}
            for i, p in enumerate(paths):
                collect_boxes(ref, p, ids[i], sc[i], np.clip(bb[i], 0, SIZE), SIZE)
            check(all(runs[0][2].get(p, []) == ref[p] for p in paths),
                  "the detect twin's detections from the checkpoint differ from the trained model's eval step")
            with torch.inference_mode():
                raw_twin, raw_trained = twin.model(twin._normalized(images)), model(images)
            check(all(torch.equal(a, b) for a, b in zip(raw_twin, raw_trained)),
                  "the raw outputs of the checkpoint's model differ from the trained model's")
            n_rows = sum(map(len, ref.values()))
            print(f"slice 5 checkpoint -> detect twin --model_path: the first batch's {n_rows} detections equal "
                  f"the trained model's eval step bit for bit, and so do the raw boxes and scores "
                  f"(max score {float(raw_trained[1].max()):.4g})")
            del twin
            del model
            torch.cuda.empty_cache()

            # a darknet53 .params from the port's writer, through
            # --pretrained_base_path, in a short random-shape run
            base_path = f"{tmp}/darknet53_seeded.params"
            written = write_darknet53_params(base_path, seed=5)
            probe_model = YOLOv3(num_classes=NUM_CLASSES)
            train_yolov3._load_pretrained_base(train_yolov3.parse_args(["--pretrained_base_path", base_path]),
                                               probe_model)
            loaded = variables_of(probe_model)
            same = all(np.array_equal(a, b) for (_, a), (_, b) in zip(
                walk({"params": loaded["params"]["backbone"], "batch_stats": loaded["batch_stats"]["backbone"]}),
                walk(written)))
            check(same, "the darknet53 .params loaded through --pretrained_base_path differs from what was written")
            argv_r = ["--dataset_root", tmp, "--batch_size", str(TWIN_BATCH), "--epochs", "2", "--val_interval", "0",
                      "--save_interval", "0", "--dtype", "bf16", "--pretrained_base_path", base_path,
                      "--save_prefix", "0000", "--experiment_root", f"{tmp}/exp_random", "--log_interval", "1",
                      "--num_workers", str(workers), "--seed", "7"]
            speed.clear()
            _, stats_r = train_yolov3.main(argv_r)
            steps = [s for ep in stats_r["epochs"] for s in ep["steps"]]
            rand = {"steps": len(steps), **_step_summary(steps),
                    "samples_s": sum(ep["samples"] for ep in stats_r["epochs"])
                    / sum(ep["seconds"] for ep in stats_r["epochs"]), "logged": list(speed)}
            figures["random_shapes"] = rand
            print(f"slice 5 random shapes (bf16, B={TWIN_BATCH}, 320-608 px, {len(steps)} steps, base from the "
                  f"port's darknet53 .params) on {card}: {rand['samples_s']:.1f} samples/s over the run, "
                  f"{rand['steady_images_s']:.1f} images/s past each shape's first step (wait share "
                  f"{rand['steady_wait_share']:.3f}); first steps: {rand['first_steps']}")
    k1["total"] = sum(k1.values())
    figures["k1"] = k1
    return figures, k1["total"]


# ---------------------------------------------------------------------------
# phase 11: slice 6, COCO, ImageNet-DET and ImageNet-VID from disk
# ---------------------------------------------------------------------------

COCO_IMAGES = 16  # distinct images, written under every name of the tree
COCO_W, COCO_H = 640, 480
COCO_SPLITS = {"train2017": 480, "val2017": 256}
COCO_VAL = COCO_SPLITS["val2017"]
COCO_CLASSES = 80
DET_VAL, DET_CLASSES = 64, 200
VID_SNIPPETS, VID_FRAMES, VID_EVERY = 4, 32, 2
VID_W, VID_H = 640, 360
VID_VAL = VID_SNIPPETS * VID_FRAMES // VID_EVERY
SLICE6_LOOP_IMAGES = 512  # images of each warm detect loop: its split's files over and over


def _coco_ann(aid, img_id, cat, bbox, iscrowd=0):
    return {"id": aid, "image_id": img_id, "category_id": cat, "bbox": [float(v) for v in bbox],
            "area": float(bbox[2] * bbox[3]), "iscrowd": iscrowd}


def write_coco_tree(root: str, images, jpegs) -> None:
    """`root`/MSCoco: the distinct images written in turn under the names of
    each split, image ids 100000 + 7n, each name with its own annotations:
    the image's 1-4 boxes under their json category ids (1-90 with gaps), a
    crowd over the first box on every fourth name, a 3x2 box (under any
    minimum area) on every fifth; one val name in 32 without boxes."""
    names, ids = load_names("coco"), [int(i) for i in load_names("coco_ids")]
    cats = [{"id": i, "name": n} for i, n in zip(ids, names)]
    base = os.path.join(root, "MSCoco")
    os.makedirs(os.path.join(base, "annotations"), exist_ok=True)
    n, aid = 0, 1
    for split, count in COCO_SPLITS.items():
        os.makedirs(os.path.join(base, "images", split), exist_ok=True)
        entries, anns = [], []
        for i in range(count):
            k, n = n % len(images), n + 1
            img_id = 100000 + 7 * n
            fname = f"{img_id:012d}.jpg"
            with open(os.path.join(base, "images", split, fname), "wb") as f:
                f.write(jpegs[k])
            entries.append({"id": img_id, "width": COCO_W, "height": COCO_H, "file_name": fname,
                            "coco_url": f"http://images.cocodataset.org/{split}/{fname}"})
            if split == "val2017" and i % 32 == 31:
                continue
            boxes = images[k][1]
            for x0, y0, x1, y1, c in boxes:
                anns.append(_coco_ann(aid, img_id, ids[c], (x0, y0, x1 - x0, y1 - y0)))
                aid += 1
            if i % 4 == 0:
                x0, y0, x1, y1, c = boxes[0]
                cx0, cy0 = max(x0 - 8, 0), max(y0 - 8, 0)
                anns.append(_coco_ann(aid, img_id, ids[c], (cx0, cy0, min(x1 + 8, COCO_W) - cx0,
                                                             min(y1 + 8, COCO_H) - cy0), iscrowd=1))
                aid += 1
            if i % 5 == 0:
                anns.append(_coco_ann(aid, img_id, ids[boxes[-1][4]], (5, 5, 3, 2)))
                aid += 1
        with open(os.path.join(base, "annotations", f"instances_{split}.json"), "w") as f:
            json.dump({"images": entries, "annotations": anns, "categories": cats}, f)


def write_det_tree(root: str, images, jpegs, split: str = "val", count: int = DET_VAL) -> None:
    """`root`/ImageNetDET/ILSVRC: `count` names of `split` over the distinct
    images, .JPEG, each XML with the image's boxes (0-based) under WordNet
    ids."""
    wn = load_names("imagenetdet_wn")
    base = os.path.join(root, "ImageNetDET", "ILSVRC")
    for d in ("ImageSets/DET", f"Data/DET/{split}", f"Annotations/DET/{split}"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    lines = []
    for i in range(count):
        k = i % len(images)
        name = f"ILSVRC2012_{split}_{i + 1:08d}"
        lines.append(f"{name} {i + 1}")
        with open(os.path.join(base, "Data", "DET", split, name + ".JPEG"), "wb") as f:
            f.write(jpegs[k])
        objs = "".join(f"<object><name>{wn[(c * 5 + i) % DET_CLASSES]}</name><bndbox><xmin>{x0}</xmin>"
                       f"<ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>"
                       for x0, y0, x1, y1, c in images[k][1])
        with open(os.path.join(base, "Annotations", "DET", split, name + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>{COCO_W}</width><height>{COCO_H}</height></size>{objs}</annotation>")
    with open(os.path.join(base, "ImageSets", "DET", f"{split}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def vid_snippet(s: int, seed: int = 3000):
    """Snippet s of the VID tree: its frames (VID_H x VID_W, a smooth
    background with 1-3 solid boxes moving in straight lines, each box in
    every frame) and each frame's boxes as (x0, y0, x1, y1, class, track)."""
    rs = np.random.RandomState(seed + s)
    bg = _background(rs, VID_H, VID_W)
    tracks = []
    for t in range(1 + s % 3):
        bw, bh = int(rs.randint(40, 160)), int(rs.randint(40, 120))
        tracks.append((bw, bh, rs.uniform(0, VID_W - bw), rs.uniform(0, VID_H - bh), rs.uniform(-6, 6),
                       rs.uniform(-4, 4), rs.randint(0, 256, 3), int(rs.randint(0, 30)), t))
    frames, labels = [], []
    for f in range(VID_FRAMES):
        img, boxes = bg.copy(), []
        for bw, bh, x, y, vx, vy, color, cls, t in tracks:
            x0 = int(np.clip(x + vx * f, 0, VID_W - bw))
            y0 = int(np.clip(y + vy * f, 0, VID_H - bh))
            img[y0:y0 + bh, x0:x0 + bw] = color
            boxes.append((x0, y0, x0 + bw, y0 + bh, cls, t))
        frames.append(img.astype(np.uint8))
        labels.append(boxes)
    return frames, labels


def write_vid_tree(root: str, splits=(("val", VID_SNIPPETS, 3000),)) -> None:
    """`root`/ImageNetVID/ILSVRC: for each (split, snippets, seed) that many
    snippets of VID_FRAMES .JPEG frames (`vid_snippet` from the seed),
    frame ids 1, 2, ... in the split file, an XML a frame with each box's
    WordNet id and track id; the snippets are encoded in a thread pool."""
    wn = load_names("imagenetvid_wn")
    base = os.path.join(root, "ImageNetVID", "ILSVRC")
    os.makedirs(os.path.join(base, "ImageSets", "VID"), exist_ok=True)

    def write(split, s, seed):
        video = f"ILSVRC2015_{split}_{s:08d}"
        for d in ("Data", "Annotations"):
            os.makedirs(os.path.join(base, d, "VID", split, video), exist_ok=True)
        frames, labels = vid_snippet(s, seed)
        for f, (img, boxes) in enumerate(zip(frames, labels)):
            with open(os.path.join(base, "Data", "VID", split, video, f"{f:06d}.JPEG"), "wb") as fh:
                fh.write(encode_jpeg(img))
            objs = "".join(f"<object><trackid>{t}</trackid><name>{wn[c]}</name><bndbox><xmin>{x0}</xmin>"
                           f"<ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>"
                           for x0, y0, x1, y1, c, t in boxes)
            with open(os.path.join(base, "Annotations", "VID", split, video, f"{f:06d}.xml"), "w") as fh:
                fh.write(f"<annotation><size><width>{VID_W}</width><height>{VID_H}</height></size>{objs}"
                         "</annotation>")
        return [f"{video}/{f:06d}" for f in range(len(frames))]

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        for split, snippets, seed in splits:
            names = [n for video in pool.map(lambda s: write(split, s, seed), range(snippets)) for n in video]
            with open(os.path.join(base, "ImageSets", "VID", f"{split}.txt"), "w") as fh:
                fh.write("\n".join(f"{n} {i + 1}" for i, n in enumerate(names)) + "\n")


class _PerSampleVOC(VOCDetection):
    """VOC through the per-sample route (the same plans: its XML sizes are
    the JPEGs')."""

    native_train_ok = False


def check_sample_tiles(root: str):
    """The per-sample route's tiles against the core's file route on this
    build: 20 COCO plans (every filter, flips, windows beyond the image) cut
    from decoded pixels by native.crop_resize_pad and by
    native.load_train_batch from the files, and two train batches of a VOC
    epoch through each route from one seed, bit for bit."""
    coco = COCODetection(root=f"{root}/MSCoco", splits=["instances_train2017"])
    tf = YOLO3DefaultTrainTransform(SIZE, SIZE, np.random.RandomState(2), random.Random(2))
    paths, plans = [], []
    for i in range(min(20, len(coco))):
        label, (w, h) = coco.label_and_size(i)
        bbox, rect, flip, _, mat = tf.plan(label, int(w), int(h))
        paths.append(coco.sample_path(i))
        plans.append((bbox, rect, flip, i % 5, mat))
    want = native.load_train_batch(paths, np.array([p[1] for p in plans]), np.array([p[2] for p in plans]),
                                   np.array([p[3] for p in plans]), SIZE, SIZE, tf.fill)
    for i, (path, plan) in enumerate(zip(paths, plans)):
        got = tf.apply(native.decode(path), plan)[0]
        check(np.array_equal(got, want[i]), f"the per-sample tile of {path} (interp {plan[3]}, flip {plan[2]}) "
                                            f"differs from the file route's on {native.decoder()}")
    batches = []
    for cls in (VOCDetection, _PerSampleVOC):
        rs, rnd = np.random.RandomState(4), random.Random(4)
        ds = cls(root=f"{root}/PascalVOC/VOCdevkit", splits=[(2007, "trainval"), (2012, "trainval")])
        loader = DetectionLoader(ds, TWIN_BATCH, shuffle=True, seed=4, last_batch="discard", num_workers=4,
                                 transform_factory=lambda w, h: YOLO3DefaultTrainTransform(w, h, rs, rnd),
                                 shape_sizes=[SIZE])
        it = iter(loader)
        batches.append([next(it) for _ in range(2)])
    check(all(set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a) for a, b in zip(*batches)),
          "the per-sample route's VOC batches differ from the native route's")
    return {"tiles": len(paths), "voc_batches": 2, "decoder": native.decoder()}


def time_sample_loaders(root: str, workers: int, card: str):
    """Train batches/s at B=48, 416 px: the native route on VOC, and the
    per-sample route on COCO without and with mixup (LOADER_PASSES passes
    over the split in one iteration; the first batch's latency apart from
    the steady rate); plus the plans and blends drawn alone."""
    figures = {}
    voc = VOCDetection(root=f"{root}/PascalVOC/VOCdevkit", splits=[(2007, "trainval"), (2012, "trainval")])
    coco = COCODetection(root=f"{root}/MSCoco", splits=["instances_train2017"])
    for label, ds, mixup in (("voc_native", voc, False), ("coco_per_sample", coco, False),
                             ("coco_per_sample_mixup", coco, True)):
        order = np.random.RandomState(0).permutation(np.tile(np.arange(len(ds)), LOADER_PASSES))
        rs, rnd = np.random.RandomState(0), random.Random(0)
        loader = DetectionLoader(
            MixupDetection(ds, rs) if mixup else ds, TWIN_BATCH, last_batch="discard", num_workers=workers,
            sampler=lambda epoch, o=order: o, num_samples=len(order), shape_sizes=[SIZE],
            transform_factory=lambda w, h: YOLO3DefaultTrainTransform(w, h, rs, rnd))
        first, rate = _arrivals(loader)
        figures[label] = {"first_batch_s": first, "batches_s": rate, "images_s": rate * TWIN_BATCH,
                          "batches": len(loader)}
    tf = YOLO3DefaultTrainTransform(SIZE, SIZE, np.random.RandomState(1), random.Random(1))
    mixer = MixupDetection(coco, np.random.RandomState(1))
    t0 = time.perf_counter()
    for i in range(len(coco)):
        label = coco.label_and_size(i)[0]
        h, w = native.image_size(coco.sample_path(i))
        mixer.draw()
        tf.plan(label, w, h)
    figures["draw_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / len(coco)
    for k, v in figures.items():
        print(f"slice 6 train loader {k} (B={TWIN_BATCH}, {SIZE} px) on {card}'s host ({workers} workers): {v}")
    return figures


def data_slice6(dev, card):
    """Phase 11.  Returns (the phase's figures, K1's launches on the slice 6
    paths)."""
    figures, k1 = {}, {}
    workers = os.cpu_count() or 1
    with logged_speed() as speed, tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        images = [synth_image(2000 + k, COCO_H, COCO_W, COCO_CLASSES) for k in range(COCO_IMAGES)]
        jpegs = encode_jpegs(images)
        write_coco_tree(tmp, images, jpegs)
        write_det_tree(tmp, images, jpegs)
        write_vid_tree(tmp)
        write_voc_tree(tmp)
        figures["tree_s"] = time.perf_counter() - t0
        print(f"slice 6 trees: COCO ({COCO_IMAGES} distinct {COCO_W}x{COCO_H} JPEGs under {COCO_SPLITS} names, "
              f"80 classes), DET ({DET_VAL} val names), VID ({VID_SNIPPETS} snippets of {VID_FRAMES} "
              f"{VID_W}x{VID_H} frames), VOC; written in {figures['tree_s']:.1f} s")
        figures["tile_check"] = check_sample_tiles(tmp)
        print(f"slice 6 per-sample tiles equal the file route's bit for bit on {native.decoder()}: "
              f"{figures['tile_check']}")
        figures["loader"] = time_sample_loaders(tmp, workers, card)

        # the train twin on COCO with mixup: bf16, B=48, random shapes, one
        # epoch, validated with the COCO metric
        exp = f"{tmp}/exp"
        argv = ["--dataset", "coco", "--dataset_root", tmp, "--batch_size", str(TWIN_BATCH), "--data_shape",
                str(SIZE), "--epochs", "1", "--mixup", "--no_mixup_epochs", "0", "--nopretrained_cnn", "--dtype",
                "bf16", "--save_prefix", "0000", "--experiment_root", exp, "--save_interval", "1",
                "--log_interval", "1", "--num_workers", str(workers)]
        nms_greedy.launches = 0
        model, stats = train_yolov3.main(argv)
        torch.cuda.synchronize()
        k1["coco_train_twin_validation"] = nms_greedy.launches
        n_val = -(-COCO_VAL // TWIN_BATCH)
        check(k1["coco_train_twin_validation"] == n_val,
              f"K1 launches in the COCO train twin's validation: {k1['coco_train_twin_validation']}, "
              f"expected {n_val}")
        ep = stats["epochs"][0]
        check(ep["samples"] == COCO_SPLITS["train2017"] // TWIN_BATCH * TWIN_BATCH, f"epoch samples {ep['samples']}")
        twin = {"samples_s": ep["samples_s"], "wait_share": ep["wait_s"] / ep["seconds"], "steps": len(ep["steps"]),
                **_step_summary(ep["steps"]), "val": stats["val"], "logged": list(speed)}
        figures["train_twin"] = twin
        print(f"slice 6 train twin (COCO, --mixup, bf16, B={TWIN_BATCH}, random shapes, one epoch of "
              f"{ep['samples']} images) on {card}: {ep['samples_s']:.1f} samples/s over the epoch, "
              f"{twin['steady_images_s']} after each shape's first step, waiting on the prefetcher "
              f"{twin['wait_share']:.3f} of the epoch ({twin['steady_wait_share']} after each shape's first "
              f"step); first steps {twin['first_steps']}; validation "
              f"(COCO metric, {COCO_VAL} images) {stats['val'][0]['seconds']:.2f} s, mAP {stats['val'][0]['map']}")
        for line in speed:
            print(f"  logged: {line}")
        ckpt = f"{exp}/0000/yolo3_darknet53_coco_0000.params"
        check(os.path.exists(ckpt), f"the train twin wrote no checkpoint {ckpt}")

        # the detect twins, B=128: COCO from the checkpoint, DET and VID
        # with seeded random weights (their classes are not COCO's)
        runs = {}
        for name, extra, metrics, n in (("coco", ["--model_path", ckpt], "coco,voc", COCO_VAL),
                                        ("det", [], "voc", DET_VAL),
                                        ("vid", ["--every", str(VID_EVERY)], "vid", VID_VAL)):
            argv_d = ["--dataset", name, "--dataset_root", tmp, "--data_shape", str(SIZE), "--batch_size",
                      str(DETECT_BATCH), "--dtype", "bf16", "--save_dir", f"{tmp}/res", "--save_prefix", name,
                      "--num_workers", str(workers), "--metrics", metrics, *extra]
            nms_greedy.launches = 0
            t0 = time.perf_counter()
            preds = detect.main(argv_d)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            k1[f"{name}_detect_twin"] = nms_greedy.launches
            check(nms_greedy.launches == -(-n // DETECT_BATCH),
                  f"K1 launches in the {name} detect twin: {nms_greedy.launches} for {n} images")
            results = {}
            for m in metrics.split(","):
                path = f"{tmp}/res/{name}/{m}.txt"
                check(os.path.exists(path), f"the {name} detect twin wrote no {m}.txt")
                results[m] = open(path).read().splitlines()[-1]
            runs[name] = preds
            figures[f"detect_twin_{name}"] = {"images": n, "seconds": secs, "images_s_disk_to_metrics": n / secs,
                                              "metrics": results, "detections": sum(map(len, preds.values()))}
            print(f"slice 6 detect twin on {name} (bf16, B={DETECT_BATCH}, {SIZE} px, --metrics {metrics}) on "
                  f"{card}: {n} JPEGs to the metrics in {secs:.2f} s (model load included), K1 launched "
                  f"{nms_greedy.launches} times; {results}")

        # the checkpoint read back: the detect twin's model gives the trained
        # model's raw boxes and scores and its eval step's detections on the
        # first val batch, bit for bit
        cfg = YoloConfig(num_classes=COCO_CLASSES)
        coco_twin = Detector(cfg, detect.load_model_variables(ckpt, cfg), dtype=torch.bfloat16, data_shape=SIZE)
        coco_val = COCODetection(root=f"{tmp}/MSCoco", splits=["instances_val2017"], allow_empty=True,
                                 inference=True)
        paths = [coco_val.sample_path(i) for i in range(DETECT_BATCH)]
        images = torch.from_numpy(native.load_batch(paths, SIZE, SIZE)[0]).to(dev)
        with torch.inference_mode():
            raw_twin, raw_trained = coco_twin.model(coco_twin._normalized(images)), model(images)
        check(all(torch.equal(a, b) for a, b in zip(raw_twin, raw_trained)),
              "the raw outputs of the COCO checkpoint's model differ from the trained model's")
        ids, sc, bb = (a.cpu().numpy() for a in make_eval_step(model)(images))
        ref = {}
        for i, p in enumerate(paths):
            collect_boxes(ref, p, ids[i], sc[i], np.clip(bb[i], 0, SIZE), SIZE)
        check(all(runs["coco"].get(p, []) == ref.get(p, []) for p in paths),
              "the COCO detect twin's detections from the checkpoint differ from the trained model's eval step")
        print(f"slice 6 checkpoint -> detect twin --model_path (80 classes, 255-wide head): raw boxes and scores "
              f"equal the trained model's bit for bit, and so do the first batch's "
              f"{sum(map(len, ref.values()))} detections")
        del model
        torch.cuda.empty_cache()

        # the warm detect loops, JPEG on disk to predictions, each split's
        # files over and over
        loops = (("coco", coco_twin, coco_val),
                 ("det", None, ImageNetDetection(root=f"{tmp}/ImageNetDET/ILSVRC", splits=["val"], allow_empty=True,
                                                 inference=True)),
                 ("vid", None, ImageNetVidDetection(root=f"{tmp}/ImageNetVID/ILSVRC", splits=[(2017, "val")],
                                                    every=VID_EVERY, inference=True)))
        for name, det, ds in loops:
            if det is None:
                det = Detector(YoloConfig(num_classes=ds.num_class), dtype=torch.bfloat16, data_shape=SIZE)
            split = [ds.sample_path(i) for i in range(len(ds))]
            files = DetectSet((split * math.ceil(SLICE6_LOOP_IMAGES / len(split)))[:SLICE6_LOOP_IMAGES])
            for label in ("warm", "timed"):
                nms_greedy.launches = 0
                t0 = time.perf_counter()
                detect.detect_dataset(det, files, DetectionLoader(files, DETECT_BATCH, num_workers=workers,
                                                                  native_decode=(SIZE, SIZE)))
                torch.cuda.synchronize()
                loop_s = time.perf_counter() - t0
            k1[f"{name}_detect_loop"] = nms_greedy.launches
            check(nms_greedy.launches == -(-len(files) // DETECT_BATCH), f"K1 launches in the {name} loop: {k1}")
            figures[f"detect_loop_{name}"] = {"images": len(files), "seconds": loop_s,
                                              "images_s": len(files) / loop_s, "classes": ds.num_class}
            print(f"slice 6 detect loop on {name} (bf16, B={DETECT_BATCH}, {SIZE} px, {ds.num_class} classes, "
                  f"warm) on {card}: {len(files)} JPEGs to predictions in {loop_s:.3f} s, "
                  f"{len(files) / loop_s:.1f} images/s")
            del det
        del coco_twin
        torch.cuda.empty_cache()
    k1["total"] = sum(k1.values())
    figures["k1"] = k1
    print(f"slice 6 K1 launches: {k1}")
    return figures, k1["total"]


# ---------------------------------------------------------------------------
# phase 12: slice 7, VID windows from disk and YOLOv3T training
# ---------------------------------------------------------------------------

# the slice's model: the factory's YOLOv3T on ImageNet-VID's 30 classes with
# the flags that run the correlation (`train_yolov3 --dataset vid --window
# 3,1 --k_join_pos late --corr_pos early --corr_d 4`)
SLICE7 = dict(num_classes=30, k=WINDOW, k_join_pos="late", corr_pos="early", corr_d=4)
SLICE7_CLASSES = SLICE7["num_classes"]
TRAIN_WINDOWS = 16  # 48 frames: the frames of the B=48 2D step
WINDOW_DETECT_BATCH = 32  # slice 2's B=32 windows
CORR_BWD_LAUNCHES = 3  # per train step: one adjoint launch for each level's two cost volumes
VID_TRAIN_SNIPPETS, VID_EVERY7 = 6, 2
WINDOW_LOOP = 256  # windows of the warm detect loop: the val windows over and over
# (name, B, H, W, C, d, stride2): the train step's three levels at B=16 and
# B=1 (at 13x13x1024 one image needs C cut into 64 slabs to fill the card),
# then an odd size at d=2, a stride2 of 2 and C=3, and the edges of the
# adjoint's tiling: ragged last tiles in both axes, C = 20 (a last chunk
# and a last slab of 4 channels), d = 0, a ragged last group of
# displacement columns (steps 11 in groups of 7) and frames misaligned by
# one float (4-byte copies: name "misaligned..."); every pair is two frames
# of a (B, 3, H, W, C) window, taken with its batch stride
CORR_BWD_CASES = [
    ("level1_52x52x256", 16, 52, 52, 256, 4, 1),
    ("level2_26x26x512", 16, 26, 26, 512, 4, 1),
    ("level3_13x13x1024", 16, 13, 13, 1024, 4, 1),
    ("level1_B1", 1, 52, 52, 256, 4, 1),
    ("level2_B1", 1, 26, 26, 512, 4, 1),
    ("level3_B1", 1, 13, 13, 1024, 4, 1),
    ("d2_13x11", 3, 13, 11, 64, 2, 1),
    ("d4_stride2", 4, 26, 26, 64, 4, 2),
    ("C3", 2, 11, 9, 3, 2, 1),
    ("ragged_19x21", 2, 19, 21, 48, 4, 1),
    ("C20", 1, 26, 26, 20, 4, 1),
    ("d0", 2, 13, 13, 32, 0, 1),
    ("d5_ragged_group", 2, 26, 26, 64, 5, 1),
    ("misaligned_26x26x64", 2, 26, 26, 64, 4, 1),
]


def case_window(gen, name, b, h, w, c, dev):
    """A (B, 3, H, W, C) float32 window; for a case named "misaligned..." it
    starts one float into its storage, so its frames' pointers are not
    16-byte aligned."""
    if name.startswith("misaligned"):
        return torch.randn(b * WINDOW * h * w * c + 1, generator=gen, device=dev)[1:].view(b, WINDOW, h, w, c)
    return torch.randn(b, WINDOW, h, w, c, generator=gen, device=dev)


def backward_plan(b, h, w, c, d, stride2, aligned=True, pair=False):
    """The adjoint's plan as a dict for the JSON lines."""
    pl = correlation_kernel.plan_backward(b, h, w, c, d, stride2, aligned, pair)
    return dict(r=pl.r, gx=pl.gx, gy=pl.gy, tile=list(pl.tile), slab=pl.slab, threads=pl.threads, copy=pl.copy,
                smem=pl.smem, grid=list(pl.grid), ctas=pl.ctas)


def corr_backward_times(b, h, w, c, d, stride2, pair=False):
    """(bytes time, operations time) in ms of one adjoint launch on an
    H100: g (B, H, W, D), f1 and f2 read once and gf1, gf2 written once,
    against a multiply and an add for each of gf1's and gf2's terms whose
    partner lies inside the image, and a divide per gradient of a volume.
    The pair: two g and three frames read, three gradients written, the
    work of two volumes and the middle frame's add."""
    steps = d // stride2
    offsets = [i * stride2 for i in range(-steps, steps + 1)]
    n_disp = len(offsets) ** 2
    volumes, frames = (2, 3) if pair else (1, 2)
    nbytes = (volumes * b * h * w * n_disp + 2 * frames * b * h * w * c) * 4
    inside = sum(max(0, h - abs(dy)) for dy in offsets) * sum(max(0, w - abs(dx)) for dx in offsets)
    ops = volumes * (4 * b * c * inside + 2 * b * h * w * c) + (b * h * w * c if pair else 0)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3


def check_corr_backward(dev):
    """Phase 12: the adjoint kernel against its plain version in float32
    on every case of CORR_BWD_CASES (allclose rtol=atol=1e-5, K2's
    tolerance: the same products summed in another order), for one volume
    and for the pair of a window (frames 0 and 2 against frame 1), whose
    gradients must also equal two one-volume launches' bit for bit (frame
    1's their sum).  Returns the max abs error."""
    gen = torch.Generator(device=dev).manual_seed(7)
    max_err = 0.0
    for name, b, h, w, c, d, s2 in CORR_BWD_CASES:
        window = case_window(gen, name, b, h, w, c, dev)
        f1, f2 = window[:, 0], window[:, 1]
        aligned = correlation_kernel.aligned(f1, f2)
        check(not (aligned and name.startswith("misaligned")), f"adjoint {name}: the frames are aligned")
        g = torch.randn(b, h, w, num_corr_channels(d, s2), generator=gen, device=dev)
        got = cost_volume_backward(g, f1, f2, d, s2)
        want = cost_volume_backward_plain(g, f1, f2, d, s2)
        torch.cuda.synchronize()
        err = max(float((a - r).abs().max()) for a, r in zip(got, want))
        check(all(a.shape == r.shape == (b, h, w, c) for a, r in zip(got, want)), f"adjoint {name}: shapes")
        check(all(bool(torch.allclose(a, r, **CORR_TOL)) for a, r in zip(got, want)),
              f"cost volume adjoint {name}: max abs error {err}")
        gb = torch.randn(b, h, w, num_corr_channels(d, s2), generator=gen, device=dev)
        pair = cost_volume_pair_backward(g, gb, window, d, s2)
        want = cost_volume_pair_backward_plain(g, gb, window, d, s2)
        other = cost_volume_backward(gb, window[:, 2], f2, d, s2)
        torch.cuda.synchronize()
        pair_err = float((pair - want).abs().max())
        check(pair.shape == window.shape and bool(torch.allclose(pair, want, **CORR_TOL)),
              f"cost volume adjoint pair {name}: max abs error {pair_err}")
        check(torch.equal(pair[:, 0], got[0]) and torch.equal(pair[:, 2], other[0])
              and torch.equal(pair[:, 1], got[1] + other[1]),
              f"cost volume adjoint pair {name}: not the two one-volume launches' gradients")
        max_err = max(max_err, err, pair_err)
        print(f"cost volume adjoint {name}: B={b} {h}x{w}x{c} d={d} stride2={s2}, frames of a window "
              f"(batch stride {f1.stride(0)}), plan {backward_plan(b, h, w, c, d, s2, aligned)}: max abs error "
              f"{err:.3g}, allclose; the pair (plan grid {backward_plan(b, h, w, c, d, s2, aligned, True)['grid']}) "
              f"{pair_err:.3g}, equal to two launches")
    return max_err


def window_batch(rs, b, size, device, k=WINDOW):
    """`train_batch` for windows: (B, k, S, S, 3) uint8 windows of
    neighbouring frames of one clip, one normalize-only colour map a
    window, gt row 0 [10, 10, 100, 100] class 1."""
    clip = rs.randint(0, 255, (b + k - 1, size, size, 3)).astype(np.uint8)
    batch = train_batch(rs, b, size, "cpu")
    batch["image"] = torch.from_numpy(np.stack([clip[i:i + k] for i in range(b)]))
    return {k: v.to(device) for k, v in batch.items()}


def slice7_model(dtype=torch.bfloat16):
    model = build_model(YoloConfig(**SLICE7, dtype=dtype))
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def check_gradient_through_cost_volume(dev):
    """The stage-1 route through the Corr layer on the card in train mode:
    the output carries CostVolume's backward (the step fails without it),
    and the stage-1 weights get a non-zero gradient from the cost-volume
    channels alone.  Returns the gradient's largest magnitude."""
    model = slice7_model().to(dev, memory_format=torch.channels_last).train()
    x = apply_color(*(window_batch(np.random.RandomState(3), 2, 128, dev)[k] for k in ("image", "color")))
    route = model.frame_routes(x)[0]
    corr = model.corr(route)
    check(corr.grad_fn is not None, "slice 7: the Corr output has no grad_fn: the cost volume cuts the gradient")
    names, stack, seen = set(), [corr.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        names.add(fn.name())
        stack.extend(nxt for nxt, _ in fn.next_functions)
    check(any("CostVolume" in n for n in names), f"slice 7: no CostVolume backward in the Corr graph: {sorted(names)}")
    before = cost_volume_backward.launches
    base = route.shape[1] * route.shape[-1]  # the time-folded channels; the rest are the two cost volumes
    corr[..., base:].float().square().sum().backward()
    torch.cuda.synchronize()
    check(cost_volume_backward.launches - before == 1, "slice 7: the adjoint kernel did not run once for both volumes")
    grad = model.stage1.conv0.Conv_0.weight.grad
    top = float(grad.abs().max()) if grad is not None else 0.0
    check(grad is not None and top > 0 and bool(torch.isfinite(grad).all()),
          f"slice 7: the stage-1 stem gets no gradient through the cost volume ({top})")
    print(f"slice 7 gradient through the cost volume (stage-1 route, B=2 windows at 128 px, bf16): the Corr output's "
          f"graph holds {sorted(n for n in names if 'CostVolume' in n)}, 1 adjoint launch, the stem's largest "
          f"gradient {top:.3g}")
    return top


def time_window_step(dev, card):
    """The B=16-window 416-px bf16 train step of the slice model from a
    seeded init: times (median of 10 after 3 warm, CUDA events), peak
    memory, K2's forward and adjoint launches a step, a profiled step, and
    K2 forward and adjoint per level on the step's own routes."""
    model = slice7_model().to(dev, memory_format=torch.channels_last)
    state = create_train_state(model, lr_schedule("step", 1e-3, steps_per_epoch=100, epochs=10))
    step = make_train_step(model, num_classes=SLICE7_CLASSES)
    batch = window_batch(np.random.RandomState(0), TRAIN_WINDOWS, SIZE, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = statistics.median(cuda_time_ms(lambda: step(state, batch), iters=10, warmup=3))
    peak = torch.cuda.max_memory_allocated()
    cost_volume.launches = cost_volume_backward.launches = 0
    losses = {k: float(v) for k, v in step(state, batch).items()}
    torch.cuda.synchronize()
    launches = (cost_volume.launches, cost_volume_backward.launches)
    check(launches == (CORR_LAUNCHES, CORR_BWD_LAUNCHES), f"slice 7 train step: K2 (forward, adjoint) launches {launches}")
    check(all(np.isfinite(v) for v in losses.values()), f"slice 7 train step losses not finite: {losses}")
    prof = profile_steps([(f"slice 7 train B={TRAIN_WINDOWS} windows", lambda _: step(state, batch), None, 1, 14)], card)
    idle = next(iter(prof.values()), {}).get("idle_share")
    figures = dict(ms=ms, windows_s=TRAIN_WINDOWS / ms * 1e3, frames_s=TRAIN_WINDOWS * WINDOW / ms * 1e3,
                   peak_gib=peak / 2**30, idle_share=idle, launches=dict(zip(("forward", "adjoint"), launches)),
                   losses=losses)
    print(f"slice 7 train step B={TRAIN_WINDOWS} windows of {WINDOW} frames at {SIZE} px bf16 on {card}: "
          f"{figures['windows_s']:.1f} windows/s, {figures['frames_s']:.1f} frames/s ({ms:.3f} ms/step, median of "
          f"10 after 3 warm), peak memory {peak / 2**30:.2f} GiB, idle share {idle}, K2 launches a step: "
          f"{launches[0]} forward + {launches[1]} adjoint")
    # K2 forward and adjoint on the step's routes, level by level
    levels = []
    model.eval()
    with torch.no_grad():
        frames = model.frame_routes(apply_color(batch["image"], batch["color"]))
    d = SLICE7["corr_d"]
    for r in frames:
        b, _, h, w, c = r.shape
        f = r.float()  # the window as the Corr layer hands it over
        f1, f2 = f[:, 0], f[:, 1]
        g, gb = (torch.randn(b, h, w, num_corr_channels(d, 1), device=dev) for _ in range(2))
        fwd = median_ms(lambda: cost_volume(f1, f2, d, 1), 20)
        bwd = median_ms(lambda: cost_volume_pair_backward(g, gb, f, d, 1), 20)
        bwd_plain = median_ms(lambda: cost_volume_pair_backward_plain(g, gb, f, d, 1), 3, warmup=1)
        single = median_ms(lambda: cost_volume_backward(g, f1, f2, d, 1), 20)
        tb, to = corr_backward_times(b, h, w, c, d, 1, pair=True)
        fb, fo = corr_times(b, h, w, c, d, 1)
        plan = backward_plan(b, h, w, c, d, 1, correlation_kernel.aligned(*f.unbind(1)), pair=True)
        levels.append(dict(shape=[b, h, w, c], forward_ms=fwd, adjoint_ms=bwd, adjoint_plain_ms=bwd_plain,
                           adjoint_bytes_ms=tb, adjoint_ops_ms=to, forward_bound_ms=max(fb, fo), adjoint_plan=plan,
                           one_volume_adjoint_ms=single))
        print(f"slice 7 K2 on the step's routes B={b} {h}x{w}x{c} d={d} on {card}: forward {fwd:.4f} ms, adjoint of "
              f"the pair {bwd:.4f} ms (plain {bwd_plain:.3f} ms, bound {max(tb, to):.4f} ms: bytes {tb:.4f}, "
              f"operations {to:.4f}; one volume's {single:.4f} ms) with the plan {plan}")
    figures["levels"] = levels
    figures["k2_forward_ms"] = 2 * sum(lv["forward_ms"] for lv in levels)
    figures["k2_adjoint_ms"] = sum(lv["adjoint_ms"] for lv in levels)
    print(f"slice 7 K2 a train step: forward {figures['k2_forward_ms']:.4f} ms + adjoint {figures['k2_adjoint_ms']:.4f} "
          f"ms over {CORR_LAUNCHES} + {CORR_BWD_LAUNCHES} launches, of the {ms:.3f} ms step")
    del model, state, batch
    return figures


def data_slice7(dev, card):
    """Phase 12.  Returns (the phase's figures, the kernels' launches on its
    paths, the adjoint's figures for the kernels line)."""
    figures, k1, k2 = {}, {}, {}
    workers = os.cpu_count() or 1
    figures["adjoint_max_abs_err"] = check_corr_backward(dev)
    figures["grad_through_cost_volume"] = check_gradient_through_cost_volume(dev)
    torch.cuda.empty_cache()
    figures["card_vs_cpu"] = check_train_card_vs_cpu(
        "slice 7", slice7_model(dtype=None), lambda device: window_batch(np.random.RandomState(1), 2, 128, device),
        SLICE7_CLASSES, "128 px, B=2 windows")
    torch.cuda.empty_cache()
    figures["train_step"] = time_window_step(dev, card)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        nms_greedy.launches = 0
        rec, _ = overfit.run(overfit.parse_args(["--out", f"{tmp}/overfit_k3.json", "--config", "k3"]))
        k1["overfit_k3"] = nms_greedy.launches
        check(rec["pass"], f"overfit k3 fails the JAX package's rule: {rec}")
        print(f"slice 7 overfit k3 (YOLOv3T k=3, late max join, bf16, 160 px, B=8 static windows, 400 steps) on "
              f"{card}: passes the JAX package's rule; loss {rec['loss_first']:.2f} -> {rec['loss_last']:.4f}, mean "
              f"top-1 IoU {rec['mean_top1_iou']:.4f}, class accuracy {rec['top1_class_acc']}, "
              f"{rec['step_ms']:.2f} ms/step on the host's clock")
        figures["overfit_k3"] = rec
    torch.cuda.empty_cache()

    with logged_speed() as speed, tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_vid_tree(tmp, (("train", VID_TRAIN_SNIPPETS, 4000), ("val", VID_SNIPPETS, 3000)))
        figures["tree_s"] = time.perf_counter() - t0
        vid = f"{tmp}/ImageNetVID/ILSVRC"
        val = ImageNetVidDetection(root=vid, splits=[(2017, "val")], every=VID_EVERY7, window=(WINDOW, 1),
                                   inference=True)
        train = ImageNetVidDetection(root=vid, splits=[(2017, "train")], every=VID_EVERY7, window=(WINDOW, 1))
        print(f"slice 7 VID tree: {VID_TRAIN_SNIPPETS} train and {VID_SNIPPETS} val snippets of {VID_FRAMES} "
              f"{VID_W}x{VID_H} frames, written in {figures['tree_s']:.1f} s; {len(train)} train and {len(val)} val "
              f"windows of {WINDOW} at every {VID_EVERY7}th frame")

        # the loader alone on windows: the train route (B=16, 416 px) and the inference route
        loaders = {}
        order = np.random.RandomState(0).permutation(np.tile(np.arange(len(train)), 4))
        rs, rnd = np.random.RandomState(0), random.Random(0)
        loader = DetectionLoader(train, TRAIN_WINDOWS, last_batch="discard", num_workers=workers,
                                 sampler=lambda epoch: order, num_samples=len(order), shape_sizes=[SIZE],
                                 transform_factory=lambda w, h: YOLO3VideoTrainTransform(WINDOW, w, h, rs, rnd))
        vorder = np.tile(np.arange(len(val)), -(-WINDOW_LOOP // len(val)))[:WINDOW_LOOP]
        runs = (("train", TRAIN_WINDOWS, loader),
                ("inference", WINDOW_DETECT_BATCH,
                 DetectionLoader(val, WINDOW_DETECT_BATCH, num_workers=workers, sampler=lambda epoch: vorder,
                                 num_samples=len(vorder), inference_transform=YOLO3VideoInferenceTransform(SIZE, SIZE))))
        for name, b, pass_ in runs:
            # a pass of a few batches: the rate over the whole pass, first batch included (each
            # worker takes a whole batch, so the second half arrives at once), and the first apart
            t0 = time.perf_counter()
            times = [time.perf_counter() for _ in pass_]
            total = times[-1] - t0
            loaders[name] = {"batches": len(times), "first_batch_s": times[0] - t0, "windows_s": len(times) * b / total,
                             "frames_s": len(times) * b * WINDOW / total}
        figures["loader"] = loaders
        for k, v in loaders.items():
            print(f"slice 7 window loader, {k} route ({SIZE} px, {workers} workers) on {card}'s host: {v}")

        # the train twin: bf16, B=16 windows, 416 px, one epoch, validated on val windows
        exp = f"{tmp}/exp"
        argv = ["--dataset", "vid", "--dataset_root", tmp, "--window", f"{WINDOW},1", "--k_join_pos", "late",
                "--corr_pos", "early", "--corr_d", str(SLICE7["corr_d"]), "--every", str(VID_EVERY7),
                "--batch_size", str(TRAIN_WINDOWS), "--data_shape", str(SIZE), "--no_random_shape", "--epochs", "1",
                "--nopretrained_cnn", "--dtype", "bf16", "--save_prefix", "0000", "--experiment_root", exp,
                "--save_interval", "1", "--log_interval", "1", "--num_workers", str(workers)]
        nms_greedy.launches = cost_volume.launches = cost_volume_backward.launches = 0
        model, stats = train_yolov3.main(argv)
        torch.cuda.synchronize()
        n_steps, n_val = len(train) // TRAIN_WINDOWS, -(-len(val) // TRAIN_WINDOWS)
        k1["train_twin_validation"] = nms_greedy.launches
        k2["train_twin"] = (cost_volume.launches, cost_volume_backward.launches)
        check(k1["train_twin_validation"] == n_val, f"slice 7 K1 launches in the train twin: {nms_greedy.launches}")
        check(k2["train_twin"] == (CORR_LAUNCHES * (n_steps + n_val), CORR_BWD_LAUNCHES * n_steps),
              f"slice 7 K2 (forward, adjoint) launches in the train twin: {k2['train_twin']} for {n_steps} steps "
              f"and {n_val} validation batches")
        ep = stats["epochs"][0]
        rest = ep["steps"][1:]
        secs = sum(t for _, t, _ in rest)
        twin = {"samples_s": ep["samples_s"], "wait_share": ep["wait_s"] / ep["seconds"], "steps": len(ep["steps"]),
                "steady_windows_s": len(rest) * TRAIN_WINDOWS / secs if secs else None,
                "steady_wait_share": sum(w for _, _, w in rest) / secs if secs else None,
                "first_step_ms": ep["steps"][0][1] * 1e3, "val": stats["val"], "logged": list(speed)}
        figures["train_twin"] = twin
        print(f"slice 7 train twin (VID windows, bf16, B={TRAIN_WINDOWS}, {SIZE} px, one epoch of {ep['samples']} "
              f"windows) on {card}: {ep['samples_s']:.1f} windows/s over the epoch, {twin['steady_windows_s']} past the "
              f"first step, waiting on the prefetcher {twin['steady_wait_share']} of that; first step "
              f"{twin['first_step_ms']:.0f} ms; validation (VOC mAP, {len(val)} windows) "
              f"{stats['val'][0]['seconds']:.2f} s, mAP {stats['val'][0]['map']}; K2 {k2['train_twin']}, "
              f"K1 {k1['train_twin_validation']}")
        ckpt = f"{exp}/0000/yolo3_darknet53_vid_0000.params"
        check(os.path.exists(ckpt), f"the train twin wrote no checkpoint {ckpt}")

        # the detect twin from that checkpoint: B=32 windows from disk
        argv_d = ["--dataset", "vid", "--dataset_root", tmp, "--window", f"{WINDOW},1", "--k_join_pos", "late",
                  "--corr_pos", "early", "--corr_d", str(SLICE7["corr_d"]), "--every", str(VID_EVERY7),
                  "--model_path", ckpt, "--data_shape", str(SIZE), "--batch_size", str(WINDOW_DETECT_BATCH),
                  "--dtype", "bf16", "--save_dir", f"{tmp}/res", "--save_prefix", "vid", "--num_workers",
                  str(workers), "--metrics", "voc"]
        nms_greedy.launches = cost_volume.launches = 0
        t0 = time.perf_counter()
        preds = detect.main(argv_d)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_batches = -(-len(val) // WINDOW_DETECT_BATCH)
        k1["detect_twin"], k2["detect_twin"] = nms_greedy.launches, (cost_volume.launches, 0)
        check((nms_greedy.launches, cost_volume.launches) == (n_batches, CORR_LAUNCHES * n_batches),
              f"slice 7 detect twin launches (K1, K2) {(nms_greedy.launches, cost_volume.launches)}")
        check(os.path.exists(f"{tmp}/res/vid/voc.txt"), "the window detect twin wrote no voc.txt")
        figures["detect_twin"] = {"windows": len(val), "seconds": secs, "windows_s_disk_to_metrics": len(val) / secs,
                                  "detections": sum(map(len, preds.values())),
                                  "voc": open(f"{tmp}/res/vid/voc.txt").read().splitlines()[-1]}
        print(f"slice 7 detect twin (VID windows from the checkpoint, bf16, B={WINDOW_DETECT_BATCH}, {SIZE} px) on "
              f"{card}: {len(val)} windows to the metrics in {secs:.2f} s (model load included); "
              f"{figures['detect_twin']}")

        # the checkpoint read back: the first batch's raw outputs and detections equal the trained model's
        cfg = YoloConfig(**SLICE7)
        twin_det = Detector(cfg, detect.load_model_variables(ckpt, cfg), dtype=torch.bfloat16, data_shape=SIZE)
        tf = YOLO3VideoInferenceTransform(SIZE, SIZE)
        idxs = range(min(WINDOW_DETECT_BATCH, len(val)))
        images = torch.from_numpy(np.stack([
            tf(np.stack([native.decode(p) for p in val.window_paths(i)]), val.label_and_size(i)[0])[0] for i in idxs
        ])).to(dev)
        model.eval()
        with torch.inference_mode():
            raw_twin, raw_trained = twin_det.model(twin_det._normalized(images)), model(images)
        check(all(torch.equal(a, b) for a, b in zip(raw_twin, raw_trained)),
              "the raw outputs of the window checkpoint's model differ from the trained model's")
        ids, sc, bb = (a.cpu().numpy() for a in make_eval_step(model)(images))
        ref = {}
        for n, i in enumerate(idxs):
            collect_boxes(ref, val.sample_path(i), ids[n], sc[n], np.clip(bb[n], 0, SIZE), SIZE)
        paths = [val.sample_path(i) for i in idxs]
        check(all(preds.get(p, []) == ref.get(p, []) for p in paths),
              "the window detect twin's detections from the checkpoint differ from the trained model's eval step")
        print(f"slice 7 checkpoint -> detect twin --model_path: raw boxes and scores equal the trained model's bit for "
              f"bit, and so do the first batch's {sum(map(len, ref.values()))} detections")
        del model

        # the warm windowed detect loop, JPEG frames on disk to predictions
        order = np.tile(np.arange(len(val)), -(-WINDOW_LOOP // len(val)))[:WINDOW_LOOP]
        for label in ("warm", "timed"):
            nms_greedy.launches = cost_volume.launches = 0
            t0 = time.perf_counter()
            detect.detect_dataset(twin_det, val, DetectionLoader(
                val, WINDOW_DETECT_BATCH, num_workers=workers, sampler=lambda epoch: order, num_samples=len(order),
                inference_transform=tf), max_do=WINDOW_LOOP)
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t0
        n_batches = -(-WINDOW_LOOP // WINDOW_DETECT_BATCH)
        k1["detect_loop"], k2["detect_loop"] = nms_greedy.launches, (cost_volume.launches, 0)
        check((nms_greedy.launches, cost_volume.launches) == (n_batches, CORR_LAUNCHES * n_batches),
              f"slice 7 detect loop launches (K1, K2) {(nms_greedy.launches, cost_volume.launches)}")
        with torch.inference_mode():
            step_ms = median_ms(lambda: twin_det(images), 10)
        figures["detect_loop"] = {"windows": WINDOW_LOOP, "seconds": loop_s, "windows_s": WINDOW_LOOP / loop_s,
                                  "frames_s": WINDOW_LOOP * WINDOW / loop_s,
                                  "step_alone_windows_s": len(idxs) / step_ms * 1e3}
        print(f"slice 7 detect loop on VID windows (bf16, B={WINDOW_DETECT_BATCH}, {SIZE} px, warm) on {card}: "
              f"{WINDOW_LOOP} windows to predictions in {loop_s:.3f} s, {WINDOW_LOOP / loop_s:.1f} windows/s "
              f"({WINDOW_LOOP * WINDOW / loop_s:.1f} frames/s); the step alone {figures['detect_loop']['step_alone_windows_s']:.1f} windows/s")
        del twin_det
        torch.cuda.empty_cache()
    k1["total"] = sum(v for v in k1.values())
    k2["total"] = [sum(v[0] for v in k2.values()), sum(v[1] for v in k2.values())]
    figures["k1"], figures["k2"] = k1, k2
    print(f"slice 7 launches: K1 {k1}, K2 (forward, adjoint) {k2}")
    return figures, k1["total"], k2["total"]


# ---------------------------------------------------------------------------
# phase 13: slice 9, YOLOv3Temporal t=5 (per-frame heads, the correlation
# pyramid and the funnel) through detection, training and both twins
# ---------------------------------------------------------------------------

# the JAX bench's t=5 section (bench.py:462-471): t_out with the correlation
# pyramid at d=4, kernel_size=3
T5 = dict(num_classes=NUM_CLASSES, temporal=True, t_out=True, corr_pos="early", corr_d=4)
T5_FRAMES = 5
T5_BATCHES = (1, 4, 16)
# per request or train step: each frame against the middle one, the middle one against itself
T5_CORR_LAUNCHES = 5
FUNNEL = dict(num_classes=NUM_CLASSES, temporal=True, t_out=False)
# the train twin's model: `train_yolov3 --dataset vid --window 5,1 --temp --mult_out --corr_d 4`
T5_TRAIN = dict(num_classes=30, temporal=True, t_out=True, corr_d=4)
T5_TRAIN_WINDOWS = 8  # 40 frames
T5_DETECT_BATCH = 16
# (name, B, H, W, C, d): the pyramid's cost volume at 416 px in detection
# (B=16 and B=1 windows) and training (B=8), then an odd size; each volume
# takes a frame of a (B, 5, H, W, C) window against the middle one, and
# "mid" the middle frame against itself (one tensor for f1 and f2)
T5_CORR_CASES = [
    ("detect_52x52x256", 16, 52, 52, 256, 4),
    ("detect_B1", 1, 52, 52, 256, 4),
    ("train_52x52x256", 8, 52, 52, 256, 4),
    ("d2_13x11x64", 2, 13, 11, 64, 2),
]


def t5_window(gen, b, h, w, c, dev):
    return torch.randn(b, T5_FRAMES, h, w, c, generator=gen, device=dev)


def check_t5_kernels(dev):
    """Phase 13: K2, the kernel_size=3 correlation composed of K2 and the
    patch sum (`ops/correlation.correlation` on CUDA tensors), and the
    gradient through it (K2's adjoint) against their plain versions on
    every case of T5_CORR_CASES, each frame of a window against the middle
    frame and the middle frame against itself (allclose rtol=atol=1e-5).
    Returns the max abs errors (forward, composed, adjoint)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    errs = dict(forward=0.0, composed=0.0, adjoint=0.0)
    for name, b, h, w, c, d in T5_CORR_CASES:
        window = t5_window(gen, b, h, w, c, dev)
        mid = window[:, T5_FRAMES // 2]
        for i in (0, T5_FRAMES // 2):
            f1 = mid if i == T5_FRAMES // 2 else window[:, i]  # the middle frame: one tensor for both
            k1 = cost_volume(f1, mid, d, 1)
            p1 = correlation_plain(f1, mid, d, 1, 1, 1)
            before = cost_volume.launches
            k3 = correlation(f1, mid, d, kernel_size=3, stride1=1, stride2=1)
            p3 = correlation_plain(f1, mid, d, 3, 1, 1)
            torch.cuda.synchronize()
            check(cost_volume.launches - before == 1, f"t5 {name}: the kernel_size=3 route did not launch K2 once")
            e1, e3 = float((k1 - p1).abs().max()), float((k3 - p3).abs().max())
            check(bool(torch.allclose(k1, p1, **CORR_TOL)), f"t5 cost volume {name} frame {i}: max abs error {e1}")
            check(bool(torch.allclose(k3, p3, **CORR_TOL)),
                  f"t5 kernel_size=3 correlation {name} frame {i}: max abs error {e3}")
            errs["forward"], errs["composed"] = max(errs["forward"], e1), max(errs["composed"], e3)
        # the gradient through the composed route, frame 0 and the middle frame against itself
        g = torch.randn(b, h, w, num_corr_channels(d, 1), generator=gen, device=dev)
        before = cost_volume_backward.launches
        grads = []
        for fn in (lambda a, m: correlation(a, m, d, kernel_size=3, stride1=1, stride2=1),
                   lambda a, m: correlation_plain(a, m, d, 3, 1, 1)):
            x = window.detach().requires_grad_()
            xm = x[:, T5_FRAMES // 2]
            ((fn(x[:, 0], xm) * g).sum() + (fn(xm, xm) * g).sum()).backward()
            grads.append(x.grad)
        torch.cuda.synchronize()
        check(cost_volume_backward.launches - before == 2, f"t5 {name}: the gradient did not launch K2's adjoint twice")
        e = float((grads[0] - grads[1]).abs().max())
        check(bool(torch.allclose(grads[0], grads[1], **CORR_TOL)),
              f"t5 kernel_size=3 correlation gradient {name}: max abs error {e}")
        errs["adjoint"] = max(errs["adjoint"], e)
        print(f"t5 cost volume {name}: B={b} {h}x{w}x{c} d={d}, frames of a (B, 5) window, the middle one "
              f"against itself too: K2 vs plain {errs['forward']:.3g}, the kernel_size=3 route (K2 + patch sum) "
              f"vs correlation_plain(kernel_size=3) {errs['composed']:.3g}, its gradient (K2's adjoint) vs "
              f"autograd of the plain version {e:.3g}, allclose")
    return errs


class PlainCorr(torch.nn.Module):
    """The Corr layer of the pyramid (keep='none', comp_mid) with the plain
    correlation in the kernels' place."""

    def __init__(self, corr):
        super().__init__()
        self.d, self.k = corr.d, corr.kernel_size

    def forward(self, x):
        x32 = x.float()
        mid = x32[:, x.shape[1] // 2]
        return torch.stack([correlation_plain(x32[:, i], mid, self.d, self.k, 1, 1) for i in range(x.shape[1])], 1)


def t5_windows(rs, b, size=SIZE):
    """(B, 5, S, S, 3) uint8 windows of neighbouring frames of one clip."""
    clip = rs.randint(0, 256, (b + T5_FRAMES - 1, size, size, 3)).astype(np.uint8)
    return np.stack([clip[i:i + T5_FRAMES] for i in range(b)])


def serve_t5(rs, dev, card):
    """Phase 13, detection: the t=5 pyramid model (T5) answers B=1, 4 and
    16 windows; K2 5 times and K1 once a request; the composed route on the
    model's own stage-1 features and the heads on it against the plain
    version; times; the funnel (FUNNEL) at B=16; the entry point.  Returns
    (figures, K1 launches, K2 launches)."""
    figures, k1, k2 = {}, {}, {}
    t0 = time.perf_counter()
    det = Detector(YoloConfig(**T5), dtype=torch.bfloat16, data_shape=SIZE, device="cuda", seed=0)
    print(f"t5 Detector (YOLOv3Temporal, t_out, corr pyramid d={T5['corr_d']}) built on {det.device} in "
          f"{time.perf_counter() - t0:.1f} s")
    requests = [t5_windows(rs, b) for b in T5_BATCHES]
    nms_greedy.launches = cost_volume.launches = 0
    outs, made = [], []
    for x in requests:
        before = cost_volume.launches, nms_greedy.launches
        outs.append(det(x))
        made.append((cost_volume.launches - before[0], nms_greedy.launches - before[1]))
    torch.cuda.synchronize()
    k1["detect"], k2["detect"] = nms_greedy.launches, cost_volume.launches
    check(all(m == (T5_CORR_LAUNCHES, 1) for m in made), f"t5: launches (K2, K1) per request {made}")
    for out, b in zip(outs, T5_BATCHES):
        check(all(o.shape[:3] == (b, T5_FRAMES, POST_NMS) for o in out), f"t5 B={b}: outputs {[o.shape for o in out]}")
    check_detections("t5 (frames folded)", [tuple(o.flatten(0, 1) for o in out) for out in outs],
                     [b * T5_FRAMES for b in T5_BATCHES])

    # the B=16 request step by step: the composed route on the model's own
    # stage-1 features against the plain version, and the heads on each
    m = det.model
    x16 = torch.from_numpy(requests[-1]).to(dev)
    with torch.inference_mode():
        xn = to_normalized(x16, dtype=det.dtype)
        y = time_distributed(m.stage1, xn)
        kern = m.corr(y)
        plain = PlainCorr(m.corr)(y)
        err = float((kern - plain).abs().max())
        check(kern.shape == (16, T5_FRAMES, SIZE // 8, SIZE // 8, num_corr_channels(T5["corr_d"], 1))
              and bool(torch.allclose(kern, plain, **CORR_TOL)),
              f"t5 B=16 Corr (kernel_size=3): kernel route vs plain max abs error {err}")
        figures["corr_route_max_abs_err"] = err
        print(f"t5 B=16 Corr(d={T5['corr_d']}, kernel_size=3, keep='none', comp_mid) on the model's stage-1 "
              f"features {tuple(kern.shape)}: K2 + patch sum vs plain max abs error {err:.3g}, allclose")
        corr = m.corr
        heads = [m(xn)]
        m.corr = PlainCorr(corr)
        try:
            heads.append(m(xn))
        finally:
            m.corr = corr
    for i, name in enumerate(("boxes", "scores")):
        a, b_ = (h[i].clamp(0, SIZE) if name == "boxes" else h[i] for h in heads)
        e = (a - b_).abs()
        e_max, e_mean, tol = float(e.max()), float(e.mean()), HEAD_TOL[name]
        print(f"t5 B=16 {name} {tuple(a.shape)} bf16, kernel vs plain correlation: max abs {e_max:.3g} "
              f"(tol {tol['max']}), mean abs {e_mean:.3g} (tol {tol['mean']}), {float((e == 0).float().mean()):.4f} equal")
        check(e_max <= tol["max"] and e_mean <= tol["mean"],
              f"t5 B=16 {name}: kernel vs plain correlation, max {e_max}, mean {e_mean}")
        figures[f"head_{name}_max_abs"] = e_max

    # times: the request, the forward, K2 and the patch sum on the model's features
    x1 = torch.from_numpy(requests[0]).to(dev)
    with torch.inference_mode():
        t_fwd = median_ms(lambda: m(xn), 10)
        t16 = median_ms(lambda: det(x16), 10)
        t1 = median_ms(lambda: det(x1), 30, warmup=5)
        f = y.float()
        f1, fm = f[:, 0], f[:, T5_FRAMES // 2]
        d = T5["corr_d"]
        vol = cost_volume(f1, fm, d, 1)
        k_ms = median_ms(lambda: cost_volume(f1, fm, d, 1), 50)
        patch_ms = median_ms(lambda: patch_correlation(lambda *a: vol, f1, fm, d, 3), 50)
        p_ms = median_ms(lambda: correlation_plain(f1, fm, d, 1, 1, 1), 10)
        p3_ms = median_ms(lambda: correlation_plain(f1, fm, d, 3, 1, 1), 10)
    b, h, w, c = f1.shape
    tb, to = corr_times(b, h, w, c, d, 1)
    pl = correlation_kernel.plan(b, h, w, c, d, 1, correlation_kernel.aligned(f1, fm))
    figures.update(
        request_ms=t16, windows_s=16 / t16 * 1e3, frames_s=16 * T5_FRAMES / t16 * 1e3, forward_ms=t_fwd,
        latency_b1_ms=t1,
        k2=dict(shape=[b, h, w, c], ms=k_ms, plain_ms=p_ms, bytes_ms=tb, ops_ms=to, patch_sum_ms=patch_ms,
                plain_k3_ms=p3_ms, launches=T5_CORR_LAUNCHES,
                plan=dict(r=pl.r, gx=pl.gx, gy=pl.gy, tile=list(pl.tile), threads=pl.threads, copy=pl.copy,
                          ctas=pl.ctas)))
    print(f"t5 K2 on the model's stage-1 features B={b} {h}x{w}x{c} d={d} on {card}: {k_ms:.4f} ms a launch "
          f"(plain {p_ms:.3f} ms, bound {max(tb, to):.4f} ms: bytes {tb:.4f}, operations {to:.4f}), the patch sum "
          f"and divide {patch_ms:.4f} ms after it, correlation_plain(kernel_size=3) {p3_ms:.3f} ms; plan {pl}")
    figures["profile"] = profile_steps([("t5 B=16 windows", det, x16, 3, 12)], card).get("t5 B=16 windows")
    print(f"t5 B=16 windows of {T5_FRAMES} at {SIZE} px bf16 on {card}: {figures['windows_s']:.1f} windows/s, "
          f"{figures['frames_s']:.1f} frames/s ({t16:.3f} ms/request, forward {t_fwd:.3f}; K2 {T5_CORR_LAUNCHES} x "
          f"{k_ms:.4f} ms + patch sums); B=1 window {t1:.3f} ms/request")

    # K1 on the folded B*T images against the plain NMS
    with torch.inference_mode():
        boxes, scores = m(xn)
        cands = select_topk_candidates(boxes.flatten(0, 1), scores.flatten(0, 1), topk=NMS_TOPK)
        got = nms_greedy(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
        want = nms_greedy_plain(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
    check(all(torch.equal(a, b_) for a, b_ in zip(got, want)),
          "t5 K1 on the B*T = 80 folded images: not the plain NMS's rows")
    figures["k1_80_images_ms"] = median_ms(lambda: nms_greedy(cands, NMS_THRESH, VALID_THRESH, POST_NMS,
                                                              return_keep=False), 50)
    print(f"t5 K1 on the {cands.shape[0]} folded images (K={cands.shape[1]}): equal to the plain NMS, "
          f"{figures['k1_80_images_ms']:.4f} ms a call")
    del det, m
    torch.cuda.empty_cache()

    # the funnel: one set of detections a window, one K1 call, no K2
    fdet = Detector(YoloConfig(**FUNNEL), dtype=torch.bfloat16, data_shape=SIZE, device="cuda", seed=0)
    nms_greedy.launches = cost_volume.launches = 0
    out = fdet(x16)
    torch.cuda.synchronize()
    k1["funnel"] = nms_greedy.launches
    check((nms_greedy.launches, cost_volume.launches) == (1, 0),
          f"t5 funnel: launches (K1, K2) {(nms_greedy.launches, cost_volume.launches)}")
    check_detections("t5 funnel", [out], [16])
    tf = median_ms(lambda: fdet(x16), 10)
    figures["funnel"] = dict(request_ms=tf, windows_s=16 / tf * 1e3)
    print(f"t5 funnel (5 -> 3 -> 1, 3-D cells) B=16 windows at {SIZE} px bf16 on {card}: {16 / tf * 1e3:.1f} "
          f"windows/s ({tf:.3f} ms/request), 1 K1 call, no K2")
    del fdet
    torch.cuda.empty_cache()

    # the entry point, as a user runs it: one request of 4 windows
    nms_greedy.launches = cost_volume.launches = 0
    preds = detect.main(["--data_shape", str(SIZE), "--batch_size", "4", "--num_requests", "1", "--seed", "1",
                         "--dtype", "bf16", "--window", f"{T5_FRAMES},1", "--temp", "--mult_out", "--corr_pos",
                         "early", "--corr_d", str(T5["corr_d"])])
    made = cost_volume.launches, nms_greedy.launches
    k1["entry_point"], k2["entry_point"] = made[1], made[0]
    check(made == (T5_CORR_LAUNCHES, 1), f"t5 entry point: launches (K2, K1) {made}")
    entries = check_entry_point(preds, 4 * T5_FRAMES)
    print(f"t5 entry point: {len(entries)} normalised detections over 4 windows x {T5_FRAMES} frames, in range")
    return figures, k1, k2


def t5_train_batch(rs, b, size, device):
    """`window_batch` for t=5 with per-timestep gt: (B, 5, S, S, 3) uint8
    windows, one normalize-only colour map a window, gt row 0 [10, 10, 100,
    100] class 1 in every frame, (B, 5, TRAIN_ROWS, .)."""
    batch = train_batch(rs, b, size, "cpu")
    batch["image"] = torch.from_numpy(t5_windows(rs, b, size))
    for k in ("gt_boxes", "gt_ids"):
        batch[k] = batch[k][:, None].expand((-1, T5_FRAMES) + batch[k].shape[1:]).contiguous()
    return {k: v.to(device) for k, v in batch.items()}


def t5_train_model(dtype=torch.bfloat16):
    model = build_model(YoloConfig(**T5_TRAIN, dtype=dtype))
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def train_t5(dev, card):
    """Phase 13, training: the B=8-window 416-px bf16 t_out train step
    (windows/s, frames/s, peak memory, a profiled step's idle share, K2 and
    its adjoint 5 launches each a step, each timed at the step's shape
    against its plain version and bound), a float32 step card vs CPU.
    Returns (figures, K2 launches (forward, adjoint))."""
    figures = {}
    figures["card_vs_cpu"] = check_train_card_vs_cpu(
        "t5", t5_train_model(dtype=None), lambda device: t5_train_batch(np.random.RandomState(1), 1, 128, device),
        T5_TRAIN["num_classes"], "128 px, B=1 window of 5 frames, per-timestep gt")
    torch.cuda.empty_cache()
    model = t5_train_model().to(dev, memory_format=torch.channels_last)
    state = create_train_state(model, lr_schedule("step", 1e-3, steps_per_epoch=100, epochs=10))
    step = make_train_step(model, num_classes=T5_TRAIN["num_classes"])
    batch = t5_train_batch(np.random.RandomState(0), T5_TRAIN_WINDOWS, SIZE, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = statistics.median(cuda_time_ms(lambda: step(state, batch), iters=10, warmup=3))
    peak = torch.cuda.max_memory_allocated()
    cost_volume.launches = cost_volume_backward.launches = 0
    losses = {k: float(v) for k, v in step(state, batch).items()}
    torch.cuda.synchronize()
    launches = (cost_volume.launches, cost_volume_backward.launches)
    check(launches == (T5_CORR_LAUNCHES, T5_CORR_LAUNCHES), f"t5 train step: K2 (forward, adjoint) launches {launches}")
    check(all(np.isfinite(v) for v in losses.values()), f"t5 train step losses not finite: {losses}")
    prof = profile_steps([(f"t5 train B={T5_TRAIN_WINDOWS} windows", lambda _: step(state, batch), None, 1, 14)], card)
    idle = next(iter(prof.values()), {}).get("idle_share")
    n = T5_TRAIN_WINDOWS
    figures.update(ms=ms, windows_s=n / ms * 1e3, frames_s=n * T5_FRAMES / ms * 1e3, peak_gib=peak / 2**30,
                   idle_share=idle, launches=dict(zip(("forward", "adjoint"), launches)), losses=losses)
    print(f"t5 train step B={n} windows of {T5_FRAMES} frames at {SIZE} px bf16, per-timestep heads and gt, on "
          f"{card}: {figures['windows_s']:.1f} windows/s, {figures['frames_s']:.1f} frames/s ({ms:.3f} ms/step, "
          f"median of 10 after 3 warm), peak memory {peak / 2**30:.2f} GiB, idle share {idle}, K2 launches a step: "
          f"{launches[0]} forward + {launches[1]} adjoint; losses {losses}")
    # K2 and its adjoint at the step's shape, on its own stage-1 features
    model.eval()
    with torch.no_grad():
        y = time_distributed(model.stage1, apply_color(batch["image"], batch["color"]).to(torch.bfloat16)).float()
    f1, fm = y[:, 0], y[:, T5_FRAMES // 2]
    b, h, w, c = f1.shape
    d = T5_TRAIN["corr_d"]
    g = torch.randn(b, h, w, num_corr_channels(d, 1), device=dev)
    fwd = median_ms(lambda: cost_volume(f1, fm, d, 1), 20)
    bwd = median_ms(lambda: cost_volume_backward(g, f1, fm, d, 1), 20)
    bwd_mid = median_ms(lambda: cost_volume_backward(g, fm, fm, d, 1), 20)
    bwd_plain = median_ms(lambda: cost_volume_backward_plain(g, f1, fm, d, 1), 3, warmup=1)
    got, want = cost_volume_backward(g, fm, fm, d, 1), cost_volume_backward_plain(g, fm, fm, d, 1)
    torch.cuda.synchronize()
    err = max(float((a - r).abs().max()) for a, r in zip(got, want))
    check(all(bool(torch.allclose(a, r, **CORR_TOL)) for a, r in zip(got, want))
          and got[0].data_ptr() != got[1].data_ptr(),
          f"t5 K2 adjoint, the middle frame against itself: max abs error {err}, or the gradients alias")
    tb, to = corr_backward_times(b, h, w, c, d, 1)
    fb, fo = corr_times(b, h, w, c, d, 1)
    plan = backward_plan(b, h, w, c, d, 1, correlation_kernel.aligned(f1, fm))
    figures["k2"] = dict(shape=[b, h, w, c], forward_ms=fwd, forward_bytes_ms=fb, forward_ops_ms=fo,
                         adjoint_ms=bwd, adjoint_mid_ms=bwd_mid, adjoint_plain_ms=bwd_plain, adjoint_bytes_ms=tb,
                         adjoint_ops_ms=to, adjoint_plan=plan, adjoint_mid_max_abs_err=err)
    print(f"t5 K2 at the train step's shape B={b} {h}x{w}x{c} d={d} on {card}: forward {fwd:.4f} ms (bound "
          f"{max(fb, fo):.4f}), adjoint {bwd:.4f} ms ({bwd_mid:.4f} for the middle frame against itself, two "
          f"distinct gradients within {err:.3g} of the plain adjoint; plain {bwd_plain:.3f} ms, bound "
          f"{max(tb, to):.4f} ms: bytes {tb:.4f}, operations {to:.4f}) with the plan {plan}")
    del model, state, batch
    torch.cuda.empty_cache()
    return figures, launches


def data_t5(dev, card):
    """Phase 13.  Returns (the phase's figures, K1's launches, K2's
    (forward, adjoint) launches on its paths)."""
    figures, k1, k2 = {}, {}, {}
    workers = os.cpu_count() or 1
    figures["kernels"] = check_t5_kernels(dev)
    torch.cuda.empty_cache()
    serve, k1_serve, k2_serve = serve_t5(np.random.RandomState(13), dev, card)
    figures["detect"] = serve
    k1.update(k1_serve)
    k2.update({k: (v, 0) for k, v in k2_serve.items()})
    figures["train_step"], k2["train_step"] = train_t5(dev, card)

    with tempfile.TemporaryDirectory() as tmp:
        nms_greedy.launches = cost_volume.launches = cost_volume_backward.launches = 0
        rec, _ = overfit.run(overfit.parse_args(["--out", f"{tmp}/overfit_t5.json", "--config", "t5"]))
        k1["overfit_t5"] = nms_greedy.launches
        k2["overfit_t5"] = (cost_volume.launches, cost_volume_backward.launches)
        check(rec["pass"], f"overfit t5 fails the JAX package's rule: {rec}")
        print(f"t5 overfit (YOLOv3Temporal t=5 t_out, corr pyramid d=2, bf16, 160 px, B=8 static windows, 400 steps, "
              f"per-timestep gt, the middle frame's detections) on {card}: passes the JAX package's rule; loss "
              f"{rec['loss_first']:.2f} -> {rec['loss_last']:.4f}, mean top-1 IoU {rec['mean_top1_iou']:.4f}, class "
              f"accuracy {rec['top1_class_acc']}, {rec['step_ms']:.2f} ms/step on the host's clock")
        figures["overfit_t5"] = rec
    torch.cuda.empty_cache()

    with logged_speed() as speed, tempfile.TemporaryDirectory() as tmp:
        # phase 12's VID tree, read as windows of 5 with per-frame labels
        write_vid_tree(tmp, (("train", VID_TRAIN_SNIPPETS, 4000), ("val", VID_SNIPPETS, 3000)))
        vid = f"{tmp}/ImageNetVID/ILSVRC"
        val = ImageNetVidDetection(root=vid, splits=[(2017, "val")], every=VID_EVERY7, window=(T5_FRAMES, 1),
                                   mult_out=True, inference=True)
        train = ImageNetVidDetection(root=vid, splits=[(2017, "train")], every=VID_EVERY7, window=(T5_FRAMES, 1),
                                     mult_out=True)
        flags = ["--dataset", "vid", "--dataset_root", tmp, "--window", f"{T5_FRAMES},1", "--temp", "--mult_out",
                 "--corr_pos", "early", "--corr_d", str(T5["corr_d"]), "--every", str(VID_EVERY7), "--data_shape",
                 str(SIZE), "--dtype", "bf16", "--num_workers", str(workers)]
        exp = f"{tmp}/exp"
        nms_greedy.launches = cost_volume.launches = cost_volume_backward.launches = 0
        model, stats = train_yolov3.main(flags + ["--batch_size", str(T5_TRAIN_WINDOWS), "--no_random_shape",
                                                  "--epochs", "1", "--nopretrained_cnn", "--save_prefix", "0000",
                                                  "--experiment_root", exp, "--save_interval", "1",
                                                  "--log_interval", "1"])
        torch.cuda.synchronize()
        n_steps, n_val = len(train) // T5_TRAIN_WINDOWS, -(-len(val) // T5_TRAIN_WINDOWS)
        k1["train_twin_validation"] = nms_greedy.launches
        k2["train_twin"] = (cost_volume.launches, cost_volume_backward.launches)
        check(k1["train_twin_validation"] == n_val, f"t5 K1 launches in the train twin: {nms_greedy.launches}")
        check(k2["train_twin"] == (T5_CORR_LAUNCHES * (n_steps + n_val), T5_CORR_LAUNCHES * n_steps),
              f"t5 K2 (forward, adjoint) launches in the train twin: {k2['train_twin']} for {n_steps} steps and "
              f"{n_val} validation batches")
        val0 = stats["val"][0]
        ep = stats["epochs"][0]
        rest = ep["steps"][1:]
        secs = sum(t for _, t, _ in rest)
        twin = {"samples_s": ep["samples_s"], "wait_share": ep["wait_s"] / ep["seconds"], "steps": len(ep["steps"]),
                "steady_windows_s": len(rest) * T5_TRAIN_WINDOWS / secs if secs else None,
                "steady_wait_share": sum(w for _, _, w in rest) / secs if secs else None,
                "first_step_ms": ep["steps"][0][1] * 1e3, "val": stats["val"], "logged": list(speed)}
        figures["train_twin"] = twin
        print(f"t5 train twin (VID windows of 5, per-frame labels, bf16, B={T5_TRAIN_WINDOWS}, {SIZE} px, one epoch "
              f"of {ep['samples']} windows) on {card}: {ep['samples_s']:.1f} windows/s over the epoch, "
              f"{twin['steady_windows_s']} past the first step, waiting on the prefetcher {twin['steady_wait_share']} "
              f"of that; validation (VOCMApMetricTemporal, {len(val)} windows) {val0['seconds']:.2f} s, the "
              f"last offset's mAP {val0['map']}; K2 {k2['train_twin']}, K1 {k1['train_twin_validation']}")
        ckpt = f"{exp}/0000/yolo3_darknet53_vid_0000.params"
        check(os.path.exists(ckpt), f"the t5 train twin wrote no checkpoint {ckpt}")
        del model

        # the detect twin from that checkpoint, a cache directory a window offset
        nms_greedy.launches = cost_volume.launches = 0
        t0 = time.perf_counter()
        preds = detect.main(flags + ["--model_path", ckpt, "--batch_size", str(T5_DETECT_BATCH), "--save_dir",
                                     f"{tmp}/res", "--save_prefix", "vid", "--metrics", "voc,vid"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_batches = -(-len(val) // T5_DETECT_BATCH)
        k1["detect_twin"], k2["detect_twin"] = nms_greedy.launches, (cost_volume.launches, 0)
        check((nms_greedy.launches, cost_volume.launches) == (n_batches, T5_CORR_LAUNCHES * n_batches),
              f"t5 detect twin launches (K1, K2) {(nms_greedy.launches, cost_volume.launches)}")
        dirs = sorted(p for p in os.listdir(f"{tmp}/res/vid") if p.startswith("pred"))
        check(dirs == [f"pred_o{t}" for t in range(T5_FRAMES)], f"t5 detect twin cache directories {dirs}")
        check(isinstance(preds, list) and len(preds) == T5_FRAMES and all(os.path.exists(f"{tmp}/res/vid/{m}.txt")
                                                                          for m in ("voc", "vid")),
              "the t5 detect twin wrote no per-offset predictions or metrics")
        figures["detect_twin"] = {"windows": len(val), "seconds": secs, "windows_s_disk_to_metrics": len(val) / secs,
                                  "detections_per_offset": [sum(map(len, p.values())) for p in preds],
                                  "voc": open(f"{tmp}/res/vid/voc.txt").read().splitlines()[-1],
                                  "vid": open(f"{tmp}/res/vid/vid.txt").read().splitlines()[-1]}
        print(f"t5 detect twin (VID windows of 5 from the checkpoint, bf16, B={T5_DETECT_BATCH}, {SIZE} px, "
              f"pred_o0..pred_o4) on {card}: {len(val)} windows to the metrics in {secs:.2f} s (model load "
              f"included); {figures['detect_twin']}")
        torch.cuda.empty_cache()
    k1["total"] = sum(v for v in k1.values())
    k2["total"] = [sum(v[0] for v in k2.values()), sum(v[1] for v in k2.values())]
    figures["k1"], figures["k2"] = k1, k2
    print(f"t5 launches: K1 {k1}, K2 (forward, adjoint) {k2}")
    return figures, k1["total"], k2["total"]


# ---------------------------------------------------------------------------
# phase 14: slice 10, the combined class-tree dataset and YouTube-BB through
# both twins
# ---------------------------------------------------------------------------

TREE_CLASSES = 285  # the nodes of filtered_det.tree
YT_CLASSES = 23
YT_SPLITS = (("train", 8, 5000), ("validation", 4, 6000))  # (split, clips, vid_snippet seed)
YT_FRAMES = 12  # annotated frames a clip, 1 s apart
YT_ABSENT = 6  # every 6th frame of a clip has its object absent
DET_TRAIN = 64
COMB_VID_SNIPPETS = 2  # a split: the twins take every 25th frame, 2 of a snippet's 32
HIER_LEVEL = 10
COMB_STEP_CLASSES = (80, TREE_CLASSES)  # slice 6's COCO head beside the tree's
SLICE10_YT = dict(num_classes=YT_CLASSES, k=WINDOW, k_join_pos="late", corr_pos="early", corr_d=4)


def write_yt_tree(root: str, splits=YT_SPLITS) -> None:
    """`root`/YouTubeBB: for each (split, clips, seed) that many clips, each
    a video of its own: YT_FRAMES 640x360 JPEG frames (`vid_snippet`'s
    first frames) under frames/<video>/<ms>.jpg, 1 s apart, each clip's
    timestamps apart from every other's; one csv row a frame for the
    snippet's first track, its class one of the 23, its box in fractions of
    the frame, absent on every YT_ABSENT-th frame."""
    ids, names = [int(i) for i in load_names("youtubebb_ids")], load_names("youtubebb")
    base = os.path.join(root, "YouTubeBB")

    def write(split, c, seed):
        video = f"yt_{split[0]}{c:04d}"
        os.makedirs(os.path.join(base, "frames", video), exist_ok=True)
        frames, labels = vid_snippet(c, seed)
        rows = []
        for f in range(YT_FRAMES):
            ts = str((100 * c + f) * 1000)
            with open(os.path.join(base, "frames", video, ts + ".jpg"), "wb") as fh:
                fh.write(encode_jpeg(frames[f]))
            x0, y0, x1, y1, cls, _ = labels[f][0]
            k = cls % YT_CLASSES
            absent = f % YT_ABSENT == YT_ABSENT - 1
            box = [-1, -1, -1, -1] if absent else [x0 / VID_W, x1 / VID_W, y0 / VID_H, y1 / VID_H]
            rows.append([video, ts, str(ids[k]), names[k], "0", "absent" if absent else "present"] + box)
        return rows

    os.makedirs(base, exist_ok=True)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        for split, clips, seed in splits:
            rows = [r for clip in pool.map(lambda c: write(split, c, seed), range(clips)) for r in clip]
            with open(os.path.join(base, f"yt_bb_detection_{split}.csv"), "w") as fh:
                fh.write("".join(",".join(str(v) for v in r) + "\n" for r in rows))


def tree_step(dev, card):
    """The detect step alone at B=128, 416 px, bf16 on the 80-class head and
    the tree's 285: images/s; for 285 the request split into the network
    (head), the decode, the top-k and K1, K1 held against the plain NMS on
    its candidates, and a profiled request."""
    x = torch.from_numpy(np.random.RandomState(14).randint(0, 256, (DETECT_BATCH, SIZE, SIZE, 3)).astype(
        np.uint8)).to(dev)
    out = {}
    for c in COMB_STEP_CLASSES:
        det = Detector(YoloConfig(num_classes=c, pad_stem=True), dtype=torch.bfloat16, data_shape=SIZE, seed=c)
        with torch.inference_mode():
            ms = median_ms(lambda: det(x), 10)
        out[c] = {"request_ms": ms, "images_s": DETECT_BATCH / ms * 1e3}
        if c != TREE_CLASSES:
            del det
            continue
        raw = []
        hooks = [getattr(det.model, f"output{i}").prediction.register_forward_hook(
            lambda m, a, o: raw.append(o)) for i in range(3)]
        with torch.inference_mode():
            xn = det._normalized(x)
            det.model(xn)
            for h in hooks:
                h.remove()
            outputs = [getattr(det.model, f"output{i}") for i in range(3)]

            def decode():
                lv = [decode_predictions(p, o.anchors, o.stride, c) for p, o in zip(raw, outputs)]
                return torch.cat([v[0] for v in lv], dim=1), torch.cat([v[1] for v in lv], dim=1)

            boxes, scores = det.model(xn)
            cands = select_topk_candidates(boxes, scores, topk=NMS_TOPK)
            split = {"network_ms": median_ms(lambda: det.model(xn), 10), "decode_ms": median_ms(decode, 10),
                     "topk_ms": median_ms(lambda: select_topk_candidates(boxes, scores, topk=NMS_TOPK), 10),
                     "k1_ms": median_ms(lambda: nms_greedy(cands, NMS_THRESH, VALID_THRESH, POST_NMS), 20)}
            packed, keep = nms_greedy(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
            ref_packed, ref_keep = nms_greedy_plain(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
            split["k1_plain_ms"] = median_ms(lambda: nms_greedy_plain(cands, NMS_THRESH, VALID_THRESH, POST_NMS), 5)
        check(torch.equal(keep.bool(), ref_keep) and torch.equal(packed, ref_packed),
              "the 285-class candidates at B=128: K1 and the plain NMS differ")
        split["head_ms"] = split["network_ms"] - split["decode_ms"]
        split["scores_gb"] = scores.numel() * scores.element_size() / 1e9
        out[c].update(split, k1_equal_plain=True, profile=profile_steps(
            [(f"slice 10 {c}-class B={DETECT_BATCH}", det, x, 3, 10)], card))
        del det, boxes, scores, cands, raw
    torch.cuda.empty_cache()
    t = out[TREE_CLASSES]
    print(f"slice 10 detect step alone (bf16, B={DETECT_BATCH}, {SIZE} px) on {card}: "
          + ", ".join(f"{c} classes {out[c]['request_ms']:.3f} ms ({out[c]['images_s']:.1f} images/s)"
                      for c in COMB_STEP_CLASSES)
          + f"; the 285-class request: network {t['network_ms']:.3f} ms (head {t['head_ms']:.3f}, decode "
            f"{t['decode_ms']:.3f}), top-k {t['topk_ms']:.3f}, K1 {t['k1_ms']:.4f} (plain {t['k1_plain_ms']:.3f}, "
            f"bit-equal), float32 scores {t['scores_gb']:.2f} GB")
    return out


def data_slice10(dev, card):
    """Phase 14.  Returns (the phase's figures, K1's launches, K2's
    (forward, adjoint) launches on its paths)."""
    figures, k1, k2 = {}, {}, {}
    workers = os.cpu_count() or 1
    with tempfile.TemporaryDirectory() as tmp:
        nms_greedy.launches = 0
        rec, _ = overfit.run(overfit.parse_args(["--out", f"{tmp}/overfit_tree.json", "--config", "tree"]))
        k1["overfit_tree"] = nms_greedy.launches
        check(rec["pass"], f"overfit tree fails the JAX package's rule: {rec}")
        print(f"slice 10 overfit tree (YOLOv3, 7 tree nodes, multi-hot rows, bf16, 160 px, B=8, 400 steps) on "
              f"{card}: passes the JAX package's rule (top class on the leaf's branch); loss {rec['loss_first']:.2f} "
              f"-> {rec['loss_last']:.4f}, mean top-1 IoU {rec['mean_top1_iou']:.4f}, {rec['step_ms']:.2f} ms/step "
              "on the host's clock")
        figures["overfit_tree"] = rec
    torch.cuda.empty_cache()
    figures["step"] = tree_step(dev, card)

    with logged_speed() as speed, tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        images = [synth_image(2000 + k, COCO_H, COCO_W, COCO_CLASSES) for k in range(COCO_IMAGES)]
        jpegs = encode_jpegs(images)
        write_coco_tree(tmp, images, jpegs)
        write_det_tree(tmp, images, jpegs)
        write_det_tree(tmp, images, jpegs, "train", DET_TRAIN)
        write_vid_tree(tmp, (("train", COMB_VID_SNIPPETS, 4000), ("val", COMB_VID_SNIPPETS, 3000)))
        write_voc_tree(tmp)
        write_yt_tree(tmp)
        figures["tree_s"] = time.perf_counter() - t0
        yt_val = YouTubeBBDetection(root=f"{tmp}/YouTubeBB", splits=["val"], frames=25, inference=True)
        print(f"slice 10 trees: VOC, COCO, DET ({DET_TRAIN} train, {DET_VAL} val), VID ({COMB_VID_SNIPPETS} train "
              f"and {COMB_VID_SNIPPETS} val snippets, every 25th frame) and YouTube-BB ({YT_SPLITS[0][1]} train and {YT_SPLITS[1][1]} val clips "
              f"of {YT_FRAMES} {VID_W}x{VID_H} frames 1 s apart, every {YT_ABSENT}th absent; {len(yt_val)} val "
              f"frames); written in {figures['tree_s']:.1f} s")

        # the combined train twin: five datasets on the tree, bf16, B=48, 416 px, one epoch
        exp = f"{tmp}/exp"
        names = "voc,coco,det,vid,yt"
        argv = ["--dataset", names, "--dataset_root", tmp, "--batch_size", str(TWIN_BATCH), "--data_shape",
                str(SIZE), "--no_random_shape", "--epochs", "1", "--nopretrained_cnn", "--dtype", "bf16",
                "--save_prefix", "0000", "--experiment_root", exp, "--save_interval", "1", "--log_interval", "1",
                "--num_workers", str(workers)]
        nms_greedy.launches = 0
        model, stats = train_yolov3.main(argv)
        torch.cuda.synchronize()
        args = train_yolov3.parse_args(argv)
        train_ds = train_yolov3.get_dataset(args, args.dataset)
        val_ds = train_yolov3.get_dataset(args, args.dataset, val=True)
        check(len(train_ds.classes) == TREE_CLASSES and model.output0.num_classes == TREE_CLASSES,
              f"the combined model's classes: {len(train_ds.classes)}")
        n_val = -(-len(val_ds) // TWIN_BATCH)
        k1["comb_train_twin_validation"] = nms_greedy.launches
        check(nms_greedy.launches == n_val, f"K1 launches in the combined train twin: {nms_greedy.launches}, "
                                            f"expected {n_val}")
        ep = stats["epochs"][0]
        rest = ep["steps"][1:]
        secs = sum(t for _, t, _ in rest)
        twin = {"train_images": len(train_ds), "val_images": len(val_ds), "samples_s": ep["samples_s"],
                "wait_share": ep["wait_s"] / ep["seconds"], "steps": len(ep["steps"]),
                "steady_images_s": len(rest) * TWIN_BATCH / secs if secs else None,
                "steady_wait_share": sum(w for _, _, w in rest) / secs if secs else None,
                "first_step_ms": ep["steps"][0][1] * 1e3, "val": stats["val"], "logged": list(speed)}
        figures["comb_train_twin"] = twin
        print(f"slice 10 combined train twin ({names} on the {TREE_CLASSES}-node tree, multi-hot labels, bf16, "
              f"B={TWIN_BATCH}, {SIZE} px, one epoch of {ep['samples']} of {len(train_ds)} images) on {card}: "
              f"{ep['samples_s']:.1f} images/s over the epoch, {twin['steady_images_s']} past the first step, "
              f"waiting on the prefetcher {twin['steady_wait_share']} of that; first step "
              f"{twin['first_step_ms']:.0f} ms; validation (VOC mAP over the tree, {len(val_ds)} images, each box "
              f"once a node of its branch) {stats['val'][0]['seconds']:.2f} s; K1 {k1['comb_train_twin_validation']}")
        ckpt = f"{exp}/0000/yolo3_darknet53_{names.replace(',', '_')}_0000.params"
        check(os.path.exists(ckpt), f"the combined train twin wrote no checkpoint {ckpt}")

        # the combined detect twin from that checkpoint: four val splits, hierarchical NMS
        comb = detect.get_dataset(["comb"], tmp, hier_level=HIER_LEVEL)
        argv_d = ["--dataset", "comb", "--hier_level", str(HIER_LEVEL), "--dataset_root", tmp, "--model_path", ckpt,
                  "--data_shape", str(SIZE), "--batch_size", str(DETECT_BATCH), "--dtype", "bf16", "--save_dir",
                  f"{tmp}/res", "--save_prefix", "comb", "--num_workers", str(workers), "--metrics", "voc"]
        nms_greedy.launches = 0
        t0 = time.perf_counter()
        preds = detect.main(argv_d)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1["comb_detect_twin"] = nms_greedy.launches
        check(nms_greedy.launches == -(-len(comb) // DETECT_BATCH),
              f"K1 launches in the combined detect twin: {nms_greedy.launches} for {len(comb)} images")
        voc = open(f"{tmp}/res/comb/voc.txt").read().splitlines()
        check(len(voc) == TREE_CLASSES + 1, f"the combined voc.txt has {len(voc)} lines")
        t0 = time.perf_counter()
        table = [[comb.on_branch(i, j) for j in range(TREE_CLASSES)] for i in range(TREE_CLASSES)]
        table_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        merged = detect.hierarchical_nms(preds, comb, level_thresh=HIER_LEVEL)
        hier_s = time.perf_counter() - t0
        n_in, n_out = sum(map(len, preds.values())), sum(map(len, merged.values()))
        figures["comb_detect_twin"] = {"images": len(comb), "seconds": secs, "images_s_disk_to_metrics": len(comb) / secs,
                                       "detections": n_in, "after_hierarchical_nms": n_out,
                                       "hierarchical_nms_s": hier_s, "on_branch_table_s": table_s,
                                       "on_branch_pairs": sum(map(sum, table)), "voc": voc[-1]}
        # the checkpoint through the twin against the trained model's eval step on the first batch
        paths = [comb.sample_path(i) for i in range(min(DETECT_BATCH, len(comb)))]
        batch = torch.from_numpy(native.load_batch(paths, SIZE, SIZE)[0]).to(dev)
        ids, sc, bb = (a.cpu().numpy() for a in make_eval_step(model)(batch))
        ref = {}
        for i, p in enumerate(paths):
            collect_boxes(ref, p, ids[i], sc[i], np.clip(bb[i], 0, SIZE), SIZE)
        check(all(preds.get(p, []) == ref[p] for p in paths),
              "the combined detect twin's detections from the checkpoint differ from the trained model's eval step")
        with torch.inference_mode():
            boxes, scores = model(batch)
            cands = select_topk_candidates(boxes, scores, topk=NMS_TOPK)
            packed, keep = nms_greedy(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
            ref_packed, ref_keep = nms_greedy_plain(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
        check(torch.equal(keep.bool(), ref_keep) and torch.equal(packed, ref_packed),
              "the trained 285-class model's candidates: K1 and the plain NMS differ")
        del boxes, scores, cands
        print(f"slice 10 combined detect twin (comb: VOC, COCO, DET and VID val on the tree, bf16, B={DETECT_BATCH}, "
              f"{SIZE} px, --hier_level {HIER_LEVEL}) on {card}: {len(comb)} images to voc.txt in {secs:.2f} s "
              f"(model load included), K1 {k1['comb_detect_twin']}; the first batch's "
              f"{sum(map(len, ref.values()))} detections equal the trained model's eval step bit for bit, K1 "
              f"bit-equal to the plain NMS on its candidates; hierarchical NMS {n_in} -> {n_out} detections in "
              f"{hier_s:.3f} s on the host (the {TREE_CLASSES}x{TREE_CLASSES} on_branch table {table_s:.3f} s)")

        # a model trained on comb scored on VOC through the class map
        voc_ds = detect.get_dataset(["voc"], tmp)
        cmap = detect.get_class_map(comb, voc_ds)
        check(len(cmap) == NUM_CLASSES and min(cmap) >= 0, f"the VOC -> tree class map {cmap}")
        nms_greedy.launches = 0
        t0 = time.perf_counter()
        detect.main(["--dataset", "voc", "--trained_on", "comb", "--dataset_root", tmp, "--model_path", ckpt,
                     "--data_shape", str(SIZE), "--batch_size", str(DETECT_BATCH), "--dtype", "bf16", "--save_dir",
                     f"{tmp}/res", "--save_prefix", "voc_from_comb", "--num_workers", str(workers), "--metrics", "voc"])
        torch.cuda.synchronize()
        k1["trained_on_detect_twin"] = nms_greedy.launches
        check(nms_greedy.launches == -(-len(voc_ds) // DETECT_BATCH),
              f"K1 launches in the --trained_on detect twin: {nms_greedy.launches}")
        voc = open(f"{tmp}/res/voc_from_comb/voc.txt").read().splitlines()
        check(len(voc) == NUM_CLASSES + 1, f"the --trained_on voc.txt has {len(voc)} lines")
        figures["trained_on"] = {"images": len(voc_ds), "seconds": time.perf_counter() - t0, "class_map": cmap,
                                 "voc": voc[-1]}
        print(f"slice 10 detect twin --dataset voc --trained_on comb on {card}: {len(voc_ds)} images scored through "
              f"the class map {cmap}, K1 {k1['trained_on_detect_twin']}; {voc[-1]}")
        del model
        torch.cuda.empty_cache()

        # YouTube-BB windows: the train twin (YOLOv3T, 23 classes, slice 7's flags), B=16 windows
        yt_flags = ["--dataset", "yt", "--dataset_root", tmp, "--window", f"{WINDOW},1", "--k_join_pos", "late",
                    "--corr_pos", "early", "--corr_d", str(SLICE10_YT["corr_d"]), "--data_shape", str(SIZE),
                    "--dtype", "bf16", "--num_workers", str(workers)]
        yt_train = YouTubeBBDetection(root=f"{tmp}/YouTubeBB", splits=["train"], frames=25, window=(WINDOW, 1))
        yt_valw = YouTubeBBDetection(root=f"{tmp}/YouTubeBB", splits=["val"], frames=25, window=(WINDOW, 1),
                                     inference=True)
        nms_greedy.launches = cost_volume.launches = cost_volume_backward.launches = 0
        model, stats = train_yolov3.main(yt_flags + ["--batch_size", str(TRAIN_WINDOWS), "--no_random_shape",
                                                     "--epochs", "1", "--nopretrained_cnn", "--save_prefix", "0001",
                                                     "--experiment_root", exp, "--save_interval", "1",
                                                     "--log_interval", "1"])
        torch.cuda.synchronize()
        n_steps, n_val = len(yt_train) // TRAIN_WINDOWS, -(-len(yt_valw) // TRAIN_WINDOWS)
        k1["yt_train_twin_validation"] = nms_greedy.launches
        k2["yt_train_twin"] = (cost_volume.launches, cost_volume_backward.launches)
        check(nms_greedy.launches == n_val, f"K1 launches in the YouTube-BB train twin: {nms_greedy.launches}")
        check(k2["yt_train_twin"] == (CORR_LAUNCHES * (n_steps + n_val), CORR_BWD_LAUNCHES * n_steps),
              f"K2 (forward, adjoint) launches in the YouTube-BB train twin: {k2['yt_train_twin']} for {n_steps} "
              f"steps and {n_val} validation batches")
        ep = stats["epochs"][0]
        rest = ep["steps"][1:]
        secs = sum(t for _, t, _ in rest)
        figures["yt_train_twin"] = {"windows": len(yt_train), "samples_s": ep["samples_s"], "steps": len(ep["steps"]),
                                    "steady_windows_s": len(rest) * TRAIN_WINDOWS / secs if secs else None,
                                    "steady_wait_share": sum(w for _, _, w in rest) / secs if secs else None,
                                    "first_step_ms": ep["steps"][0][1] * 1e3, "val": stats["val"]}
        print(f"slice 10 YouTube-BB train twin (windows of {WINDOW}, YOLOv3T on the 23 classes, bf16, "
              f"B={TRAIN_WINDOWS}, {SIZE} px, one epoch of {ep['samples']} windows) on {card}: "
              f"{figures['yt_train_twin']['steady_windows_s']} windows/s past the first step, waiting "
              f"{figures['yt_train_twin']['steady_wait_share']} of that; K2 {k2['yt_train_twin']}, K1 "
              f"{k1['yt_train_twin_validation']}")
        ckpt = f"{exp}/0001/yolo3_darknet53_yt_0000.params"
        check(os.path.exists(ckpt), f"the YouTube-BB train twin wrote no checkpoint {ckpt}")

        # the detect twin on YouTube-BB windows from that checkpoint, B=32
        nms_greedy.launches = cost_volume.launches = 0
        t0 = time.perf_counter()
        preds = detect.main(yt_flags + ["--model_path", ckpt, "--batch_size", str(WINDOW_DETECT_BATCH),
                                        "--save_dir", f"{tmp}/res", "--save_prefix", "yt", "--metrics", "voc"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_batches = -(-len(yt_valw) // WINDOW_DETECT_BATCH)
        k1["yt_detect_twin"], k2["yt_detect_twin"] = nms_greedy.launches, (cost_volume.launches, 0)
        check((nms_greedy.launches, cost_volume.launches) == (n_batches, CORR_LAUNCHES * n_batches),
              f"YouTube-BB detect twin launches (K1, K2) {(nms_greedy.launches, cost_volume.launches)}")
        check(os.path.exists(f"{tmp}/res/yt/voc.txt"), "the YouTube-BB window detect twin wrote no voc.txt")
        tf = YOLO3VideoInferenceTransform(SIZE, SIZE)
        idxs = range(min(WINDOW_DETECT_BATCH, len(yt_valw)))
        windows = torch.from_numpy(np.stack([
            tf(np.stack([native.decode(p) for p in yt_valw.window_paths(i)]), yt_valw.label_and_size(i)[0])[0]
            for i in idxs])).to(dev)
        ids, sc, bb = (a.cpu().numpy() for a in make_eval_step(model)(windows))
        ref = {}
        for n, i in enumerate(idxs):
            collect_boxes(ref, yt_valw.sample_path(i), ids[n], sc[n], np.clip(bb[n], 0, SIZE), SIZE)
        check(all(preds.get(p, []) == ref.get(p, []) for p in ref),
              "the YouTube-BB window detect twin's detections differ from the trained model's eval step")
        # the raw boxes and scores too: a one-epoch model may keep no detection above the threshold
        cfg = YoloConfig(**SLICE10_YT)
        twin_det = Detector(cfg, detect.load_model_variables(ckpt, cfg), dtype=torch.bfloat16, data_shape=SIZE)
        model.eval()
        with torch.inference_mode():
            raw_twin, raw_trained = twin_det.model(twin_det._normalized(windows)), model(windows)
        check(all(torch.equal(a, b) for a, b in zip(raw_twin, raw_trained)),
              "the raw outputs of the YouTube-BB window checkpoint's model differ from the trained model's")
        del twin_det, raw_twin, raw_trained
        figures["yt_detect_twin"] = {"windows": len(yt_valw), "seconds": secs, "windows_s_disk_to_metrics":
                                     len(yt_valw) / secs, "voc": open(f"{tmp}/res/yt/voc.txt").read().splitlines()[-1]}
        print(f"slice 10 YouTube-BB detect twin (windows of {WINDOW} from the checkpoint, bf16, "
              f"B={WINDOW_DETECT_BATCH}, {SIZE} px) on {card}: {len(yt_valw)} windows to voc.txt in {secs:.2f} s, "
              f"(K1, K2) {(k1['yt_detect_twin'], k2['yt_detect_twin'][0])}; the first batch's "
              f"{sum(map(len, ref.values()))} detections and its raw boxes and scores equal the trained model's bit for bit")
        del model
        torch.cuda.empty_cache()
    k1["total"] = sum(v for v in k1.values())
    k2["total"] = [sum(v[0] for v in k2.values()), sum(v[1] for v in k2.values())]
    figures["k1"], figures["k2"] = k1, k2
    print(f"slice 10 launches: K1 {k1}, K2 (forward, adjoint) {k2}")
    return figures, k1["total"], k2["total"]


# ---------------------------------------------------------------------------
# phase 15: slice 11, data-parallel training (BASELINE config 3: VOC with
# mixup and syncbn, which the reference trains on four GPUs)

DP_RANKS = 2  # (a): two ranks on the one card over gloo (NCCL refuses two ranks on one device)
DP_LOCAL = 4  # (a): each rank's batch; the global batch is DP_RANKS * DP_LOCAL
DP_STEPS = 2
# (a)'s runs, (dtype, accum_steps): the float64 ones are held to TRAIN_TOL;
# the float32 one is timed and held to DP_FLOAT32_FLOOR times the float32
# noise floor (the one-process step against itself on the global batch's
# rows reversed), which two steps at lr 1e-3 carry past TRAIN_TOL at any
# summation order
DP_RUNS = ((torch.float64, 1), (torch.float64, 2), (torch.float32, 1))
# the pair's losses, update L2, worst leaf and BN statistics at most this
# many times the floor's (2 runs on an H100: 0.35, 1.01, 1.15 and 1.05 times)
DP_FLOAT32_FLOOR = 2.0
DP_NCCL_STEPS = 3  # (b): steps held bit for bit
DP_TIMEOUT_S = 300  # the process group's, and the spawner's join of each child


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    """A rank's environment as torchrun sets it, every rank on card 0."""
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port))


def dp_batch(device, dtype=torch.float32):
    """Config 3's global batch at 416 px: the timed train batch (uint8
    pixels, VOC's colour maps, gt padded to TRAIN_ROWS) with mixup ratios,
    its floats in `dtype`."""
    batch = train_batch(np.random.RandomState(3), DP_RANKS * DP_LOCAL, SIZE, device)
    mix = np.random.RandomState(4).uniform(0.3, 1.0, (DP_RANKS * DP_LOCAL, TRAIN_ROWS, 1)).astype(np.float32)
    batch["gt_mix"] = torch.from_numpy(mix).to(device)
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}


def dp_model(device, dtype=torch.float32, s2d_stem=False):
    """Config 3's model from seed 1: float32 masters computing in `dtype`
    (float64 masters for float64)."""
    model = YOLOv3(num_classes=NUM_CLASSES, dtype=dtype, s2d_stem=s2d_stem)
    init_weights(model, torch.Generator().manual_seed(1))
    if dtype == torch.float64:
        model = model.double()
    return model.to(device, memory_format=torch.channels_last)


def dp_run(device, batch, dtype, accum, steps):
    """`steps` steps of config 3's model (mixup) on `batch`: the losses a
    step (global means in a process group), each step's ms on the host's
    clock, and the model."""
    model = dp_model(device, dtype)
    state = create_train_state(model, lr_schedule("step", 1e-3, steps_per_epoch=100, epochs=10))
    step = make_train_step(model, num_classes=NUM_CLASSES, mixup=True, accum_steps=accum)
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = multihost.global_mean(step(state, batch))
        losses.append({k: float(v) for k, v in m.items()})
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, model


def dp_rank(work: str) -> int:
    """A rank of phase 15 (a), started by `dp_pair`: joins the gloo group on
    card 0, takes its rows of the global batch, runs DP_RUNS, and writes
    what it saw to `work` (the states on rank 0 only)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with mesh.process_group("cuda", backend="gloo", timeout_s=DP_TIMEOUT_S) as dev:
        rank = multihost.process_index()
        rows = slice(rank * DP_LOCAL, (rank + 1) * DP_LOCAL)
        out = {"flags": [multihost.sync_flag(rank == 0), multihost.sync_any(rank == 1),
                         multihost.sync_any(False)]}
        for dtype, accum in DP_RUNS:
            batch = {k: v[rows] for k, v in dp_batch(dev, dtype).items()}
            losses, ms, model = dp_run(dev, batch, dtype, accum, DP_STEPS)
            flat = torch.cat([t.double().flatten() for t in model.state_dict().values()])
            ref = flat.clone()
            torch.distributed.broadcast(ref, src=0)
            out[str(dtype), accum] = {"losses": losses, "ms": ms, "rank_diff": float((flat - ref).abs().max())}
            if rank == 0:
                out[str(dtype), accum]["state"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
            del model, flat, ref
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    return 0


def wait_all(procs, timeout, label):
    """Every child's output; kills the rest when one fails or any runs over
    `timeout` seconds, and fails the phase."""
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        fail(f"{label}: a child ran over {timeout} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for i, (proc, out) in enumerate(zip(procs, outs)):
        check(proc.returncode == 0, f"{label}: child {i} exited {proc.returncode}:\n{out[-3000:]}")
    return outs


def dp_pair(dev, card):
    """Phase 15 (a): two ranks on the one card over gloo (CUDA tensors
    through the host) against the one-process step on the global batch on
    the card: in float64 within TRAIN_TOL, without and with accumulation
    (the batch reordered as the ranks' micro-batches make it); in float32
    timed, and its distance from the one-process step within
    DP_FLOAT32_FLOOR times that step's distance from itself on the batch's
    rows reversed."""
    figures = {}
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", tmp],
                                  env=rank_env(r, DP_RANKS, port), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(DP_RANKS)]
        wait_all(procs, DP_TIMEOUT_S, "phase 15 (a)")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(DP_RANKS)]
    check(all(r["flags"] == [True, True, False] for r in ranks), f"sync_flag / sync_any: {[r['flags'] for r in ranks]}")

    def state(model):
        return {k: v.detach().double().cpu() for k, v in model.state_dict().items()}

    for dtype, accum in DP_RUNS:
        key, name = (str(dtype), accum), str(dtype).split(".")[-1]
        got = ranks[0][key]
        check(got["rank_diff"] == ranks[1][key]["rank_diff"] == 0.0,
              f"phase 15 (a) {name} accum {accum}: the ranks' states differ by {got['rank_diff']}")
        batch = dp_batch(dev, dtype)
        before = state(dp_model("cpu", dtype))
        # micro-batch i of the pair holds chunk i of each rank's rows
        order = torch.arange(DP_RANKS * DP_LOCAL).view(DP_RANKS, accum, -1).transpose(0, 1).flatten().to(dev)
        ref_losses, ref_ms, ref_model = dp_run(dev, {k: v[order] for k, v in batch.items()}, dtype, accum, DP_STEPS)
        ref = state(ref_model)
        del ref_model
        label = (f"slice 11 (a) {DP_RANKS} ranks x B={DP_LOCAL} over gloo, {name}, accum_steps={accum}, {DP_STEPS} "
                 f"steps at {SIZE} px vs one process on the global batch")
        ours = {k: v.double() for k, v in got["state"].items()}
        run = {"step_ms": got["ms"], "one_process_step_ms": ref_ms, "losses": got["losses"]}
        if dtype == torch.float64:
            run.update(check_train_states(label, got["losses"], ref_losses, ours, ref, before))
        else:
            ctl_losses, _, ctl_model = dp_run(dev, {k: v.flip(0) for k, v in batch.items()}, dtype, accum, DP_STEPS)
            run["errors"] = train_state_errors(got["losses"], ref_losses, ours, ref, before)
            run["noise_floor"] = train_state_errors(ctl_losses, ref_losses, state(ctl_model), ref, before)
            del ctl_model
            for k in ("loss_rtol", "l2", "worst_leaf", "stats_err"):
                check(run["errors"][k] <= DP_FLOAT32_FLOOR * run["noise_floor"][k],
                      f"{label}: {k} {run['errors'][k]:.3g}, past {DP_FLOAT32_FLOOR} times the noise floor's "
                      f"{run['noise_floor'][k]:.3g}")
            print(f"{label}: the update {run['errors']['l2']:.3g} apart in L2 (worst leaf "
                  f"{run['errors']['worst_leaf']:.3g}, losses within rtol {run['errors']['loss_rtol']:.2e}); the "
                  f"one-process step on the rows reversed {run['noise_floor']['l2']:.3g} (worst leaf "
                  f"{run['noise_floor']['worst_leaf']:.3g}, losses {run['noise_floor']['loss_rtol']:.2e}): "
                  f"float32's rounding, amplified by train-mode BN over two steps; within {DP_FLOAT32_FLOOR} times "
                  f"the floor")
        figures[f"{name}_accum{accum}"] = run
        print(f"slice 11 (a) {name} step on {card}, {DP_RANKS} ranks on one card over gloo (host-staged all-reduce, "
              f"no target), accum_steps={accum}: " + ", ".join(f"{ms:.1f}" for ms in got["ms"])
              + " ms a step on the host's clock; one process at B=" + str(DP_RANKS * DP_LOCAL) + ": "
              + ", ".join(f"{ms:.1f}" for ms in ref_ms))
        torch.cuda.empty_cache()
    figures["peak_gib_rank0"] = ranks[0]["peak_gib"]
    return figures


def dp_nccl_world1(dev, card):
    """Phase 15 (b): the train step in a NCCL group of one at slice 4's
    B=48, 416 px, bf16 (s2d stem): bit-equal to the plain step over
    DP_NCCL_STEPS steps (cuDNN deterministic for the comparison, and the
    plain step run twice as a control); both timed as phase 9 times it.
    The step averages no gradients in a group of one, so `average_gradients`
    is then called on the last step's gradients by hand: NCCL's all-reduce
    of the flattened gradients and the copy back, bit for bit, timed."""
    batch = train_batch(np.random.RandomState(0), TRAIN_BATCH, SIZE, dev)

    def make():
        model = dp_model(dev, torch.bfloat16, s2d_stem=True)
        state = create_train_state(model, lr_schedule("step", 1e-3, steps_per_epoch=100, epochs=10))
        return model, state, make_train_step(model, num_classes=NUM_CLASSES)

    def run():
        model, state, step = make()
        losses = [{k: v.clone() for k, v in step(state, batch).items()} for _ in range(DP_NCCL_STEPS)]
        return losses, {k: v.clone() for k, v in model.state_dict().items()}

    def timed():
        model, state, step = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = statistics.median(cuda_time_ms(lambda: step(state, batch), iters=10, warmup=3))
        return ms, torch.cuda.max_memory_allocated(), model

    def averaged(model):
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        before = [g.clone() for g in grads]
        ms = statistics.median(cuda_time_ms(lambda: average_gradients(model), iters=10, warmup=3))
        return ms, sum(g.numel() * g.element_size() for g in grads), all(map(torch.equal, grads, before))

    def equal(a, b):
        return (all(torch.equal(x[k], y[k]) for x, y in zip(a[0], b[0]) for k in x)
                and all(torch.equal(a[1][k], b[1][k]) for k in a[1]))

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain, control = run(), run()
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(free_port()))
        with mesh.process_group("cuda", timeout_s=DP_TIMEOUT_S):
            check(torch.distributed.get_backend() == "nccl", "phase 15 (b): the group is not NCCL's")
            dp = run()
            torch.backends.cudnn.deterministic = deterministic
            dp_ms, dp_peak, model = timed()
            avg_ms, avg_bytes, avg_equal = averaged(model)
            del model
        plain_ms, plain_peak, _ = timed()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(key, None)
    check(equal(plain, control), "phase 15 (b): the plain step is not deterministic run to run")
    check(equal(dp, plain), "phase 15 (b): the NCCL world-1 step differs from the plain step")
    check(avg_equal, "phase 15 (b): average_gradients in a NCCL group of one changed the gradients")
    print(f"slice 11 (b) B={TRAIN_BATCH} at {SIZE} px bf16, s2d stem, on {card}: the step in a NCCL group of one "
          f"equals the plain step bit for bit over {DP_NCCL_STEPS} steps (losses, parameters, statistics); "
          f"{dp_ms:.3f} ms a step against {plain_ms:.3f} plain (median of 10 after 3 warm), peak memory "
          f"{dp_peak / 2**30:.2f} against {plain_peak / 2**30:.2f} GiB; average_gradients on its "
          f"{avg_bytes / 1e6:.1f} MB of gradients (NCCL's all-reduce of one rank and the copy back) {avg_ms:.3f} ms, "
          f"no bit changed")
    torch.cuda.empty_cache()
    return {"dp_ms": dp_ms, "plain_ms": plain_ms, "dp_peak_gib": dp_peak / 2**30, "plain_peak_gib": plain_peak / 2**30,
            "bit_equal_steps": DP_NCCL_STEPS, "average_gradients_ms": avg_ms, "gradient_mb": avg_bytes / 1e6}


def twin_rank(argv) -> int:
    """A rank of phase 15 (c), started by torchrun: the train twin's `main`,
    as `python -m videoyolo_torch.train_yolov3` runs it, with K1 counted; its
    figures on the last line."""
    logging.basicConfig(level=logging.INFO)
    nms_greedy.launches = 0
    _, stats = train_yolov3.main(argv)
    torch.cuda.synchronize()
    ep = stats["epochs"][0]
    print(json.dumps({"k1": nms_greedy.launches, "samples_s": ep["samples_s"], "steps": len(ep["steps"]),
                      "wait_share": ep["wait_s"] / ep["seconds"], "val": stats["val"]}))
    return 0


def torchrun(args, log_path=None):
    """`python -m torch.distributed.run --nproc_per_node 1 ...` from the
    checkout's root."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1", "--master_port",
           str(free_port()), *args]
    env = dict(os.environ)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    return subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def dp_twin(card):
    """Phase 15 (c): the train twin under torchrun, one rank over NCCL, on a
    VOC tree (phase 10's): one epoch with --mixup --syncbn (B=48, 416 px,
    validated: K1 counted), one checkpoint; then a SIGTERM to the rank in
    the first epoch of three, which must leave `<prefix>_0000.params` alone
    and exit 0."""
    workers = os.cpu_count() or 1
    with tempfile.TemporaryDirectory() as tmp:
        write_voc_tree(tmp)
        argv = ["--dataset", "voc", "--mixup", "--syncbn", "--dataset_root", tmp, "--batch_size", str(TWIN_BATCH),
                "--data_shape", str(SIZE), "--no_random_shape", "--nopretrained_cnn", "--dtype", "bf16",
                "--save_prefix", "0000", "--save_interval", "1", "--log_interval", "1", "--num_workers", str(workers)]
        t0 = time.perf_counter()
        out, = wait_all([torchrun([os.path.abspath(__file__), "--twin-rank", *argv, "--epochs", "1",
                                   "--experiment_root", f"{tmp}/exp"])], DP_TIMEOUT_S, "phase 15 (c) one epoch")
        seconds = time.perf_counter() - t0
        rec = json.loads(out.strip().splitlines()[-1])
        files = sorted(os.listdir(f"{tmp}/exp/0000"))
        check(files == ["yolo3_darknet53_voc_0000.params", "yolo3_darknet53_voc_train.log"],
              f"phase 15 (c): the twin's files {files}")
        n_val = -(-VOC_TEST // TWIN_BATCH)
        check(rec["k1"] == n_val, f"phase 15 (c): K1 launches in the twin's validation {rec['k1']}, expected {n_val}")
        print(f"slice 11 (c) train twin under torchrun (1 rank, NCCL, --mixup --syncbn, bf16, B={TWIN_BATCH}, {SIZE} "
              f"px, one epoch of {rec['steps']} steps) on {card}: {rec['samples_s']:.1f} samples/s over the epoch, "
              f"waiting on the prefetcher {rec['wait_share']:.3f} of it; validation K1 {rec['k1']} launches, mAP "
              f"{rec['val'][0]['map']:.4f}; one checkpoint; {seconds:.1f} s with torchrun's start")

        agent = torchrun(["-m", "videoyolo_torch.train_yolov3", *argv, "--epochs", "3", "--experiment_root",
                          f"{tmp}/sig"])
        lines, signalled = [], False
        deadline = time.time() + DP_TIMEOUT_S
        while time.time() < deadline and not signalled:
            line = agent.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "[Epoch 0][Batch 0]" in line:
                workers_of = subprocess.run(["ps", "-o", "pid=", "--ppid", str(agent.pid)], capture_output=True,
                                            text=True).stdout.split()
                check(len(workers_of) == 1, f"phase 15 (c): torchrun's workers {workers_of}")
                os.kill(int(workers_of[0]), signal.SIGTERM)
                signalled = True
        rest, = wait_all([agent], DP_TIMEOUT_S, "phase 15 (c) SIGTERM")
        log = "".join(lines) + rest
        check(signalled, f"phase 15 (c): no first step seen:\n{log[-3000:]}")
        files = sorted(os.listdir(f"{tmp}/sig/0000"))
        check("Preempted: wrote" in log and "Validation" not in log
              and files == ["yolo3_darknet53_voc_0000.params", "yolo3_darknet53_voc_train.log"],
              f"phase 15 (c) SIGTERM: files {files}:\n{log[-3000:]}")
        print(f"slice 11 (c) SIGTERM to the rank in its first epoch: exit 0, {files[0]} written, no validation")
    return {"twin": {**rec, "seconds": seconds}, "sigterm": {"files": files}}, rec["k1"]


def data_slice11(dev, card):
    """Phase 15.  Returns (the phase's figures, K1's launches on the twin's
    validation)."""
    figures = {"pair": dp_pair(dev, card), "nccl_world1": dp_nccl_world1(dev, card)}
    twin, k1 = dp_twin(card)
    figures.update(twin)
    return figures, k1


# ---------------------------------------------------------------------------
# phase 16: slice 12, streaming video detection (videoyolo_torch/streaming.py)
# through the detect twin
# ---------------------------------------------------------------------------

# (a) the JAX bench's stream configuration (bench.py:479-522): the tip split
STREAM = dict(num_classes=NUM_CLASSES, k=WINDOW, k_join_type="max", k_join_pos="late")
STREAM_BATCH = 32  # streams, the JAX bench's
STREAM_T5_BATCH = 16  # (c): the t=5 pyramid's streams, slice 9's B=16 windows
STREAM_SMALL_BATCH = 2  # (d) and (e)
STREAM_CHECK_STEPS = 3  # steps held against the windowed forward after the reset
STREAM_WARM, STREAM_TIMED = 3, 10
STREAM_PROFILED = 5  # steps of the profiled run (one step's idle share spread 0.17-0.65)
STREAM_F32_SIZE = 128
STREAM_TOL = dict(rtol=1e-4, atol=1e-4)  # (e): float32 stream vs windowed Detector, other conv algorithms
PLAIN_TOUT = dict(num_classes=NUM_CLASSES, temporal=True, t_out=True)  # (d): the route split of t=5
# (name, config, streams at 416 px, split, K2 launches a step)
STREAM_CELLS = [
    ("a_late_max", STREAM, STREAM_BATCH, "tips", 0),
    ("b_slice2", SLICE2, STREAM_BATCH, "routes", CORR_LAUNCHES),
    ("c_t5_pyramid", T5, STREAM_T5_BATCH, "stage1", T5_CORR_LAUNCHES),
    ("d_t5_plain_tout", PLAIN_TOUT, STREAM_SMALL_BATCH, "routes", 0),
    ("d_t5_funnel", FUNNEL, STREAM_SMALL_BATCH, "stage1", 0),
]
STREAM_TIMED_CELLS = ("a_late_max", "b_slice2", "c_t5_pyramid")
STREAM_SNIPPETS = 2  # (f): two snippets of phase 12's VID tree, every frame


def stream_frames_on_card(gen, n, b, size, dev):
    """n distinct seeded uint8 frames (B, S, S, 3) on the card."""
    return [torch.randint(0, 256, (b, size, size, 3), generator=gen, dtype=torch.uint8, device=dev)
            for _ in range(n)]


def trail_window(frames, i, k):
    """The window (B, k, S, S, 3) ending at frame i, left-padded with frame 0."""
    return torch.stack([frames[max(0, j)] for j in range(i - k + 1, i + 1)], dim=1)


def check_head_tol(label, got, want):
    """A stream's raw (boxes, scores) against the windowed forward's, boxes
    clipped to the image, within HEAD_TOL; returns the max abs errors."""
    errs = {}
    for i, name in enumerate(("boxes", "scores")):
        a, b_ = (h[i].float().clamp(0, SIZE) if name == "boxes" else h[i].float() for h in (got, want))
        e = (a - b_).abs()
        e_max, e_mean, tol = float(e.max()), float(e.mean()), HEAD_TOL[name]
        check(e_max <= tol["max"] and e_mean <= tol["mean"],
              f"{label} {name}: stream vs windowed forward max {e_max} (tol {tol['max']}), mean {e_mean} "
              f"(tol {tol['mean']})")
        errs[name] = (e_max, e_mean)
    return errs


def stream_cell(name, cfg, b, split, k2_per_step, dev, card, gen):
    """(a)-(d): `cfg` at 416 px bf16 as B streams through StreamingDetector:
    the split, K1 once and K2 `k2_per_step` times a step, for
    STREAM_CHECK_STEPS steps after the reset the raw outputs within HEAD_TOL
    of the same model's windowed forward on the same window and the
    detections in range; for the timed cells frames/s over STREAM_TIMED
    steps after STREAM_WARM (CUDA events) beside the windowed Detector on B
    windows, peak memory and STREAM_PROFILED profiled steps (their idle
    share, and the device busy time they read over the CUDA-event step:
    the profiler's own host cost lengthens its wall time); (a) K1
    bit-equal to the plain NMS on the stream's candidates.  Returns
    (figures, K1, K2 launches)."""
    det = Detector(YoloConfig(**cfg), dtype=torch.bfloat16, data_shape=SIZE, device="cuda", seed=0)
    m = det.model
    stream = StreamingDetector(m)
    check(stream.split == split, f"stream {name}: the {stream.split} split, expected {split}")
    k = stream.k
    timed = name in STREAM_TIMED_CELLS
    frames = stream_frames_on_card(gen, 1 + STREAM_CHECK_STEPS + (STREAM_WARM + STREAM_TIMED if timed else 0), b,
                                   SIZE, dev)
    figures = dict(config=cfg, streams=b, split=split, k=k)
    made, errs = [], []

    def counted(fn):
        """fn() with the kernels' counts set to 0 just before it; adds what
        it launched to `made`."""
        nms_greedy.launches = cost_volume.launches = 0
        out = fn()
        torch.cuda.synchronize()
        made.append((nms_greedy.launches, cost_volume.launches))
        return out

    for i in range(1 + STREAM_CHECK_STEPS):
        dets = counted(lambda: stream.reset(frames[0]) if i == 0 else stream.step(frames[i]))
        t_out = dets[0].dim() == 4
        shape = (b, k, POST_NMS) if t_out else (b, POST_NMS)
        check(dets[0].shape[:-1] == shape and dets[2].shape[:-1] == shape,
              f"stream {name} step {i}: outputs {[tuple(d.shape) for d in dets]}")
        check_detections(f"stream {name} step {i}", [tuple(d.flatten(0, 1) if t_out else d for d in
                                                          (dets[0], dets[1], dets[2].clamp(0, SIZE)))],
                         [b * k if t_out else b])
        with torch.inference_mode():
            want = m(to_normalized(trail_window(frames, i, k), dtype=det.dtype))
            errs.append(check_head_tol(f"stream {name} step {i}", stream.raw(), want))
    check(all(mk == (1, k2_per_step) for mk in made), f"stream {name}: launches (K1, K2) a step {made}")
    steps = len(made)
    figures["launches_a_step"] = dict(k1=1, k2=k2_per_step)
    figures["head_vs_windowed"] = {n: [max(e[n][0] for e in errs), max(e[n][1] for e in errs)]
                                   for n in ("boxes", "scores")}
    print(f"stream {name} ({split} split, k={k}) B={b} streams at {SIZE} px bf16: reset + {STREAM_CHECK_STEPS} "
          f"steps, K1 1 and K2 {k2_per_step} a step, raw outputs vs the windowed forward on the same windows "
          f"(boxes clipped): max/mean abs {figures['head_vs_windowed']} within HEAD_TOL")
    if name == "a_late_max":
        with torch.inference_mode():
            boxes, scores = stream.raw()
            cands = select_topk_candidates(boxes, scores, topk=NMS_TOPK)
            got = nms_greedy(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
            want = nms_greedy_plain(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
        check(all(torch.equal(a, b_) for a, b_ in zip(got, want)),
              f"stream {name}: K1 on the stream's candidates is not the plain NMS's")
        figures["k1_equal_plain"] = True
        print(f"stream {name}: K1's keep mask and rows on the stream's B={b} candidates (K={cands.shape[1]}) "
              "equal the plain NMS's")
    if timed:
        it = iter(frames[1 + STREAM_CHECK_STEPS:])
        torch.cuda.reset_peak_memory_stats()
        ms = statistics.median(counted(lambda: cuda_time_ms(lambda: stream.step(next(it)), iters=STREAM_TIMED,
                                                            warmup=STREAM_WARM)))
        peak = torch.cuda.max_memory_allocated()
        prof = counted(lambda: profile_steps([(f"stream {name} B={b} step", lambda f: stream.step(f), frames[-1],
                                               STREAM_PROFILED, 8)], card))
        steps += STREAM_WARM + STREAM_TIMED + STREAM_PROFILED
        windows = trail_window(frames, len(frames) - 1, k)
        w_ms = median_ms(lambda: det(windows), STREAM_TIMED)
        prof = next(iter(prof.values()), {})
        idle, busy = prof.get("idle_share"), prof.get("busy_ms")
        idle_events = None if busy is None else max(0.0, 1 - busy / ms)
        per = k if t_out else 1  # detections a step: one set a stream, or one a frame of its window (t_out)
        figures.update(step_ms=ms, frames_s=b / ms * 1e3, windowed_request_ms=w_ms, windowed_frames_s=b / w_ms * 1e3,
                       stream_over_windowed=w_ms / ms, peak_gib=peak / 2**30, idle_share=idle,
                       profiled_wall_ms=prof.get("wall_ms"), busy_ms=busy, idle_share_events=idle_events,
                       detection_sets_a_step=b * per, buffers_mb=sum(x.numel() * x.element_size()
                                                                     for x in stream._buffers) / 1e6)
        print(f"stream {name} B={b} at {SIZE} px bf16 on {card}: {figures['frames_s']:.1f} frames/s ({ms:.3f} ms a "
              f"step, median of {STREAM_TIMED} after {STREAM_WARM} warm), the windowed Detector on B={b} windows of "
              f"{k} {w_ms:.3f} ms ({figures['windowed_frames_s']:.1f} frames detected/s): {w_ms / ms:.2f}x; peak "
              f"memory {peak / 2**30:.2f} GiB, buffers {figures['buffers_mb']:.1f} MB, idle share {idle} profiled, "
              f"{idle_events} of the CUDA-event step")
    k1, k2 = sum(mk[0] for mk in made), sum(mk[1] for mk in made)
    check((k1, k2) == (steps, k2_per_step * steps), f"stream {name}: launches (K1, K2) {(k1, k2)} over {steps} steps")
    del stream, det, m, frames
    torch.cuda.empty_cache()
    return figures, k1, k2


def match_rows(a, b) -> bool:
    """Detections (ids, scores, boxes) of one image, numpy, within STREAM_TOL:
    the scores in order, each row against its own largest magnitude (a
    corner near 0 of a wide box carries the rounding of its centre and
    size), rows of scores within the tolerance matched in either order."""
    rows, ref = (np.concatenate([np.asarray(x, np.float64) for x in d], -1) for d in (a, b))
    if not np.allclose(rows[:, 1], ref[:, 1], **STREAM_TOL):
        return False
    unused = list(range(len(ref)))
    for row in rows:
        hit = next((u for u in unused if np.abs(row - ref[u]).max()
                    <= STREAM_TOL["atol"] + STREAM_TOL["rtol"] * np.abs(ref[u]).max()), None)
        if hit is None:
            return False
        unused.remove(hit)
    return True


def stream_f32(dev, card):
    """(e): float32 at 128 px, B=2 streams, each of (a)-(d)'s configurations:
    the trail stream over k+1 frames against the windowed Detector on the
    same weights and windows, every step (STREAM_TOL); the center anchor over
    k+2 frames: exactly that many pairs, in order, each equal to the window
    centred on its frame, clamped at the clip's ends.  Returns the steps
    held a configuration."""
    gen = torch.Generator(device=dev).manual_seed(16)
    out = {}
    s, b = STREAM_F32_SIZE, STREAM_SMALL_BATCH
    for name, cfg, *_ in STREAM_CELLS:
        det = Detector(YoloConfig(**cfg), dtype=torch.float32, data_shape=s, device="cuda", seed=1)
        stream = StreamingDetector(det.model)
        k = stream.k
        frames = stream_frames_on_card(gen, k + 2, b, s, dev)

        def held(dets, window, label):
            want = [x.cpu().numpy().reshape(-1, POST_NMS, x.shape[-1]) for x in det(window)]
            got = [x.cpu().numpy().reshape(-1, POST_NMS, x.shape[-1]) for x in (dets[0], dets[1], dets[2].clamp(0, s))]
            for i in range(len(got[0])):  # an image: a stream, or a frame of its window (t_out)
                check(match_rows([x[i] for x in got], [x[i] for x in want]),
                      f"stream float32 {name} {label} image {i}: not within {STREAM_TOL} of the windowed Detector")

        for i in range(k + 1):
            held(stream.reset(frames[0]) if i == 0 else stream.step(frames[i]), trail_window(frames, i, k),
                 f"trail step {i}")
        pairs = list(stream_frames(stream, iter(frames), anchor="center"))
        check([m for m, _ in pairs] == list(range(len(frames))),
              f"stream float32 {name} center: frames {[m for m, _ in pairs]}")
        for m, dets in pairs:
            idx = [min(max(0, m + d), len(frames) - 1) for d in range(-(k // 2), k - k // 2)]
            held(dets, torch.stack([frames[j] for j in idx], 1), f"center frame {m}")
        out[name] = dict(trail_steps=k + 1, center_frames=len(pairs))
        del det, stream
        torch.cuda.empty_cache()
    print(f"stream float32 {s} px B={b} streams, configurations {list(out)}: every trail step and every center "
          f"frame within rtol=atol={STREAM_TOL['rtol']} of the windowed Detector on the same windows (rows against "
          "their own magnitude, near-tied rows in either order); center yields each clip's frames once, in order")
    return out


def stream_twin(dev, card):
    """(f): the detect twin with --stream on STREAM_SNIPPETS snippets of
    phase 12's VID tree (--every 1, bf16, 416 px): YOLOv3T late max, trail
    and center, and --temp --mult_out --window 5,1 with the correlation
    pyramid; one pred/ file a frame, K1 (and K2) counted, and the cache equal
    bit for bit to an in-process StreamingDetector on the same weights fed
    the same frames (decoded one at a time by the JPEG core, as the loader
    decodes them) with a reset at each snippet; then one synthetic --stream
    request through the entry point.  Returns (figures, K1, K2 launches)."""
    figures, k1, k2 = {}, {}, {}
    workers = os.cpu_count() or 1
    with tempfile.TemporaryDirectory() as tmp:
        write_vid_tree(tmp, (("val", STREAM_SNIPPETS, 3000),))
        vid = f"{tmp}/ImageNetVID/ILSVRC/Data/VID/val"
        videos = sorted(os.listdir(vid))
        paths = [[f"{vid}/{v}/{f}" for f in sorted(os.listdir(f"{vid}/{v}"))] for v in videos]
        n = sum(map(len, paths))
        base = ["--dataset", "vid", "--dataset_root", tmp, "--every", "1", "--data_shape", str(SIZE), "--dtype",
                "bf16", "--num_workers", str(workers), "--metrics", "voc", "--stream"]
        runs = [("trail", ["--window", f"{WINDOW},1", "--k_join_type", "max", "--k_join_pos", "late"]),
                ("center", ["--window", f"{WINDOW},1", "--k_join_type", "max", "--k_join_pos", "late",
                            "--stream_anchor", "center"]),
                ("t5_trail", ["--window", f"{T5_FRAMES},1", "--temp", "--mult_out", "--corr_pos", "early",
                              "--corr_d", str(T5["corr_d"])])]
        for label, extra in runs:
            flags = base + extra + ["--save_dir", f"{tmp}/res", "--save_prefix", label]
            nms_greedy.launches = cost_volume.launches = 0
            t0 = time.perf_counter()
            preds = detect.main(flags)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            k1[label], k2[label] = nms_greedy.launches, cost_volume.launches
            args = detect.parse_args(flags)
            stream = StreamingDetector(Detector(detect.dataset_config(args, 30), dtype=torch.bfloat16, device="cuda",
                                                seed=args.seed).model)
            lag = (stream.k - 1 - stream.k // 2) if args.stream_anchor == "center" else 0
            k2_step = T5_CORR_LAUNCHES if label.startswith("t5") else 0
            check((k1[label], k2[label]) == (n + lag * len(videos), k2_step * (n + lag * len(videos))),
                  f"stream twin {label}: launches (K1, K2) {(k1[label], k2[label])} for {n} frames")
            files = sorted(f"{v}/{f}" for v in os.listdir(f"{tmp}/res/{label}/pred")
                           for f in os.listdir(f"{tmp}/res/{label}/pred/{v}"))
            check(files == sorted(f"{v}/{os.path.basename(p)[:-5]}.txt" for v, ps in zip(videos, paths) for p in ps),
                  f"stream twin {label}: {len(files)} cache files for {n} frames, or misnamed")
            want = {}
            t_off = -1 if args.stream_anchor == "trail" else stream.k // 2
            for ps in paths:  # a reset at each snippet
                frames = (torch.from_numpy(native.load_batch([p], SIZE, SIZE)[0]).to(dev) for p in ps)
                for m, dets in stream_frames(stream, frames, anchor=args.stream_anchor):
                    ids, sc, bb = (x[0].cpu().numpy() for x in dets)
                    if ids.ndim == 3:
                        ids, sc, bb = ids[t_off], sc[t_off], bb[t_off]
                    collect_boxes(want, ps[m], ids, sc, bb.clip(0, SIZE), SIZE)
            check(preds == want, f"stream twin {label}: the cache differs from the in-process stream")
            figures[label] = dict(frames=n, seconds=secs, frames_s_disk_to_metrics=n / secs, k1=k1[label],
                                  k2=k2[label], detections=sum(map(len, preds.values())),
                                  voc=open(f"{tmp}/res/{label}/voc.txt").read().splitlines()[-1])
            print(f"stream twin {label} ({stream.split} split) on {len(videos)} VID snippets, {n} frames, bf16, "
                  f"{SIZE} px, on {card}: {n / secs:.1f} frames/s from JPEG on disk to the metrics (model build "
                  f"included), one pred/ file a frame, K1 {k1[label]}, K2 {k2[label]}, the cache equal to the "
                  f"in-process stream with a reset at each snippet")
            del stream
            torch.cuda.empty_cache()
    nms_greedy.launches = cost_volume.launches = 0
    preds = detect.main(["--data_shape", str(SIZE), "--batch_size", "4", "--num_requests", "3", "--seed", "2",
                         "--dtype", "bf16", "--window", f"{WINDOW},1", "--k_join_type", "max", "--k_join_pos", "late",
                         "--stream"])
    k1["entry_point"], k2["entry_point"] = nms_greedy.launches, cost_volume.launches
    check((nms_greedy.launches, cost_volume.launches) == (3, 0),
          f"stream entry point: launches (K1, K2) {(nms_greedy.launches, cost_volume.launches)}")
    entries = check_entry_point(preds, 4 * 3)
    print(f"stream entry point: 4 synthetic streams x 3 frames, {len(entries)} normalised detections, in range")
    return figures, k1, k2


def data_slice12(dev, card):
    """Phase 16.  Returns (the phase's figures, K1's and K2's launches on
    its paths)."""
    figures, k1, k2 = {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(12)
    for name, cfg, b, split, k2_per_step in STREAM_CELLS:
        figures[name], k1[name], k2[name] = stream_cell(name, cfg, b, split, k2_per_step, dev, card, gen)
    figures["f32_vs_windowed"] = stream_f32(dev, card)
    figures["twin"], k1_twin, k2_twin = stream_twin(dev, card)
    k1.update({f"twin_{k}": v for k, v in k1_twin.items()})
    k2.update({f"twin_{k}": v for k, v in k2_twin.items()})
    k1["total"], k2["total"] = sum(k1.values()), sum(k2.values())
    figures["k1"], figures["k2"] = k1, k2
    print(f"slice 12 launches: K1 {k1}, K2 {k2}")
    return figures, k1["total"], k2["total"]


# ---------------------------------------------------------------------------
# phase 17: slice 13, the conv-RNN and the 3D / 2+1D blocks of YOLOv3T
# (videoyolo_torch/models/layers.py ConvRNN, Conv21D; yolo3_temporal.py)
# ---------------------------------------------------------------------------

# the JAX package's rnn profile (tools/prof_temporal.py:141-150): YOLOv3T on
# ImageNet-VID's 30 classes, k=3, the late max join, B=16 windows at 416 px;
# beside it the one conv-RNN configuration that runs K2 (the tip GRU, then
# the late correlation, no join), and the 3-D and 2+1D blocks
S13_CLASSES = 30
S13_MODELS = {  # name: (YOLOv3T keywords, K2 launches a request)
    "rnn_late_max": (dict(k_join_type="max", k_join_pos="late", rnn_pos="late"), 0),
    "rnn_out": (dict(k_join_type="max", k_join_pos="late", rnn_pos="out"), 0),
    "rnn_late_corr": (dict(k_join_pos="late", rnn_pos="late", corr_pos="late", corr_d=4), CORR_LAUNCHES),
    "block3_mean": (dict(k_join_type="mean", k_join_pos="late", block_conv_type="3"), 0),
    "block21_max": (dict(k_join_type="max", k_join_pos="late", block_conv_type="21"), 0),
}
S13_BATCH = 16
S13_WARM, S13_TIMED = 3, 10
S13_F32_SIZE = 128
S13_STREAMS = {"rnn_out": "tips", "rnn_late_max": "routes"}  # (c): the split each takes
S13_STREAM_STEPS = 3  # steps held against the windowed forward after the reset
S13_TRAIN = ("rnn_late_corr", "block21_max")  # (d)
S13_TRAIN_WINDOWS = 8
S13_F32_WINDOWS = 2  # (d): the float32 step's windows, phase 12's (BN statistics over 6 frames)
S13_TWIN_EVERY = 8  # (e): 24 train windows (3 steps at B=8), 8 val windows (one batch)
S13_TWIN_VAL_SNIPPETS = 2  # (e): the first two of phase 12's val snippets
# (e): the flags as a user of the JAX CLI passes them; the factory's default
# k_join_type "max" makes this the tip GRU with the late max join
S13_TWIN_FLAGS = ["--window", f"{WINDOW},1", "--rnn_pos", "late", "--k_join_pos", "late", "--corr_pos", "late",
                  "--corr_d", "4", "--every", str(S13_TWIN_EVERY)]
# the named ranges of phase 17's profiles: {scope: [(models.layers class, method)]}
S13_SCOPES = {"rnn_gates": [("ConvGRUCell", "gates"), ("ConvLSTMCell", "gates")],
              "rnn_average": [("ConvRNN", "average")]}


def s13_model(name, dtype=torch.bfloat16, seed=0) -> YOLOv3T:
    """The phase's model `name` from a seeded init.  The factory gives the
    late join whenever k_join_pos is late (its k_join_type defaults to
    "max"), so YOLOv3T is built from its keywords, as the factory would
    build the others."""
    model = YOLOv3T(num_classes=S13_CLASSES, k=WINDOW, dtype=dtype, **S13_MODELS[name][0])
    return init_weights(model, torch.Generator().manual_seed(seed))


class S13Detector(Detector):
    """`Detector` (normalise, forward, top-k, K1, clip) over `s13_model`."""

    def __init__(self, name, dtype, size, device, seed=0):
        self.name = name
        super().__init__(YoloConfig(num_classes=S13_CLASSES, k=WINDOW), dtype=dtype, data_shape=size, device=device,
                         seed=seed)

    def _float_model(self, cfg, variables, seed):
        return s13_model(self.name, cfg.dtype, seed)


def s13_windows(gen, b, size, dev):
    return torch.randint(0, 256, (b, WINDOW, size, size, 3), generator=gen, dtype=torch.uint8, device=dev)


def s13_profile(label, fn, n, card):
    """`scoped_profile` with the conv-RNN's gate arithmetic (`gates`) and
    its two directions' mean (`average`) in named ranges."""
    return scoped_profile(label, fn, n, card, S13_SCOPES)


def scoped_profile(label, fn, n, card, scopes, when=None):
    """n profiled calls of fn() with the methods of `scopes` (a class of
    `models.layers` by name, or a class) in named ranges (only on the
    instances `when` holds for, where given):
    wall, device busy and idle share a call, device ops, and each range's
    device time a call (the kernels its ops launched) and share of the busy
    time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from videoyolo_torch.models import layers

    saved = []
    for scope, targets in scopes.items():
        for cls_name, attr in targets:
            cls = getattr(layers, cls_name) if isinstance(cls_name, str) else cls_name
            raw = cls.__dict__[attr]
            static = isinstance(raw, staticmethod)
            inner = raw.__func__ if static else raw

            def wrapped(*a, _f=inner, _s=scope, _static=static, **k):
                if when is not None and not _static and not when(a[0]):
                    return _f(*a, **k)
                with record_function(_s):
                    return _f(*a, **k)

            setattr(cls, attr, staticmethod(wrapped) if static else wrapped)
            saved.append((cls, attr, raw))
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
    finally:
        for cls, attr, raw in saved:
            setattr(cls, attr, raw)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in scopes]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy_ms == 0:
        print(f"profile {label}: the profiler recorded no device time; busy share not measured")
        return {}
    scoped = {s: sum(e.device_time_total for e in prof.events()
                     if e.name == s and e.device_type == torch.autograd.DeviceType.CPU) / 1e3 / n
              for s in scopes}
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": max(0.0, 1 - busy_ms / wall_ms),
           "ops": sum(e.count for e in kernels) // n,
           **{f"{s}_ms": v if v else None for s, v in scoped.items()},
           **{f"{s}_share": v / busy_ms if v else None for s, v in scoped.items()}}
    print(f"profile {label} x{n} on {card} (profiler on): wall {wall_ms:.3f} ms a call, device busy {busy_ms:.3f} ms, "
          f"idle share {out['idle_share']:.3f}, {out['ops']} device ops; "
          + ", ".join(f"{s} {out[f'{s}_ms']} ms ({out[f'{s}_share']} of busy)" for s in scopes))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms a call  {e.count // n:4d}x  {e.key[:90]}")
    return out


def s13_outputs(model, vols):
    """(boxes, scores) of the output heads on the three given tips."""
    outs = [getattr(model, f"output{i}")(v) for i, v in enumerate(vols)]
    return torch.cat([o[0] for o in outs], dim=-2), torch.cat([o[1] for o in outs], dim=-2)


def s13_serve(name, dev, card, gen):
    """(a), and (c) for the streamed models: B=16 windows at 416 px bf16
    through the Detector; returns (figures, K1, K2 launches)."""
    k2_req = S13_MODELS[name][1]
    t0 = time.perf_counter()
    det = S13Detector(name, torch.bfloat16, SIZE, "cuda")
    m = det.model
    figures = dict(config=S13_MODELS[name][0], windows=S13_BATCH, build_s=time.perf_counter() - t0)
    x = s13_windows(gen, S13_BATCH, SIZE, dev)
    nms_greedy.launches = cost_volume.launches = 0
    outs = det(x)
    torch.cuda.synchronize()
    k1, k2 = nms_greedy.launches, cost_volume.launches
    check((k1, k2) == (1, k2_req), f"slice 13 {name}: launches (K1, K2) a request {(k1, k2)}, expected (1, {k2_req})")
    check_detections(f"slice 13 {name}", [outs], [S13_BATCH], classes=S13_CLASSES)
    with torch.inference_mode():
        xn = det._normalized(x)
        boxes, scores = m(xn)
        cands = select_topk_candidates(boxes, scores, topk=NMS_TOPK)
        got = nms_greedy(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
        want = nms_greedy_plain(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
    check(all(torch.equal(a, b) for a, b in zip(got, want)), f"slice 13 {name}: K1 on its candidates differs from the "
          "plain NMS")
    figures["k1_equal_plain"] = True
    # (the comparisons with the plain versions are not counted)
    if k2_req:  # the late correlation on the tip GRU's outputs: K2 against the plain version, and the heads on each
        with torch.inference_mode():
            tips = m.fpn(m.window_routes(m.frame_routes(xn)))
            k_vols = [m.corr(t) for t in tips]
            p_vols = [plain_corr(m.corr, t) for t in tips]
            errs = [float((a - b).abs().max()) for a, b in zip(k_vols, p_vols)]
            check(all(bool(torch.allclose(a, b, **CORR_TOL)) for a, b in zip(k_vols, p_vols)),
                  f"slice 13 {name}: K2 on the tip GRU's outputs vs the plain correlation, max abs errors {errs}")
            head_err = check_head_tol(f"slice 13 {name} heads, K2 vs the plain correlation", s13_outputs(m, k_vols),
                                      s13_outputs(m, p_vols))
        figures.update(k2_max_abs_err=max(errs), k2_shapes=[list(t.shape) for t in tips],
                       head_kernel_vs_plain=head_err)
        print(f"slice 13 {name}: K2 on the tip GRU's outputs {[tuple(t.shape) for t in tips]} within rtol=atol="
              f"{CORR_TOL['rtol']} of the plain correlation (max abs {max(errs):.3g}); the bf16 heads on them within "
              f"HEAD_TOL: {head_err}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms_greedy.launches = cost_volume.launches = 0
    ms = statistics.median(cuda_time_ms(lambda: det(x), iters=S13_TIMED, warmup=S13_WARM))
    peak = torch.cuda.max_memory_allocated()
    prof = s13_profile(f"slice 13 {name} B={S13_BATCH} windows", lambda: det(x), 1, card)
    n_req = S13_TIMED + S13_WARM + 2
    check((nms_greedy.launches, cost_volume.launches) == (n_req, k2_req * n_req),
          f"slice 13 {name}: launches (K1, K2) {(nms_greedy.launches, cost_volume.launches)} over {n_req} requests")
    k1, k2 = k1 + nms_greedy.launches, k2 + cost_volume.launches
    figures.update(ms=ms, windows_s=S13_BATCH / ms * 1e3, frames_s=S13_BATCH * WINDOW / ms * 1e3,
                   peak_gib=peak / 2**30, profile=prof, launches_a_request=dict(k1=1, k2=k2_req),
                   idle_share_events=max(0.0, 1 - prof["busy_ms"] / ms) if prof else None)
    print(f"slice 13 {name} B={S13_BATCH} windows of {WINDOW} at {SIZE} px bf16 ({S13_CLASSES} classes) on {card}: "
          f"{figures['windows_s']:.1f} windows/s, {figures['frames_s']:.1f} frames/s ({ms:.3f} ms a request, median "
          f"of {S13_TIMED} after {S13_WARM} warm), peak memory {peak / 2**30:.2f} GiB; K1 1 and K2 {k2_req} a request")
    if name in S13_STREAMS:
        stream_fig, sk1 = s13_stream(name, det, gen, dev, card, ms)
        figures["stream"] = stream_fig
        k1 += sk1
    del det, m, x
    torch.cuda.empty_cache()
    return figures, k1, k2


def s13_stream(name, det, gen, dev, card, windowed_ms):
    """(c): B=16 streams of `det`'s model: the split, K1 once a step, the
    raw outputs of the reset and S13_STREAM_STEPS steps within HEAD_TOL of
    the windowed forward on the same windows, frames/s over 10 steps after
    3 warm beside the windowed rate.  Returns (figures, K1 launches)."""
    stream = StreamingDetector(det.model)
    check(stream.split == S13_STREAMS[name], f"slice 13 stream {name}: the {stream.split} split")
    frames = stream_frames_on_card(gen, 1 + S13_STREAM_STEPS + S13_WARM + S13_TIMED, S13_BATCH, SIZE, dev)
    nms_greedy.launches = cost_volume.launches = 0
    errs = []
    for i in range(1 + S13_STREAM_STEPS):
        dets = stream.reset(frames[0]) if i == 0 else stream.step(frames[i])
        check_detections(f"slice 13 stream {name} step {i}", [tuple(dets[:2]) + (dets[2].clamp(0, SIZE),)],
                         [S13_BATCH], classes=S13_CLASSES)
        with torch.inference_mode():
            want = det.model(to_normalized(trail_window(frames, i, WINDOW), dtype=det.dtype))
            errs.append(check_head_tol(f"slice 13 stream {name} step {i}", stream.raw(), want))
    it = iter(frames[1 + S13_STREAM_STEPS:])
    ms = statistics.median(cuda_time_ms(lambda: stream.step(next(it)), iters=S13_TIMED, warmup=S13_WARM))
    steps = 1 + S13_STREAM_STEPS + S13_WARM + S13_TIMED
    check((nms_greedy.launches, cost_volume.launches) == (steps, 0),
          f"slice 13 stream {name}: launches (K1, K2) {(nms_greedy.launches, cost_volume.launches)} over {steps} steps")
    figures = dict(split=stream.split, step_ms=ms, frames_s=S13_BATCH / ms * 1e3,
                   windowed_frames_s=S13_BATCH / windowed_ms * 1e3, stream_over_windowed=windowed_ms / ms,
                   head_vs_windowed={n: [max(e[n][0] for e in errs), max(e[n][1] for e in errs)]
                                     for n in ("boxes", "scores")})
    print(f"slice 13 stream {name} ({stream.split} split) B={S13_BATCH} at {SIZE} px bf16 on {card}: "
          f"{figures['frames_s']:.1f} frames/s ({ms:.3f} ms a step, median of {S13_TIMED} after {S13_WARM} warm) "
          f"against the windowed Detector's {figures['windowed_frames_s']:.1f} frames detected/s: "
          f"{figures['stream_over_windowed']:.2f}x; reset + {S13_STREAM_STEPS} steps within HEAD_TOL of the windowed "
          f"forward: {figures['head_vs_windowed']}")
    del stream, frames
    return figures, nms_greedy.launches


def s13_f32(dev, card, gen):
    """(b) and (c)'s float32 streams at 128 px: each model's raw outputs on
    the card against the CPU's from the same seed (rtol=atol=1e-3), and the
    streamed models' B=2 streams against the windowed Detector on the card
    at every trail step (STREAM_TOL).  Returns (figures, K1 launches)."""
    s, out, k1 = S13_F32_SIZE, {}, 0
    for name in S13_MODELS:
        x = s13_windows(gen, 1, s, dev)
        det = S13Detector(name, torch.float32, s, "cuda", seed=1)
        cpu = copy.deepcopy(det.model).cpu()
        with torch.inference_mode():
            xn = det._normalized(x)
            raw = [[t.cpu() for t in det.model(xn)], list(cpu(xn.cpu()))]
        del cpu
        errs = {n_: float((a - r).abs().max()) for n_, a, r in zip(("boxes", "scores"), *raw)}
        check(all(bool(torch.allclose(a, r, rtol=1e-3, atol=1e-3)) for a, r in zip(*raw)),
              f"slice 13 {name} float32 at {s} px, card vs CPU: max abs errors {errs}")
        out[name] = dict(card_vs_cpu_max_abs=errs)
        print(f"slice 13 {name} float32 at {s} px, card vs CPU: max abs errors {errs} (allclose rtol=atol=1e-3)")
        if name in S13_STREAMS:
            stream = StreamingDetector(det.model)
            frames = stream_frames_on_card(gen, WINDOW + 1, STREAM_SMALL_BATCH, s, dev)
            nms_greedy.launches = 0
            for i in range(WINDOW + 1):
                dets = stream.reset(frames[0]) if i == 0 else stream.step(frames[i])
                want = [t.cpu().numpy() for t in det(trail_window(frames, i, WINDOW))]
                got = [t.cpu().numpy() for t in (dets[0], dets[1], dets[2].clamp(0, s))]
                for j in range(STREAM_SMALL_BATCH):
                    check(match_rows([g[j] for g in got], [w[j] for w in want]),
                          f"slice 13 stream {name} float32 step {i} stream {j}: not within {STREAM_TOL} of the "
                          "windowed Detector")
            k1 += nms_greedy.launches
            out[name]["stream_trail_steps"] = WINDOW + 1
            print(f"slice 13 stream {name} float32 at {s} px, B={STREAM_SMALL_BATCH} streams: every trail step within "
                  f"rtol=atol={STREAM_TOL['rtol']} of the windowed Detector")
            del stream
        del det
        torch.cuda.empty_cache()
    return out, k1


def s13_train(name, dev, card):
    """(d): one float32 step on B=2 windows at 128 px (phase 12's) card vs
    CPU (TRAIN_TOL), then
    the B=8-window 416-px bf16 step timed as phase 12's (median of 10 after
    3 warm), its peak memory, K2 and its adjoint counted, one profiled step.
    Returns (figures, (K2, K2') launches)."""
    k2_step, bwd_step = (CORR_LAUNCHES, CORR_BWD_LAUNCHES) if S13_MODELS[name][1] else (0, 0)
    figures = {"card_vs_cpu": check_train_card_vs_cpu(
        f"slice 13 {name}", s13_model(name, dtype=None),
        lambda device: window_batch(np.random.RandomState(1), S13_F32_WINDOWS, S13_F32_SIZE, device),
        S13_CLASSES, f"{S13_F32_SIZE} px, B={S13_F32_WINDOWS} windows")}
    torch.cuda.empty_cache()
    model = s13_model(name).to(dev, memory_format=torch.channels_last)
    state = create_train_state(model, lr_schedule("step", 1e-3, steps_per_epoch=100, epochs=10))
    step = make_train_step(model, num_classes=S13_CLASSES)
    batch = window_batch(np.random.RandomState(0), S13_TRAIN_WINDOWS, SIZE, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cost_volume.launches = cost_volume_backward.launches = 0
    ms = statistics.median(cuda_time_ms(lambda: step(state, batch), iters=S13_TIMED, warmup=S13_WARM))
    peak = torch.cuda.max_memory_allocated()
    losses = {k: float(v) for k, v in step(state, batch).items()}
    prof = s13_profile(f"slice 13 {name} train B={S13_TRAIN_WINDOWS} windows", lambda: step(state, batch), 1, card)
    torch.cuda.synchronize()
    n = S13_TIMED + S13_WARM + 3  # the profile's warm step and its profiled step
    launches = (cost_volume.launches, cost_volume_backward.launches)
    check(launches == (k2_step * n, bwd_step * n),
          f"slice 13 {name} train step: K2 (forward, adjoint) launches {launches} over {n} steps")
    check(all(np.isfinite(v) for v in losses.values()), f"slice 13 {name} train step losses not finite: {losses}")
    figures.update(ms=ms, windows_s=S13_TRAIN_WINDOWS / ms * 1e3, frames_s=S13_TRAIN_WINDOWS * WINDOW / ms * 1e3,
                   peak_gib=peak / 2**30, profile=prof,
                   idle_share_events=max(0.0, 1 - prof["busy_ms"] / ms) if prof else None, launches_a_step=dict(k2=k2_step, k2_adjoint=bwd_step),
                   losses=losses)
    print(f"slice 13 {name} train step B={S13_TRAIN_WINDOWS} windows of {WINDOW} at {SIZE} px bf16 on {card}: "
          f"{figures['windows_s']:.1f} windows/s, {figures['frames_s']:.1f} frames/s ({ms:.3f} ms a step, median of "
          f"{S13_TIMED} after {S13_WARM} warm), peak memory {peak / 2**30:.2f} GiB, K2 {k2_step} + K2' {bwd_step} a "
          f"step; losses {losses}")
    del model, state, batch
    torch.cuda.empty_cache()
    return figures, launches


def s13_twins(dev, card):
    """(e): the train twin a few steps on phase 12's VID tree (its first two
    val snippets) with the tip GRU (S13_TWIN_FLAGS, B=8, 416 px, bf16),
    then the detect twin on its checkpoint: the checkpoint's raw outputs and
    the first batch's detections equal the trained model's bit for bit.
    Returns (figures, K1 launches, K2 launches)."""
    workers = os.cpu_count() or 1
    figures, k1, k2 = {}, 0, 0
    with logged_speed() as speed, tempfile.TemporaryDirectory() as tmp:
        write_vid_tree(tmp, (("train", VID_TRAIN_SNIPPETS, 4000), ("val", S13_TWIN_VAL_SNIPPETS, 3000)))
        vid = f"{tmp}/ImageNetVID/ILSVRC"
        val = ImageNetVidDetection(root=vid, splits=[(2017, "val")], every=S13_TWIN_EVERY, window=(WINDOW, 1),
                                   inference=True)
        train = ImageNetVidDetection(root=vid, splits=[(2017, "train")], every=S13_TWIN_EVERY, window=(WINDOW, 1))
        flags = ["--dataset", "vid", "--dataset_root", tmp, "--data_shape", str(SIZE), "--dtype", "bf16",
                 "--num_workers", str(workers), "--batch_size", str(S13_TRAIN_WINDOWS)] + S13_TWIN_FLAGS
        exp = f"{tmp}/exp"
        nms_greedy.launches = cost_volume.launches = cost_volume_backward.launches = 0
        model, stats = train_yolov3.main(flags + ["--no_random_shape", "--epochs", "1", "--nopretrained_cnn",
                                                  "--save_prefix", "0000", "--experiment_root", exp,
                                                  "--save_interval", "1", "--log_interval", "1"])
        torch.cuda.synchronize()
        n_steps, n_val = len(train) // S13_TRAIN_WINDOWS, -(-len(val) // S13_TRAIN_WINDOWS)
        check(type(model) is YOLOv3T and model.rnn_pos == "late" and model.late_join and not model.late_corr,
              "slice 13 train twin: not the tip GRU with the late max join")
        check((nms_greedy.launches, cost_volume.launches, cost_volume_backward.launches) == (n_val, 0, 0),
              f"slice 13 train twin launches (K1, K2, K2') "
              f"{(nms_greedy.launches, cost_volume.launches, cost_volume_backward.launches)}")
        k1 += nms_greedy.launches
        ep = stats["epochs"][0]
        figures["train_twin"] = {"steps": len(ep["steps"]), "samples_s": ep["samples_s"], "val": stats["val"],
                                 "logged": list(speed)}
        print(f"slice 13 train twin ({' '.join(S13_TWIN_FLAGS)}, bf16, B={S13_TRAIN_WINDOWS}, {SIZE} px, "
              f"{n_steps} steps, {len(val)} val windows) on {card}: {ep['samples_s']:.1f} windows/s over the epoch; "
              f"K1 {n_val}; the factory's late max join pre-empts the late correlation, so K2 0")
        ckpt = f"{exp}/0000/yolo3_darknet53_vid_0000.params"
        check(os.path.exists(ckpt), f"the slice 13 train twin wrote no checkpoint {ckpt}")

        nms_greedy.launches = cost_volume.launches = 0
        t0 = time.perf_counter()
        preds = detect.main(flags + ["--model_path", ckpt, "--save_dir", f"{tmp}/res", "--save_prefix", "rnn",
                                     "--metrics", "voc"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_batches = -(-len(val) // S13_TRAIN_WINDOWS)
        check((nms_greedy.launches, cost_volume.launches) == (n_batches, 0),
              f"slice 13 detect twin launches (K1, K2) {(nms_greedy.launches, cost_volume.launches)}")
        k1 += nms_greedy.launches
        args = detect.parse_args(flags)
        cfg = detect.dataset_config(args, S13_CLASSES)
        twin_det = Detector(cfg, detect.load_model_variables(ckpt, cfg), dtype=torch.bfloat16, data_shape=SIZE)
        tf = YOLO3VideoInferenceTransform(SIZE, SIZE)
        idxs = range(min(S13_TRAIN_WINDOWS, len(val)))
        images = torch.from_numpy(np.stack([
            tf(np.stack([native.decode(p) for p in val.window_paths(i)]), val.label_and_size(i)[0])[0] for i in idxs
        ])).to(dev)
        model.eval()
        with torch.inference_mode():
            raw_twin, raw_trained = twin_det.model(twin_det._normalized(images)), model(images)
        check(all(torch.equal(a, b) for a, b in zip(raw_twin, raw_trained)),
              "slice 13: the raw outputs of the checkpoint's model differ from the trained model's")
        nms_greedy.launches = 0
        ids, sc, bb = (a.cpu().numpy() for a in make_eval_step(model)(images))
        k1 += nms_greedy.launches
        ref = {}
        for n, i in enumerate(idxs):
            collect_boxes(ref, val.sample_path(i), ids[n], sc[n], np.clip(bb[n], 0, SIZE), SIZE)
        check(all(preds.get(val.sample_path(i), []) == ref.get(val.sample_path(i), []) for i in idxs),
              "slice 13: the detect twin's detections from the checkpoint differ from the trained model's")
        figures["detect_twin"] = {"windows": len(val), "seconds": secs, "detections": sum(map(len, preds.values())),
                                  "voc": open(f"{tmp}/res/rnn/voc.txt").read().splitlines()[-1]}
        print(f"slice 13 detect twin from the checkpoint (B={S13_TRAIN_WINDOWS}, {len(val)} windows, {secs:.2f} s, "
              f"model load included) on {card}: raw outputs and the first batch's "
              f"{sum(map(len, ref.values()))} detections equal the trained model's bit for bit")
        del model, twin_det
        torch.cuda.empty_cache()
    return figures, k1, k2


def data_slice13(dev, card):
    """Phase 17.  Returns (the phase's figures, K1's launches, K2's
    (forward, adjoint) launches on its paths)."""
    figures, k1, k2, seconds = {}, {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(17)
    t0 = time.perf_counter()
    for name in S13_MODELS:
        figures[name], k1[name], fwd = s13_serve(name, dev, card, gen)
        k2[name] = (fwd, 0)
    seconds["a_c"] = time.perf_counter() - t0
    figures["f32"], k1["f32_streams"] = s13_f32(dev, card, gen)
    seconds["b_c_f32"] = time.perf_counter() - t0
    for name in S13_TRAIN:
        figures[name]["train_step"], k2[f"train_{name}"] = s13_train(name, dev, card)
    seconds["d"] = time.perf_counter() - t0
    figures["twins"], k1["twins"], _ = s13_twins(dev, card)
    seconds["e"] = time.perf_counter() - t0
    figures["seconds_from_start"] = seconds
    print(f"slice 13 parts' ends, seconds from the phase's start: {seconds}")
    k1["total"] = sum(k1.values())
    k2["total"] = [sum(v[0] for v in k2.values()), sum(v[1] for v in k2.values())]
    figures["k1"], figures["k2"] = k1, k2
    print(f"slice 13 launches: K1 {k1}, K2 (forward, adjoint) {k2}")
    return figures, k1["total"], k2["total"]


# phase 18: slice 14, the 3D / 2+1D and hierarchical DarkNet backbones
# (videoyolo_torch/models/darknet3d.py, h_darknet.py, inflate.py; the
# factory's new_model) through the factory, both twins and the train step
# ---------------------------------------------------------------------------

S14_CLASSES = 30  # ImageNet-VID's
S14_MODELS = {  # name: (the factory's new_model keywords, frames a window)
    "d3d_2_3_3": (dict(k=5, conv_types=(2, 3, 3, 2, 2, 2)), 5),
    "d3d_2_21_21_funnel": (dict(k=5, conv_types=(2, 21, 21, 2, 2, 2), funnel_time=True), 5),
    "hdk_3_3_max": (dict(k=9, hierarchical=(3, 3, 1, 1, 1), h_join_type="max"), 9),
    "hdk_3_3_conv": (dict(k=9, hierarchical=(3, 3, 1, 1, 1), h_join_type="conv"), 9),
}
S14_BATCH = 16
S14_WARM, S14_TIMED = 3, 10
S14_F32_SIZE = 128
S14_TRAIN = ("d3d_2_3_3", "hdk_3_3_max")  # (c); from its zero init the conv merge overflows (ROADMAP.md Queue 3)
S14_TRAIN_WINDOWS = 8
S14_F32_WINDOWS = 2
S14_TWIN_EVERY = 8  # (d): 24 train windows (3 steps at B=8), 8 val windows (one batch)
S14_TWINS = {  # (d): the flags as a user of the JAX CLI passes them; the Darknet3D twin inflates a written base
    "d3d": ["--window", "5,1", "--new_model", "--conv_types", "2,3,3,2,2,2"],
    "hdk": ["--window", "9,1", "--new_model", "--hier", "3,3,1,1,1", "--h_join_type", "max", "--nopretrained_cnn"],
}
S14_SCOPES = {"depthwise_temporal": [("Conv3d", "forward")]}  # the Conv3d calls with groups > 1


def s14_model(name, dtype=torch.bfloat16, seed=0):
    """The phase's model `name` from the factory and a seeded init; the
    conv merges' kernels are drawn too (N(0, 1/3)): from their zero init
    every feature after a merge is zero, as a trained model's is not."""
    model = build_model(YoloConfig(num_classes=S14_CLASSES, new_model=True, dtype=dtype, **S14_MODELS[name][0]))
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    with torch.no_grad():
        for n_, p in model.named_parameters():
            if ".conv1d_" in n_ and n_.endswith("Conv_0.weight"):
                p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
    return model


class S14Detector(Detector):
    """`Detector` (normalise, forward, top-k, K1, clip) over `s14_model`."""

    def __init__(self, name, dtype, size, device, seed=0):
        self.name = name
        kw, _ = S14_MODELS[name]
        super().__init__(YoloConfig(num_classes=S14_CLASSES, new_model=True, **kw), dtype=dtype, data_shape=size,
                         device=device, seed=seed)

    def _float_model(self, cfg, variables, seed):
        return s14_model(self.name, cfg.dtype, seed)


def s14_windows(gen, name, b, size, dev):
    return torch.randint(0, 256, (b, S14_MODELS[name][1], size, size, 3), generator=gen, dtype=torch.uint8,
                         device=dev)


def s14_serve(name, dev, card, gen):
    """(a): B=16 windows at 416 px bf16 through the Detector: K1 once a
    request and bit-equal to the plain NMS on the model's candidates, ms and
    windows/s (median of 10 after 3 warm, CUDA events), peak memory, one
    profiled request with the depthwise temporal convs' device time.
    Returns (figures, K1 launches)."""
    t0 = time.perf_counter()
    det = S14Detector(name, torch.bfloat16, SIZE, "cuda")
    t = S14_MODELS[name][1]
    figures = dict(config=S14_MODELS[name][0], windows=S14_BATCH, frames=t, build_s=time.perf_counter() - t0)
    x = s14_windows(gen, name, S14_BATCH, SIZE, dev)
    nms_greedy.launches = 0
    outs = det(x)
    torch.cuda.synchronize()
    k1 = nms_greedy.launches
    check(k1 == 1, f"slice 14 {name}: K1 launches a request {k1}, expected 1")
    check_detections(f"slice 14 {name}", [outs], [S14_BATCH], classes=S14_CLASSES)
    with torch.inference_mode():
        boxes, scores = det.model(det._normalized(x))
        cands = select_topk_candidates(boxes, scores, topk=NMS_TOPK)
        got = nms_greedy(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
        want = nms_greedy_plain(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
    # (the comparison with the plain version is not counted)
    check(all(torch.equal(a, b) for a, b in zip(got, want)), f"slice 14 {name}: K1 on its candidates differs from the "
          "plain NMS")
    figures["k1_equal_plain"] = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms_greedy.launches = 0
    ms = statistics.median(cuda_time_ms(lambda: det(x), iters=S14_TIMED, warmup=S14_WARM))
    peak = torch.cuda.max_memory_allocated()
    prof = scoped_profile(f"slice 14 {name} B={S14_BATCH} windows", lambda: det(x), 1, card, S14_SCOPES,
                          when=lambda conv: conv.groups > 1)
    n_req = S14_TIMED + S14_WARM + 2
    check(nms_greedy.launches == n_req, f"slice 14 {name}: K1 launches {nms_greedy.launches} over {n_req} requests")
    k1 += nms_greedy.launches
    figures.update(ms=ms, windows_s=S14_BATCH / ms * 1e3, frames_s=S14_BATCH * t / ms * 1e3, peak_gib=peak / 2**30,
                   profile=prof, idle_share_events=max(0.0, 1 - prof["busy_ms"] / ms) if prof else None)
    print(f"slice 14 {name} B={S14_BATCH} windows of {t} at {SIZE} px bf16 ({S14_CLASSES} classes) on {card}: "
          f"{figures['windows_s']:.1f} windows/s, {figures['frames_s']:.1f} frames/s ({ms:.3f} ms a request, median "
          f"of {S14_TIMED} after {S14_WARM} warm), peak memory {peak / 2**30:.2f} GiB; K1 1 a request, bit-equal to "
          f"the plain NMS")
    del det, x
    torch.cuda.empty_cache()
    return figures, k1


def s14_f32(dev, card, gen):
    """(b): each model in float32 at 128 px on one window, its raw outputs
    on the card against the CPU's from the same seed (rtol=atol=1e-3)."""
    s, out = S14_F32_SIZE, {}
    for name in S14_MODELS:
        x = s14_windows(gen, name, 1, s, dev)
        det = S14Detector(name, torch.float32, s, "cuda", seed=1)
        cpu = copy.deepcopy(det.model).cpu()
        with torch.inference_mode():
            xn = det._normalized(x)
            raw = [[t.cpu() for t in det.model(xn)], list(cpu(xn.cpu()))]
        errs = {n_: float((a - r).abs().max()) for n_, a, r in zip(("boxes", "scores"), *raw)}
        check(all(bool(torch.allclose(a, r, rtol=1e-3, atol=1e-3)) for a, r in zip(*raw)),
              f"slice 14 {name} float32 at {s} px, card vs CPU: max abs errors {errs}")
        out[name] = dict(card_vs_cpu_max_abs=errs)
        print(f"slice 14 {name} float32 at {s} px, card vs CPU: max abs errors {errs} (allclose rtol=atol=1e-3)")
        del det, cpu
        torch.cuda.empty_cache()
    return out


def s14_train(name, dev, card):
    """(c): one float32 step on B=2 windows at 128 px card vs CPU
    (TRAIN_TOL), then the B=8-window 416-px bf16 step (median of 10 after 3
    warm), its peak memory and one profiled step with the depthwise
    temporal convs' device time."""
    t = S14_MODELS[name][1]
    figures = {"card_vs_cpu": check_train_card_vs_cpu(
        f"slice 14 {name}", s14_model(name, dtype=None),
        lambda device: window_batch(np.random.RandomState(1), S14_F32_WINDOWS, S14_F32_SIZE, device, k=t),
        S14_CLASSES, f"{S14_F32_SIZE} px, B={S14_F32_WINDOWS} windows of {t}")}
    torch.cuda.empty_cache()
    model = s14_model(name).to(dev, memory_format=torch.channels_last)
    state = create_train_state(model, lr_schedule("step", 1e-3, steps_per_epoch=100, epochs=10))
    step = make_train_step(model, num_classes=S14_CLASSES)
    batch = window_batch(np.random.RandomState(0), S14_TRAIN_WINDOWS, SIZE, dev, k=t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = statistics.median(cuda_time_ms(lambda: step(state, batch), iters=S14_TIMED, warmup=S14_WARM))
    peak = torch.cuda.max_memory_allocated()
    losses = {k: float(v) for k, v in step(state, batch).items()}
    prof = scoped_profile(f"slice 14 {name} train B={S14_TRAIN_WINDOWS} windows", lambda: step(state, batch), 1,
                          card, S14_SCOPES, when=lambda conv: conv.groups > 1)
    check(all(np.isfinite(v) for v in losses.values()), f"slice 14 {name} train step losses not finite: {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
          f"slice 14 {name}: parameters not finite after {S14_TIMED + S14_WARM + 3} steps")
    figures.update(ms=ms, windows_s=S14_TRAIN_WINDOWS / ms * 1e3, frames_s=S14_TRAIN_WINDOWS * t / ms * 1e3,
                   peak_gib=peak / 2**30, profile=prof,
                   idle_share_events=max(0.0, 1 - prof["busy_ms"] / ms) if prof else None, losses=losses)
    print(f"slice 14 {name} train step B={S14_TRAIN_WINDOWS} windows of {t} at {SIZE} px bf16 on {card}: "
          f"{figures['windows_s']:.1f} windows/s, {figures['frames_s']:.1f} frames/s ({ms:.3f} ms a step, median of "
          f"{S14_TIMED} after {S14_WARM} warm), peak memory {peak / 2**30:.2f} GiB; losses {losses}")
    del model, state, batch
    torch.cuda.empty_cache()
    return figures


def s14_twins(dev, card):
    """(d): on a VID tree (phase 12's train snippets, two val snippets) the
    train twin three steps with each backbone (B=8, 416 px, bf16; the
    Darknet3D one with --pretrained_base_path, through the inflate branch),
    the detect twin on each checkpoint (its raw outputs and the first
    batch's detections bit-equal to the trained model's), and `--stream
    --new_model` refused.  Returns (figures, K1 launches)."""
    workers = os.cpu_count() or 1
    figures, k1 = {}, 0
    with logged_speed() as speed, tempfile.TemporaryDirectory() as tmp:
        write_vid_tree(tmp, (("train", VID_TRAIN_SNIPPETS, 4000), ("val", S13_TWIN_VAL_SNIPPETS, 3000)))
        base = f"{tmp}/darknet53.params"
        write_darknet53_params(base, seed=14)
        vid = f"{tmp}/ImageNetVID/ILSVRC"
        for twin, extra in S14_TWINS.items():
            if "--nopretrained_cnn" not in extra:
                extra = extra + ["--pretrained_base_path", base]
            window = (int(extra[1].split(",")[0]), 1)
            val = ImageNetVidDetection(root=vid, splits=[(2017, "val")], every=S14_TWIN_EVERY, window=window,
                                       inference=True)
            train = ImageNetVidDetection(root=vid, splits=[(2017, "train")], every=S14_TWIN_EVERY, window=window)
            flags = ["--dataset", "vid", "--dataset_root", tmp, "--data_shape", str(SIZE), "--dtype", "bf16",
                     "--num_workers", str(workers), "--batch_size", str(S14_TRAIN_WINDOWS), "--every",
                     str(S14_TWIN_EVERY)] + extra
            exp = f"{tmp}/exp_{twin}"
            nms_greedy.launches = 0
            speed.clear()
            t0 = time.perf_counter()
            model, stats = train_yolov3.main(flags + ["--no_random_shape", "--epochs", "1", "--save_prefix", "0000",
                                                      "--experiment_root", exp, "--save_interval", "1",
                                                      "--log_interval", "1"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n_steps, n_val = len(train) // S14_TRAIN_WINDOWS, -(-len(val) // S14_TRAIN_WINDOWS)
            check(type(model) is YOLOv3T and model.has_backbone, f"slice 14 {twin} train twin: not the new_model")
            check(nms_greedy.launches == n_val, f"slice 14 {twin} train twin: K1 launches {nms_greedy.launches}, "
                  f"expected {n_val}")
            check(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
                  f"slice 14 {twin} train twin: parameters not finite")
            k1 += nms_greedy.launches
            ep = stats["epochs"][0]
            fig = {"flags": extra, "steps": len(ep["steps"]), "samples_s": ep["samples_s"], "seconds": secs,
                   "val": stats["val"], "logged": list(speed)}
            print(f"slice 14 train twin ({' '.join(extra)}, bf16, B={S14_TRAIN_WINDOWS}, {SIZE} px, {n_steps} steps, "
                  f"{len(val)} val windows) on {card}: {ep['samples_s']:.1f} windows/s over the epoch, {secs:.2f} s "
                  f"with the model's build; K1 {n_val}")
            ckpt = f"{exp}/0000/yolo3_darknet53_vid_0000.params"
            check(os.path.exists(ckpt), f"the slice 14 {twin} train twin wrote no checkpoint {ckpt}")

            nms_greedy.launches = 0
            t0 = time.perf_counter()
            dflags = [f for f in flags if f not in ("--nopretrained_cnn",)]
            if "--pretrained_base_path" in dflags:
                i = dflags.index("--pretrained_base_path")
                dflags = dflags[:i] + dflags[i + 2:]
            preds = detect.main(dflags + ["--model_path", ckpt, "--save_dir", f"{tmp}/res", "--save_prefix", twin,
                                          "--metrics", "voc"])
            torch.cuda.synchronize()
            dsecs = time.perf_counter() - t0
            check(nms_greedy.launches == n_val, f"slice 14 {twin} detect twin: K1 launches {nms_greedy.launches}")
            k1 += nms_greedy.launches
            args = detect.parse_args(dflags)
            cfg = detect.dataset_config(args, S14_CLASSES)
            twin_det = Detector(cfg, detect.load_model_variables(ckpt, cfg), dtype=torch.bfloat16, data_shape=SIZE)
            tf = YOLO3VideoInferenceTransform(SIZE, SIZE)
            idxs = range(min(S14_TRAIN_WINDOWS, len(val)))
            images = torch.from_numpy(np.stack([
                tf(np.stack([native.decode(p) for p in val.window_paths(i)]), val.label_and_size(i)[0])[0]
                for i in idxs])).to(dev)
            model.eval()
            with torch.inference_mode():
                raw_twin, raw_trained = twin_det.model(twin_det._normalized(images)), model(images)
            check(all(torch.equal(a, b) for a, b in zip(raw_twin, raw_trained)),
                  f"slice 14 {twin}: the raw outputs of the checkpoint's model differ from the trained model's")
            nms_greedy.launches = 0
            ids, sc, bb = (a.cpu().numpy() for a in make_eval_step(model)(images))
            k1 += nms_greedy.launches
            ref = {}
            for n, i in enumerate(idxs):
                collect_boxes(ref, val.sample_path(i), ids[n], sc[n], np.clip(bb[n], 0, SIZE), SIZE)
            check(all(preds.get(val.sample_path(i), []) == ref.get(val.sample_path(i), []) for i in idxs),
                  f"slice 14 {twin}: the detect twin's detections from the checkpoint differ from the trained model's")
            try:
                detect.main(dflags + ["--stream", "--save_dir", f"{tmp}/res", "--save_prefix", f"{twin}_stream"])
                refused = False
            except ValueError as e:
                refused = "built-in per-frame backbone" in str(e)
            check(refused, f"slice 14 {twin}: the detect twin's --stream --new_model was not refused")
            fig["detect_twin"] = {"windows": len(val), "seconds": dsecs,
                                  "detections": sum(map(len, preds.values())),
                                  "voc": open(f"{tmp}/res/{twin}/voc.txt").read().splitlines()[-1]}
            figures[twin] = fig
            print(f"slice 14 detect twin from the {twin} checkpoint (B={S14_TRAIN_WINDOWS}, {len(val)} windows, "
                  f"{dsecs:.2f} s, model load included) on {card}: raw outputs and the first batch's "
                  f"{sum(map(len, ref.values()))} detections equal the trained model's bit for bit; --stream refused")
            del model, twin_det, images
            torch.cuda.empty_cache()
    return figures, k1


def data_slice14(dev, card):
    """Phase 18.  Returns (the phase's figures, K1's launches on its
    paths)."""
    figures, k1, seconds = {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(18)
    t0 = time.perf_counter()
    for name in S14_MODELS:
        figures[name], k1[name] = s14_serve(name, dev, card, gen)
    seconds["a"] = time.perf_counter() - t0
    figures["f32"] = s14_f32(dev, card, gen)
    seconds["b"] = time.perf_counter() - t0
    for name in S14_TRAIN:
        figures[name]["train_step"] = s14_train(name, dev, card)
    seconds["c"] = time.perf_counter() - t0
    figures["twins"], k1["twins"] = s14_twins(dev, card)
    seconds["d"] = time.perf_counter() - t0
    figures["seconds_from_start"] = seconds
    print(f"slice 14 parts' ends, seconds from the phase's start: {seconds}")
    k1["total"] = sum(k1.values())
    figures["k1"] = k1
    print(f"slice 14 launches: K1 {k1}")
    return figures, k1["total"]


# ---------------------------------------------------------------------------
# phase 19: slice 15, the two-stream FlowNet family (videoyolo_torch/models/
# flownet.py, ts_darknet.py, flownet_utils.py; the factory's motion_stream)
# through the factory and both twins, and FlowNetC's cost volume (K2 at d=20,
# stride2=2 on its stride-8 level)
# ---------------------------------------------------------------------------

S15_CLASSES = 30  # the JAX package's profile of the model (tools/prof_temporal.py:123-131), as its size and batch
S15_SIZE = 384  # a multiple of 64, as FlowNetS needs
S15_MODELS = {"ungated": None, "add": "add", "mul": "mul"}  # name: the factory's add_type
S15_BATCH = 16
S15_WARM, S15_TIMED = 3, 10
S15_F32_SIZE = 128
S15_TRAIN_WINDOWS = 8
S15_F32_WINDOWS = 2
S15_K2 = (S15_BATCH, S15_SIZE // 8, S15_SIZE // 8, 256)  # FlowNetC's stride-8 level of a B=16 batch of pairs
S15_FLOW_FRAMES = 3  # (c): frames of a translating scene, 400 x 400 (cropped to 384 x 384)
S15_FLOW_TOL = dict(rtol=1e-3, atol=1e-3)
S15_TWIN_EVERY = 8  # (e): 24 train windows (3 steps at B=8), 8 val windows (one batch)
S15_TWIN = ["--window", f"{WINDOW},1", "--motion_stream", "flownet", "--stream_gating", "add", "--no_random_shape",
            "--nopretrained_cnn"]  # (e): the train twin's flags; the detect twin's without the last two
S15_SCOPES = {"flownet": [(TwoStreamDarknet, "motion")], "darknet": [(TwoStreamDarknet, "appearance")]}


def s15_cfg(name, dtype=None):
    return YoloConfig(num_classes=S15_CLASSES, k=WINDOW, motion_stream="flownet", add_type=S15_MODELS[name],
                      dtype=dtype)


def s15_windows(gen, b, size, dev):
    return torch.randint(0, 256, (b, WINDOW, size, size, 3), generator=gen, dtype=torch.uint8, device=dev)


def s15_serve(name, dev, card, gen):
    """(a): B=16 windows of 3 at 384 px bf16 through the Detector: K1 once a
    request and bit-equal to the plain NMS on the model's candidates, no K2
    (the two-stream model's FlowNetS has no cost volume), ms and windows/s
    (median of 10 after 3 warm, CUDA events), peak memory, one profiled
    request with the FlowNet stream's and Darknet-53's device time apart and
    the profile's device time over the request's CUDA-event time.  Returns
    (figures, K1 launches)."""
    t0 = time.perf_counter()
    det = Detector(s15_cfg(name), dtype=torch.bfloat16, data_shape=S15_SIZE, device="cuda")
    figures = dict(add_type=S15_MODELS[name], windows=S15_BATCH, build_s=time.perf_counter() - t0)
    x = s15_windows(gen, S15_BATCH, S15_SIZE, dev)
    nms_greedy.launches = cost_volume.launches = 0
    outs = det(x)
    torch.cuda.synchronize()
    k1 = nms_greedy.launches
    check(k1 == 1 and cost_volume.launches == 0,
          f"slice 15 {name}: K1 {k1} and K2 {cost_volume.launches} launches a request, expected 1 and 0")
    check_detections(f"slice 15 {name}", [outs], [S15_BATCH], classes=S15_CLASSES)
    with torch.inference_mode():
        boxes, scores = det.model(det._normalized(x))
        cands = select_topk_candidates(boxes, scores, topk=NMS_TOPK)
        got = nms_greedy(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
        want = nms_greedy_plain(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
    # (the comparison with the plain version is not counted)
    check(all(torch.equal(a, b) for a, b in zip(got, want)), f"slice 15 {name}: K1 on its candidates differs from the "
          "plain NMS")
    figures["k1_equal_plain"] = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms_greedy.launches = 0
    ms = statistics.median(cuda_time_ms(lambda: det(x), iters=S15_TIMED, warmup=S15_WARM))
    peak = torch.cuda.max_memory_allocated()
    prof = scoped_profile(f"slice 15 {name} B={S15_BATCH} windows", lambda: det(x), 1, card, S15_SCOPES)
    n_req = S15_TIMED + S15_WARM + 2
    check(nms_greedy.launches == n_req, f"slice 15 {name}: K1 launches {nms_greedy.launches} over {n_req} requests")
    k1 += nms_greedy.launches
    coverage = prof["busy_ms"] / ms if prof else None
    figures.update(ms=ms, windows_s=S15_BATCH / ms * 1e3, frames_s=S15_BATCH * WINDOW / ms * 1e3,
                   peak_gib=peak / 2**30, profile=prof, profile_coverage=coverage,
                   idle_share_events=max(0.0, 1 - coverage) if prof else None)
    print(f"slice 15 {name} B={S15_BATCH} windows of {WINDOW} at {S15_SIZE} px bf16 ({S15_CLASSES} classes) on {card}: "
          f"{figures['windows_s']:.1f} windows/s ({ms:.3f} ms a request, median of {S15_TIMED} after {S15_WARM} warm), "
          f"peak memory {peak / 2**30:.2f} GiB; the profile's device time {coverage} of the request's CUDA-event time; "
          "K1 1 a request, bit-equal to the plain NMS; K2 0")
    del det, x
    torch.cuda.empty_cache()
    return figures, k1


def s15_f32(dev, card, gen):
    """(b): each model in float32 at 128 px on one window, its raw outputs
    on the card against the CPU's from the same seed (rtol=atol=1e-3)."""
    s, out = S15_F32_SIZE, {}
    for name in S15_MODELS:
        x = s15_windows(gen, 1, s, dev)
        det = Detector(s15_cfg(name), dtype=torch.float32, data_shape=s, device="cuda", seed=1)
        cpu = copy.deepcopy(det.model).cpu()
        with torch.inference_mode():
            xn = det._normalized(x)
            raw = [[t.cpu() for t in det.model(xn)], list(cpu(xn.cpu()))]
        errs = {n_: float((a - r).abs().max()) for n_, a, r in zip(("boxes", "scores"), *raw)}
        check(all(bool(torch.allclose(a, r, rtol=1e-3, atol=1e-3)) for a, r in zip(*raw)),
              f"slice 15 {name} float32 at {s} px, card vs CPU: max abs errors {errs}")
        out[name] = dict(card_vs_cpu_max_abs=errs)
        print(f"slice 15 {name} float32 at {s} px, card vs CPU: max abs errors {errs} (allclose rtol=atol=1e-3)")
        del det, cpu
        torch.cuda.empty_cache()
    return out


def s15_k2_level(f1, f2, card):
    """K2 at FlowNetC's d=20, stride2=2 on (f1, f2): within CORR_TOL of the
    plain version; its ms (median of 50 launches, CUDA events), the plain
    version's (median of 3), the bound and the plan."""
    b, h, w, c = f1.shape
    d, s2 = CORR_D, CORR_STRIDE2
    out, ref = cost_volume(f1, f2, d, s2), correlation_plain(f1, f2, d, 1, 1, s2)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(out.shape == ref.shape == (b, h, w, num_corr_channels(d, s2)), f"K2 at FlowNetC's level: {tuple(out.shape)}")
    check(bool(torch.allclose(out, ref, **CORR_TOL)), f"K2 at FlowNetC's level B={b}: max abs error {err}")
    del out, ref
    k_ms = median_ms(lambda: cost_volume(f1, f2, d, s2), 50)
    p_ms = median_ms(lambda: correlation_plain(f1, f2, d, 1, 1, s2), 3, warmup=1)
    t_bytes, t_ops = corr_times(b, h, w, c, d, s2)
    b_ms, b_by = bound([(t_bytes, t_ops)])
    pl = correlation_kernel.plan(b, h, w, c, d, s2, correlation_kernel.aligned(f1, f2))
    fig = dict(shape=[b, h, w, c], d=d, stride2=s2, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
               bytes_ms=t_bytes, ops_ms=t_ops, max_abs_err=err,
               plan=dict(r=pl.r, gx=pl.gx, gy=pl.gy, tile=list(pl.tile), threads=pl.threads, copy=pl.copy,
                         ctas=pl.ctas, live=pl.live))
    print(f"cost volume at FlowNetC's level B={b} {h}x{w}x{c} d={d} stride2={s2} on {card}: kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: bytes {t_bytes:.4f}, operations {t_ops:.4f}); max abs "
          f"error {err:.3g}, allclose; plan R={pl.r}, group {pl.gy}x{pl.gx}, {pl.threads} threads, {pl.ctas} CTAs")
    return fig


def s15_flow_frames(root):
    """S15_FLOW_FRAMES JPEG frames of one scene translating by (3, 2)
    pixels a frame, written under `root`; their paths."""
    scene, _ = synth_image(15, 448, 448, 1)
    paths = []
    for t in range(S15_FLOW_FRAMES):
        path = os.path.join(root, f"{t:06d}.jpg")
        with open(path, "wb") as fh:
            fh.write(encode_jpeg(np.ascontiguousarray(scene[2 * t:2 * t + 400, 3 * t:3 * t + 400])))
        paths.append(path)
    return paths


def s15_flownetc(dev, card):
    """(c): K2 at FlowNetC's level of a 384-px B=16 batch and of one pair
    (B=1), against its plain version (rtol=atol=1e-5), its ms, bound and
    plain ms; FlowNetC's launches a call; `process_imagedir` over frames
    the script writes (FlowNetC, float32, on the card: one `.flo` and one
    K2 launch a pair) and each pair's flow from FlowNetC and FlowNetS on
    the card against the CPU (1e-3); `process_two_images` timed at B=1.
    Returns (figures, K2 launches on the path)."""
    figures = {}
    gen = torch.Generator(device=dev).manual_seed(19)
    b, h, w, c = S15_K2
    pair = torch.randn(b, 2, h, w, c, generator=gen, device=dev)
    figures["k2"] = s15_k2_level(pair[:, 0], pair[:, 1], card)
    figures["k2_b1"] = s15_k2_level(pair[:1, 0], pair[:1, 1], card)
    del pair
    torch.cuda.empty_cache()
    gen_cpu = torch.Generator().manual_seed(19)
    nets = {}
    for name, cls in (("flownetc", FlowNetC), ("flownets", FlowNetS)):
        cpu = init_weights(cls(), gen_cpu).eval()
        nets[name] = (copy.deepcopy(cpu).to(dev, memory_format=torch.channels_last), cpu)
    k2 = 0
    with tempfile.TemporaryDirectory() as tmp:
        paths = s15_flow_frames(tmp)
        frames = [read_image(p) for p in paths]
        cost_volume.launches = 0
        flows = flownet_utils.process_imagedir(nets["flownetc"][0], tmp, device="cuda")
        torch.cuda.synchronize()
        k2 += cost_volume.launches
        check(cost_volume.launches == len(paths) - 1 and len(flows) == len(paths) - 1,
              f"slice 15 FlowNetC process_imagedir: {cost_volume.launches} K2 launches, {len(flows)} flows for "
              f"{len(paths) - 1} pairs")
        written = sorted(f for f in os.listdir(os.path.join(tmp, "flow")) if f.endswith(".flo"))
        check(written == [f"{t:06d}.flo" for t in range(len(paths) - 1)], f"slice 15 process_imagedir wrote {written}")
        check(all(np.array_equal(flownet_utils.read_flo(os.path.join(tmp, "flow", n_)), f)
                  for n_, f in zip(written, flows)), "slice 15: a .flo differs from its flow")
        errs = {}
        for name, (card_net, cpu_net) in nets.items():
            cost_volume.launches = 0
            got = [flownet_utils.process_two_images(card_net, a, b_, device="cuda") for a, b_ in zip(frames, frames[1:])]
            k2 += cost_volume.launches
            check(cost_volume.launches == (len(frames) - 1 if name == "flownetc" else 0),
                  f"slice 15 {name}: K2 launches {cost_volume.launches} over {len(frames) - 1} pairs")
            ref = [flownet_utils.process_two_images(cpu_net, a, b_, device="cpu") for a, b_ in zip(frames, frames[1:])]
            errs[name] = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
            scale = max(float(np.abs(r).max()) for r in ref)
            check(all(np.allclose(g, r, **S15_FLOW_TOL) for g, r in zip(got, ref)),
                  f"slice 15 {name} float32 flows, card vs CPU: max abs error {errs[name]} (flows to {scale})")
            if name == "flownetc":
                check(all(np.allclose(f, r, **S15_FLOW_TOL) for f, r in zip(flows, ref)),
                      "slice 15: process_imagedir's flows on the card differ from the CPU's")
            print(f"slice 15 {name} float32 flow of {len(frames) - 1} pairs at {got[0].shape[0] * 4} x "
                  f"{got[0].shape[1] * 4} px, card vs CPU: max abs error {errs[name]:.3g} (flows to {scale:.3g}; "
                  f"allclose {S15_FLOW_TOL})")
        fc = nets["flownetc"][0]
        t0 = time.perf_counter()
        cost_volume.launches = 0
        times = []
        for i in range(3 + 10):
            t1 = time.perf_counter()
            flownet_utils.process_two_images(fc, frames[0], frames[1], device="cuda")
            times.append((time.perf_counter() - t1) * 1e3)
        k2 += cost_volume.launches
        check(cost_volume.launches == 13, f"slice 15 process_two_images: K2 launches {cost_volume.launches} in 13 calls")
    figures.update(flow_card_vs_cpu_max_abs=errs, process_two_images_ms=statistics.median(times[3:]),
                   process_imagedir_pairs=len(flows))
    print(f"slice 15 process_two_images (FlowNetC float32, one pair at 384 x 384, the host's crop and normalise, the "
          f"copies and the flow back) on {card}: {figures['process_two_images_ms']:.3f} ms a call (median of 10 after "
          f"3, host clock), K2 {figures['k2_b1']['ms']:.4f} ms of it; K2 one launch a FlowNetC call")
    del nets, fc
    torch.cuda.empty_cache()
    return figures, k2


def s15_train(dev, card):
    """(d): one float32 step of the "add" model on B=2 windows at 128 px
    card vs CPU (TRAIN_TOL), then its B=8-window 384-px bf16 step (median
    of 10 after 3 warm), peak memory and one profiled step."""
    figures = {"card_vs_cpu": check_train_card_vs_cpu(
        "slice 15 add", build_model(s15_cfg("add")),
        lambda device: window_batch(np.random.RandomState(1), S15_F32_WINDOWS, S15_F32_SIZE, device),
        S15_CLASSES, f"{S15_F32_SIZE} px, B={S15_F32_WINDOWS} windows of {WINDOW}")}
    torch.cuda.empty_cache()
    model = init_weights(build_model(s15_cfg("add", torch.bfloat16)), torch.Generator().manual_seed(0))
    model.to(dev, memory_format=torch.channels_last)
    state = create_train_state(model, lr_schedule("step", 1e-3, steps_per_epoch=100, epochs=10))
    step = make_train_step(model, num_classes=S15_CLASSES)
    batch = window_batch(np.random.RandomState(0), S15_TRAIN_WINDOWS, S15_SIZE, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = statistics.median(cuda_time_ms(lambda: step(state, batch), iters=S15_TIMED, warmup=S15_WARM))
    peak = torch.cuda.max_memory_allocated()
    losses = {k: float(v) for k, v in step(state, batch).items()}
    prof = scoped_profile(f"slice 15 add train B={S15_TRAIN_WINDOWS} windows", lambda: step(state, batch), 1, card,
                          S15_SCOPES)
    check(all(np.isfinite(v) for v in losses.values()), f"slice 15 add train step losses not finite: {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
          f"slice 15 add: parameters not finite after {S15_TIMED + S15_WARM + 3} steps")
    coverage = prof["busy_ms"] / ms if prof else None
    figures.update(ms=ms, windows_s=S15_TRAIN_WINDOWS / ms * 1e3, peak_gib=peak / 2**30, profile=prof,
                   profile_coverage=coverage, losses=losses)
    print(f"slice 15 add train step B={S15_TRAIN_WINDOWS} windows of {WINDOW} at {S15_SIZE} px bf16 on {card}: "
          f"{figures['windows_s']:.1f} windows/s ({ms:.3f} ms a step, median of {S15_TIMED} after {S15_WARM} warm), "
          f"peak memory {peak / 2**30:.2f} GiB; the profile's device time {coverage} of the step's; losses {losses}")
    del model, state, batch
    torch.cuda.empty_cache()
    return figures


def s15_twins(dev, card):
    """(e): on a VID tree (phase 12's train snippets, two val snippets) the
    train twin three steps with --motion_stream flownet --stream_gating add
    --window 3,1 at 384 px (B=8, bf16, --no_random_shape, --nopretrained_cnn),
    then the detect twin on its checkpoint: its raw outputs and the first
    batch's detections bit-equal to the trained model's.  Returns (figures,
    K1 launches)."""
    workers = os.cpu_count() or 1
    k1 = 0
    with logged_speed() as speed, tempfile.TemporaryDirectory() as tmp:
        write_vid_tree(tmp, (("train", VID_TRAIN_SNIPPETS, 4000), ("val", S13_TWIN_VAL_SNIPPETS, 3000)))
        vid = f"{tmp}/ImageNetVID/ILSVRC"
        window = (WINDOW, 1)
        val = ImageNetVidDetection(root=vid, splits=[(2017, "val")], every=S15_TWIN_EVERY, window=window,
                                   inference=True)
        train = ImageNetVidDetection(root=vid, splits=[(2017, "train")], every=S15_TWIN_EVERY, window=window)
        flags = ["--dataset", "vid", "--dataset_root", tmp, "--data_shape", str(S15_SIZE), "--dtype", "bf16",
                 "--num_workers", str(workers), "--batch_size", str(S15_TRAIN_WINDOWS), "--every", str(S15_TWIN_EVERY)]
        exp = f"{tmp}/exp"
        nms_greedy.launches = 0
        t0 = time.perf_counter()
        model, stats = train_yolov3.main(flags + S15_TWIN + ["--epochs", "1", "--save_prefix", "0000",
                                                             "--experiment_root", exp, "--save_interval", "1",
                                                             "--log_interval", "1"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_steps, n_val = len(train) // S15_TRAIN_WINDOWS, -(-len(val) // S15_TRAIN_WINDOWS)
        check(isinstance(getattr(model, "backbone", None), TwoStreamDarknet) and model.backbone.add_type == "add",
              "slice 15 train twin: not the gated two-stream model")
        check(nms_greedy.launches == n_val, f"slice 15 train twin: K1 launches {nms_greedy.launches}, expected {n_val}")
        check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "slice 15 train twin: parameters not finite")
        k1 += nms_greedy.launches
        ep = stats["epochs"][0]
        check(len(ep["steps"]) == n_steps, f"slice 15 train twin: {len(ep['steps'])} steps, expected {n_steps}")
        figures = {"flags": S15_TWIN, "steps": len(ep["steps"]), "samples_s": ep["samples_s"], "seconds": secs,
                   "val": stats["val"], "logged": list(speed)}
        print(f"slice 15 train twin ({' '.join(S15_TWIN)}, bf16, B={S15_TRAIN_WINDOWS}, {S15_SIZE} px, {n_steps} steps, "
              f"{len(val)} val windows) on {card}: {ep['samples_s']:.1f} windows/s over the epoch, {secs:.2f} s with the "
              f"model's build; K1 {n_val}")
        ckpt = f"{exp}/0000/yolo3_darknet53_vid_0000.params"
        check(os.path.exists(ckpt), f"the slice 15 train twin wrote no checkpoint {ckpt}")

        nms_greedy.launches = 0
        t0 = time.perf_counter()
        dflags = flags + S15_TWIN[:-2]
        preds = detect.main(dflags + ["--model_path", ckpt, "--save_dir", f"{tmp}/res", "--save_prefix", "twin",
                                      "--metrics", "voc"])
        torch.cuda.synchronize()
        dsecs = time.perf_counter() - t0
        check(nms_greedy.launches == n_val, f"slice 15 detect twin: K1 launches {nms_greedy.launches}")
        k1 += nms_greedy.launches
        cfg = detect.dataset_config(detect.parse_args(dflags), S15_CLASSES)
        twin_det = Detector(cfg, detect.load_model_variables(ckpt, cfg), dtype=torch.bfloat16, data_shape=S15_SIZE)
        tf = YOLO3VideoInferenceTransform(S15_SIZE, S15_SIZE)
        idxs = range(min(S15_TRAIN_WINDOWS, len(val)))
        images = torch.from_numpy(np.stack([
            tf(np.stack([native.decode(p) for p in val.window_paths(i)]), val.label_and_size(i)[0])[0]
            for i in idxs])).to(dev)
        model.eval()
        with torch.inference_mode():
            raw_twin, raw_trained = twin_det.model(twin_det._normalized(images)), model(images)
        check(all(torch.equal(a, b) for a, b in zip(raw_twin, raw_trained)),
              "slice 15: the raw outputs of the checkpoint's model differ from the trained model's")
        nms_greedy.launches = 0
        ids, sc, bb = (a.cpu().numpy() for a in make_eval_step(model)(images))
        k1 += nms_greedy.launches
        ref = {}
        for n, i in enumerate(idxs):
            collect_boxes(ref, val.sample_path(i), ids[n], sc[n], np.clip(bb[n], 0, S15_SIZE), S15_SIZE)
        check(all(preds.get(val.sample_path(i), []) == ref.get(val.sample_path(i), []) for i in idxs),
              "slice 15: the detect twin's detections from the checkpoint differ from the trained model's")
        figures["detect_twin"] = {"windows": len(val), "seconds": dsecs, "detections": sum(map(len, preds.values())),
                                  "voc": open(f"{tmp}/res/twin/voc.txt").read().splitlines()[-1]}
        print(f"slice 15 detect twin from the checkpoint (B={S15_TRAIN_WINDOWS}, {len(val)} windows, {dsecs:.2f} s, "
              f"model load included) on {card}: raw outputs and the first batch's {sum(map(len, ref.values()))} "
              "detections equal the trained model's bit for bit")
        del model, twin_det, images
        torch.cuda.empty_cache()
    return figures, k1


def s15_refusals():
    """(f): what the twins refuse with the flownet stream, each where the JAX
    CLIs fail: a data shape that is not a multiple of 64 (detect and
    train), the train twin's random shapes, `--stream`, and
    `--pretrained_cnn` with `--stream_gating`."""
    flow = ["--window", f"{WINDOW},1", "--motion_stream", "flownet"]
    synthetic = ["--batch_size", "1", "--num_requests", "1", *flow]
    train = ["--dataset", "vid", *flow]
    with tempfile.NamedTemporaryFile(suffix=".params") as base:
        args = train_yolov3.parse_args(train + ["--stream_gating", "add", "--pretrained_base_path", base.name])
        with torch.device("meta"):
            gated = train_yolov3.yolo3_darknet53(["a"] * S15_CLASSES, **train_yolov3.temporal_kwargs(args))
        cases = {
            "detect_data_shape_416": (ValueError, "divisible by 64", lambda: detect.main(synthetic)),
            "detect_stream": (ValueError, "built-in per-frame backbone",
                              lambda: detect.main(synthetic + ["--data_shape", str(S15_SIZE), "--stream"])),
            "train_data_shape_416": (ValueError, "divisible by 64", lambda: train_yolov3.check_ported(
                train_yolov3.parse_args(train + ["--no_random_shape"]))),
            "train_random_shapes": (ValueError, "--no_random_shape", lambda: train_yolov3.check_ported(
                train_yolov3.parse_args(train + ["--data_shape", str(S15_SIZE)]))),
            "train_gated_pretrained_cnn": (RuntimeError, "--stream_gating",
                                           lambda: train_yolov3._load_pretrained_base(args, gated)),
        }
        refused = {}
        for name, (exc, text, fn) in cases.items():
            try:
                fn()
                refused[name] = False
            except exc as e:
                refused[name] = text in str(e)
            check(refused[name], f"slice 15: {name} was not refused")
    print(f"slice 15 refusals: {sorted(refused)}")
    return refused


def data_slice15(dev, card):
    """Phase 19.  Returns (the phase's figures, K1's launches on its paths,
    K2's)."""
    figures, k1, seconds = {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(19)
    t0 = time.perf_counter()
    for name in S15_MODELS:
        figures[name], k1[name] = s15_serve(name, dev, card, gen)
    seconds["a"] = time.perf_counter() - t0
    figures["f32"] = s15_f32(dev, card, gen)
    seconds["b"] = time.perf_counter() - t0
    figures["flownetc"], k2 = s15_flownetc(dev, card)
    seconds["c"] = time.perf_counter() - t0
    figures["add"]["train_step"] = s15_train(dev, card)
    seconds["d"] = time.perf_counter() - t0
    figures["twins"], k1["twins"] = s15_twins(dev, card)
    seconds["e"] = time.perf_counter() - t0
    figures["refused"] = s15_refusals()
    seconds["f"] = time.perf_counter() - t0
    figures["seconds_from_start"] = seconds
    print(f"slice 15 parts' ends, seconds from the phase's start: {seconds}")
    k1["total"] = sum(k1.values())
    figures["k1"], figures["k2_launches"] = k1, k2
    print(f"slice 15 launches: K1 {k1}, K2 {k2}")
    return figures, k1["total"], k2


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start, phase_s = time.perf_counter(), {}  # each phase's end, seconds from here

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
    phase_s["2"] = time.perf_counter() - t_start

    # 3. the kernels against their plain versions
    rs = np.random.RandomState(0)
    nms_err, nms_cases, nms_synthetic = check_nms_kernel(rs, dev, card)
    corr_err = check_corr_kernel(dev)
    int8_cases, k3_err, conv_err = check_int8_kernels(dev)
    phase_s["3"] = time.perf_counter() - t_start

    # 4. slice 1: the detect path at 416 px, bf16
    nms_ms = {}
    det1, x128, x1, nms_launches, err = serve_slice1(rs, dev, card, nms_ms)
    nms_err = max(nms_err, err)
    phase_s["4"] = time.perf_counter() - t_start

    # 5. slice 2: YOLOv3T windows with early correlation at 416 px, bf16
    det2, x32, corr_launches, nms_launches2, corr, err = serve_slice2(rs, dev, card)
    corr_err = max(corr_err, err)
    phase_s["5"] = time.perf_counter() - t_start

    # 6. slice 3: fused-int8 YOLOv3 at 416 px, bf16 tips
    det3, x128_3, int8_launches, k3, conv, cells3 = serve_slice3(rs, dev, card)
    phase_s["6"] = time.perf_counter() - t_start

    # 7. reference
    check_reference(rs)
    phase_s["7"] = time.perf_counter() - t_start

    # 8. profile
    profile_steps([("slice 1 B=128", det1, x128, 3, 8), ("slice 1 B=1", det1, x1, 20, 4),
                   ("slice 2 B=32", det2, x32, 3, 10), ("slice 3 B=128", det3, x128_3, 3, 10)], card)
    phase_s["8"] = time.perf_counter() - t_start

    # 9. slice 4: training
    del det1, det2, det3, x128, x1, x32, x128_3
    torch.cuda.empty_cache()
    train_figures, k1_slice4 = train_slice4(dev, card)
    phase_s["9"] = time.perf_counter() - t_start

    # 10. slice 5: detect and train on VOC from disk through the twins
    torch.cuda.empty_cache()
    data_figures, k1_slice5 = data_slice5(dev, card)
    phase_s["10"] = time.perf_counter() - t_start

    # 11. slice 6: COCO, ImageNet-DET and -VID from disk through the twins
    torch.cuda.empty_cache()
    slice6_figures, k1_slice6 = data_slice6(dev, card)
    phase_s["11"] = time.perf_counter() - t_start

    # 12. slice 7: VID windows from disk, YOLOv3T training, K2's adjoint
    torch.cuda.empty_cache()
    slice7_figures, k1_slice7, k2_slice7 = data_slice7(dev, card)
    step7 = slice7_figures["train_step"]
    phase_s["12"] = time.perf_counter() - t_start

    # 13. slice 9: YOLOv3Temporal t=5, detection, training and both twins
    torch.cuda.empty_cache()
    t5_figures, k1_slice9, k2_slice9 = data_t5(dev, card)
    phase_s["13"] = time.perf_counter() - t_start

    # 14. slice 10: the combined class tree and YouTube-BB through both twins
    torch.cuda.empty_cache()
    comb_figures, k1_slice10, k2_slice10 = data_slice10(dev, card)
    phase_s["14"] = time.perf_counter() - t_start

    # 15. slice 11: data-parallel training (the earlier phases' memory freed)
    torch.cuda.empty_cache()
    dp_figures, k1_slice11 = data_slice11(dev, card)
    phase_s["15"] = time.perf_counter() - t_start

    # 16. slice 12: streaming video detection through the detect twin
    torch.cuda.empty_cache()
    stream_figures, k1_slice12, k2_slice12 = data_slice12(dev, card)
    phase_s["16"] = time.perf_counter() - t_start

    # 17. slice 13: the conv-RNN and the 3D / 2+1D blocks through both twins and the stream
    torch.cuda.empty_cache()
    s13_figures, k1_slice13, k2_slice13 = data_slice13(dev, card)
    phase_s["17"] = time.perf_counter() - t_start

    # 18. slice 14: the 3D / 2+1D and hierarchical DarkNet backbones through the factory and both twins
    torch.cuda.empty_cache()
    s14_figures, k1_slice14 = data_slice14(dev, card)
    phase_s["18"] = time.perf_counter() - t_start

    # 19. slice 15: the two-stream FlowNet family through the factory and both twins, FlowNetC's K2
    torch.cuda.empty_cache()
    cost_volume_backward.launches = quant_downsample.launches = int8_conv.launches = 0
    s15_figures, k1_slice15, k2_slice15 = data_slice15(dev, card)
    off_path15 = dict(adjoint=cost_volume_backward.launches, k3=quant_downsample.launches,
                      int8_conv=int8_conv.launches)
    check(not any(off_path15.values()), f"phase 19 launched kernels off its path: {off_path15}")
    phase_s["19"] = time.perf_counter() - t_start

    adjoint = dict(
        ms=step7["k2_adjoint_ms"],
        plain_ms=sum(lv["adjoint_plain_ms"] for lv in step7["levels"]),
        bound_ms=sum(max(lv["adjoint_bytes_ms"], lv["adjoint_ops_ms"]) for lv in step7["levels"]),
        bound_by=("bytes" if sum(lv["adjoint_bytes_ms"] for lv in step7["levels"])
                  >= sum(lv["adjoint_ops_ms"] for lv in step7["levels"]) else "operations"),
    )

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
            "launches_slice5": k1_slice5,
            "launches_slice6": k1_slice6,
            "launches_slice7": k1_slice7,
            "launches_slice9": k1_slice9,
            "slice9_80_images_ms": t5_figures["detect"]["k1_80_images_ms"],
            "launches_slice10": k1_slice10,
            "slice10_285_class_b128_ms": comb_figures["step"][TREE_CLASSES]["k1_ms"],
            "launches_slice11": k1_slice11,
            "launches_slice12": k1_slice12,
            "launches_slice13": k1_slice13,
            "launches_slice14": k1_slice14,
            "launches_slice15": k1_slice15,
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
            "launches_slice7": k2_slice7[0],
            "train_step_ms": step7["k2_forward_ms"],
            "train_step_launches": step7["launches"]["forward"],
            "launches_slice9": k2_slice9[0],
            "slice9": {"per": f"one t=5 request: {T5_CORR_LAUNCHES} launches, then the kernel_size=3 patch sum",
                       "detect": t5_figures["detect"]["k2"], "train": {k: t5_figures["train_step"]["k2"][k] for k in (
                           "shape", "forward_ms", "forward_bytes_ms", "forward_ops_ms")},
                       "max_abs_err": t5_figures["kernels"]},
            "launches_slice10": k2_slice10[0],
            "launches_slice12": k2_slice12,
            "launches_slice13": k2_slice13[0],
            "slice13": {"per": f"one B={S13_BATCH} request of the tip GRU with the late correlation: {CORR_LAUNCHES} "
                               "launches, on the GRU's outputs",
                        "max_abs_err": s13_figures["rnn_late_corr"]["k2_max_abs_err"],
                        "shapes": s13_figures["rnn_late_corr"]["k2_shapes"]},
            "launches_slice15": k2_slice15,
            "slice15": {"per": "one FlowNetC call: 1 launch, d=20, stride2=2 (441 channels) on its stride-8 level",
                        "b16": s15_figures["flownetc"]["k2"], "b1": s15_figures["flownetc"]["k2_b1"]},
        },
        {
            "name": "cost_volume_backward",
            "route": "cuda",
            "source": "videoyolo_torch/csrc/correlation.cu",
            "replaces": "videoyolo_tpu/ops/pallas_correlation.py:63 (its adjoint: the TPU kernel has none; the JAX "
                        "package differentiates videoyolo_tpu/ops/correlation.py:64-80)",
            "launches": step7["launches"]["adjoint"],
            "max_abs_err": slice7_figures["adjoint_max_abs_err"],
            **adjoint,
            "library_ms": None,
            "match": True,
            "cases": len(CORR_BWD_CASES),
            "per": f"one B={TRAIN_WINDOWS}-window train step: {CORR_BWD_LAUNCHES} launches, one a level for the "
                   "pair of volumes",
            "levels": [{**{k: lv[k] for k in ("shape", "adjoint_ms", "adjoint_plain_ms", "adjoint_bytes_ms",
                                              "adjoint_ops_ms", "one_volume_adjoint_ms")}, "plan": lv["adjoint_plan"]}
                       for lv in step7["levels"]],
            "launches_slice7": k2_slice7[1],
            "launches_slice9": k2_slice9[1],
            "slice9": {"per": f"one t=5 train step: {T5_CORR_LAUNCHES} one-volume launches",
                       **{k: t5_figures["train_step"]["k2"][k] for k in (
                           "shape", "adjoint_ms", "adjoint_mid_ms", "adjoint_plain_ms", "adjoint_bytes_ms",
                           "adjoint_ops_ms", "adjoint_plan", "adjoint_mid_max_abs_err")},
                       "train_step_launches": t5_figures["train_step"]["launches"]["adjoint"]},
            "launches_slice10": k2_slice10[1],
            "launches_slice13": k2_slice13[1],
            "launches_slice15": off_path15["adjoint"],
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
            "launches_slice15": off_path15["k3"],
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
            "launches_slice15": off_path15["int8_conv"],
        },
    ]
    print(json.dumps({"slice4_training": train_figures}))
    print(json.dumps({"slice5_data": data_figures}))
    print(json.dumps({"slice6_data": slice6_figures}))
    print(json.dumps({"slice7_windows": slice7_figures}))
    print(json.dumps({"slice9_t5": t5_figures}))
    print(json.dumps({"slice10_comb": comb_figures}))
    print(json.dumps({"slice11_dp": dp_figures}))
    print(json.dumps({"slice12_stream": stream_figures}))
    print(json.dumps({"slice13_rnn_3d": s13_figures}))
    print(json.dumps({"slice14_backbones": s14_figures}))
    print(json.dumps({"slice15_two_stream": s15_figures}))
    print(json.dumps({"phase_end_s": phase_s}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # a child of phase 15 (a)
        sys.exit(dp_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--twin-rank"]:  # a rank of phase 15 (c), under torchrun
        sys.exit(twin_rank(sys.argv[2:]))
    sys.exit(main())
