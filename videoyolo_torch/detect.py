"""Detect entry point (the twin of detect_yolo3.py), on a dataset from disk
or on seeded synthetic requests.

    python -m videoyolo_torch.detect --dataset voc --dataset_root datasets \
        --data_shape 416 --batch_size 128 [--dtype f32|bf16] [--model_path P] \
        [--save_dir results --save_prefix 0001] [--metrics voc] [--max_do N] \
        [--skip_existing] [--num_workers 8] [--device cpu]
    python -m videoyolo_torch.detect --dataset img.jpg,dir/,list.txt ...

    python -m videoyolo_torch.detect --dataset coco --metrics coco,voc ...
    python -m videoyolo_torch.detect --dataset det --metrics voc ...
    python -m videoyolo_torch.detect --dataset vid --every 2 --metrics vid [--metric_agnostic] ...
    python -m videoyolo_torch.detect --dataset vid --window 3,1 --k_join_pos late --corr_pos early \
        --corr_d 4 --metrics voc ...   # YOLOv3T on VID windows
    python -m videoyolo_torch.detect --dataset vid --window 5,1 --temp --mult_out [--offset 0] \
        --corr_pos early --corr_d 4 --metrics voc,vid ...   # YOLOv3Temporal, one output a frame
    python -m videoyolo_torch.detect --dataset yt [--window 3,1 ...] --metrics voc ...   # YouTube-BB
    python -m videoyolo_torch.detect --dataset comb [--hier_level 10] --metrics voc ...   # the class tree
    python -m videoyolo_torch.detect --dataset voc --trained_on comb --metrics voc ...

With `--dataset`, detect_yolo3.py's dataset path on its validation splits:
`voc` is VOC 2007 test under `<dataset_root>/PascalVOC/VOCdevkit`, `coco`
COCO's instances_val2017 under `<dataset_root>/MSCoco` (images without
boxes kept), `det` ImageNet-DET val under `<dataset_root>/ImageNetDET/ILSVRC`
`vid` the frames of ImageNet-VID val under
`<dataset_root>/ImageNetVID/ILSVRC`, every `--every`th of each video,
`yt` YouTube-BB's validation clips under `<dataset_root>/YouTubeBB`,
about `--every` frames of each, and `comb` the val splits of voc, coco,
det and vid combined through the 285-node WordNet class tree, each box
once for every node of its branch; anything else is a list of JPEG files,
directories of them and `.txt` lists of paths.  The JPEG core (native.py) decodes and resizes the images
in batches, the detect step (`serving.Detector`, K1's NMS on the card) runs
on each batch, the tail batch included, and the detections go to
`<save_dir>/<save_prefix>/pred/` as one `.txt` file an image
(`pred/<video>/<frame>.txt` for VID), in the JAX package's format
(`img_path,cls,score,x1,y1,x2,y2`, boxes normalised by the data shape), so
each package reads the other's cache.  A run whose cache is complete reads
it and runs no detect step; `--skip_existing` detects only the images whose
file is missing.  A labelled dataset is then evaluated by each of
`--metrics`, written to `<save_dir>/<save_prefix>/<metric>.txt`: `voc` (VOC
mAP at IoU 0.5), `coco` (COCO mAP at IoU .5:.95, its results json removed
after) and `vid` (the VID motion mAP; `--metric_agnostic` scores the boxes
without their classes).  On `comb` the detections of each image go
through the hierarchical NMS of detect_yolo3.py first (`--hier_level`: a
class deeper in the tree than that is lifted to its ancestor at that
level; a box that overlaps a kept box of its own branch is merged into it).
`--trained_on D` scores a model trained on dataset D: the model has D's
classes, and the metrics map the evaluated dataset's classes onto them by
WordNet id (`get_class_map`; a class D lacks scores nothing), so a model
trained on `comb` is scored on `voc`.  The cache names an image's file
by its stem (`<video>/<stem>` on vid), as detect_yolo3.py does, so stems
repeated across comb's subsets or YouTube-BB's videos share a file
(ROADMAP.md Queue 3).
`--model_path` takes the JAX package's flax msgpack or an MXNet `.params`
file (the reference's gluon checkpoints); without it the weights are
seeded random, with a warning.
With `--window k[,step]` and k > 1 on `vid` or `yt`, each sample is the
window of k frames around a val frame (the VID window sampler, which
YouTube-BB's clips share) and the model is
YOLOv3T with the temporal flags (`--k_join_type`, `--k_join_pos`,
`--block_conv_type` 2, 3 or 21, `--rnn_pos` late or out, `--corr_pos`,
`--corr_d`, read only with `--corr_pos`, as detect_yolo3.py reads them).  The windows take the JAX
detect CLI's Python route (detect_yolo3.py:989-992): each frame decoded,
resized with interp 9 and normalised, in the loader's workers; the
detections are the key frame's, cached under its name.  The cost volumes
run on K2 and the NMS on K1 for each batch.  The metrics then read each
image's size as detect_yolo3.py's `evaluate` reads it for a window, from
the first two axes of the stacked (k, H, W, 3) frames, so their numbers
are the JAX CLI's (ROADMAP.md Queue 3: a fault of the reference, mirrored).
`--temp` and `--mult_out` (detect_yolo3.py:48-49, 297) build YOLOv3Temporal
on windows of `--window` k (5) frames: `--temp` alone the funnel (one set
of detections a window, the key frame's), `--mult_out` the per-timestep
heads (with `--corr_pos`, the `--corr_d` correlation pyramid): each window
gets detections for each of its frames, one NMS call on the B*k frames,
and the cache holds one directory a window offset, `pred_o0` ... `pred_o4`
(a frame of the window clamped onto the key frame at a video's ends is
written under the key frame only, detect_yolo3.py:560-600).  The metrics
then score the offset `--offset` (-2..2) from the middle: its frames'
detections against their own labels, the size read from the frame itself.
`--mult_out` takes `vid`: YouTube-BB gives no per-frame labels of a
window, in either package.
`--stream` with `--window k,1` (k > 1) detects with the streaming detector
(streaming.py, detect_yolo3.py:400-460): the frames one at a time in the
dataset's order, each decoded alone (the single-frame JPEG route), one
per-frame pass each, the rest of the window from buffers on the card; a
stream resets where the frame's directory changes (a new video).  Each
frame gets the detections of the window ending at it (`--stream_anchor
trail`) or centred on it, clamped at the video's ends
(`--stream_anchor center`: the windowed path's windows, emitted k//2 frames
late).  It takes any `--window` model (YOLOv3T's flags, or `--temp` /
`--mult_out` for YOLOv3Temporal, whose per-frame outputs give each frame
its own offset's detections: the last for trail, the middle for center),
on vid, yt or ad-hoc JPEG inputs; the cache is the flat `pred/` of one
file a frame.  It refuses `--skip_existing` (the buffers need consecutive
frames), `--quantize` (item 9a) and `--new_model`.
`--new_model` (detect_yolo3.py:45-47, 290-298) builds YOLOv3T over a
backbone that returns the routes itself: `Darknet3D` with `--conv_types`
(2, 3 or 21 for the stem and each of the five stages) on windows of
`--window` k frames, or, with `--hier` (e.g. 3,3,1,1,1 on `--window 9,1`),
`HDarknet`, merging groups of 3 frames by `--h_join_type` max or conv; one
set of detections a window, the key frame's.
`--motion_stream flownet` (detect_yolo3.py:43-44, 290-291) builds the
two-stream YOLOv3T on windows of `--window 3,1`: the middle frame through
Darknet-53, the outer two through FlowNetS, optionally gating Darknet-53
(`--stream_gating add|mul`); one set of detections a window.  Its
`--data_shape` must be a multiple of 64 (384, 448): the default 416 fails
the JAX CLI's FlowNetS assertion and is refused here.  `--motion_stream
r21d` raises (ROADMAP.md Queue 1 item 7's R(2+1)D half), and `--stream`
refuses the two-stream backbone, as it refuses --new_model's.

Without `--dataset`, the seeded synthetic mode:

    python -m videoyolo_torch.detect --data_shape 416 --batch_size 128 \
        --num_requests 3 --seed 0 [--device cpu] [--dtype f32|bf16] [--out preds.json]
    python -m videoyolo_torch.detect --data_shape 416 --batch_size 32 \
        --window 3,1 --k_join_pos late --corr_pos early --corr_d 4   # YOLOv3T windows
    python -m videoyolo_torch.detect --data_shape 416 --batch_size 16 \
        --window 3,1 --k_join_pos late --rnn_pos late   # the tip conv-RNN (--block_conv_type 3|21: 3-D blocks)
    python -m videoyolo_torch.detect --data_shape 416 --batch_size 16 \
        --window 5,1 --temp --mult_out --corr_pos early --corr_d 4   # YOLOv3Temporal windows
    python -m videoyolo_torch.detect --data_shape 416 --batch_size 32 \
        --window 3,1 --k_join_type max --k_join_pos late --stream   # 32 streams of a clip
    python -m videoyolo_torch.detect --data_shape 416 --batch_size 16 \
        --window 5,1 --new_model --conv_types 2,3,3,2,2,2   # Darknet3D (--hier 3,3,1,1,1 --window 9,1: HDarknet)
    python -m videoyolo_torch.detect --data_shape 384 --batch_size 16 \
        --window 3,1 --motion_stream flownet --stream_gating add   # the two-stream model
    python -m videoyolo_torch.detect --data_shape 416 --batch_size 128 --quantize int8

The model takes seeded random weights.  Each request is a batch of uint8
images drawn from the seed or, with `--window k[,stride]` and k > 1, a batch
of k-frame windows: window i takes every stride-th frame from frame i of a
seeded synthetic clip, so neighbouring windows share frames as they do in a
video.  The temporal flags are those of detect_yolo3.py (`--corr_d` counts
only with `--corr_pos`; `--temp` and `--mult_out` as above, a window's
frames named `<window>_o<t>` with `--mult_out`).  With `--stream`, B
streams of `--num_requests` frames each (every stream its own seeded clip)
go through the streaming detector, one frame of every stream a request,
named `stream<i>/frame<j>`.  `--quantize int8` serves
the fused-int8 YOLOv3,
calibrated on the first two request batches as detect_yolo3.py calibrates on
the first two loader batches.  The command prints one summary line per request
and, with --out, writes the detections as {image or window name: [[cls,
score, x1, y1, x2, y2], ...]} with normalised boxes.

Both modes run on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import logging
import os
import time

import numpy as np
import torch

from . import native
from .data.base import check_jpeg
from .data.combined import COMB, CombinedDetection
from .data.detectset import DetectSet
from .data.imgnetdet import ImageNetDetection
from .data.imgnetvid import ImageNetVidDetection
from .data.loader import DetectionLoader
from .data.mscoco import COCODetection
from .data.pascalvoc import VOCDetection
from .data.prefetch import device_prefetch
from .data.transforms import YOLO3VideoInferenceTransform
from .data.youtubebb import YouTubeBBDetection
from .metrics.imgnetvid import VIDDetectionMetric
from .metrics.mscoco import COCODetectionMetric
from .metrics.pascalvoc import VOCMApMetric
from .models.factory import YoloConfig, build_model
from .models.flownet import check_input_size
from .serving import Detector, collect_boxes
from .streaming import StreamingDetector, stream_frames
from .train.checkpoint import load_detector_params, variables_of

NUM_CLASSES = 20  # the VOC classes of the main path
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_shape", type=int, default=416)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_requests", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: cuda (raises without a GPU)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="f32",
                   help="the model's dtype; f32 as detect_yolo3.py serves, bf16 on request")
    p.add_argument("--out", default=None, help="write the detections as JSON")
    p.add_argument("--window", default="1,1", help="temporal window size of frames and stride")
    p.add_argument("--k_join_type", default=None, help="way to fuse k: max, mean or cat")
    p.add_argument("--k_join_pos", default=None, help="position of the k fuse: early or late")
    p.add_argument("--block_conv_type", default="2", help="conv type of the YOLO blocks: 2, 3 or 21")
    p.add_argument("--rnn_pos", default=None, help="position of RNN: late or out")
    p.add_argument("--corr_pos", default=None, help="position of the correlation: early or late")
    p.add_argument("--corr_d", type=int, default=4, help="the d of the correlation")
    p.add_argument("--temp", action="store_true", help="the t=5 temporal model (YOLOv3Temporal)")
    p.add_argument("--mult_out", action="store_true", help="one output a frame of the window (t_out)")
    p.add_argument("--offset", type=int, default=0, help="with --mult_out, the window offset to evaluate: -2..2")
    p.add_argument("--new_model", action="store_true",
                   help="YOLOv3T over a backbone that returns the routes: Darknet3D, or HDarknet with --hier")
    p.add_argument("--conv_types", default="2,2,2,2,2,2", help="Darknet3D's conv types: the stem and 5 stages")
    p.add_argument("--hier", default="1,1,1,1,1", help="HDarknet's merge windows a level")
    p.add_argument("--h_join_type", default=None, help="HDarknet's merge: max or conv")
    p.add_argument("--motion_stream", default=None,
                   help="the two-stream model's motion stream: flownet (--window 3,1; r21d: ROADMAP.md item 7)")
    p.add_argument("--stream_gating", default=None, help="the motion stream's gating of darknet: add or mul")
    p.add_argument("--quantize", default=None, choices=["int8", "int8_static", "int8_dynamic"],
                   help="int8 serving: the fused int8-end-to-end YOLOv3")
    p.add_argument("--stream", action="store_true",
                   help="streaming detection over frames in order, one per-frame pass a frame (--window k,1)")
    p.add_argument("--stream_anchor", choices=["trail", "center"], default="trail",
                   help="--stream: the window ending at each frame, or centred on it")
    # the dataset path (detect_yolo3.py's flags)
    p.add_argument("--dataset", default=None,
                   help="voc, coco, det, vid, yt or comb, or comma-separated JPEG files, directories and .txt lists")
    p.add_argument("--dataset_root", default="datasets", help="root directory holding the datasets")
    p.add_argument("--save_dir", default="results", help="directory of the prediction cache and metrics")
    p.add_argument("--save_prefix", default="0001", help="subdirectory of --save_dir")
    p.add_argument("--metrics", default="voc", help="comma-separated metrics: voc, coco, vid")
    p.add_argument("--metric_agnostic", action="store_true", help="the vid metric without the classes")
    p.add_argument("--every", type=float, default=25,
                   help="vid: every this many frames; yt: about this many frames a clip")
    p.add_argument("--hier_level", type=int, default=10, help="comb: the tree level cut of the hierarchical NMS")
    p.add_argument("--trained_on", default="", help="the dataset the model was trained on, if not --dataset")
    p.add_argument("--max_do", type=int, default=-1, help="the most images to detect on; -1 is all")
    p.add_argument("--model_path", default="", help="flax msgpack or MXNet .params; '' = seeded random")
    p.add_argument("--skip_existing", action="store_true",
                   help="detect only the images whose pred/*.txt file is missing")
    p.add_argument("--num_workers", type=int, default=8, help="data loading workers")
    return p.parse_args(argv)


def _requests(rs, num, b, s, k, stride):
    """Each request's uint8 batch: (B, S, S, 3) images, or (B, k, S, S, 3)
    windows over a synthetic clip when k > 1."""
    for _ in range(num):
        if k == 1:
            yield rs.randint(0, 256, (b, s, s, 3)).astype(np.uint8)
            continue
        span = (k - 1) * stride + 1
        clip = rs.randint(0, 256, (b + span - 1, s, s, 3)).astype(np.uint8)
        yield np.stack([clip[i : i + span : stride] for i in range(b)])


def backbone_kwargs(args) -> dict:
    """--new_model's and --motion_stream's backbone flags as the factory's
    keywords (none without them), as detect_yolo3.py passes them; a flownet
    stream's data shape checked first (a multiple of 64, where the JAX
    CLI's model fails its encoder's assertion)."""
    kw = {}
    if args.motion_stream:
        if args.motion_stream == "flownet":
            check_input_size(args.data_shape, args.data_shape)
        kw.update(motion_stream=args.motion_stream, add_type=args.stream_gating)
    if args.new_model:
        kw.update(new_model=True, conv_types=tuple(int(c) for c in args.conv_types.split(",")),
                  hierarchical=tuple(int(h) for h in args.hier.split(",")), h_join_type=args.h_join_type)
    return kw


def check_stream_args(args, window) -> None:
    """detect_yolo3.py's --stream asserts (:960-968, 1008-1011), and the int8
    stream deferred."""
    if args.new_model or args.motion_stream:
        raise ValueError("--stream needs the built-in per-frame backbone: --new_model's Darknet3D and HDarknet and "
                         "--motion_stream's two-stream backbone own their time mixing (the JAX package's stream "
                         "asserts so)")
    if window[0] <= 1:
        raise ValueError("--stream needs a temporal window (--window k,1)")
    if window[1] != 1:
        raise ValueError("--stream runs stride-1 windows (--window k,1); strided windows skip frames the buffers "
                         "would need")
    if args.skip_existing:
        raise ValueError("--skip_existing cannot compose with --stream: the buffers need consecutive frames")
    if args.quantize:
        raise NotImplementedError("--quantize with --stream (the int8 temporal family) is deferred, see ROADMAP.md "
                                  "Queue 1 item 9a")


def main(argv=None):
    args = parse_args(argv)
    if args.dataset:
        return main_dataset(args)
    k, stride = ([int(w) for w in args.window.split(",")] + [1])[:2]
    if args.stream:
        return main_stream(args, (k, stride))
    if k == 1 and (args.temp or args.mult_out):
        k = 5  # YOLOv3Temporal's default t
    temporal = k > 1
    cfg = YoloConfig(
        num_classes=NUM_CLASSES, pad_stem=True,
        k=k if temporal else None,
        k_join_type=args.k_join_type, k_join_pos=args.k_join_pos, block_conv_type=args.block_conv_type,
        rnn_pos=args.rnn_pos, corr_pos=args.corr_pos, corr_d=args.corr_d if args.corr_pos else None,
        temporal=args.temp, t_out=args.mult_out, **backbone_kwargs(args),
    )
    if args.quantize and args.quantize != "int8":
        raise NotImplementedError(f"--quantize {args.quantize} is deferred, see ROADMAP.md Queue 1 item 9a")
    if args.quantize and temporal:
        raise NotImplementedError(
            "--quantize with --window (the int8 temporal family) is deferred, see ROADMAP.md Queue 1 item 9a"
        )
    s = args.data_shape
    requests = list(_requests(np.random.RandomState(args.seed), args.num_requests, args.batch_size, s, k, stride))
    det = Detector(
        cfg, dtype=DTYPES[args.dtype], data_shape=s, device=args.device, seed=args.seed,
        quantize=args.quantize, calibration=requests[:2] if args.quantize else None,
    )
    name = "window" if temporal else "image"
    preds = {}
    for r, batch in enumerate(requests):
        t0 = time.perf_counter()
        ids, sc, bb = (a.cpu().numpy() for a in det(batch))
        ms = (time.perf_counter() - t0) * 1e3
        n_det = int((ids >= 0).sum())
        print(
            f"request {r}: batch {args.batch_size} at {s} px on {det.device}: "
            f"{n_det} detections ({n_det / args.batch_size:.1f}/{name}), {ms:.1f} ms"
        )
        for i in range(args.batch_size):
            if ids.ndim == 4:  # one set of detections a frame of the window
                for t in range(ids.shape[1]):
                    collect_boxes(preds, f"request{r}/{name}{i:04d}_o{t}", ids[i, t], sc[i, t], bb[i, t], s)
            else:
                collect_boxes(preds, f"request{r}/{name}{i:04d}", ids[i], sc[i], bb[i], s)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(preds, f)
    return preds


def main_stream(args, window):
    """The synthetic mode with --stream: `--batch_size` streams, each a
    seeded clip of `--num_requests` frames, through the streaming detector
    (`--stream_anchor`); one summary line a frame of the streams."""
    check_stream_args(args, window)
    cfg = YoloConfig(
        num_classes=NUM_CLASSES, k=window[0],
        k_join_type=args.k_join_type, k_join_pos=args.k_join_pos, block_conv_type=args.block_conv_type,
        rnn_pos=args.rnn_pos, corr_pos=args.corr_pos, corr_d=args.corr_d if args.corr_pos else None,
        temporal=args.temp, t_out=args.mult_out,
    )
    stream = StreamingDetector(Detector(cfg, dtype=DTYPES[args.dtype], device=args.device, seed=args.seed).model)
    s, b = args.data_shape, args.batch_size
    clips = np.random.RandomState(args.seed).randint(0, 256, (args.num_requests, b, s, s, 3)).astype(np.uint8)
    t_off = -1 if args.stream_anchor == "trail" else stream.k // 2
    preds = {}
    t0 = time.perf_counter()
    for m, (ids, sc, bb) in stream_frames(stream, iter(clips), anchor=args.stream_anchor):
        ids, sc, bb = (a.cpu().numpy() for a in (ids, sc, bb.clamp(0, s)))
        ms = (time.perf_counter() - t0) * 1e3
        if ids.ndim == 4:  # t_out: the anchor frame's offset of the window
            ids, sc, bb = ids[:, t_off], sc[:, t_off], bb[:, t_off]
        n_det = int((ids >= 0).sum())
        print(f"frame {m} of {b} streams at {s} px on {stream.device} ({stream.split} split, {args.stream_anchor}): "
              f"{n_det} detections ({n_det / b:.1f}/frame), {ms:.1f} ms")
        for i in range(b):
            collect_boxes(preds, f"stream{i:04d}/frame{m:04d}", ids[i], sc[i], bb[i], s)
        t0 = time.perf_counter()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(preds, f)
    return preds


# --------------------------------------------------------------------------
# the dataset path (detect_yolo3.py:145-269, 552-690, 890-1150)
# --------------------------------------------------------------------------

def get_dataset(names, dataset_root: str, every: float = 25, window=(1, 1), mult_out: bool = False,
                hier_level: int = 10):
    """`--dataset` -> an inference dataset (detect_yolo3.py:145-269): the
    validation split of voc, coco, det, vid (frames, every `every`th, or
    their `window`s, labelled a frame with `mult_out`) or yt (clips, about
    `every` frames of each, or their windows), the four of comb in the
    class tree's validation mode, or JPEG files, directories and `.txt`
    lists."""
    if names[0] == "comb":
        subsets = [get_dataset([n], dataset_root, every) for n in COMB]
        return CombinedDetection(subsets, class_tree=True, validation=True, inference=True, hier_level=hier_level)
    if names[0] == "yt":
        return YouTubeBBDetection(root=os.path.join(dataset_root, "YouTubeBB"), splits=["val"], frames=every,
                                  window=window, inference=True)
    if names[0] == "voc":
        return VOCDetection(
            root=os.path.join(dataset_root, "PascalVOC", "VOCdevkit"), splits=[(2007, "test")],
            inference=True,
        )
    if names[0] == "coco":
        return COCODetection(root=os.path.join(dataset_root, "MSCoco"), splits=["instances_val2017"],
                             allow_empty=True, inference=True)
    if names[0] == "det":
        return ImageNetDetection(root=os.path.join(dataset_root, "ImageNetDET", "ILSVRC"), splits=["val"],
                                 allow_empty=True, inference=True)
    if names[0] == "vid":
        return ImageNetVidDetection(root=os.path.join(dataset_root, "ImageNetVID", "ILSVRC"),
                                    splits=[(2017, "val")], every=int(every), window=window, mult_out=mult_out,
                                    inference=True)
    img_files = []
    for f in names:
        ext = os.path.splitext(f)[1].lower()
        if ext in (".jpg", ".jpeg", ".png"):
            img_files.append(f)
        elif ext in (".mp4", ".avi", ".mov"):
            raise NotImplementedError(f"{f}: video inputs need frames without cv2, ROADMAP.md Queue 1 item 15")
        elif ext == ".txt":
            with open(f) as fh:
                img_files += [line.strip() for line in fh if line.strip()]
        elif os.path.isdir(f):
            img_files += [
                os.path.join(f, p) for p in sorted(os.listdir(f))
                if os.path.splitext(p)[1].lower() in (".jpg", ".jpeg", ".png")
            ]
        else:
            raise ValueError(f"unrecognised dataset input: {f}")
    for f in img_files:
        check_jpeg(f)
    return DetectSet(img_files)


def _cache_file(pred_dir: str, dataset, img_path: str) -> str:
    """An image's file in the cache (detect_yolo3.py:552-557): `<stem>.txt`,
    or `<video>/<frame>.txt` for VID, whose frame names repeat across
    videos."""
    name = os.path.splitext(os.path.basename(img_path))[0]
    if getattr(dataset, "name", "") == "vid":
        name = os.path.join(img_path.split("/")[-2], name)
    return os.path.join(pred_dir, name + ".txt")


def _pred_dir(save_dir: str, offset=None) -> str:
    return os.path.join(save_dir, "pred" if offset is None else f"pred_o{offset}")


def _layouts(dataset):
    """The cache's (directory offset, path of a sample) pairs: `pred` and
    each sample's path, or with mult_out one `pred_o{t}` a window offset
    and the window's t-th frame (detect_yolo3.py:560-600)."""
    if getattr(dataset, "mult_out", False):
        return [(t, lambda idx, t=t: dataset.window_paths(idx)[t]) for t in range(dataset.window[0])]
    return [(None, dataset.sample_path)]


def save_predictions(save_dir, dataset, boxes, max_do=-1, indices=None):
    """The pred/*.txt cache, one file an image, written through a renamed
    temporary (a kill mid-write leaves a complete file or none); with
    mult_out `boxes` is a list of one dict a window offset, each written to
    its own `pred_o{t}`.  `indices` restricts the write to those samples."""
    for offset, path_of in _layouts(dataset):
        _save_predictions_dict(_pred_dir(save_dir, offset), dataset, boxes if offset is None else boxes[offset],
                               path_of, max_do, indices)


def _save_predictions_dict(out_dir, dataset, boxes, path_of, max_do, indices):
    os.makedirs(out_dir, exist_ok=True)
    if max_do < 0:
        max_do = len(dataset)
    for idx in indices if indices is not None else range(min(len(dataset), max_do)):
        img_path = path_of(idx)
        final = _cache_file(out_dir, dataset, img_path)
        os.makedirs(os.path.dirname(final), exist_ok=True)
        tmp = final + ".tmp"
        with open(tmp, "w") as f:
            for box in boxes.get(img_path, []):
                f.write("{},{},{},{},{},{},{}\n".format(img_path, box[0], box[1], box[2], box[3], box[4], box[5]))
        os.replace(tmp, final)


def _missing_indices(save_dir, dataset, max_do=-1):
    """Sample indices with a cache file missing (the --skip_existing set):
    with mult_out, a window counts as done only with all its offsets'
    files."""
    if max_do < 0:
        max_do = len(dataset)
    return [
        idx for idx in range(min(len(dataset), max_do))
        if not all(os.path.exists(_cache_file(_pred_dir(save_dir, offset), dataset, path_of(idx)))
                   for offset, path_of in _layouts(dataset))
    ]


def load_predictions(save_dir, dataset, max_do=-1):
    """The cache as {img_path: [[cls, score, x1..y2]]} (with mult_out a
    list of them, one a window offset); None if a file is missing."""
    out = []
    for offset, path_of in _layouts(dataset):
        boxes = _load_predictions_dict(_pred_dir(save_dir, offset), dataset, path_of, max_do)
        if boxes is None:
            return None
        if offset is None:
            return boxes
        out.append(boxes)
    return out


def _load_predictions_dict(out_dir, dataset, path_of, max_do):
    if not os.path.exists(out_dir):
        return None
    if max_do < 0:
        max_do = len(dataset)
    boxes = {}
    for idx in range(min(len(dataset), max_do)):
        path = _cache_file(out_dir, dataset, path_of(idx))
        if not os.path.exists(path):
            logging.info("prediction file missing: %s", path)
            return None
        with open(path) as f:
            for line in f:
                parts = line.rstrip().split(",")
                if len(parts) < 7:
                    continue
                boxes.setdefault(parts[0], []).append([int(parts[1])] + [float(p) for p in parts[2:7]])
    return boxes


def get_class_map(trained_on, eval_on):
    """Each class of `eval_on` as the id of the same WordNet id in
    `trained_on`, -1 where it has none (detect_yolo3.py:692-697)."""
    toc = list(trained_on.wn_classes)
    return [toc.index(c) if c in toc else -1 for c in eval_on.wn_classes]


def hierarchical_nms(predictions, dataset, ov_thresh=0.5, conf_thresh=0.0, level_thresh=10):
    """Merge each image's detections along the class tree's branches
    (detect_yolo3.py:699-745), on the host: the boxes in order of falling
    class id; a class deeper than `level_thresh` is lifted to its ancestor
    at that level; a box whose best overlap (IoU above `ov_thresh`, the +1
    convention on the normalised coordinates, as the JAX package computes
    it) with a kept box is off that box's branch is kept, on the same class
    raises its score, and on another class of the branch is dropped.
    The branch table is built once a call."""
    levels = dataset.get_levels()
    wn = list(dataset.wn_classes)
    index = {w: i for i, w in enumerate(wn)}
    up = [index.get(dataset.parents[w]) for w in wn]  # the parent's id; None under ROOT
    n = len(wn)
    on_branch = [[dataset.on_branch(i, j) for j in range(n)] for i in range(n)]
    level_thresh = max(0, level_thresh)
    out = {}
    for img_path, boxes in predictions.items():
        kept = []
        for box in sorted(boxes, key=lambda x: x[0], reverse=True):
            cls, conf, coords = int(box[0]), box[1], box[2:]
            if conf < conf_thresh:
                continue
            while levels[cls] > level_thresh:
                if up[cls] is None:
                    raise ValueError(f"--hier_level {level_thresh} lifts {wn[cls]} above the tree's root")
                cls = up[cls]
            best_ov, best_idx = 0.0, -1
            for i, kb in enumerate(kept):
                ov = _iou_plus1(coords, kb[2:])
                if ov > ov_thresh and ov > best_ov:
                    best_ov, best_idx = ov, i
            if best_idx == -1 or not on_branch[cls][kept[best_idx][0]]:
                kept.append([cls, conf] + list(coords))
            elif cls == kept[best_idx][0]:
                kept[best_idx][1] = max(kept[best_idx][1], conf)
        out[img_path] = kept
    return out


def _iou_plus1(a, b) -> float:
    """One pair's IoU with +1 on every side, in the float64 operations of
    ops/bbox.np_bbox_iou(offset=1)."""
    a0, a1, a2, a3 = (float(v) for v in a[:4])
    b0, b1, b2, b3 = (float(v) for v in b[:4])
    tl0, tl1, br0, br1 = max(a0, b0), max(a1, b1), min(a2, b2), min(a3, b3)
    area_i = (br0 - tl0 + 1) * (br1 - tl1 + 1) * float(tl0 < br0 and tl1 < br1)
    area_a = (a2 - a0 + 1) * (a3 - a1 + 1)
    area_b = (b2 - b0 + 1) * (b3 - b1 + 1)
    return area_i / (area_a + area_b - area_i)


def get_metric(dataset, metric_name: str, save_dir: str, agnostic: bool = False, offset=None, class_map=None):
    """`--metrics` -> a metric (detect_yolo3.py:890-917); `offset` the
    window offset the VID metric scores with mult_out; `class_map` the
    evaluated classes' ids in the model's (--trained_on)."""
    if metric_name == "voc":
        return VOCMApMetric(iou_thresh=0.5, class_names=dataset.classes, class_map=class_map)
    if metric_name == "coco":
        return COCODetectionMetric(dataset, os.path.join(save_dir, "coco_eval"), cleanup=True)
    if metric_name == "vid":
        return VIDDetectionMetric(dataset, class_map=class_map, agnostic=agnostic, offset=offset)
    raise ValueError(f"unknown metric {metric_name!r}")


def evaluate(metrics, dataset, predictions, offset=0):
    """Update the metrics from the normalised predictions, with each
    image's sample id (detect_yolo3.py:920-952).  Each image's size comes
    from its JPEG header (the JAX package decodes the image for it: the
    same numbers).  For a window, detect_yolo3.py reads the size from the
    first two axes of the stacked (k, H, W, 3) frames, (h, w) = (k, H): its
    fault, mirrored so that both packages score alike (ROADMAP.md Queue 3).
    With mult_out the window's frame at `offset` from the middle is scored,
    with its own id, label and size (there the JAX CLI takes the frame's
    shape, right)."""
    sample_ids = (
        dataset.get_sample_ids() if hasattr(dataset, "get_sample_ids") else dataset.sample_ids
    ) if hasattr(dataset, "sample_ids") else list(range(len(dataset)))
    mult_out = getattr(dataset, "mult_out", False)
    k = getattr(dataset, "window", (1, 1))[0]
    for idx in range(len(dataset)):
        img_path, sid, y = dataset.sample_path(idx), sample_ids[idx], dataset.label_and_size(idx)[0]
        if mult_out:
            img_path, sid, y = img_path[offset + 2], sid[offset + 2], y[offset + 2]
        h, w = native.image_size(img_path)
        if k > 1 and not mult_out:
            h, w = k, h
        preds = np.asarray(predictions.get(img_path, np.zeros((0, 6))), dtype=np.float64).reshape(-1, 6)
        det_bboxes = preds[None, :, 2:6] * np.array([w, h, w, h])
        gt_difficults = y[None, :, 5:6] if y.shape[-1] > 5 else None
        for metric in metrics:
            metric.update(det_bboxes, preds[None, :, 0:1], preds[None, :, 1:2], y[None, :, :4], y[None, :, 4:5],
                          gt_difficults, sid=sid)
    return [m.get() for m in metrics]


def load_model_variables(path: str, cfg: YoloConfig):
    """A checkpoint's variables in the standard layout of `cfg`'s model
    (Detector refolds a 3-channel stem for pad_stem)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    template = variables_of(build_model(dataclasses.replace(cfg, pad_stem=False, s2d_stem=False, dtype=None)))
    return load_detector_params(path, template)


def detect_dataset(det: Detector, dataset, loader, max_do=-1):
    """The detect step over the loader's batches (the tail batch kept);
    returns {img_path: [[cls, score, x1..y2 normalised]]}, or with mult_out
    a list of them, one a window offset, each frame of a window under its
    own path (a frame clamped onto the key frame at a video's end is
    skipped, as detect_yolo3.py:240-242 skips it)."""
    shape = det.data_shape
    mult_out = getattr(dataset, "mult_out", False)
    boxes_out = [{} for _ in range(dataset.window[0])] if mult_out else {}
    if max_do < 0:
        max_do = len(dataset)
    done = 0
    for batch in device_prefetch(iter(loader), det.device, size=2, keys=("image",)):
        ids, sc, bb = (a.cpu().numpy() for a in det(batch["image"]))
        for i in range(ids.shape[0]):
            if done >= max_do:
                break
            sidx = int(batch["idx"][i])
            if mult_out:
                files = dataset.window_paths(sidx)
                for off, file in enumerate(files):
                    if off != 2 and file == files[2]:
                        continue
                    collect_boxes(boxes_out[off], file, ids[i, off], sc[i, off], bb[i, off], shape)
            else:
                collect_boxes(boxes_out, dataset.sample_path(sidx), ids[i], sc[i], bb[i], shape)
            done += 1
        if done >= max_do:
            break
    return boxes_out


def detect_stream(stream: StreamingDetector, dataset, loader, shape: int, anchor: str = "trail", max_do=-1):
    """Streaming detection over the loader's frames (batch 1, in the
    dataset's order; detect_yolo3.py:400-461): a stream resets where the
    directory of the frame's path changes, and each frame gets the
    detections of the window ending at it or centred on it (`anchor`),
    boxes clipped to the image; a t_out model's the anchor frame's offset
    (-1 for trail, k//2 for center).  Returns {img_path: [[cls, score,
    x1..y2 normalised]]}."""
    t_off = -1 if anchor == "trail" else stream.k // 2
    boxes_out = {}
    if max_do < 0:
        max_do = len(dataset)
    done = 0

    def path_frame_pairs():
        for batch in device_prefetch(iter(loader), stream.device, size=2, keys=("image",)):
            yield dataset.sample_path(int(batch["idx"][0])), batch["image"]

    for _, group in itertools.groupby(path_frame_pairs(), key=lambda pf: os.path.dirname(pf[0])):
        if done >= max_do:
            break
        paths = []

        def frames():
            for p, img in group:
                paths.append(p)
                yield img

        for m, dets in stream_frames(stream, frames(), anchor=anchor):
            if done >= max_do:
                break
            ids, sc, bb = (a[0].cpu().numpy() for a in dets)
            if ids.ndim == 3:  # t_out (T, P, 1): the anchor frame's offset
                ids, sc, bb = ids[t_off], sc[t_off], bb[t_off]
            collect_boxes(boxes_out, paths[m], ids, sc, bb.clip(0, shape), shape)
            done += 1
    return boxes_out


def dataset_config(args, num_classes: int) -> YoloConfig:
    """The dataset path's model (detect_yolo3.py:270-301): YOLOv3 with the
    standard stem, YOLOv3T with the temporal flags under --window k > 1,
    YOLOv3Temporal with --temp or --mult_out, or YOLOv3T over Darknet3D or
    HDarknet with --new_model, or over the two-stream backbone with
    --motion_stream."""
    k = int(args.window.split(",")[0])
    if k <= 1 and not (args.temp or args.mult_out or args.new_model or args.motion_stream):
        return YoloConfig(num_classes=num_classes)
    return YoloConfig(num_classes=num_classes, k=k if k > 1 else None, k_join_type=args.k_join_type,
                      k_join_pos=args.k_join_pos, block_conv_type=args.block_conv_type, rnn_pos=args.rnn_pos,
                      corr_pos=args.corr_pos,
                      corr_d=args.corr_d if args.corr_pos else None, temporal=args.temp, t_out=args.mult_out,
                      **backbone_kwargs(args))


def main_dataset(args):
    """detect_yolo3.py's main on a dataset: detect (or read the cache),
    write the cache, evaluate.  Returns the predictions."""
    window = tuple(([int(w) for w in args.window.split(",")] + [1])[:2])
    name = args.dataset.split(",")[0]
    if args.stream:
        check_stream_args(args, window)
    elif window[0] > 1 and name not in ("vid", "yt"):
        raise ValueError("--window k > 1 needs a video dataset (detect_yolo3.py:960-963): --dataset vid or yt, "
                         "or --stream")
    if args.mult_out and name != "vid" and not args.stream:
        raise ValueError("--mult_out scores each frame of a window by its own labels, which only the vid dataset "
                         "gives (YouTube-BB's windows carry the key frame's)")
    # --stream reads single frames in order: the dataset's frames, not its
    # windows (detect_yolo3.py:178-198); --mult_out then picks the model's
    # per-frame heads, not the cache's layout
    data_window = (1, 1) if args.stream else window
    dataset = get_dataset(args.dataset.split(","), args.dataset_root, args.every, data_window,
                          args.mult_out and not args.stream, args.hier_level)
    trained_on = dataset
    if args.trained_on:
        trained_on = get_dataset([args.trained_on], args.dataset_root, args.every, hier_level=args.hier_level)
    classes = trained_on.classes or ["object"]
    class_map = get_class_map(trained_on, dataset) if args.trained_on else None
    save_dir = os.path.join(args.save_dir, args.save_prefix)
    os.makedirs(save_dir, exist_ok=True)
    predictions = load_predictions(save_dir, dataset, args.max_do)
    if predictions is None:
        indices = None
        if args.skip_existing:
            indices = _missing_indices(save_dir, dataset, args.max_do) or None
            logging.info("resuming detect: %d samples still to run", len(indices or ()))
        s = args.data_shape
        route = (dict(inference_transform=YOLO3VideoInferenceTransform(s, s)) if data_window[0] > 1
                 else dict(native_decode=(s, s)))
        loader = DetectionLoader(
            dataset, batch_size=1 if args.stream else args.batch_size, num_workers=args.num_workers, **route,
            sampler=None if indices is None else (lambda epoch: np.asarray(indices, np.int64)),
            num_samples=None if indices is None else len(indices),
        )
        cfg = dataset_config(args, len(classes))  # the standard stem, as detect_yolo3.py's default
        variables = None
        if args.model_path:
            variables = load_model_variables(args.model_path, cfg)
            logging.info("loaded params from %s", args.model_path)
        else:
            logging.warning("no --model_path: seeded random weights")
        n = len(indices) if indices is not None else min(len(dataset), args.max_do if args.max_do >= 0 else len(dataset))
        if args.stream:
            stream = StreamingDetector(
                Detector(cfg, variables, dtype=DTYPES[args.dtype], device=args.device, seed=args.seed).model)
            t0 = time.perf_counter()
            boxes = detect_stream(stream, dataset, loader, args.data_shape, args.stream_anchor, args.max_do)
            secs = time.perf_counter() - t0
            print(f"streamed {n} frames (windows of {window[0]}, {stream.split} split, {args.stream_anchor}) at "
                  f"{args.data_shape} px on {stream.device} in {secs:.3f} s ({n / max(secs, 1e-9):.1f} frames/s "
                  "from JPEG on disk)", flush=True)
        else:
            det = Detector(cfg, variables, dtype=DTYPES[args.dtype], data_shape=args.data_shape,
                           device=args.device, seed=args.seed)
            t0 = time.perf_counter()
            boxes = detect_dataset(det, dataset, loader, args.max_do)
            secs = time.perf_counter() - t0
            name = f"windows of {window[0]} frames" if window[0] > 1 else "images"
            print(f"detected {n} {name} at {args.data_shape} px on {det.device} in {secs:.3f} s "
                  f"({n / max(secs, 1e-9):.1f} {name.split()[0]}/s from JPEG on disk)", flush=True)
        save_predictions(save_dir, dataset, boxes, args.max_do, indices=indices)
        predictions = load_predictions(save_dir, dataset, args.max_do) if indices is not None else boxes
        if predictions is None:
            raise RuntimeError(f"the prediction cache under {save_dir} is still incomplete")
    else:
        print(f"read {len(dataset)} images' predictions from the cache under {save_dir}; no detect step",
              flush=True)
    mult_out = getattr(dataset, "mult_out", False)
    eval_predictions = predictions[args.offset + 2] if mult_out else predictions
    if getattr(dataset, "name", "") == "comb" and getattr(dataset, "parents", None):
        t0 = time.perf_counter()
        eval_predictions = hierarchical_nms(eval_predictions, dataset, level_thresh=args.hier_level)
        print(f"hierarchical NMS over {len(eval_predictions)} images ({len(dataset.classes)} classes) in "
              f"{time.perf_counter() - t0:.3f} s on the host", flush=True)
    if dataset.classes:
        metrics = [get_metric(dataset, m, save_dir, args.metric_agnostic, args.offset if mult_out else None,
                              class_map) for m in args.metrics.split(",")]
        results = evaluate(metrics, dataset, eval_predictions, args.offset)
        for metric_name, (names, values) in zip(args.metrics.split(","), results):
            path = os.path.join(save_dir, f"{metric_name}.txt")
            with open(path, "w") as f:
                for n_, v in zip(names, values):
                    f.write(f"{n_}: {v}\n")
            print(f"{metric_name} mAP {values[-1]} written to {path}", flush=True)
    else:
        print(f"no labels: wrote predictions for {len(eval_predictions)} images", flush=True)
    return predictions


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
