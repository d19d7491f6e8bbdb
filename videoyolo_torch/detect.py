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

With `--dataset`, detect_yolo3.py's dataset path on its validation splits:
`voc` is VOC 2007 test under `<dataset_root>/PascalVOC/VOCdevkit`, `coco`
COCO's instances_val2017 under `<dataset_root>/MSCoco` (images without
boxes kept), `det` ImageNet-DET val under `<dataset_root>/ImageNetDET/ILSVRC`
and `vid` the frames of ImageNet-VID val under
`<dataset_root>/ImageNetVID/ILSVRC`, every `--every`th of each video;
anything else is a list of JPEG files, directories of them and `.txt`
lists of paths.  The JPEG core (native.py) decodes and resizes the images
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
without their classes).
`--model_path` takes the JAX package's flax msgpack or an MXNet `.params`
file (the reference's gluon checkpoints); without it the weights are
seeded random, with a warning.
With `--window k[,step]` and k > 1 on `vid`, each sample is the window of
k frames around a val frame (the VID window sampler) and the model is
YOLOv3T with the temporal flags (`--k_join_type`, `--k_join_pos`,
`--block_conv_type` '2', `--corr_pos`, `--corr_d`, read only with
`--corr_pos`, as detect_yolo3.py reads them).  The windows take the JAX
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

Without `--dataset`, the seeded synthetic mode:

    python -m videoyolo_torch.detect --data_shape 416 --batch_size 128 \
        --num_requests 3 --seed 0 [--device cpu] [--dtype f32|bf16] [--out preds.json]
    python -m videoyolo_torch.detect --data_shape 416 --batch_size 32 \
        --window 3,1 --k_join_pos late --corr_pos early --corr_d 4   # YOLOv3T windows
    python -m videoyolo_torch.detect --data_shape 416 --batch_size 16 \
        --window 5,1 --temp --mult_out --corr_pos early --corr_d 4   # YOLOv3Temporal windows
    python -m videoyolo_torch.detect --data_shape 416 --batch_size 128 --quantize int8

The model takes seeded random weights.  Each request is a batch of uint8
images drawn from the seed or, with `--window k[,stride]` and k > 1, a batch
of k-frame windows: window i takes every stride-th frame from frame i of a
seeded synthetic clip, so neighbouring windows share frames as they do in a
video.  The temporal flags are those of detect_yolo3.py (`--corr_d` counts
only with `--corr_pos`; `--temp` and `--mult_out` as above, a window's
frames named `<window>_o<t>` with `--mult_out`).  `--quantize int8` serves
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
import json
import logging
import os
import time

import numpy as np
import torch

from . import native
from .data.base import check_jpeg
from .data.detectset import DetectSet
from .data.imgnetdet import ImageNetDetection
from .data.imgnetvid import ImageNetVidDetection
from .data.loader import DetectionLoader
from .data.mscoco import COCODetection
from .data.pascalvoc import VOCDetection
from .data.prefetch import device_prefetch
from .data.transforms import YOLO3VideoInferenceTransform
from .metrics.imgnetvid import VIDDetectionMetric
from .metrics.mscoco import COCODetectionMetric
from .metrics.pascalvoc import VOCMApMetric
from .models.factory import YoloConfig, build_model
from .serving import Detector, collect_boxes
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
    p.add_argument("--block_conv_type", default="2", help="conv type of the YOLO blocks: 2 (3 and 21: item 6)")
    p.add_argument("--corr_pos", default=None, help="position of the correlation: early or late")
    p.add_argument("--corr_d", type=int, default=4, help="the d of the correlation")
    p.add_argument("--temp", action="store_true", help="the t=5 temporal model (YOLOv3Temporal)")
    p.add_argument("--mult_out", action="store_true", help="one output a frame of the window (t_out)")
    p.add_argument("--offset", type=int, default=0, help="with --mult_out, the window offset to evaluate: -2..2")
    p.add_argument("--quantize", default=None, choices=["int8", "int8_static", "int8_dynamic"],
                   help="int8 serving: the fused int8-end-to-end YOLOv3")
    # the dataset path (detect_yolo3.py's flags)
    p.add_argument("--dataset", default=None,
                   help="voc, coco, det or vid, or comma-separated JPEG files, directories and .txt lists")
    p.add_argument("--dataset_root", default="datasets", help="root directory holding the datasets")
    p.add_argument("--save_dir", default="results", help="directory of the prediction cache and metrics")
    p.add_argument("--save_prefix", default="0001", help="subdirectory of --save_dir")
    p.add_argument("--metrics", default="voc", help="comma-separated metrics: voc, coco, vid")
    p.add_argument("--metric_agnostic", action="store_true", help="the vid metric without the classes")
    p.add_argument("--every", type=float, default=25, help="vid: every this many frames")
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


def main(argv=None):
    args = parse_args(argv)
    if args.dataset:
        return main_dataset(args)
    k, stride = ([int(w) for w in args.window.split(",")] + [1])[:2]
    if k == 1 and (args.temp or args.mult_out):
        k = 5  # YOLOv3Temporal's default t
    temporal = k > 1
    cfg = YoloConfig(
        num_classes=NUM_CLASSES, pad_stem=True,
        k=k if temporal else None,
        k_join_type=args.k_join_type, k_join_pos=args.k_join_pos, corr_pos=args.corr_pos,
        corr_d=args.corr_d if args.corr_pos else None, temporal=args.temp, t_out=args.mult_out,
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


# --------------------------------------------------------------------------
# the dataset path (detect_yolo3.py:145-269, 552-690, 890-1150)
# --------------------------------------------------------------------------

_ITEMS = {"comb": "2c", "yt": "2d"}


def get_dataset(names, dataset_root: str, every: float = 25, window=(1, 1), mult_out: bool = False):
    """`--dataset` -> an inference dataset (detect_yolo3.py:145-192): the
    validation split of voc, coco, det or vid (frames, every `every`th, or
    their `window`s, labelled a frame with `mult_out`), or JPEG files,
    directories and `.txt` lists."""
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
    if names[0] in _ITEMS:
        raise NotImplementedError(f"the {names[0]} dataset: see ROADMAP.md Queue 1 item {_ITEMS[names[0]]}")
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


def get_metric(dataset, metric_name: str, save_dir: str, agnostic: bool = False, offset=None):
    """`--metrics` -> a metric (detect_yolo3.py:890-917); `offset` the
    window offset the VID metric scores with mult_out."""
    if metric_name == "voc":
        return VOCMApMetric(iou_thresh=0.5, class_names=dataset.classes)
    if metric_name == "coco":
        return COCODetectionMetric(dataset, os.path.join(save_dir, "coco_eval"), cleanup=True)
    if metric_name == "vid":
        return VIDDetectionMetric(dataset, agnostic=agnostic, offset=offset)
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


def dataset_config(args, num_classes: int) -> YoloConfig:
    """The dataset path's model (detect_yolo3.py:270-301): YOLOv3 with the
    standard stem, YOLOv3T with the temporal flags under --window k > 1, or
    YOLOv3Temporal with --temp or --mult_out."""
    k = int(args.window.split(",")[0])
    if k <= 1 and not (args.temp or args.mult_out):
        return YoloConfig(num_classes=num_classes)
    return YoloConfig(num_classes=num_classes, k=k if k > 1 else None, k_join_type=args.k_join_type,
                      k_join_pos=args.k_join_pos, block_conv_type=args.block_conv_type, corr_pos=args.corr_pos,
                      corr_d=args.corr_d if args.corr_pos else None, temporal=args.temp, t_out=args.mult_out)


def main_dataset(args):
    """detect_yolo3.py's main on a dataset: detect (or read the cache),
    write the cache, evaluate.  Returns the predictions."""
    window = tuple(([int(w) for w in args.window.split(",")] + [1])[:2])
    if window[0] > 1 and args.dataset.split(",")[0] != "vid":
        raise ValueError("--window k > 1 needs a video dataset (detect_yolo3.py:960-963): --dataset vid")
    if args.mult_out and args.dataset.split(",")[0] != "vid":
        raise NotImplementedError("--mult_out on datasets other than vid (YouTube-BB: ROADMAP.md Queue 1 item 2d)")
    dataset = get_dataset(args.dataset.split(","), args.dataset_root, args.every, window, args.mult_out)
    classes = dataset.classes or ["object"]
    save_dir = os.path.join(args.save_dir, args.save_prefix)
    os.makedirs(save_dir, exist_ok=True)
    predictions = load_predictions(save_dir, dataset, args.max_do)
    if predictions is None:
        indices = None
        if args.skip_existing:
            indices = _missing_indices(save_dir, dataset, args.max_do) or None
            logging.info("resuming detect: %d samples still to run", len(indices or ()))
        s = args.data_shape
        route = (dict(inference_transform=YOLO3VideoInferenceTransform(s, s)) if window[0] > 1
                 else dict(native_decode=(s, s)))
        loader = DetectionLoader(
            dataset, batch_size=args.batch_size, num_workers=args.num_workers, **route,
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
        det = Detector(cfg, variables, dtype=DTYPES[args.dtype], data_shape=args.data_shape,
                       device=args.device, seed=args.seed)
        t0 = time.perf_counter()
        boxes = detect_dataset(det, dataset, loader, args.max_do)
        secs = time.perf_counter() - t0
        n = len(indices) if indices is not None else min(len(dataset), args.max_do if args.max_do >= 0 else len(dataset))
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
    if dataset.classes:
        metrics = [get_metric(dataset, m, save_dir, args.metric_agnostic, args.offset if mult_out else None)
                   for m in args.metrics.split(",")]
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
