"""Detect entry point: answers a few requests of seeded synthetic images.

    python -m videoyolo_torch.detect --data_shape 416 --batch_size 128 \
        --num_requests 3 --seed 0 [--device cpu] [--dtype f32|bf16] [--out preds.json]
    python -m videoyolo_torch.detect --data_shape 416 --batch_size 32 \
        --window 3,1 --k_join_pos late --corr_pos early --corr_d 4   # YOLOv3T windows
    python -m videoyolo_torch.detect --data_shape 416 --batch_size 128 --quantize int8

The model takes seeded random weights.  Each request is a batch of uint8
images drawn from the seed or, with `--window k[,stride]` and k > 1, a batch
of k-frame windows: window i takes every stride-th frame from frame i of a
seeded synthetic clip, so neighbouring windows share frames as they do in a
video.  The temporal flags are those of detect_yolo3.py (`--corr_d` counts
only with `--corr_pos`).  `--quantize int8` serves the fused-int8 YOLOv3,
calibrated on the first two request batches as detect_yolo3.py calibrates on
the first two loader batches.  The command prints one summary line per request
and, with --out, writes the detections as {image or window name: [[cls,
score, x1, y1, x2, y2], ...]} with normalised boxes.  Reading an image
directory is deferred (see ROADMAP.md).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .models.factory import YoloConfig
from .serving import Detector, collect_boxes

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
    p.add_argument("--corr_pos", default=None, help="position of the correlation: early or late")
    p.add_argument("--corr_d", type=int, default=4, help="the d of the correlation")
    p.add_argument("--quantize", default=None, choices=["int8", "int8_static", "int8_dynamic"],
                   help="int8 serving: the fused int8-end-to-end YOLOv3")
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
    k, stride = ([int(w) for w in args.window.split(",")] + [1])[:2]
    temporal = k > 1
    cfg = YoloConfig(
        num_classes=NUM_CLASSES, pad_stem=True,
        k=k if temporal else None,
        k_join_type=args.k_join_type, k_join_pos=args.k_join_pos, corr_pos=args.corr_pos,
        corr_d=args.corr_d if args.corr_pos else None,
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
            collect_boxes(preds, f"request{r}/{name}{i:04d}", ids[i], sc[i], bb[i], s)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(preds, f)
    return preds


if __name__ == "__main__":
    main()
