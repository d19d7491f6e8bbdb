"""Detect entry point: answers a few requests of seeded synthetic images.

    python -m videoyolo_torch.detect --data_shape 416 --batch_size 128 \
        --num_requests 3 --seed 0 [--device cpu] [--dtype bf16|f32] [--out preds.json]

The model takes seeded random weights.  Each request is a batch of uint8
images drawn from the seed; the command prints one summary line per request
and, with --out, writes the detections as {image name: [[cls, score, x1, y1,
x2, y2], ...]} with normalised boxes.  Reading an image directory is deferred
(see ROADMAP.md).
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
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    p.add_argument("--out", default=None, help="write the detections as JSON")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    det = Detector(
        YoloConfig(num_classes=NUM_CLASSES, pad_stem=True),
        dtype=DTYPES[args.dtype], data_shape=args.data_shape,
        device=args.device, seed=args.seed,
    )
    rs = np.random.RandomState(args.seed)
    s = args.data_shape
    preds = {}
    for r in range(args.num_requests):
        images = rs.randint(0, 256, (args.batch_size, s, s, 3)).astype(np.uint8)
        t0 = time.perf_counter()
        ids, sc, bb = (a.cpu().numpy() for a in det(images))
        ms = (time.perf_counter() - t0) * 1e3
        n_det = int((ids >= 0).sum())
        print(
            f"request {r}: batch {args.batch_size} at {s} px on {det.device}: "
            f"{n_det} detections ({n_det / args.batch_size:.1f}/image), {ms:.1f} ms"
        )
        for i in range(args.batch_size):
            collect_boxes(preds, f"request{r}/image{i:04d}", ids[i], sc[i], bb[i], s)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(preds, f)
    return preds


if __name__ == "__main__":
    main()
