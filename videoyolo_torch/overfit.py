"""Training-correctness evidence: overfit a tiny synthetic set, the twin of
`tools/overfit_check.py --configs yolov3`, `k3` and `t5`.

    python -m videoyolo_torch.overfit --out record.json [--config yolov3|k3|t5] [--device cpu] \
        [--dtype bf16|f32] [--steps 400] [--batch_size 8] [--data_shape 160] \
        [--seed 0] [--save_prefix PREFIX]

`yolov3`: YOLOv3(num_classes=3, bf16) from the port's seeded init trains
on 8 images (one solid color patch on noise, one box each, `synth_set`).
`k3`: YOLOv3T(num_classes=3, k=3, the late max join, bf16) trains on the
same kind of set drawn from seed + 1 (the JAX tool's seed 1), each image
repeated into a static 3-frame window, one loss a window.  `t5`:
YOLOv3Temporal(num_classes=3, t=5, t_out, the correlation pyramid at
corr_d=2, bf16) on a set drawn from seed + 2, each image repeated into a
static 5-frame window with its gt repeated for every frame (per-timestep
heads and loss); the recovery is checked on the middle frame's detections.
Each runs the
whole train step: the forward, the targets on the device, the loss, the
backward pass, SGD and the BN statistics, with lr_schedule("cosine", 5e-4,
one epoch of `steps` steps, warmup 0.1 epoch).  Then the eval step (K1's
NMS on the card) must recover each image's box and class.  The record has
the JAX tool's fields (loss_first, loss_last, mean_top1_iou,
top1_class_acc, top1_scores, pass) and its rule: mean top-1 IoU >= 0.9,
every class right, and the last loss below 5% of the first.  It also names
the device and gives the host-timed ms a step.  `--save_prefix` writes the
trained variables through `save_params` as `<prefix>_0000.params`.

The run is on the card unless `--device cpu` is given.  The exit code is 0
when the record passes, else 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .device import resolve_device
from .models.layers import init_weights
from .models.yolo3 import YOLOv3
from .models.yolo3_temporal import YOLOv3T, YOLOv3Temporal
from .train.checkpoint import save_params, variables_of
from .train.lr import lr_schedule
from .train.step import create_train_state, make_eval_step, make_train_step

NUM_CLASSES = 3
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# each config's model, the offset of its data seed and its frames a window
# (tools/overfit_check.py:123-183: cfg_yolov3 draws synth_set from seed 0,
# cfg_k3 from seed 1, cfg_t5 from seed 2)
CONFIGS = {
    "yolov3": (lambda dtype: YOLOv3(num_classes=NUM_CLASSES, dtype=dtype), 0, 1),
    "k3": (lambda dtype: YOLOv3T(num_classes=NUM_CLASSES, k=3, k_join_type="max", k_join_pos="late", dtype=dtype),
           1, 3),
    "t5": (lambda dtype: YOLOv3Temporal(num_classes=NUM_CLASSES, t=5, t_out=True, corr_d=2, dtype=dtype), 2, 5),
}
# distinguishable solid patch colors (up to 4 classes)
_COLORS = [[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9], [0.9, 0.9, 0.1]]


def synth_set(num_classes: int, seed: int = 0, batch: int = 8, size: int = 160):
    """`batch` images: one solid color patch on noise, one box each (the
    draws of tools/overfit_check.py:synth_set, which has batch 8, size 160).
    Returns (images (B, S, S, 3) float32, gt boxes (B, 8, 4), gt ids (B, 8, 1))."""
    rs = np.random.RandomState(seed)
    images = rs.rand(batch, size, size, 3).astype(np.float32) * 0.3
    gtb = np.full((batch, 8, 4), -1, np.float32)
    gti = np.full((batch, 8, 1), -1, np.float32)
    for i in range(batch):
        x1, y1 = rs.randint(10, 60), rs.randint(10, 60)
        w, h = rs.randint(40, 80), rs.randint(40, 80)
        x2, y2 = min(x1 + w, size - 1), min(y1 + h, size - 1)
        cls = i % num_classes
        images[i, y1:y2, x1:x2] = _COLORS[cls]
        gtb[i, 0] = [x1, y1, x2, y2]
        gti[i, 0, 0] = cls
    return images, gtb, gti


def iou(a, b) -> float:
    tl = np.maximum(a[:2], b[:2])
    br = np.minimum(a[2:], b[2:])
    wh = np.maximum(br - tl, 0)
    inter = wh[0] * wh[1]
    area = lambda x: (x[2] - x[0]) * (x[3] - x[1])  # noqa: E731
    return float(inter / max(area(a) + area(b) - inter, 1e-9))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True, help="path of the JSON record")
    p.add_argument("--config", choices=sorted(CONFIGS), default="yolov3")
    p.add_argument("--device", default=None, help="default: cuda (raises without a GPU)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--data_shape", type=int, default=160)
    p.add_argument("--seed", type=int, default=0, help="seeds the data and the init")
    p.add_argument("--save_prefix", default=None, help="write <prefix>_0000.params at the end")
    return p.parse_args(argv)


def run(args):
    """Train and evaluate as the module docstring says; returns (the record,
    the trained model)."""
    dev = resolve_device(args.device)
    build, data_seed, frames = CONFIGS[args.config]
    images, gtb, gti = synth_set(NUM_CLASSES, args.seed + data_seed, args.batch_size, args.data_shape)
    gt = (gtb, gti)
    if frames > 1:
        images = np.repeat(images[:, None], frames, axis=1)  # a static clip a sample
    if args.config == "t5":  # per-timestep gt (B, T, M, .): the mult_out contract
        gt = tuple(np.repeat(a[:, None], frames, axis=1) for a in gt)
    model = build(DTYPES[args.dtype])
    init_weights(model, torch.Generator().manual_seed(args.seed))
    model.to(dev, memory_format=torch.channels_last)
    lr_fn = lr_schedule("cosine", 5e-4, steps_per_epoch=args.steps, epochs=1, warmup_epochs=0.1)
    state = create_train_state(model, lr_fn)
    step = make_train_step(model, num_classes=NUM_CLASSES)
    batch = {"image": torch.from_numpy(images).to(dev), "gt_boxes": torch.from_numpy(gt[0]).to(dev),
             "gt_ids": torch.from_numpy(gt[1]).to(dev)}
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        metrics = step(state, batch)
        if i % 50 == 0 or i == args.steps - 1:
            losses.append(float(metrics["total"]))
            print(f"[{args.config}] step {i}: loss {losses[-1]:.2f}", flush=True)
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    ids, scores, boxes = (t.cpu().numpy() for t in make_eval_step(model)(batch["image"]))
    if ids.ndim == 4:  # per-timestep detections: the middle frame's
        ids, scores, boxes = ids[:, frames // 2], scores[:, frames // 2], boxes[:, frames // 2]
    ious = [iou(boxes[i, 0], gtb[i, 0]) for i in range(args.batch_size)]
    cls_ok = [int(ids[i, 0, 0]) == i % NUM_CLASSES for i in range(args.batch_size)]
    rec = {
        "config": args.config,
        "loss_first": losses[0],
        "loss_last": losses[-1],
        "mean_top1_iou": float(np.mean(ious)),
        "top1_class_acc": float(np.mean(cls_ok)),
        "top1_scores": [float(scores[i, 0, 0]) for i in range(args.batch_size)],
        "pass": bool(np.mean(ious) >= 0.9 and all(cls_ok) and losses[-1] < losses[0] * 0.05),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dtype": args.dtype, "steps": args.steps, "batch_size": args.batch_size,
        "data_shape": args.data_shape, "seed": args.seed,
        "step_ms": step_ms,  # host clock over the loop, the loss reads included
    }
    if args.save_prefix:
        save_params(args.save_prefix, variables_of(model), 0.0, 0.0, epoch=0, save_interval=1)
        rec["checkpoint"] = f"{args.save_prefix}_0000.params"
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    os.replace(tmp, args.out)
    print(json.dumps(rec), flush=True)
    return rec, model


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))[0]["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
