"""Train entry point (the twin of train_yolov3.py) on VOC, COCO,
ImageNet-DET, ImageNet-VID and YouTube-BB frames or windows from disk, or
on any of them combined through the WordNet class tree.

    python -m videoyolo_torch.train_yolov3 --dataset voc|coco|det|vid|yt --dataset_root datasets \
        --batch_size 64 --epochs 200 [--dtype bf16|f32] [--no_random_shape] \
        [--mixup [--no_mixup_epochs 20]] [--host_color] [--allow_empty | --noallow_empty] \
        [--every 25] [--syncbn] \
        [--nopretrained_cnn | --pretrained_base_path darknet53.params] \
        [--resume P | --start_epoch -1] [--device cpu] ...
    torchrun --nproc_per_node 4 -m videoyolo_torch.train_yolov3 --syncbn ...   # data-parallel, a card a rank
    python -m videoyolo_torch.train_yolov3 --dataset vid --window 3,1 --k_join_pos late \
        --corr_pos early --corr_d 4 --nopretrained_cnn --batch_size 16 ...   # YOLOv3T on windows
    python -m videoyolo_torch.train_yolov3 --dataset vid --window 5,1 --temp --mult_out \
        --corr_pos early --corr_d 4 --nopretrained_cnn --batch_size 8 ...   # YOLOv3Temporal, t_out
    python -m videoyolo_torch.train_yolov3 --dataset vid --window 5,1 --new_model \
        --conv_types 2,3,3,2,2,2 --pretrained_base_path darknet53.params ...   # Darknet3D, inflated
    python -m videoyolo_torch.train_yolov3 --dataset vid --window 9,1 --new_model --hier 3,3,1,1,1 \
        --h_join_type max ...   # HDarknet
    python -m videoyolo_torch.train_yolov3 --dataset vid --window 3,1 --motion_stream flownet \
        --stream_gating add --data_shape 384 --no_random_shape --nopretrained_cnn ...   # two-stream
    python -m videoyolo_torch.train_yolov3 --dataset comb ...   # voc,coco,det,vid on the class tree
    python -m videoyolo_torch.train_yolov3 --dataset voc,coco,det,vid,yt ...   # any list, the same way

YOLOv3 / Darknet-53 on the dataset's train split (VOC 2007 + 2012
trainval; COCO's instances_train2017; DET train, images without boxes kept
unless --noallow_empty; VID train frames, every --every-th of each video;
YouTube-BB's `yt_bb_detection_train.csv` clips, about --every frames of
each), validated on its validation split (VOC 2007 test; COCO val2017
with the COCO metric; DET, VID and YouTube-BB val with VOC mAP at IoU 0.5
over the validation set's classes, as get_val_metric chooses).  Each train batch is planned on
the host (expand, constrained crop, filter, flip and a colour map an
image, from a seed).  VOC without mixup takes the JPEG core's train batch
(decode, crop, resize, flip in the core's threads); every other dataset,
and any under --mixup or --host_color, takes the per-sample route (the
loader decodes each image, blends it with a random partner under --mixup,
and cuts its tile with the core's resampler in worker threads).  The
batches are copied to the card on a side stream (data/prefetch.py) and
taken by the train step of train/step.py (targets, loss, backward, SGD,
the colour map applied on the device unless --host_color applied it on
the host).  --mixup blends until the last --no_mixup_epochs epochs.
Shapes are drawn from 320-608 px every 10 batches unless
`--no_random_shape`.  Validation decodes through the core's inference
batch and runs the eval step (K1's NMS on the card).  Checkpoints follow
the reference's best / interval / negative-interval GC policies under
`<experiment_root>/<save_prefix>/yolo3_<network>_<dataset>`, in the JAX
package's flax msgpack, and `--resume` / `--start_epoch -1` resume from
them.  `--pretrained_cnn` (the default) warm-starts the base from gluoncv's
ImageNet Darknet-53 `.params` and raises when none is found;
`--nopretrained_cnn` trains from a seeded random init.

Under `torchrun` (or any launcher that sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT) the twin trains data-parallel, one process a
device (parallel/mesh.py): rank r on `cuda:LOCAL_RANK` over NCCL, or on the
CPU over gloo with `--device cpu`.  `--batch_size` is the global batch; each
rank takes `batch_size / world` samples a step from its own contiguous
block of a seeded permutation a epoch (parallel/multihost.py), with the
random-shape schedule seeded alike on every rank, so the shapes stay in
lockstep.  BatchNorm takes the global batch's statistics and the gradients
are averaged over the ranks (train/step.py), as the JAX package's
batch-sharded step does; so `--syncbn` is accepted at any world size and
changes nothing, as in the JAX CLI, and `--gpus` and `--num_samples` are
accepted for the same parity (the devices come from the launcher).  Every
rank validates the whole validation set in local-size batches; the losses
logged are the ranks' means.  Rank 0 alone writes the `_train.log`, the
checkpoints and `_best_map.log`.  `--max_epoch_time` follows rank 0's
clock, and a SIGTERM to any rank stops every rank, each agreed at a
log-interval boundary: rank 0 then writes `<prefix>_<epoch>.params` (the
epoch so far; `--start_epoch -1` resumes at the next one) and the ranks
exit 0.  In one process the SIGTERM stops after the step in flight.

`--dataset comb` (voc, coco, det, vid) or a comma list of datasets trains
on their train splits combined through the 285-node class tree
(data/combined.py): each box's label is a multi-hot row over its branch of
the tree, which the train step's targets take as they are; validation is
on the validation splits combined, each box once for every node of its
branch, by VOC mAP over the 285 classes.  YouTube-BB's boxes are
fractions of the frame, which the transforms and the metrics read as
pixels, as the JAX package does (ROADMAP.md Queue 3).

`--window k[,step]` with k > 1 (vid or yt, as the JAX CLI asserts) trains
YOLOv3T on windows of k frames, every step-th, around each train frame
(of a VID video or a YouTube-BB clip), labelled by the key frame: the temporal flags `--k_join_type`,
`--k_join_pos`, `--block_conv_type` (2, 3 or 21), `--rnn_pos` (late or out),
`--corr_pos` and `--corr_d` (0: the model's default) are the JAX CLI's.  Each window's plan is drawn once
from the key frame and applied to its k frames in the per-sample route
(one colour map a window); validation takes the windows through the JAX
CLI's Python route (each frame decoded, resized with interp 9 and
normalised in the loader's workers) and VOC mAP.  A train step runs the
cost volumes (K2) forward and their adjoint kernel backward on the card.
`--temp` (the funnel) or `--mult_out` (per-timestep heads: t_out, with
`--corr_d` the correlation pyramid) trains YOLOv3Temporal on windows of
`--window` k (5) frames, as the JAX CLI builds it; `--mult_out` labels
every frame of a window (VID only: YouTube-BB has no per-frame labels of
a window in either package), the train step folds the frames into the batch
for the targets and the loss, and validation scores each offset of the
window with `VOCMApMetricTemporal`.
Like the JAX CLI, `--pretrained_cnn` does not load into YOLOv3T or
YOLOv3Temporal (neither has a `backbone` scope): pass `--nopretrained_cnn`
or `--resume`.

`--new_model` trains YOLOv3T over a backbone that returns the routes
itself, as the JAX CLI builds it: `Darknet3D` with `--conv_types` (the
stem's and the five stages' conv types, 2, 3 or 21) on windows of
`--window` k frames, or with `--hier` (e.g. 3,3,1,1,1 on `--window 9,1`)
`HDarknet`, merging groups of 3 frames by `--h_join_type` max or conv.
`--pretrained_cnn` inflates the ImageNet Darknet-53 into Darknet3D's 3-D
and 2+1D stages and loads it as it is into HDarknet; it refuses Darknet3D
with every conv type 2, where the JAX CLI's load fails (ROADMAP.md Queue 3).
From their zero init the conv merges overflow the first step's gradient,
in both packages (Queue 3): train `--h_join_type conv` from a checkpoint.

`--motion_stream flownet` trains the two-stream YOLOv3T on windows of
`--window 3,1` (the middle frame through Darknet-53, the outer two through
FlowNetS; `--stream_gating add|mul` gates Darknet-53 with the FlowNet
encoder's features), as the JAX CLI builds it.  It trains at one shape,
a multiple of 64: `--data_shape 384 --no_random_shape` (the JAX CLI's run
fails on the first batch of 416 px or of five of its ten random shapes,
and the twin refuses them).  `--pretrained_cnn` loads the ImageNet
Darknet-53 into the ungated model's darknet half, as the JAX CLI does, and
refuses the gated one, where the JAX CLI's load fails (Queue 3).

The log line `Speed: %.3f samples/sec` is the JAX CLI's (a rank's samples).
The run is on the card unless `--device cpu` is given.  Paths this slice
does not port raise NotImplementedError naming their ROADMAP.md item:
`--features_dir` and `--trained_on`.
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import random
import signal
import time

import numpy as np
import torch

from .data.combined import COMB, CombinedDetection
from .data.imgnetdet import ImageNetDetection
from .data.imgnetvid import ImageNetVidDetection
from .data.loader import DetectionLoader
from .data.mscoco import COCODetection
from .data.pascalvoc import VOCDetection
from .data.prefetch import device_prefetch
from .data.youtubebb import YouTubeBBDetection
from .data.transforms import (
    MixupDetection,
    YOLO3DefaultInferenceTransform,
    YOLO3DefaultTrainTransform,
    YOLO3VideoInferenceTransform,
    YOLO3VideoTrainTransform,
    check_mixable,
)
from .device import resolve_device
from .metrics.mscoco import COCODetectionMetric
from .metrics.pascalvoc import VOCMApMetric, VOCMApMetricTemporal
from .models.darknet import Darknet53
from .models.darknet3d import Darknet3D
from .models.factory import yolo3_darknet53
from .models.inflate import inflate_darknet53_to_3d
from .models.flownet import check_input_size
from .models.layers import init_weights
from .models.s2d import refold_stem_s2d
from .models.ts_darknet import TwoStreamDarknet
from .parallel import mesh
from .parallel.multihost import (
    global_mean, is_coordinator, local_batch_size, process_count, process_epoch_indices, process_index, sync_any,
    sync_flag,
)
from .train.checkpoint import load_into, resume_params, save_params, save_variables, variables_of
from .train.lr import lr_schedule
from .train.step import create_train_state, fast_forward_schedule, make_eval_step, make_train_step
from .utils.gluon_import import load_gluon_darknet53

DTYPES = {"bf16": torch.bfloat16, "f32": None}
TRAIN_KEYS = ("image", "gt_boxes", "gt_ids", "gt_mix", "color")
DATASETS = ("voc", "coco", "det", "vid", "yt")


def _csv(s: str):
    return [x for x in s.split(",") if x]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--network", default="darknet53", choices=["darknet53"])
    p.add_argument("--dataset", type=_csv, default=["voc"], help="datasets to train on: voc, coco, det, vid, yt; comb or a list: combined")
    p.add_argument("--dataset_val", type=_csv, default=[], help="datasets to test on (default: --dataset)")
    p.add_argument("--dataset_root", default="datasets")
    p.add_argument("--save_prefix", default="0001")
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--save_interval", type=int, default=-10,
                   help="epochs between saves; negative: every epoch, GC to every |N|th")
    p.add_argument("--val_interval", type=int, default=1)
    p.add_argument("--resume", default="")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_boxes", type=int, default=56)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--start_epoch", type=int, default=0, help="-1: the latest checkpoint's next epoch")
    p.add_argument("--data_shape", type=int, default=416)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lr_mode", default="step", choices=["step", "poly", "cosine", "constant"])
    p.add_argument("--lr_decay", type=float, default=0.1)
    p.add_argument("--lr_decay_period", type=int, default=0)
    p.add_argument("--lr_decay_epoch", type=_csv, default=["160", "180"])
    p.add_argument("--warmup_epochs", type=int, default=0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=0.0005)
    p.add_argument("--pretrained_cnn", dest="pretrained_cnn", action="store_true", default=True)
    p.add_argument("--nopretrained_cnn", dest="pretrained_cnn", action="store_false")
    p.add_argument("--pretrained_base_path", default="",
                   help="darknet53 .params; '' = search $MXNET_HOME/models, ~/.mxnet/models, <dataset_root>/weights")
    p.add_argument("--no_random_shape", action="store_true")
    p.add_argument("--no_wd", action="store_true", help="no weight decay on BN scales and biases")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    p.add_argument("--s2d_stem", action="store_true")
    p.add_argument("--accum_steps", type=int, default=1)
    p.add_argument("--label_smooth", action="store_true")
    p.add_argument("--freeze_base", action="store_true")
    p.add_argument("--num_workers", type=int, default=-1, help="-1: one a CPU core")
    p.add_argument("--seed", type=int, default=233)
    p.add_argument("--max_epoch_time", type=float, default=-1, help="minutes an epoch may run")
    p.add_argument("--experiment_root", default=os.path.join("models", "experiments"))
    p.add_argument("--device", default=None, help="default: cuda (raises without a GPU)")
    p.add_argument("--mixup", action="store_true", help="blend each image with a random partner")
    p.add_argument("--no_mixup_epochs", type=int, default=20, help="no mixup in the last N epochs")
    p.add_argument("--host_color", action="store_true",
                   help="apply the colour map and normalisation on the host (float32 batches)")
    p.add_argument("--allow_empty", dest="allow_empty", action="store_true", default=True,
                   help="keep the images without boxes (det, vid)")
    p.add_argument("--noallow_empty", dest="allow_empty", action="store_false")
    p.add_argument("--every", type=float, default=25,
                   help="vid: every this many frames; yt: about this many frames a clip")
    p.add_argument("--syncbn", action="store_true",
                   help="kept for parity: BN's statistics always span the global batch")
    p.add_argument("--gpus", type=_csv, default=["0"], help="kept for parity: the devices come from torchrun")
    p.add_argument("--num_samples", type=int, default=-1, help="kept for parity: training images; -1 auto")
    p.add_argument("--window", type=_csv, default=["1", "1"], help="temporal window size and stride (vid, yt)")
    p.add_argument("--k_join_type", default=None, help="way to fuse k: max, mean, cat")
    p.add_argument("--k_join_pos", default=None, help="position of the k fuse: early or late")
    p.add_argument("--block_conv_type", default="2", help="conv type of the YOLO blocks: 2, 3 or 21")
    p.add_argument("--rnn_pos", default=None, help="position of RNN: late or out")
    p.add_argument("--corr_pos", default=None, help="position of the correlation features: early or late")
    p.add_argument("--corr_d", type=int, default=0, help="the d of the correlation; 0: the model's default")
    p.add_argument("--temp", action="store_true", help="the t=5 temporal model (YOLOv3Temporal)")
    p.add_argument("--mult_out", action="store_true", help="one output a frame of the window (t_out)")
    p.add_argument("--new_model", action="store_true",
                   help="YOLOv3T over a backbone that returns the routes: Darknet3D, or HDarknet with --hier")
    p.add_argument("--conv_types", type=_csv, default=["2"] * 6, help="Darknet3D's conv types: the stem and 5 stages")
    p.add_argument("--hier", type=_csv, default=["1"] * 5, help="HDarknet's merge windows a level")
    p.add_argument("--h_join_type", default=None, help="HDarknet's merge: max or conv")
    p.add_argument("--motion_stream", default=None,
                   help="the two-stream model's motion stream: flownet (--window 3,1; r21d: ROADMAP.md item 7)")
    p.add_argument("--stream_gating", default=None, help="the motion stream's gating of darknet: add or mul")
    # paths this slice does not port
    p.add_argument("--features_dir", default=None)
    p.add_argument("--trained_on", default="")
    return p.parse_args(argv)


def check_ported(args):
    """Raise on bad flags and on those whose paths this slice does not port."""
    for name in args.dataset + args.dataset_val:
        if name not in DATASETS + ("comb",):
            raise ValueError(f"unknown dataset {name!r}")
    if window(args)[0] > 1 and (args.dataset[0] not in ("vid", "yt") or combined(args.dataset)):
        raise ValueError("window > 1 requires one video dataset, vid or yt (train_yolov3.py:775-776)")
    if args.mult_out and any(n != "vid" for n in args.dataset + args.dataset_val):
        raise ValueError("--mult_out labels each frame of a window, which only the vid dataset gives")
    if args.motion_stream == "flownet":
        # the JAX CLI's FlowNetS asserts H and W are multiples of 64 on the
        # first batch of another shape: the default 416 and five of the ten
        # random shapes (352, 416, 480, 544, 608; train_yolov3.py:285) fail
        check_input_size(args.data_shape, args.data_shape)
        if not args.no_random_shape:
            raise ValueError("--motion_stream flownet trains at one shape, a multiple of 64: pass --no_random_shape "
                             "(five of the ten random shapes, 352, 416, 480, 544 and 608, fail FlowNetS's "
                             "divisibility check, as the JAX CLI's run fails on its first batch of one)")
    if args.features_dir:
        raise NotImplementedError("--features_dir (the head-only model): see ROADMAP.md Queue 1 item 13")
    if args.trained_on:
        raise NotImplementedError("--trained_on (class surgery): see ROADMAP.md Queue 1 item 12")


def temporal_kwargs(args) -> dict:
    """The temporal flags as the factory's keywords (none for the 2D
    model), as the JAX CLI passes them, with the backbone's under
    --new_model."""
    k = window(args)[0]
    if k <= 1 and not (args.temp or args.mult_out or args.new_model or args.motion_stream):
        return {}
    return dict(k=k if k > 1 else None, k_join_type=args.k_join_type, k_join_pos=args.k_join_pos,
                block_conv_type=args.block_conv_type, rnn_pos=args.rnn_pos, corr_pos=args.corr_pos,
                corr_d=args.corr_d or None, temporal=args.temp, t_out=args.mult_out, **backbone_kwargs(args))


def backbone_kwargs(args) -> dict:
    """--new_model's and --motion_stream's backbone flags as the factory's
    keywords (none without them)."""
    kw = {}
    if args.motion_stream:
        kw.update(motion_stream=args.motion_stream, add_type=args.stream_gating)
    if args.new_model:
        kw.update(new_model=True, conv_types=tuple(int(c) for c in args.conv_types),
                  hierarchical=tuple(int(h) for h in args.hier), h_join_type=args.h_join_type)
    return kw


def window(args):
    """--window as (k, step)."""
    return tuple(([int(w) for w in args.window] + [1])[:2])


def combined(names) -> bool:
    """Whether `--dataset` names datasets combined through the class tree."""
    return len(names) > 1 or names[0] == "comb"


def get_dataset(args, names, val: bool = False):
    """The datasets named by `--dataset` (train_yolov3.py:201-218): one, or
    `comb` and any list combined through the class tree (in validation
    mode, each box once a node of its branch, with `val`)."""
    if not combined(names):
        return get_single_dataset(args, names[0], val)
    names = COMB if names[0] == "comb" else names
    return CombinedDetection([get_single_dataset(args, n, val) for n in names], class_tree=True, validation=val,
                             inference=val)


def get_single_dataset(args, name: str, val: bool = False):
    """One dataset by name (train_yolov3.py:135-198): the train split, or
    the validation split with `val`."""
    root = args.dataset_root
    if name == "voc":
        voc = os.path.join(root, "PascalVOC", "VOCdevkit")
        if val:
            return VOCDetection(root=voc, splits=[(2007, "test")], inference=True)
        return VOCDetection(root=voc, splits=[(2007, "trainval"), (2012, "trainval")])
    if name == "coco":
        return COCODetection(root=os.path.join(root, "MSCoco"),
                             splits=["instances_val2017" if val else "instances_train2017"],
                             allow_empty=val, inference=val)
    if name == "det":
        return ImageNetDetection(root=os.path.join(root, "ImageNetDET", "ILSVRC"), splits=["val" if val else "train"],
                                 allow_empty=args.allow_empty or val, inference=val)
    if name == "yt":
        return YouTubeBBDetection(root=os.path.join(root, "YouTubeBB"), splits=["val" if val else "train"],
                                  frames=args.every, window=window(args), inference=val)
    return ImageNetVidDetection(root=os.path.join(root, "ImageNetVID", "ILSVRC"),
                                splits=[(2017, "val" if val else "train")], allow_empty=args.allow_empty or val,
                                every=int(args.every), window=window(args), mult_out=args.mult_out, inference=val)


def get_val_metric(args, val_dataset, save_prefix: str):
    """COCO validation -> the COCO metric at the data shape; anything else,
    the combined validation among them -> VOC mAP at IoU 0.5 over the
    validation set's classes, one a window offset (`VOCMApMetricTemporal`)
    for VID with --mult_out (train_yolov3.py:340-369)."""
    names = args.dataset_val or args.dataset
    name = "comb" if combined(names) else names[0]
    if name == "coco":
        # every rank validates and writes a results json: one file a rank
        suffix = f"_eval_p{process_index()}" if process_count() > 1 else "_eval"
        return COCODetectionMetric(val_dataset, save_prefix + suffix, cleanup=True,
                                   data_shape=(args.data_shape, args.data_shape))
    if name == "vid" and args.mult_out:
        return VOCMApMetricTemporal(t=window(args)[0], iou_thresh=0.5, class_names=list(val_dataset.classes))
    return VOCMApMetric(iou_thresh=0.5, class_names=list(val_dataset.classes))


def get_dataloaders(args, train_dataset, val_dataset, rs: np.random.RandomState, rnd: random.Random):
    """The train loader (random shape buckets unless --no_random_shape) and
    the validation loader (the core's inference batch, labelled; windows
    through the video inference transform).  In a job of several ranks each
    takes the local batch from its block of the epoch's permutation
    (train_yolov3.py:238-250); both loaders take local-size batches."""
    num_workers = args.num_workers if args.num_workers > 0 else (os.cpu_count() or 4)
    pc = process_count()
    batch_size = local_batch_size(args.batch_size, pc)
    sampler, num_samples = None, None
    if pc > 1:
        n = len(train_dataset)
        sampler, num_samples = (lambda epoch: process_epoch_indices(n, epoch, seed=args.seed)), n // pc
    sizes = [args.data_shape] if args.no_random_shape else [320 + 32 * i for i in range(10)]
    k, color = window(args)[0], not args.host_color
    if k > 1:
        factory = lambda w, h: YOLO3VideoTrainTransform(k, w, h, rs, rnd, device_color=color)  # noqa: E731
    else:
        factory = lambda w, h: YOLO3DefaultTrainTransform(w, h, rs, rnd, device_color=color)  # noqa: E731
    # class-tree training takes the multi-hot rows (a MixupDetection forwards these)
    multihot = train_dataset.num_class if getattr(train_dataset, "name", "") == "comb" and getattr(
        train_dataset, "parents", None) else 0
    train_loader = DetectionLoader(
        train_dataset, batch_size=batch_size, shuffle=True, last_batch="discard",
        max_boxes=args.max_boxes, num_workers=num_workers, seed=args.seed,
        transform_factory=factory, shape_sizes=sizes, shape_interval=10, multihot=multihot,
        sampler=sampler, num_samples=num_samples,
    )
    s = args.data_shape
    route = (dict(inference_transform=YOLO3VideoInferenceTransform(s, s)) if k > 1
             else dict(native_decode=(s, s), label_transform=YOLO3DefaultInferenceTransform(s, s)))
    val_loader = DetectionLoader(
        val_dataset, batch_size=batch_size, max_boxes=args.max_boxes, num_workers=num_workers, **route,
    )
    return train_loader, val_loader


def validate(eval_step, val_loader, metric, device):
    """The eval step on the card, the metric on the host.  Per-timestep
    outputs (B, T, ...) update a temporal metric offset by offset, any
    other metric with T folded into the batch (train_yolov3.py:371-413)."""
    metric.reset()
    for batch in device_prefetch(iter(val_loader), device, size=2, keys=("image",)):
        ids, scores, bboxes = (a.cpu().numpy() for a in eval_step(batch["image"]))
        label = batch["label"]
        size = batch["image"].shape[-2]
        if ids.ndim == 4:
            t = ids.shape[1]
            if isinstance(metric, VOCMApMetricTemporal):
                metric.update([bboxes[:, i].clip(0, size) for i in range(t)], [ids[:, i] for i in range(t)],
                              [scores[:, i] for i in range(t)], [label[:, i, :, :4] for i in range(t)],
                              [label[:, i, :, 4:5] for i in range(t)],
                              [label[:, i, :, 5:6] for i in range(t)] if label.shape[-1] > 5 else None)
                continue
            ids, scores, bboxes = (a.reshape((-1,) + a.shape[2:]) for a in (ids, scores, bboxes))
            label = label.reshape((-1,) + label.shape[2:])
        metric.update(bboxes.clip(0, size), ids, scores, label[..., :4], label[..., 4:5],
                      label[..., 5:6] if label.shape[-1] > 5 else None)
    return metric.get()


def _find_pretrained_base(args):
    """The ImageNet darknet53 .params: --pretrained_base_path, else the
    gluoncv model-zoo caches."""
    if args.pretrained_base_path:
        if not os.path.exists(args.pretrained_base_path):
            raise FileNotFoundError(args.pretrained_base_path)
        return args.pretrained_base_path
    roots = [
        os.path.join(os.environ.get("MXNET_HOME", os.path.expanduser("~/.mxnet")), "models"),
        os.path.join(args.dataset_root, "weights"),
    ]
    for root in roots:
        found = sorted(glob.glob(os.path.join(root, "darknet53*.params")))
        if found:
            return found[0]
    return None


def _load_pretrained_base(args, model):
    """Load ImageNet darknet53 weights into the model's base: refolded for
    the s2d stem, inflated for Darknet3D's 3-D and 2+1D stages (a 3-D
    kernel the 2D one repeated over time / its extent, a 2+1D cell's
    spatial kernel the 2D one and its temporal kernel 1/3, BN across), as
    they are into HDarknet and the ungated two-stream model's darknet half
    (Darknet-53's tree); raises when none are found, and for the gated
    two-stream model."""
    path = _find_pretrained_base(args)
    if path is None:
        raise RuntimeError(
            "--pretrained_cnn (default) needs ImageNet darknet53 weights but none were found. Provide "
            "--pretrained_base_path, place darknet53*.params under ~/.mxnet/models or "
            f"{args.dataset_root}/weights, or pass --nopretrained_cnn to train the base from scratch."
        )
    if isinstance(getattr(model, "backbone", None), TwoStreamDarknet) and model.backbone.add_type:
        # the JAX CLI loads Darknet-53's paths into the gated tree here and
        # fails on its names (ROADMAP.md Queue 3)
        raise RuntimeError(
            "--pretrained_cnn with --stream_gating: the gated two-stream tree (gstart, gstage4, stage5) is not "
            "Darknet-53's (conv0, stage1-5), so the JAX CLI's load fails on it; pass --nopretrained_cnn, or train "
            "the ungated model (its darknet half takes the base as it is).")
    variables = variables_of(model)
    if "backbone" not in variables["params"]:
        raise RuntimeError(
            "--pretrained_cnn is not wired for models without a 'backbone' scope (YOLOv3T and YOLOv3Temporal "
            "build their stages inline); pass --nopretrained_cnn or warm-start via --resume."
        )
    conv_types = tuple(int(c) for c in args.conv_types) if args.new_model else (2,) * 6
    darknet3d = isinstance(getattr(model, "backbone", None), Darknet3D)
    if darknet3d and all(c == 2 for c in conv_types):
        # the JAX CLI loads Darknet-53's paths into Darknet3D's tree here and
        # fails on its names (ROADMAP.md Queue 3)
        raise RuntimeError(
            "--pretrained_cnn with --new_model and every conv type 2: Darknet3D's tree (stem, down{i}, "
            "stage{i}_block{j}) is not Darknet-53's, so the JAX CLI's load fails on it; pass --nopretrained_cnn, "
            "a conv type 3 or 21 (the inflate branch), or --hier (HDarknet holds Darknet-53's tree).")
    if not darknet3d and any(c != 2 for c in conv_types):
        raise RuntimeError("--conv_types other than 2 inflate into Darknet3D only; with --hier the factory builds "
                           "HDarknet, whose tree is Darknet-53's, and the JAX CLI's inflate fails on it")
    if args.s2d_stem or darknet3d:
        # load into a standard Darknet53 tree, then refold its stem (s2d) or
        # inflate it to 3-D / 2+1D (train_yolov3.py:728-763), and install it
        base = load_gluon_darknet53(variables_of(Darknet53()), path, prefix="")
        if args.s2d_stem:
            base = refold_stem_s2d(base)
        else:
            base = inflate_darknet53_to_3d(base, {"params": variables["params"]["backbone"],
                                                  "batch_stats": variables["batch_stats"]["backbone"]})
        variables["params"]["backbone"] = base["params"]
        variables["batch_stats"]["backbone"] = base["batch_stats"]
    else:
        variables = load_gluon_darknet53(variables, path, prefix="backbone")
    load_into(model, variables)
    logging.info("loaded the ImageNet-pretrained darknet53 base from %s", path)


def train(args, model, train_dataset, train_loader, val_loader, val_dataset, save_prefix, start_epoch, device):
    """The epochs: train, validate every --val_interval, checkpoint.
    Returns what the run measured: per epoch its seconds, samples/s and the
    host's wait on the prefetcher, with each step's (shape, seconds, wait)
    on the host's clock (a step that logs ends at its loss read, which waits
    for the card); each validation's mAP and seconds; and `preempted`, the
    epoch a SIGTERM stopped, if one did (train_yolov3.py:520-545,
    625-656)."""
    num_classes = train_dataset.num_class
    steps_per_epoch = max(len(train_loader), 1)
    lr_decay_epoch = [int(e) for e in args.lr_decay_epoch]
    if args.lr_decay_period > 0:
        lr_decay_epoch = list(range(args.lr_decay_period, args.epochs, args.lr_decay_period))
    lr_decay_epoch = [e - args.warmup_epochs for e in lr_decay_epoch]
    lr_fn = lr_schedule(
        args.lr_mode, args.lr, steps_per_epoch=steps_per_epoch, epochs=args.epochs,
        warmup_epochs=args.warmup_epochs, lr_decay=args.lr_decay, lr_decay_epochs=lr_decay_epoch,
    )
    state = create_train_state(model, lr_fn, args.momentum, args.wd, no_wd_bn=args.no_wd,
                               freeze_base=args.freeze_base)
    if start_epoch > 0:
        # a resumed run reads the schedule from the global step
        fast_forward_schedule(state, start_epoch * steps_per_epoch)
    train_step = make_train_step(model, num_classes=num_classes, label_smooth=args.label_smooth,
                                 mixup=args.mixup, accum_steps=args.accum_steps)
    eval_step = make_eval_step(model)
    coord, several = is_coordinator(), process_count() > 1
    check = args.log_interval or 100  # the steps at which several ranks agree to stop
    logger = logging.getLogger()
    handler = logging.FileHandler(save_prefix + "_train.log") if coord else None
    if handler is not None:
        logger.addHandler(handler)
    preempt = {"flag": False}

    def on_sigterm(signum, frame):
        preempt["flag"] = True
        logging.warning("SIGTERM: will checkpoint at the next step boundary and exit")

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:  # not the main thread
        prev_sigterm = None

    best_map = 0.0
    best_log = save_prefix + "_best_map.log"
    if (args.resume or args.start_epoch != 0) and os.path.exists(best_log):
        with open(best_log) as f:
            lines = [line for line in f if line.strip()]
        if lines:
            best_map = float(lines[-1].split("\t")[-1])
    metric = get_val_metric(args, val_dataset, save_prefix)
    stats = {"epochs": [], "val": [], "preempted": None}
    try:
        for epoch in range(start_epoch, args.epochs):
            if args.mixup:
                # no mixup in the last epochs (train_yolov3.py:546-548)
                train_dataset.set_mixup(epoch < args.epochs - args.no_mixup_epochs)
            tic = btic = time.time()
            seen = 0
            loss_sums, loss_count = None, 0
            steps, wait_total = [], 0.0
            batches = device_prefetch(iter(train_loader), device, size=2, keys=TRAIN_KEYS)
            i = -1
            while True:
                t0 = time.time()
                batch = next(batches, None)
                wait = time.time() - t0
                if batch is None:
                    break
                i += 1
                metrics = train_step(state, batch)
                loss_sums = metrics if loss_sums is None else {k: loss_sums[k] + v for k, v in metrics.items()}
                loss_count += 1
                n = batch["image"].shape[0]
                seen += n
                wait_total += wait
                if args.log_interval and (i + 1) % args.log_interval == 0:
                    m = {k: float(v) / loss_count for k, v in global_mean(loss_sums).items()}
                    rate = args.log_interval * n / (time.time() - btic)
                    logging.info(
                        "[Epoch %d][Batch %d], LR: %.2E, Speed: %.3f samples/sec, "
                        "ObjLoss=%.3f, BoxCenterLoss=%.3f, BoxScaleLoss=%.3f, ClassLoss=%.3f",
                        epoch, i, float(lr_fn(state.step)), rate, m["obj"], m["center"], m["scale"], m["cls"],
                    )
                    btic = time.time()
                # a step's time on the host's clock ends at its loss read
                # when it logs, else when it is enqueued
                steps.append((int(batch["image"].shape[-2]), time.time() - t0, wait))
                # several ranks agree at log-interval boundaries (the same step on
                # every rank) before any stops stepping: rank 0's clock, any
                # rank's SIGTERM
                if args.max_epoch_time > 0:
                    cut = (time.time() - tic) / 60 > args.max_epoch_time
                    if several:
                        cut = (i + 1) % check == 0 and sync_flag(cut)
                    if cut:
                        logging.info("Epoch %d cut off at max_epoch_time", epoch)
                        batches.close()
                        break
                stop = (i + 1) % check == 0 and sync_any(preempt["flag"]) if several else preempt["flag"]
                if stop:
                    stats["preempted"] = epoch
                    batches.close()
                    break
            if loss_sums is not None:
                float(loss_sums["total"])  # the epoch's last step is done
            secs = time.time() - tic
            logging.info("[Epoch %d] done in %.1fs, %.3f samples/sec, waited on the prefetcher %.1f%% of it",
                         epoch, secs, seen / max(secs, 1e-9), 100 * wait_total / max(secs, 1e-9))
            stats["epochs"].append({"epoch": epoch, "seconds": secs, "samples": seen,
                                    "samples_s": seen / max(secs, 1e-9), "wait_s": wait_total, "steps": steps})
            if stats["preempted"] is not None:
                path = f"{save_prefix}_{epoch:04d}.params"
                if coord:
                    save_variables(path, variables_of(model))
                logging.warning("Preempted: wrote %s; resume with --start_epoch -1", path)
                break
            current_map = 0.0
            if args.val_interval and (epoch + 1) % args.val_interval == 0:
                t0 = time.time()
                names, values = validate(eval_step, val_loader, metric, device)
                logging.info("[Epoch %d] Validation: \n%s", epoch,
                             "\n".join(f"{n_}={v}" for n_, v in zip(names, values)))
                current_map = float(values[-1])
                stats["val"].append({"epoch": epoch, "map": current_map, "seconds": time.time() - t0})
            if coord:
                best_map = save_params(save_prefix, variables_of(model), current_map, best_map, epoch,
                                       args.save_interval)
            else:
                best_map = max(best_map, current_map)
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
        if handler is not None:
            logger.removeHandler(handler)
            handler.close()
    stats["best_map"] = best_map
    return stats


def main(argv=None):
    """Returns the trained model and what `train` measured.  Started as a
    rank of a job (`mesh.launched`), it joins the job's process group for
    the run and leaves it on the way out."""
    args = parse_args(argv)
    check_ported(args)
    if not mesh.launched():
        return run(args, resolve_device(args.device))
    with mesh.process_group(args.device) as device:
        return run(args, device)


def run(args, device):
    """The run on `device`, in the process group if there is one."""
    rs, rnd = np.random.RandomState(args.seed), random.Random(args.seed)
    k = window(args)[0]
    train_dataset = get_dataset(args, args.dataset)
    if args.mixup:
        check_mixable(k)
        train_dataset = MixupDetection(train_dataset, rs)
    val_dataset = get_dataset(args, args.dataset_val or args.dataset, val=True)

    save_prefix = os.path.join(args.experiment_root, args.save_prefix,
                               f"yolo3_{args.network}_{'_'.join(args.dataset)}")
    exp_dir = os.path.dirname(save_prefix)
    if os.path.exists(exp_dir) and not args.resume and args.start_epoch == 0 and args.save_prefix != "0000":
        if any(f.endswith(".params") for f in os.listdir(exp_dir)):
            raise RuntimeError(f"experiment dir {exp_dir} has checkpoints; pass --resume or a new --save_prefix")
    os.makedirs(exp_dir, exist_ok=True)

    model = yolo3_darknet53(list(train_dataset.classes), dtype=DTYPES[args.dtype], remat=args.remat,
                            s2d_stem=args.s2d_stem, **temporal_kwargs(args))
    init_weights(model, torch.Generator().manual_seed(args.seed))
    restored, start_epoch = resume_params(args.resume, args.start_epoch, exp_dir, variables_of(model))
    if restored is not None:
        load_into(model, restored)
        logging.info("resumed params (start_epoch=%d)", start_epoch)
    elif args.pretrained_cnn:
        _load_pretrained_base(args, model)
    model.to(device, memory_format=torch.channels_last)

    train_loader, val_loader = get_dataloaders(args, train_dataset, val_dataset, rs, rnd)
    logging.info("Training %s on %s: %d samples, %d steps/epoch, on %s",
                 args.network, args.dataset, len(train_dataset), len(train_loader), device)
    stats = train(args, model, train_dataset, train_loader, val_loader, val_dataset, save_prefix, start_epoch, device)
    return model, stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
