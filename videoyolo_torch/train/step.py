"""The train and eval steps (port of videoyolo_tpu/train/step.py:43-296).

One train step: the train-mode forward, the targets made on the device
from the padded gt boxes (ops/targets.py), the loss (ops/losses.py) as the
mean over the batch of the per-sample sums, the backward pass, and SGD with
momentum and coupled weight decay.  The BN running statistics update in
the forward, as flax's mutable `batch_stats` do.

optax's chain `add_decayed_weights(wd)` then `sgd(lr_fn, momentum)` is
d = g + wd * p, trace = d + momentum * trace, p -= lr(count) * trace, with
`count` the number of updates before this one: `torch.optim.SGD(momentum,
dampening=0, weight_decay=wd)` with the group's lr set to `lr_fn(step)`
before each update.  Under warmup the first update uses lr(0) = 0, and the
momentum still takes its gradient.

Data-parallel training (one process a device in a process group,
parallel/mesh.py): each process runs the step on its local batch, BatchNorm
takes the global batch's statistics (models/layers.GlobalBatchNorm), and
after the backward pass one all-reduce a dtype of the flattened gradients
averages them over the processes, before the update.  The loss is a mean
over equal local batches, so the average of the local means is the global
mean the JAX package's step takes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..models.yolo3 import postprocess_tout
from ..ops.color import apply_color
from ..ops.losses import yolo3_loss
from ..ops.targets import merge_targets, prefetch_targets
from ..parallel import multihost

__all__ = [
    "TrainState", "create_train_state", "make_optimizer", "make_train_step", "make_eval_step",
    "freeze_base_mask", "fast_forward_schedule", "average_gradients",
]

# the top-level scopes of the base network across the model family
# (train/step.py:41): "backbone", or YOLOv3Temporal's inline darknet
_BASE_SCOPES = ("backbone", "conv0", "stage1", "stage2", "stage3")


def freeze_base_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True for the base network's parameters (the frozen
    ones under `freeze_base`)."""
    return {name: name.split(".")[0] in _BASE_SCOPES for name, _ in model.named_parameters()}


def _decays(model: nn.Module, no_wd_bn: bool) -> Dict[str, bool]:
    """Parameter name -> whether weight decay applies.  `no_wd_bn` exempts
    every leaf flax names `scale` or `bias`: the BatchNorm weights and
    biases and the prediction convs' biases."""
    out = {}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            flax_leaf = "scale" if isinstance(mod, nn.BatchNorm2d) and leaf == "weight" else leaf
            out[f"{mod_name}.{leaf}" if mod_name else leaf] = not (no_wd_bn and flax_leaf in ("scale", "bias"))
    return out


def make_optimizer(model: nn.Module, momentum: float = 0.9, weight_decay: float = 5e-4,
                   no_wd_bn: bool = False, freeze_base: bool = False) -> torch.optim.SGD:
    """SGD with momentum and coupled L2 over the model's parameters, in two
    groups (decayed or not).  `freeze_base` leaves the base network's
    parameters out: they never move, while their BN running statistics
    still update in the forward."""
    frozen = freeze_base_mask(model) if freeze_base else {}
    decays = _decays(model, no_wd_bn)
    groups = {True: [], False: []}
    for name, p in model.named_parameters():
        if not frozen.get(name, False):
            groups[decays[name]].append(p)
    param_groups = [
        {"params": ps, "weight_decay": weight_decay if decay else 0.0}
        for decay, ps in groups.items() if ps
    ]
    return torch.optim.SGD(param_groups, lr=0.0, momentum=momentum, dampening=0.0)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer (momentum
    traces), the lr schedule and the count of updates made."""

    model: nn.Module
    optimizer: torch.optim.SGD
    lr_fn: Callable[[int], torch.Tensor]
    step: int = 0

    def apply_gradients(self):
        """One SGD update from the gradients in the parameters' `.grad`, at
        lr_fn(step)."""
        lr = float(self.lr_fn(self.step))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, lr_fn: Callable, momentum: float = 0.9,
                       weight_decay: float = 5e-4, no_wd_bn: bool = False,
                       freeze_base: bool = False) -> TrainState:
    return TrainState(model, make_optimizer(model, momentum, weight_decay, no_wd_bn, freeze_base), lr_fn)


def fast_forward_schedule(state: TrainState, step: int) -> TrainState:
    """Read the lr schedule from `step` on (a resumed run): the count the
    schedule is read at, as optax's ScaleByScheduleState count."""
    state.step = int(step)
    return state


def average_gradients(model: nn.Module) -> None:
    """The parameters' `.grad` averaged over the processes of the group: one
    all-reduce of the flattened gradients a dtype (every one float32 on the
    main path), then the mean copied back in one multi-tensor copy.  In a
    group of one it changes no bit (the train step does not call it there)."""
    count = dist.get_world_size()
    by_dtype = {}
    for p in model.parameters():
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat)
        if count > 1:
            flat.div_(count)
        torch._foreach_copy_(grads, _unflatten_dense_tensors(flat, grads))


def make_train_step(
    model: nn.Module,
    num_classes: int,
    ignore_iou_thresh: float = 0.7,
    label_smooth: bool = False,
    mixup: bool = False,
    input_hw: Optional[Tuple[int, int]] = None,
    accum_steps: int = 1,
):
    """Returns train_step(state, batch) -> metrics (float32 scalar tensors
    `obj`, `center`, `scale`, `cls`, `total`, on the model's device; reading
    them waits for the step).

    batch: dict with
      image      (B, H, W, 3)  normalised, or uint8 pixels with `color`;
                 or (B, k, H, W, 3) windows for YOLOv3T and YOLOv3Temporal,
                 one colour map a window (train/step.py:171-226)
      color      (B, 3, 4)     optional per-image (per-window) color maps
                               (ops/color.py)
      gt_boxes   (B, M, 4)     corner pixels, -1 padded; (B, T, M, 4) a
                               frame for a t_out model
      gt_ids     (B, M, 1)     or (B, M, C) multi-hot; (B, T, M, 1)
      gt_mix     (B, M, 1)     read with `mixup`

    `input_hw` defaults to the image's (H, W).  `accum_steps` > 1 splits
    the batch into that many micro-batches, carries the BN statistics
    through them, and updates once with the mean of their gradients.

    In a process group of several processes the gradients are averaged
    over them before the update (`average_gradients`; a group of one runs
    the one-process step as it is); the metrics stay this
    process's (parallel/multihost.global_mean makes them global).  With
    accumulation each process splits its own local batch, so micro-batch i
    holds chunk i of every process's batch and its BN statistics span those
    chunks: the JAX step on the global batch reordered as [p0 c0, p1 c0,
    p0 c1, p1 c1] (ROADMAP.md Queue 3).

    A t_out model's per-timestep heads (B, T, N, ...) take per-timestep gt
    (B, T, M, ...): T is folded into the batch for the targets and the loss,
    so the loss is the mean over the B*T frames (train/step.py:190-205).

    A head-only model's `features` come with ROADMAP.md Queue 1 item 13."""

    def loss_fn(batch):
        x = batch["image"]
        if "color" in batch:
            x = apply_color(x, batch["color"])
        hw = input_hw or tuple(x.shape[-3:-1])
        out = model(x)
        gt_boxes, gt_ids = batch["gt_boxes"], batch["gt_ids"]
        gt_mix = batch.get("gt_mix") if mixup else None
        if out["bbox"].dim() == 4:  # per-timestep heads and gt: T folded into the batch
            if gt_boxes.dim() != 4:
                raise ValueError(f"per-timestep heads {tuple(out['bbox'].shape)} take per-timestep gt (B, T, M, 4), "
                                 f"got gt_boxes {tuple(gt_boxes.shape)}")
            out = {k: v.flatten(0, 1) for k, v in out.items()}
            gt_boxes, gt_ids = gt_boxes.flatten(0, 1), gt_ids.flatten(0, 1)
            gt_mix = None if gt_mix is None else gt_mix.flatten(0, 1)
        tg = prefetch_targets(gt_boxes, gt_ids, gt_mix, input_hw=hw, num_classes=num_classes)
        merged = merge_targets(
            out["bbox"], gt_boxes, *tg, num_classes=num_classes,
            ignore_iou_thresh=ignore_iou_thresh, label_smooth=label_smooth,
        )
        losses = yolo3_loss(out["objness"], out["raw_centers"], out["raw_scales"], out["class_pred"], *merged)
        total = (losses["obj"] + losses["center"] + losses["scale"] + losses["cls"]).mean()
        return total, {k: v.detach().mean() for k, v in losses.items()}

    def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model.train()
        model.zero_grad(set_to_none=True)
        if accum_steps <= 1:
            total, metrics = loss_fn(batch)
            total.backward()
            metrics["total"] = total.detach()
        else:
            sums = None
            for i in range(accum_steps):
                size = batch["image"].shape[0] // accum_steps
                micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                tot, m = loss_fn(micro)
                tot.backward()  # .grad accumulates the sum over micro-batches
                m["total"] = tot.detach()
                sums = m if sums is None else {k: sums[k] + m[k] for k in m}
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum_steps)
            metrics = {k: v / accum_steps for k, v in sums.items()}
        for p in model.parameters():
            if p.grad is None:
                # a parameter the loss does not reach (the two-stream model's
                # two finest FlowNet flows): optax still decays it and moves
                # its momentum, where torch's SGD would skip it
                p.grad = torch.zeros_like(p)
        if multihost.process_count() > 1:
            average_gradients(model)
        state.apply_gradients()
        return metrics

    return train_step


def make_eval_step(model: nn.Module, nms_thresh: float = 0.45, nms_topk: int = 400, post_nms: int = 100):
    """Returns eval_step(images) -> (ids, scores, bboxes): the eval-mode
    forward and `postprocess_tout` (greedy NMS, K1 on the card)."""

    @torch.inference_mode()
    def eval_step(images):
        model.eval()
        boxes, scores = model(images)
        return postprocess_tout(boxes, scores, nms_thresh=nms_thresh, nms_topk=nms_topk, post_nms=post_nms)

    return eval_step
