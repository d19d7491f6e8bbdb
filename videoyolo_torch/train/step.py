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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..models.yolo3 import postprocess_tout
from ..ops.color import apply_color
from ..ops.losses import yolo3_loss
from ..ops.targets import merge_targets, prefetch_targets

__all__ = [
    "TrainState", "create_train_state", "make_optimizer", "make_train_step", "make_eval_step",
    "freeze_base_mask", "fast_forward_schedule",
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
      image      (B, H, W, 3)  normalised, or uint8 pixels with `color`
      color      (B, 3, 4)     optional per-image color maps (ops/color.py)
      gt_boxes   (B, M, 4)     corner pixels, -1 padded
      gt_ids     (B, M, 1)     or (B, M, C) multi-hot
      gt_mix     (B, M, 1)     read with `mixup`

    `input_hw` defaults to the image's (H, W).  `accum_steps` > 1 splits
    the batch into that many micro-batches, carries the BN statistics
    through them, and updates once with the mean of their gradients.

    The JAX step's other inputs come with the slices that need them: a
    head-only model's `features` and the per-timestep heads of t_out models
    (ROADMAP.md)."""

    def loss_fn(batch):
        x = batch["image"]
        if "color" in batch:
            x = apply_color(x, batch["color"])
        hw = input_hw or tuple(x.shape[-3:-1])
        out = model(x)
        gt_boxes, gt_ids = batch["gt_boxes"], batch["gt_ids"]
        gt_mix = batch.get("gt_mix") if mixup else None
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
