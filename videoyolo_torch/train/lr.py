"""Learning-rate schedules (port of videoyolo_tpu/train/lr.py:21-54).

Linear warmup from `warmup_lr` to `lr` over `warmup_epochs` (a float is
taken), then one of step (times `lr_decay` at each epoch of
`lr_decay_epochs`, counted after warmup), poly (power 2 down to 0 at
`epochs`), cosine (down to 0 at `epochs`) or constant.  f(step) -> lr as a
float32 scalar tensor, computed in float32 as the JAX package does.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

__all__ = ["lr_schedule"]


def lr_schedule(
    mode: str,
    base_lr: float,
    steps_per_epoch: int,
    epochs: int,
    warmup_epochs: float = 0,
    warmup_lr: float = 0.0,
    lr_decay: float = 0.1,
    lr_decay_epochs: Sequence[int] = (),
    power: int = 2,
) -> Callable[[int], torch.Tensor]:
    if mode not in ("step", "poly", "cosine", "constant"):
        raise ValueError(f"lr mode must be step, poly, cosine or constant, got {mode!r}")
    f32 = torch.float32
    warmup_steps = warmup_epochs * steps_per_epoch
    total_steps = max((epochs - warmup_epochs) * steps_per_epoch, 1)
    decay_steps = torch.tensor([e * steps_per_epoch for e in lr_decay_epochs], dtype=f32)

    def sched(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=f32)
        wf = torch.clamp(step / max(warmup_steps, 1), 0.0, 1.0)
        warm = warmup_lr + (base_lr - warmup_lr) * wf
        t = torch.clamp((step - warmup_steps) / total_steps, 0.0, 1.0)
        if mode == "step":
            n = (step - warmup_steps >= decay_steps).sum() if len(lr_decay_epochs) else 0
            main = base_lr * torch.as_tensor(lr_decay, dtype=f32) ** n
        elif mode == "poly":
            main = base_lr * (1.0 - t) ** power
        elif mode == "cosine":
            main = base_lr * 0.5 * (1.0 + torch.cos(math.pi * t))
        else:
            main = torch.as_tensor(base_lr, dtype=f32)
        return torch.where(step < warmup_steps, warm, torch.as_tensor(main, dtype=f32))

    return sched
