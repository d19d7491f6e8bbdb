"""Input normalisation on the device (port of
videoyolo_tpu/data/transforms.py:to_normalized)."""
from __future__ import annotations

import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def to_normalized(img: torch.Tensor, mean=MEAN, std=STD, dtype=torch.float32) -> torch.Tensor:
    """[0, 255] (..., H, W, 3) -> (x/255 - mean)/std computed in float32,
    then cast to `dtype`.  Channel-last, as in the JAX package.

    `mean` / `std` may be tensors already on `img`'s device, which saves a
    host-to-device copy per call."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=img.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=img.device)
    return ((img.float() / 255.0 - mean) / std).to(dtype)
