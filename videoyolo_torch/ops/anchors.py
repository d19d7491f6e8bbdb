"""YOLOv3 anchors and grid offsets (port of videoyolo_tpu/ops/anchors.py)."""
from __future__ import annotations

import torch

# Anchors are listed shallow -> deep (stride 8, 16, 32), as (w, h) pairs.
DEFAULT_ANCHORS = (
    (10, 13, 16, 30, 33, 23),
    (30, 61, 62, 45, 59, 119),
    (116, 90, 156, 198, 373, 326),
)
DEFAULT_STRIDES = (8, 16, 32)


def grid_offsets(height: int, width: int, device) -> torch.Tensor:
    """(H*W, 2) float32 grid of (x, y) cell indices, row-major.

    Built on `device` with `arange`, so the decode never copies a host
    constant to the card."""
    gy, gx = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([gx, gy], dim=-1).reshape(-1, 2)
