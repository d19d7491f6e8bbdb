"""Device resolution for the port's entry points.

The port runs on the card.  `None` means CUDA, and a missing GPU is an
error, never a quiet move to the CPU; the CPU is used only when the caller
asks for it (the tests do, with `device="cpu"`).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` / "cuda" / "cuda:N" / "cpu" / a `torch.device` -> `torch.device`.

    Raises RuntimeError when CUDA is asked for (or defaulted to) and no
    CUDA device is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
