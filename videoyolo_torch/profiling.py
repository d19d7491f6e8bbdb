"""Timing on the card (the counterpart of videoyolo_tpu/profiling.py's
forced timing).

CUDA events bracket each call on the current stream; a synchronise ends the
run, so the times are the device's, not the launch queue's.  There is no CPU
fallback: timing without a card raises.
"""
from __future__ import annotations

from typing import Callable, List

import torch


def cuda_time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> List[float]:
    """Per-call times in ms of `fn()` over `iters` calls, after `warmup`
    calls, measured with CUDA events."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms measures on the card; CUDA is not available")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]
