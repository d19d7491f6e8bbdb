"""Timing on the card (the counterpart of videoyolo_tpu/profiling.py's
forced timing).

CUDA events bracket each call on the current stream; a synchronise ends the
run, so the times are the device's, not the launch queue's.  There is no CPU
fallback: timing without a card raises.
"""
from __future__ import annotations

import statistics
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


def queued_ms(fn: Callable[[], object], iters: int = 100, repeats: int = 3) -> float:
    """Device ms per call of `fn()` with the launch queue kept full: a sleep
    kernel holds the stream while `iters` calls are enqueued, and CUDA events
    bracket the calls, so host time between calls does not count (median of
    `repeats` runs).  Where the host launches a call slower than the card
    runs it, `cuda_time_ms` shows the host's time and this the card's."""
    if not torch.cuda.is_available():
        raise RuntimeError("queued_ms measures on the card; CUDA is not available")
    fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # tens of ms: longer than enqueueing the calls
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)
