#!/usr/bin/env python3
"""Drive the PyTorch port's detect path on one NVIDIA card and hold its
kernels against their plain PyTorch versions.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card

Phases; any failure exits non-zero:
  1. device: the card's name and power limit, torch and CUDA versions, the
     TF32 switches (set off, so float32 means float32);
  2. build: the NMS kernel (videoyolo_torch/csrc/nms.cu) with nvcc, sm_90a;
  3. kernel vs plain: the NMS kernel against ops/nms.py:nms_greedy_plain on
     the card, at the main path's shape and on edge cases: keep masks and
     packed rows (with and without the keep mask written) must be equal bit
     for bit;
  4. slice: Detector(YoloConfig(num_classes=20, pad_stem=True), bf16) at
     416 px with seeded random weights answers requests of B=1, 8 and 128;
     the kernel's launch count must rise by one per request, the outputs
     must be in range, and the B=128 detections must equal the plain NMS's
     on the same candidates; then the detect step's times, and one request
     through the entry point `python -m videoyolo_torch.detect`;
  5. reference: the same weights in float32 on the card and on the CPU agree
     on a small input;
  6. profile: the device's busy share and top kernels of the step at B=128
     and at B=1.
The line before last lists every kernel; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from videoyolo_torch import detect
from videoyolo_torch.data.transforms import to_normalized
from videoyolo_torch.models.factory import YoloConfig
from videoyolo_torch.models.yolo3 import select_topk_candidates
from videoyolo_torch.ops import nms_kernel
from videoyolo_torch.ops.nms import nms_greedy_plain
from videoyolo_torch.ops.nms_kernel import nms_greedy
from videoyolo_torch.profiling import cuda_time_ms
from videoyolo_torch.serving import NMS_THRESH, NMS_TOPK, Detector

SIZE = 416
NUM_CLASSES = 20
POST_NMS = 100
VALID_THRESH = 0.01
REQUEST_BATCHES = (1, 8, 128)
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# float operations per box (2 sub, 2 clamp, mul) and per IoU pair (2 max,
# 2 min, 2 sub, 2 clamp, mul, add, sub, max, div, compare)
AREA_OPS = 5
IOU_OPS = 14


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def candidates(rs, b, k, classes=NUM_CLASSES):
    """(B, K, 6) score-descending rows over a 416-px image, from numpy."""
    scores = np.sort(rs.rand(b, k))[:, ::-1].astype(np.float32)
    ids = rs.randint(0, classes, (b, k)).astype(np.float32)
    xy = rs.rand(b, k, 2).astype(np.float32) * 0.8 * SIZE
    wh = rs.rand(b, k, 2).astype(np.float32) * 150 + 4
    return np.concatenate([ids[..., None], scores[..., None], xy, xy + wh], -1)


def kernel_cases(rs):
    main = candidates(rs, 128, 400)
    low = candidates(rs, 16, 400)
    low[:, 300:, 1] = 0.005
    low[:, 250, 1] = np.float32(VALID_THRESH)  # at the threshold: invalid
    neg = candidates(rs, 16, 400)
    neg[:, ::7, 0] = -1.0
    same = candidates(rs, 8, 400)
    same[:, :, 2:6] = same[:, :1, 2:6]
    # (name, dets, post_nms, force_suppress)
    return [
        ("main_B128_K400", main, POST_NMS, False),
        ("force_suppress", candidates(rs, 16, 400), POST_NMS, True),
        ("below_valid_thresh", low, -1, False),
        ("negative_ids", neg, POST_NMS, False),
        ("K1", candidates(rs, 4, 1), POST_NMS, False),
        ("K45", candidates(rs, 8, 45, classes=3), -1, False),
        ("K1024", candidates(rs, 8, 1024), -1, False),
        ("K1024_force", candidates(rs, 4, 1024), POST_NMS, True),
        ("identical_boxes", same, -1, False),
        ("identical_boxes_force", same, POST_NMS, True),
    ]


def nms_bound(cands: torch.Tensor, m: int, force: bool, keep: bool):
    """Least time (ms) an H100 could take for the NMS of these candidates:
    bytes (each input read once, each output written once: the packed rows,
    and the keep mask when `keep`) over HBM bandwidth vs the float work these
    candidates need (areas, and the IoU of every upper-triangle pair that the
    class test lets through) over the float32 peak.  Returns (ms, "bytes" |
    "operations")."""
    b, k, _ = cands.shape
    nbytes = b * k * 6 * 4 + b * m * 6 * 4 + (b * k * 4 if keep else 0)
    ids = cands[..., 0]
    pairs = torch.ones(k, k, dtype=torch.bool, device=cands.device).triu(1)[None]
    if not force:
        pairs = pairs & (ids[:, :, None] == ids[:, None, :])
    ops = AREA_OPS * b * k + IOU_OPS * int(pairs.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def median_ms(fn, iters, warmup=3):
    return statistics.median(cuda_time_ms(fn, iters=iters, warmup=warmup))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()} limit)"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
    )

    # 2. build
    t0 = time.perf_counter()
    lib, ptxas = nms_kernel.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. the kernel against its plain version
    rs = np.random.RandomState(0)
    max_err = 0.0
    cases = kernel_cases(rs)
    for name, dets, post, force in cases:
        d = torch.from_numpy(np.ascontiguousarray(dets)).to(dev)
        packed, keep = nms_greedy(d, NMS_THRESH, VALID_THRESH, post, force)
        packed_only, no_keep = nms_greedy(d, NMS_THRESH, VALID_THRESH, post, force, return_keep=False)
        ref_packed, ref_keep = nms_greedy_plain(d, NMS_THRESH, VALID_THRESH, post, force)
        torch.cuda.synchronize()
        check(torch.equal(keep.bool(), ref_keep), f"{name}: keep masks differ")
        check(torch.equal(packed, ref_packed), f"{name}: packed rows differ")
        check(no_keep is None and torch.equal(packed_only, ref_packed),
              f"{name}: packed rows differ without the keep mask")
        max_err = max(max_err, float((packed - ref_packed).abs().max()))
        print(
            f"nms {name}: B={d.shape[0]} K={d.shape[1]} force={force}: "
            f"{float(keep.sum(1).float().mean()):.1f} kept/image, equal"
        )
    # timed as the main path calls it (box_nms): no keep mask written
    d = torch.from_numpy(np.ascontiguousarray(cases[0][1])).to(dev)
    k_ms = median_ms(lambda: nms_greedy(d, NMS_THRESH, VALID_THRESH, POST_NMS, return_keep=False), 50)
    p_ms = median_ms(lambda: nms_greedy_plain(d, NMS_THRESH, VALID_THRESH, POST_NMS), 20)
    b_ms, b_by = nms_bound(d, POST_NMS, False, keep=False)
    print(
        f"nms synthetic B=128 K=400 on {card}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
        f"bound {b_ms:.5f} ms ({b_by})"
    )

    # 4. the slice: the port's detect path at 416 px, bf16
    t0 = time.perf_counter()
    det = Detector(
        YoloConfig(num_classes=NUM_CLASSES, pad_stem=True), dtype=torch.bfloat16,
        data_shape=SIZE, device="cuda", seed=0,
    )
    print(f"Detector built on {det.device} in {time.perf_counter() - t0:.1f} s")
    requests = [rs.randint(0, 256, (b, SIZE, SIZE, 3)).astype(np.uint8) for b in REQUEST_BATCHES]
    nms_greedy.launches = 0
    outs = [det(x) for x in requests]
    torch.cuda.synchronize()
    launches = nms_greedy.launches
    check(launches == len(requests), f"NMS kernel launches {launches}, requests {len(requests)}")
    for (ids, sc, bb), x in zip(outs, requests):
        b = x.shape[0]
        check(ids.shape == sc.shape == (b, POST_NMS, 1), f"B={b}: ids/scores {tuple(ids.shape)}")
        check(bb.shape == (b, POST_NMS, 4), f"B={b}: boxes {tuple(bb.shape)}")
        check(all(bool(torch.isfinite(t).all()) for t in (ids, sc, bb)), f"B={b}: non-finite output")
        check(bool(((ids >= -1) & (ids < NUM_CLASSES) & (ids == ids.round())).all()), f"B={b}: ids")
        kept = ids >= 0
        check(bool(((sc > VALID_THRESH) & (sc <= 1))[kept].all()), f"B={b}: kept scores")
        check(bool((sc[~kept] == -1).all()), f"B={b}: padding scores")
        check(bool(((bb >= 0) & (bb <= SIZE)).all()), f"B={b}: boxes outside [0, {SIZE}]")
        n = int(kept.sum())
        check(n > 0, f"B={b}: no detections")
        print(f"request B={b}: {n} detections ({n / b:.1f}/image), outputs in range")
    print(f"NMS kernel launches over {len(requests)} requests: {launches}")

    # the B=128 request again, step by step: plain NMS on the same candidates
    x128 = torch.from_numpy(requests[-1]).to(dev)
    with torch.inference_mode():
        xn = to_normalized(x128, dtype=det.dtype)
        boxes, scores = det.model(xn)
        cands = select_topk_candidates(boxes, scores, topk=NMS_TOPK)
        packed, keep = nms_greedy(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
        ref_packed, ref_keep = nms_greedy_plain(cands, NMS_THRESH, VALID_THRESH, POST_NMS)
    check(torch.equal(keep.bool(), ref_keep) and torch.equal(packed, ref_packed),
          "B=128 model candidates: kernel and plain NMS differ")
    ids, sc, bb = outs[-1]
    check(
        torch.equal(ids, ref_packed[..., 0:1]) and torch.equal(sc, ref_packed[..., 1:2])
        and torch.equal(bb, ref_packed[..., 2:6].clamp(0, SIZE)),
        "B=128 request: detections differ from the plain NMS on the same candidates",
    )
    max_err = max(max_err, float((packed - ref_packed).abs().max()))
    print(f"B=128 request: detections equal the plain NMS's on the same candidates "
          f"({int(ref_keep.sum())} kept of {ref_keep.numel()})")

    k_ms = median_ms(
        lambda: nms_greedy(cands, NMS_THRESH, VALID_THRESH, POST_NMS, return_keep=False), 50
    )
    p_ms = median_ms(lambda: nms_greedy_plain(cands, NMS_THRESH, VALID_THRESH, POST_NMS), 20)
    b_ms, b_by = nms_bound(cands, POST_NMS, False, keep=False)
    print(
        f"nms model candidates B=128 K={cands.shape[1]} on {card}: kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by})"
    )

    x1 = torch.from_numpy(requests[0]).to(dev)
    with torch.inference_mode():
        t_fwd = median_ms(lambda: det.model(xn), 10)
        t_sel = median_ms(lambda: select_topk_candidates(boxes, scores, topk=NMS_TOPK), 20)
    t128 = median_ms(lambda: det(x128), 10)
    t1 = median_ms(lambda: det(x1), 30, warmup=5)
    print(
        f"detect B=128 at {SIZE} px bf16 on {card}: {128 / t128 * 1e3:.1f} images/s "
        f"({t128:.3f} ms/batch: forward {t_fwd:.3f}, top-k select {t_sel:.3f}, "
        f"NMS kernel {k_ms:.4f})"
    )
    print(f"detect B=1 at {SIZE} px bf16 on {card}: {t1:.3f} ms/request")

    # the entry point, as a user runs it: one request of 8 images
    before = nms_greedy.launches
    preds = detect.main(["--data_shape", str(SIZE), "--batch_size", "8", "--num_requests", "1",
                         "--seed", "1"])
    check(nms_greedy.launches - before == 1,
          f"entry point: {nms_greedy.launches - before} NMS kernel launches for 1 request")
    check(len(preds) == 8, f"entry point: detections for {len(preds)} of 8 images")
    entries = [e for v in preds.values() for e in v]
    check(bool(entries) and all(
        0 <= e[0] < NUM_CLASSES and VALID_THRESH < e[1] <= 1 and all(0 <= v <= 1 for v in e[2:])
        for e in entries
    ), "entry point: detections out of range")
    print(f"entry point: {len(entries)} normalised detections over 8 images, in range")

    # 5. reference: float32 on the card vs float32 on the CPU, same weights
    cfg32 = YoloConfig(num_classes=NUM_CLASSES, pad_stem=True)
    small = torch.from_numpy(rs.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8))
    raw = []
    for device in ("cuda", "cpu"):
        d32 = Detector(cfg32, data_shape=128, device=device, seed=0)
        with torch.inference_mode():
            raw.append([t.cpu() for t in d32.model(to_normalized(small.to(device)))])
    for name, a, r in zip(("boxes", "scores"), raw[0], raw[1]):
        err = float((a - r).abs().max())
        check(bool(torch.allclose(a, r, rtol=1e-3, atol=1e-3)),
              f"float32 {name} on the card vs the CPU: max error {err}")
        print(f"reference: float32 {name} card vs CPU at 128 px: max abs error {err:.3g} "
              "(allclose rtol=atol=1e-3: other conv algorithms, other summation orders)")

    # 6. profile of the detect step: device busy share, launches, top kernels
    from torch.profiler import ProfilerActivity, profile

    for label, x, steps, top in (("B=128", x128, 3, 8), ("B=1", x1, 20, 4)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                det(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        if busy_ms == 0:
            print(f"profile {label}: the profiler recorded no device time; busy share not measured")
            continue
        print(
            f"profile {label} x{steps} on {card} (profiler on): wall {wall_ms / steps:.3f} ms/step, "
            f"device busy {busy_ms / steps:.3f} ms/step, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}, "
            f"{sum(e.count for e in events) // steps} device ops/step"
        )
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
            print(f"  {e.self_device_time_total / 1e3 / steps:9.3f} ms/step  "
                  f"{e.count // steps:4d}x  {e.key[:90]}")

    kernels = [{
        "name": "nms_greedy",
        "route": "cuda",
        "source": "videoyolo_torch/csrc/nms.cu",
        "replaces": "videoyolo_tpu/ops/pallas_nms.py:99",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "match": True,
        "cases": len(cases) + 1,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
