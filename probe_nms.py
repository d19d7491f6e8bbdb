#!/usr/bin/env python3
"""Time the greedy-NMS kernel K1 (`videoyolo_torch.ops.nms_kernel.nms_greedy`)
of a checkout on one CUDA card, as the detect step calls it: K=400
candidates an image, 100 detections, no keep mask written, at B=128 and B=1,
on synthetic candidates and on the slice-1 model's (YOLOv3, 20 classes,
pad_stem, bf16, 416 px, weights from seed 0).

    python3 probe_nms.py [--root DIR] [--sweep]   # DIR: the checkout whose package is timed (default: this one)

Two versions of K1 are compared on one card by running this from the root of
one checkout with --root pointing at each, in turns (old, new, new, old).
Each time is taken two ways: `ms`, the median of CUDA events around each of
50 calls (where the host launches a call slower than the card runs it, the
host's time), and `queued_ms`, the device's time a call with the launch
queue kept full (`videoyolo_torch/profiling.py:queued_ms` of this checkout,
loaded by path, so an older package needs none of its own).  The kernel is
first held against the plain version, bit for bit.  Two more readings say
where a version's time goes:
  * a package with the one-kernel K1 (a single `nms_greedy_launch`, the scan
    a loop `for (int wi = 0; wi < W; ++wi)`) is timed once more with that
    loop compiled out: the bitmask build, the valid bits and the pack alone;
  * --sweep, for a package with the two-launch K1 (`launch_mask`,
    `launch_scan`): each launch alone, queued, at B=1 and B=128 and K = 64 to
    2,048 synthetic candidates, whose slopes over the 64-row blocks split a
    launch into its fixed and its per-block cost.
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SIZE, K, POST, THRESH, VALID = 416, 400, 100, 0.45, 0.01
SCAN_LOOP = "for (int wi = 0; wi < W; ++wi) {"
SWEEP_K = (64, 128, 400, 1024, 2048)


def own_profiling():
    spec = importlib.util.spec_from_file_location("probe_profiling", HERE / "videoyolo_torch" / "profiling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def candidates(rs, b, k):
    """(B, K, 6) score-descending rows over a 416-px image, 20 classes."""
    scores = np.sort(rs.rand(b, k))[:, ::-1].astype(np.float32)
    ids = rs.randint(0, 20, (b, k)).astype(np.float32)
    xy = rs.rand(b, k, 2).astype(np.float32) * 0.8 * SIZE
    wh = rs.rand(b, k, 2).astype(np.float32) * 150 + 4
    return torch.from_numpy(np.concatenate([ids[..., None], scores[..., None], xy, xy + wh], -1)).cuda()


def without_scan(root: Path):
    """The root's one-kernel K1 built with its scan loop compiled out, as a
    function of the candidates; None where the source has no such loop."""
    from videoyolo_torch.ops import cuda_build

    source = root / "videoyolo_torch" / "csrc" / "nms.cu"
    text = source.read_text()
    if SCAN_LOOP not in text:
        return None
    variant = cuda_build.BUILD_DIR / "nms_without_scan.cu"
    variant.parent.mkdir(exist_ok=True)
    variant.write_text(text.replace(SCAN_LOOP, "for (int wi = 0; wi < 0; ++wi) {"))
    fn = ctypes.CDLL(str(cuda_build.build(variant, ("-fmad=false",))[0])).nms_greedy_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(d):
        out = torch.empty((d.shape[0], POST, 6), device=d.device)
        if fn(d.data_ptr(), out.data_ptr(), None, d.shape[0], d.shape[1], POST, THRESH, VALID, 0,
              torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("probe_nms: the variant without the scan failed to launch")
    return call


def sweep(prof, rs):
    """Each launch of the two-launch K1 alone, queued, over B and K."""
    from videoyolo_torch.ops import nms_kernel

    rows = []
    for b in (1, 128):
        for k in SWEEP_K:
            d = candidates(rs, b, k)
            pl = nms_kernel.plan(b, k)
            mask = torch.empty((b, k, pl.words), dtype=torch.int64, device=d.device)
            packed = torch.empty((b, min(POST, k), 6), device=d.device)
            stream = torch.cuda.current_stream().cuda_stream
            row = dict(b=b, k=k, words=pl.words)
            row["mask_ms"] = prof.queued_ms(lambda: nms_kernel.launch_mask(d, mask, pl, THRESH, False, stream))
            row["scan_ms"] = prof.queued_ms(lambda: nms_kernel.launch_scan(d, mask, packed, None, pl, VALID, stream))
            rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="the checkout whose videoyolo_torch is timed")
    ap.add_argument("--sweep", action="store_true", help="each launch alone over B and K (two-launch K1)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_nms: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    prof = own_profiling()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from videoyolo_torch.data.transforms import to_normalized
    from videoyolo_torch.models.factory import YoloConfig
    from videoyolo_torch.models.yolo3 import select_topk_candidates
    from videoyolo_torch.ops.nms import nms_greedy_plain
    from videoyolo_torch.ops.nms_kernel import nms_greedy
    from videoyolo_torch.serving import Detector

    rs = np.random.RandomState(0)
    synthetic = candidates(rs, 128, K)
    det = Detector(YoloConfig(num_classes=20, pad_stem=True), dtype=torch.bfloat16, data_shape=SIZE,
                   device="cuda", seed=0)
    images = torch.from_numpy(rs.randint(0, 256, (128, SIZE, SIZE, 3)).astype(np.uint8)).cuda()
    with torch.inference_mode():
        model = select_topk_candidates(*det.model(to_normalized(images, dtype=det.dtype)), topk=K)

    result = dict(root=args.root, card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    no_scan = without_scan(root)
    for name, cands in (("synthetic", synthetic), ("model", model)):
        for b in (128, 1):
            d = cands[:b].contiguous()
            packed, keep = nms_greedy(d, THRESH, VALID, POST)
            ref_packed, ref_keep = nms_greedy_plain(d, THRESH, VALID, POST)
            if not (torch.equal(packed, ref_packed) and torch.equal(keep.bool(), ref_keep)):
                print(f"probe_nms: {name} B={b}: the kernel differs from the plain version", file=sys.stderr)
                return 1

            def call():
                nms_greedy(d, THRESH, VALID, POST, return_keep=False)

            result[f"{name}_B{b}"] = dict(ms=statistics.median(prof.cuda_time_ms(call, iters=50)),
                                          queued_ms=prof.queued_ms(call))
            if no_scan:
                result[f"{name}_B{b}"]["without_scan_queued_ms"] = prof.queued_ms(lambda: no_scan(d))
    if args.sweep:
        result["sweep"] = sweep(prof, rs)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
