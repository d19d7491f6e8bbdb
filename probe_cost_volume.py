#!/usr/bin/env python3
"""Time the cost-volume kernel (videoyolo_torch/csrc/correlation.cu) under
other plans and other builds at slice 2's three levels (B=32 windows of 3
frames, d=4, the frames taken by their batch stride as the Corr layer passes
them), on one CUDA card.

    python3 probe_cost_volume.py        # from the root of a checkout

Each variant is first held against the plain version (allclose rtol=atol=
1e-5), then all are timed in turns (the order, then the reverse), median of
30 launches each.  A variant is a build of the source (as it is, or with one
line replaced: BUILDS, here the staged rows unpadded and the 16-byte copies
cached in L1) and a plan (the register tile R, the displacement group rows
gy and the warps of a CTA) forced in place of
`correlation_kernel.plan`.  Prints the card, then one JSON line per level
with each variant's ms, plan and the build's ptxas registers.
"""
from __future__ import annotations

import itertools
import json
import re
import statistics
import subprocess
import sys

import torch

from videoyolo_torch.ops import correlation_kernel as ck
from videoyolo_torch.ops import cuda_build
from videoyolo_torch.ops.correlation import correlation_plain
from videoyolo_torch.profiling import cuda_time_ms

D = 4
STEPS = 2 * D + 1
TOL = dict(rtol=1e-5, atol=1e-5)
LEVELS = [(52, 256), (26, 512), (13, 1024)]  # (H = W, C)
# source variants: name -> (line replaced, its replacement, module constants)
BUILDS = {
    "base": None,
    "pad0": ("constexpr int kRowPad = 4;", "constexpr int kRowPad = 0;", dict(ROW_PAD=0)),
    "l1": ("cp.async.cg.shared.global [%0], [%1], 16, %2;", "cp.async.ca.shared.global [%0], [%1], 16, %2;", {}),
}
# the variants: every (R, gy, warps) on the source as it is; the other
# builds with the plan's two 8x8-pixel tilings
PLANS = list(itertools.product((2, 1), (3, 1), (2, 1)))
OTHER_PLANS = [(2, 3, 1), (1, 3, 2)]


def library(name):
    """(the library built from a variant of the source, bound as the
    wrapper binds its own; the module constants it needs; ptxas registers
    by instance)."""
    if BUILDS[name] is None:
        path, consts = ck.SOURCE, {}
    else:
        old, new, consts = BUILDS[name]
        src = ck.SOURCE.read_text()
        if old not in src:
            raise SystemExit(f"probe: {old!r} is not in {ck.SOURCE}")
        cuda_build.BUILD_DIR.mkdir(exist_ok=True)
        path = cuda_build.BUILD_DIR / f"correlation_{name}.cu"
        path.write_text(src.replace(old, new))
    build = ck.build
    ck.build = lambda: cuda_build.build(path, ck.NVCC_FLAGS)
    try:
        lib = ck._library.__wrapped__()
        report = ck.build()[1]
    finally:
        ck.build = build
    regs = {}
    for body in report.split("Compiling entry function")[1:]:
        inst = re.search(r"cost_volume_kernelILi(\d+)ELi(\d+)ELi(\d+)E", body)
        used = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        if inst and used:
            regs["R{}_gx{}_gy{}".format(*inst.groups())] = (int(used.group(1)), int(spill.group(1)) if spill else None)
    return lib, consts, regs


def runner(f1, f2, pl, lib, consts):
    """A call of cost_volume under a forced plan, library and module
    constants, restoring the module after each call."""
    def run():
        saved = dict(plan=ck.plan, _library=ck._library, **{k: getattr(ck, k) for k in consts})
        ck.plan = lambda *a, **k: pl
        ck._library = lambda: lib
        for k, v in consts.items():
            setattr(ck, k, v)
        try:
            return ck.cost_volume(f1, f2, D, 1)
        finally:
            for k, v in saved.items():
                setattr(ck, k, v)
    return run


def make_plan(h, c, r, gy, warps, consts):
    saved = {k: getattr(ck, k) for k in consts}
    for k, v in consts.items():
        setattr(ck, k, v)
    try:
        return ck._make(32, h, h, c, STEPS, 1, r, STEPS, gy, warps, True)
    finally:
        for k, v in saved.items():
            setattr(ck, k, v)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    libs = {name: library(name) for name in BUILDS}
    print(json.dumps({"registers, spill bytes": {name: regs for name, (_, _, regs) in libs.items()}}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for h, c in LEVELS:
        window = torch.randn(32, 3, h, h, c, generator=gen, device="cuda")
        f1, f2 = window[:, 0], window[:, 1]
        ref = correlation_plain(f1, f2, D, 1, 1, 1)
        plan = ck.plan(32, h, h, c, D, 1)
        runs = {}
        variants = [("base", r, gy, w) for r, gy, w in PLANS]
        variants += [(b, r, gy, w) for b in BUILDS if b != "base" for r, gy, w in OTHER_PLANS]
        for build, r, gy, w in variants:
            lib, consts, _ = libs[build]
            pl = make_plan(h, c, r, gy, w, consts)
            if pl.smem > ck.SMEM_BYTES:
                continue
            runs[f"{build}_R{r}_gy{gy}_w{w}"] = (runner(f1, f2, pl, lib, consts), pl)
        for name, (run, pl) in runs.items():
            out = run()
            torch.cuda.synchronize()
            if not torch.allclose(out, ref, **TOL):
                raise SystemExit(f"probe: {h}x{h}x{c} {name}: max abs error {float((out - ref).abs().max())}")
        times = {name: [] for name in runs}
        order = list(runs)
        for names in (order, order[::-1]):
            for name in names:
                times[name] += cuda_time_ms(runs[name][0], iters=30, warmup=3)
        ms = {name: statistics.median(t) for name, t in times.items()}
        print(json.dumps(dict(
            level=f"{h}x{h}x{c}", card=smi,
            plan=f"R{plan.r}_gy{plan.gy}_w{plan.threads // 32}",
            ms=dict(sorted(ms.items(), key=lambda kv: kv[1])),
            plans={name: dict(r=pl.r, gy=pl.gy, threads=pl.threads, smem=pl.smem, ctas=pl.ctas)
                   for name, (_, pl) in runs.items()},
        )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
