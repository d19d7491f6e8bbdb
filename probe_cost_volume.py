#!/usr/bin/env python3
"""Time K2's adjoint (`cost_volume_backward`, videoyolo_torch/csrc/
correlation.cu) of a checkout at the window train step's three levels (B=16
windows of 3 frames, d=4, frames 0 and 1 taken by their batch stride as the
Corr layer passes them), on one CUDA card; or the forward under other plans
and builds.

    python3 probe_cost_volume.py [--root DIR] [--sweep]   # DIR: the checkout whose package is timed
    python3 probe_cost_volume.py --forward

Two versions of the adjoint are compared on one card by running this from
the root of one checkout with --root pointing at each, in turns (old, new,
new, old; unpack the parent with `git archive` into the git-ignored
`_checkout/`).  At each level the adjoint is first held against the plain
version (allclose rtol=atol=1e-5), then timed two ways: `ms`, the median of
CUDA events around each of 30 calls, and `queued_ms`, the device's time a
call with the launch queue kept full (`videoyolo_torch/profiling.py` of this
checkout, loaded by path).  `digest` hashes gf1 and gf2 with each zero made
+0: two versions with equal digests are equal bit for bit on these finite
inputs, signed zeros aside.  The inputs come from a seeded generator on the
card, the same in every run.  Where the package has `plan_backward`, each
level prints its plan, and --sweep times every (R, column groups) of
BACKWARD_CANDIDATES at slab widths of 16 channels to all of C, each plan
held against the plain version first.  Where it has
`cost_volume_pair_backward`, each level also times the pair launch (the
Corr layer's two volumes of a window, frames 0 and 2 against frame 1)
against what it replaces, two one-volume launches and the add of the middle
frame's gradients, after holding it against the plain pair and, bit for
bit, against those; --sweep times the pair at each slab width too.

--forward times the forward (`cost_volume`) at slice 2's levels (B=32)
under each plan (the register tile R, the displacement group rows gy, the
warps of a CTA) and under builds with one line of the source replaced
(BUILDS: the staged rows unpadded, the 16-byte copies cached in L1), each
held against `correlation_plain` first, in turns (the order, then the
reverse), median of 30 launches each.

Prints the card, then one JSON line per level.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import itertools
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
D = 4
STEPS = 2 * D + 1
TOL = dict(rtol=1e-5, atol=1e-5)
LEVELS = [(52, 256), (26, 512), (13, 1024)]  # (H = W, C)
TRAIN_WINDOWS, REQUEST_WINDOWS = 16, 32
# forward source variants: name -> (line replaced, its replacement, module constants)
BUILDS = {
    "base": None,
    "pad0": ("constexpr int kRowPad = 4;", "constexpr int kRowPad = 0;", dict(ROW_PAD=0)),
    "l1": ("cp.async.cg.shared.global [%0], [%1], 16, %2;", "cp.async.ca.shared.global [%0], [%1], 16, %2;", {}),
}
# the forward variants: every (R, gy, warps) on the source as it is; the
# other builds with the plan's two 8x8-pixel tilings
PLANS = list(itertools.product((2, 1), (3, 1), (2, 1)))
OTHER_PLANS = [(2, 3, 1), (1, 3, 2)]


def own_profiling():
    spec = importlib.util.spec_from_file_location("probe_profiling", HERE / "videoyolo_torch" / "profiling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def digest(*ts: torch.Tensor) -> str:
    """sha256 of the tensors' bytes with -0 made +0."""
    h = hashlib.sha256()
    for t in ts:
        h.update((t + 0.0).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def forced(ck, pl, fn, *args):
    """A call of `fn(*args, D, 1)` under a forced adjoint plan, the module
    restored after each call."""
    def run():
        saved = ck.plan_backward
        ck.plan_backward = lambda *a, **k: pl
        try:
            return fn(*args, D, 1)
        finally:
            ck.plan_backward = saved
    return run


def adjoint(args, prof, smi) -> None:
    """The adjoint of the checkout at --root, level by level."""
    sys.path.insert(0, str(Path(args.root).resolve()))
    from videoyolo_torch.ops import correlation_kernel as ck

    planned, paired = hasattr(ck, "plan_backward"), hasattr(ck, "cost_volume_pair_backward")
    if args.sweep and not paired:
        raise SystemExit(f"probe: {args.root} has no plan_backward and pair adjoint to sweep")
    gen = torch.Generator(device="cuda").manual_seed(0)
    gen_b = torch.Generator(device="cuda").manual_seed(1)  # the pair's second gradient
    for h, c in LEVELS:
        window = torch.randn(TRAIN_WINDOWS, 3, h, h, c, generator=gen, device="cuda")
        f1, f2 = window[:, 0], window[:, 1]
        g = torch.randn(TRAIN_WINDOWS, h, h, STEPS * STEPS, generator=gen, device="cuda")
        want = ck.cost_volume_backward_plain(g, f1, f2, D, 1)
        variants = {"kernel": lambda: ck.cost_volume_backward(g, f1, f2, D, 1)}
        plans = {}
        if args.sweep:
            slabs = sorted({16, 32, 64, 128, 256, -(-c // 16) * 16} & set(range(16, c + 16, 16)))
            for r, groups in ck.BACKWARD_CANDIDATES:
                for slab in slabs:
                    pl = ck._make_backward(TRAIN_WINDOWS, h, h, c, 1, r, groups, STEPS, STEPS, slab, True)
                    plans[f"R{r}_threads{pl.threads}_slab{slab}"] = pl
                    variants[f"R{r}_threads{pl.threads}_slab{slab}"] = forced(ck, pl, ck.cost_volume_backward, g, f1, f2)
        for name, run in variants.items():
            got = run()
            torch.cuda.synchronize()
            if not all(torch.allclose(a, b, **TOL) for a, b in zip(got, want)):
                err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                raise SystemExit(f"probe: {h}x{h}x{c} {name}: max abs error {err} against the plain adjoint")
        pairs = {}
        if paired:
            gb = torch.randn(TRAIN_WINDOWS, h, h, STEPS * STEPS, generator=gen_b, device="cuda")
            ga = g

            def two():  # what the pair replaces: two launches and the middle frame's add
                a, b = ck.cost_volume_backward(ga, f1, f2, D, 1), ck.cost_volume_backward(gb, window[:, 2], f2, D, 1)
                return a[0], a[1] + b[1], b[0]

            pairs["pair"] = lambda: ck.cost_volume_pair_backward(ga, gb, window, D, 1)
            pairs["two_volumes"] = two
            if args.sweep:
                for slab in slabs:
                    pl = ck._make_backward(TRAIN_WINDOWS, h, h, c, 1, 2, 4, STEPS, STEPS, slab, True, 4)
                    plans[f"pair_slab{slab}"] = pl
                    pairs[f"pair_slab{slab}"] = forced(ck, pl, ck.cost_volume_pair_backward, ga, gb, window)
            want_pair = ck.cost_volume_pair_backward_plain(ga, gb, window, D, 1)
            ref = torch.stack(two(), dim=1)
            for name, run in pairs.items():
                got = run()
                got = torch.stack(got, dim=1) if isinstance(got, tuple) else got
                torch.cuda.synchronize()
                if not (torch.allclose(got, want_pair, **TOL) and torch.equal(got, ref)):
                    raise SystemExit(f"probe: {h}x{h}x{c} {name}: not the plain pair adjoint within {TOL}, or not "
                                     "two one-volume launches' gradients bit for bit")
        row = dict(level=f"{h}x{h}x{c}", batch=TRAIN_WINDOWS, root=args.root, card=smi,
                   digest=digest(*variants["kernel"]()))
        if planned:
            pl = ck.plan_backward(TRAIN_WINDOWS, h, h, c, D, 1)
            row["plan"] = dict(r=pl.r, gx=pl.gx, gy=pl.gy, tile=pl.tile, slab=pl.slab, threads=pl.threads,
                               smem=pl.smem, ctas=pl.ctas)
        row["ms"] = statistics.median(prof.cuda_time_ms(variants["kernel"], iters=30))
        row["queued_ms"] = prof.queued_ms(variants["kernel"])
        if paired:
            pl = ck.plan_backward(TRAIN_WINDOWS, h, h, c, D, 1, pair=True)
            row["pair_plan"] = dict(slab=pl.slab, ctas=pl.ctas)
            row["pair_queued_ms"] = prof.queued_ms(pairs["pair"])
            row["two_volumes_queued_ms"] = prof.queued_ms(pairs["two_volumes"])
        if args.sweep:
            runs = {**variants, **pairs}
            ms = {name: prof.queued_ms(runs[name]) for name in plans}
            ms.update({name: prof.queued_ms(runs[name]) for name in reversed(list(plans))})
            row["sweep_queued_ms"] = dict(sorted(ms.items(), key=lambda kv: kv[1]))
            row["sweep_ctas"] = {name: pl.ctas for name, pl in plans.items()}
        print(json.dumps(row), flush=True)


def forward_library(ck, cuda_build, name):
    """(the forward's library built from a variant of the source, bound as
    the wrapper binds its own; the module constants it needs; ptxas
    registers by instance)."""
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


def forward(prof, smi) -> None:
    """The forward of this checkout under other plans and builds."""
    sys.path.insert(0, str(HERE))
    from videoyolo_torch.ops import correlation_kernel as ck
    from videoyolo_torch.ops import cuda_build
    from videoyolo_torch.ops.correlation import correlation_plain

    def runner(f1, f2, pl, lib, consts):
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
            return ck._make(REQUEST_WINDOWS, h, h, c, STEPS, 1, r, STEPS, gy, warps, True)
        finally:
            for k, v in saved.items():
                setattr(ck, k, v)

    libs = {name: forward_library(ck, cuda_build, name) for name in BUILDS}
    print(json.dumps({"registers, spill bytes": {name: regs for name, (_, _, regs) in libs.items()}}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for h, c in LEVELS:
        window = torch.randn(REQUEST_WINDOWS, 3, h, h, c, generator=gen, device="cuda")
        f1, f2 = window[:, 0], window[:, 1]
        ref = correlation_plain(f1, f2, D, 1, 1, 1)
        plan = ck.plan(REQUEST_WINDOWS, h, h, c, D, 1)
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
                times[name] += prof.cuda_time_ms(runs[name][0], iters=30, warmup=3)
        ms = {name: statistics.median(t) for name, t in times.items()}
        print(json.dumps(dict(
            level=f"{h}x{h}x{c}", card=smi,
            plan=f"R{plan.r}_gy{plan.gy}_w{plan.threads // 32}",
            ms=dict(sorted(ms.items(), key=lambda kv: kv[1])),
            plans={name: dict(r=pl.r, gy=pl.gy, threads=pl.threads, smem=pl.smem, ctas=pl.ctas)
                   for name, (_, pl) in runs.items()},
        )))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="the checkout whose adjoint is timed")
    ap.add_argument("--sweep", action="store_true", help="time the adjoint under every R and slab width")
    ap.add_argument("--forward", action="store_true", help="time the forward under other plans and builds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    smi = card()
    print(smi, flush=True)
    prof = own_profiling()
    if args.forward:
        forward(prof, smi)
    else:
        adjoint(args, prof, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
