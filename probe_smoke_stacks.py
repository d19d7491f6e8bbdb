#!/usr/bin/env python3
"""Where `chip_smoke.py`'s time goes: its `main()` run with a thread that
samples the main thread's stack every `--period` seconds.

    python3 probe_smoke_stacks.py [--out chiprun_out/smoke_stacks.json] [--period 0.2]

Each sample counts every function on the stack once (its inclusive time),
the innermost frame of this repository with its line, and the innermost
line of `chip_smoke.py`; a count times the period is seconds.  The sampler
takes the GIL only between the main thread's bytecodes, so its cost is a
few stack walks a second.  The run needs the card, as `chip_smoke.py` does;
its exit code is the script's.  Writes one JSON object to `--out`.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def key_of(code) -> str:
    path = code.co_filename
    path = os.path.relpath(path, ROOT) if path.startswith(ROOT) else path.split("site-packages/")[-1]
    return f"{path}:{code.co_firstlineno}:{code.co_name}"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "smoke_stacks.json"))
    p.add_argument("--period", type=float, default=0.2)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import chip_smoke

    inclusive, inner, inner_smoke = collections.Counter(), collections.Counter(), collections.Counter()
    main_id, stop = threading.main_thread().ident, threading.Event()

    def sample():
        while not stop.wait(args.period):
            frame = sys._current_frames().get(main_id)
            seen, repo, smoke = set(), None, None
            while frame is not None:
                code = frame.f_code
                key = key_of(code)
                if key not in seen:
                    seen.add(key)
                    inclusive[key] += 1
                if repo is None and code.co_filename.startswith(ROOT):
                    repo = f"{key}@{frame.f_lineno}"
                if smoke is None and code.co_filename.endswith("chip_smoke.py"):
                    smoke = f"{code.co_name}@{frame.f_lineno}"
                frame = frame.f_back
            if repo:
                inner[repo] += 1
            if smoke:
                inner_smoke[smoke] += 1

    threading.Thread(target=sample, daemon=True).start()
    t0 = time.perf_counter()
    try:
        rc = chip_smoke.main()
    finally:
        stop.set()
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"period_s": args.period, "seconds": time.perf_counter() - t0,
                       "inclusive": inclusive.most_common(400), "inner": inner.most_common(400),
                       "inner_chip_smoke": inner_smoke.most_common(600)}, f)
    return rc


if __name__ == "__main__":
    sys.exit(main())
