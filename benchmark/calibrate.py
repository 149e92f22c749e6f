"""Readings for a cell's correctness limits, on the card at the cell's own
size: the program against the reference over many seeds (the lower
reading), and the control, the reference in TF32 put in the program's
place, over a few (the upper reading).

    python3 benchmark/calibrate.py --workload <cell> --seeds 101,102,... \\
        [--control 3]

One process: a warm-up unit, then per seed unit 0 of that seed's inputs
through the program, the reference, and for the first ``--control``
seeds the control. One JSON line a reading. The benchmark's runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(1, str(ROOT))
    import torch

    import program
    import spec
    import workload

    device = torch.device(args.device)
    cell = spec.load(ROOT, args.workload)
    if device.type == "cuda":
        program.build_kernels()
    seeds = [int(s) for s in args.seeds.split(",")]
    warm = workload.make(cell, seeds[0], device)
    warm.unit(workload.WARMUP_BASE)
    for i, seed in enumerate(seeds):
        loop = workload.make(cell, seed, device)
        t0 = time.perf_counter()
        u = loop.unit(0)
        t1 = time.perf_counter()
        if u.error is not None:
            print(json.dumps({"seed": seed, "error": u.error}), flush=True)
            continue
        got = loop.produced(u)
        loop.run = u.output = None
        u.frames = []
        want = loop.expected(0)
        t2 = time.perf_counter()
        line = {"seed": seed, "program": loop.compare(got, want),
                "program_s": t1 - t0, "reference_s": t2 - t1}
        del got
        if i < args.control:
            line["control"] = loop.compare(loop.expected(0, "tf32"), want)
            line["control_s"] = time.perf_counter() - t2
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
