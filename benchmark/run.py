"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See benchmark/README.md. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, and with --trace 1
the breakdown); the numbers compared with the reference, each beside its
limit, are its last key and the last lines of standard error. Without a
CUDA card, or with a JAX module loaded once the window has closed, it
prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the run may fill lives at a fixed path in the checkout
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path.insert(1, str(ROOT))

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("benchmark: no CUDA card", file=sys.stderr)
        return 2
    import harness

    try:
        result, lines = harness.run(ROOT, args.workload, args.seed,
                                    args.seconds, bool(args.trace),
                                    torch.device("cuda", 0), T_START)
    except harness.Malformed as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: JAX modules loaded in this process: {bad}",
              file=sys.stderr)
        return 1
    print(f"memory_peak_bytes {result['device']['memory_peak_bytes']}",
          flush=True)
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
