"""Write a configuration's stored receiver data with the plain reference.

    python3 benchmark/make_data.py --config ring2d-301 [--device cuda]

For each phantom seed of the configuration's ``data`` entry: the breast
phantom (phantom.py) on the finer grid the data are synthesized on, every
element transmitting at unit amplitude, one reference solve in
complex128, the field sampled at every element. The (P, n_elem, n_elem)
complex64 matrices go to ``data.file``; a reconstruction scales each
transmitter's row by its own amplitude, since the data are linear in the
source. Imports nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

import reference
from phantom import breast_phantom

ROOT = Path(__file__).resolve().parent.parent


def make(config: dict, device) -> np.ndarray:
    d = config["data"]
    synth = dict(config, grid=d["synthesized_on"])
    grid = reference.grid_of(d["synthesized_on"])
    n = int(config["ring"]["num_elements"])
    out = []
    for seed in d["phantom_seeds"]:
        t0 = time.perf_counter()
        vel = breast_phantom(grid, int(seed))
        rec = reference.synthesize(vel, synth, np.ones(n, np.complex128),
                                   device, dtype=torch.complex128)
        out.append(rec.astype(np.complex64))
        print(f"phantom {seed}: {grid.n}^2, {time.perf_counter() - t0:.1f} s, "
              f"|d| max {np.abs(rec).max():.4e}", flush=True)
    return np.stack(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    root = Path(args.root)
    with open(root / "benchmark" / "configs" / f"{args.config}.json") as fh:
        config = json.load(fh)
    rec = make(config, torch.device(args.device))
    out = root / config["data"]["file"]
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, rec=rec,
                        phantom_seeds=np.asarray(config["data"]["phantom_seeds"]))
    print(f"wrote {out} {rec.shape}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
