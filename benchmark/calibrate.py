"""Readings that the limits of a cell's check are set from (not run by the
benchmark's own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3
        [--control 1,2,3] [--faults 1,2,3]

In one process, for each seed: the program's weights drawn from that seed,
one clip (or one training run of the cell's checked steps) through the
timed path at the cell's size, then the check's numbers against the
reference; for the seeds of --control also the control's numbers (the
reference with every product in fp8 put in the program's place), and for
those of --faults the numbers of each fault of the cell's entry
(`FAULTS`). One JSON line a seed. Needs the card.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import run  # noqa: E402


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser("calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    ctl, flt = set(seeds(args.control)), set(seeds(args.faults))
    entry = None
    for seed in seeds(args.seeds):
        cell = run.Cell(args.workload, seed, 0.0, False, dev)
        if entry is None:
            entry = importlib.import_module(
                f"entries.{cell.workload['entry']}")
        t0 = time.perf_counter()
        out = entry.calibrate(cell, control=seed in ctl,
                              faults=seed in flt)
        out.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
