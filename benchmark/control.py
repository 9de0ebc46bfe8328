"""The control: the plain reference one precision below the configuration's,
put in the port's place, which the comparison has to find not correct.

The configuration states 8-bit samples and a lossless codec; the control
answers every call with the reference's answer at 7 bits (each sample, or
for MHVT each residual before the fold, keeps its top 7 bits), through the
same harness, window and comparison as a run of the port. The benchmark's
own runs never use it. On the card, at a cell's own size:

    python3 -m benchmark.control --workload <cell> --seconds 2 \\
        --seeds 11 12 13

prints each seed's checks, and exits 1 if any seed's run came out correct.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .reference import plain
from .system import Staged


def build() -> float:
    return 0.0


def launches() -> dict:
    return {}


def stage(config: dict, clip: np.ndarray, order: np.ndarray,
          pan: tuple[int, int], device) -> Staged:
    """Each call answers the reference's 7-bit answer, staged on ``device``."""
    import torch

    ans = torch.from_numpy(plain.staged_answer(config["codec"], clip, order,
                                               pan, lossy=True)).to(device)
    return Staged(lambda: ans, {"words": 0, "offsets": 0, "symbols": 0,
                                "frame_bytes": clip.nbytes})


def ranged(config: dict, clip: np.ndarray, device):
    """Each request answers the reference's 7-bit frames."""
    return (lambda a, b: plain.range_answer(clip, a, b, lossy=True)), 0


def main(argv=None) -> int:
    import torch

    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    cell, config, mix = harness.find_cell(bench, args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    readings, correct = [], []
    for seed in args.seeds:
        out = harness.run_cell(bench, cell, config, mix, seed, args.seconds,
                               False, device, time.perf_counter(),
                               subject=sys.modules[__name__])
        readings.append(out["checks"]["wrong_bytes"]["value"])
        correct.append(out["correct"])
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "control_correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    print(json.dumps({"workload": cell["name"], "device": str(device),
                      "least_wrong_bytes": min(readings)}), flush=True)
    return 1 if any(correct) else 0


if __name__ == "__main__":
    sys.exit(main())
