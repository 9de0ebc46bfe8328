"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Sets up (builds or loads the port's kernels, makes the seed's clip, encodes
and stages it as the cell's configuration stores it, warms every call up),
measures for ``--seconds``, compares the window's answers with the plain
reference, and prints one JSON line as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics from a
``torch.profiler`` trace of the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error. Everything else goes to standard error.

Exits with 2, printing no result, without a CUDA device (or with fewer
than the cell asks for), and with 3 when the run has loaded JAX or the JAX
package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a library the port imports must not load JAX on its own
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(REPO))
    from benchmark import guard, harness

    bench = harness.load_benchmark()
    cell, config, mix = harness.find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device: this benchmark measures the card and "
                    "has no CPU fallback")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        harness.log(f"{cell['name']} needs {cell['chips']} CUDA devices, "
                    f"{torch.cuda.device_count()} visible")
        return 2
    out = harness.run_cell(bench, cell, config, mix, args.seed % 2**63,
                           args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    bad = guard.forbidden()
    if bad:
        harness.log(f"the run loaded {', '.join(bad)}: the benchmark "
                    "measures metalhuffman_tpu_torch alone")
        return 3
    harness.log(f"result: correct={out['correct']} attempted="
                f"{out['attempted']} failed={out['failed']} metrics="
                f"{json.dumps(out['metrics'])}")
    for name, c in out["checks"].items():
        op, limit = next((k, v) for k, v in c.items() if k != "value")
        harness.log(f"check {name}: {c['value']} ({op.replace('_', ' ')} "
                    f"{limit})")
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
