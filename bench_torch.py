#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: decode and encode throughput
on one GPU, the twin of ``bench.py`` with the same arguments, modes and one
JSON line.

Modes (``metalhuffman_tpu_torch/bench.py``):

- ``video`` (default): a 30-frame 2048x1536 8-bit grayscale batch under one
  shared table, decoded by one launch of the image kernel (B1) a call over 4
  staged frame-order rotations; CUDA events, median and spread of 5
  repetitions of ``--iters`` calls. ``--content photo`` pans the committed
  bridge photo; ``--precoder delta2d`` takes the 2-D predictor.
- ``single``: one frame, back-to-back ``ImageCodec.decode_step`` calls on the
  host clock, each repetition ended by a host fetch (the calls' host work is
  in the number).
- ``encode``: the host encoder the port encodes with; B3's row form,
  ``encode_stream``, the row merge and the hybrid call as diagnostics.
- ``temporal``: the MHVT decode (B1, then the fold on the device);
  ``--motion`` and ``--inner color|u16`` take the other fold chains.

Every mode checks its output before it times anything; a wrong output
prints ``FATAL: ...`` on stderr and exits 1. Baseline: the reference's
2048x1536 at 30 FPS, 0.094 GB/s decoded. Prints exactly ONE line on stdout:

    {"metric": "decode_throughput", "value": N, "unit": "GB/s",
     "vs_baseline": N, "reps": R, "spread_pct": S}

``value`` is the median of ``reps`` repetitions and ``spread_pct`` is (max -
min) / median; the per-rep list and the diagnostics go to stderr, with
``-v`` also the kernel wrappers' launch counts of the whole run.
``--trace DIR`` writes a ``torch.profiler`` trace of the run to
``DIR/trace.json``.

The script re-runs itself in a child process (marked by ``MHT_BENCH_CHILD``)
under a 540 s watchdog and retries once after a timeout; a child that exits
nonzero is not retried, since it failed a check or crashed. The kernels
build at first use under ``build/``.

    python3 bench_torch.py                      # the card (--device cuda)
    python3 bench_torch.py --mode encode -v
    python bench_torch.py --mode single --height 64 --width 512 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

BASELINE_GBPS = 0.094  # 2048*1536 bytes * 30 FPS (reference target)
CHILD_ENV = "MHT_BENCH_CHILD"
WATCHDOG_S = 540  # seconds one child may run before it is killed


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=1536)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--mode", default="video",
                    choices=["video", "single", "encode", "temporal"])
    ap.add_argument("--content", default="synthetic",
                    choices=["synthetic", "photo"],
                    help="photo = committed real-photo asset, panned per frame")
    ap.add_argument("--variants", type=int, default=4,
                    help="distinct staged input batches round-robined in the "
                         "timed loop")
    ap.add_argument("--precoder", default="delta",
                    choices=["delta", "delta2d"],
                    help="delta2d = 2-D within-block predictor (mode 3): "
                         "smaller streams, reconstructed in the kernel")
    ap.add_argument("--motion", action="store_true",
                    help="temporal mode: motion-compensated fold")
    ap.add_argument("--inner", default="gray",
                    choices=["gray", "color", "u16"],
                    help="temporal mode: inner container kind (color/u16 "
                         "time the plane fold and channel interleave too)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the run to "
                         "DIR/trace.json")
    return ap


def metric_name(args) -> str:
    """The JSON line's ``metric`` for ``args``' mode, as ``bench.py`` names
    it."""
    if args.mode == "encode":
        return "encode_throughput"
    if args.mode != "temporal":
        return "decode_throughput"
    return ("temporal_" + ("mc_" if args.motion else "")
            + (f"{args.inner}_" if args.inner != "gray" else "")
            + "decode_throughput")


def run(args) -> tuple[float, int, float]:
    """Run ``args``' mode -> (median GB/s, repetitions, spread in percent)."""
    from metalhuffman_tpu_torch import bench

    geo = (args.height, args.width, args.frames, args.iters)
    if args.mode == "video":
        return bench.run_video(*geo, content=args.content,
                               precoder=args.precoder, device=args.device,
                               variants=args.variants)
    if args.mode == "temporal":
        if args.motion or args.inner != "gray":
            return bench.run_temporal_ext(
                *geo, content=args.content, variants=args.variants,
                motion=args.motion, inner=args.inner, device=args.device)
        return bench.run_temporal(*geo, content=args.content,
                                  variants=args.variants, device=args.device)
    if args.mode == "encode":
        return bench.run_encode(*geo, content=args.content,
                                device=args.device, verbose=args.verbose)
    return bench.run_single(args.height, args.width, args.device, args.iters,
                            verbose=args.verbose)


def launch_counts() -> dict:
    """The kernel wrappers' launches in this process, by kernel."""
    from metalhuffman_tpu_torch.ops import decode_cuda, encode_cuda, fold_cuda

    return {**decode_cuda.launches, **encode_cuda.launches,
            **fold_cuda.launches}


def main(argv=None) -> int:
    """The benchmark itself (the child): run the mode, print the line."""
    args = parser().parse_args(argv)
    try:
        if args.trace:
            from metalhuffman_tpu_torch.utils import profiling

            with profiling.trace(args.trace):
                gbps, reps, spread = run(args)
            print(f"trace written to {args.trace}", file=sys.stderr)
        else:
            gbps, reps, spread = run(args)
    except ValueError as e:  # the decodes' own checks: a wrong output
        print(f"FATAL: {e}", file=sys.stderr)
        return 1
    if args.verbose:
        print(f"launches {json.dumps(launch_counts())}", file=sys.stderr)
    print(json.dumps({
        "metric": metric_name(args),
        "value": round(gbps, 4),
        "unit": "GB/s",
        "vs_baseline": round(gbps / BASELINE_GBPS, 2),
        "reps": reps,
        "spread_pct": round(spread, 1),
    }))
    return 0


def supervise(cmd: list, timeout: float = WATCHDOG_S) -> int:
    """Run ``cmd`` (the child) with a watchdog: pass its last stdout line
    on and return 0 when it exits 0 with output; retry once when it runs
    past ``timeout`` (it is killed); else return 1. A nonzero exit is
    final: it is a failed check or a crash, and a retry that passed would
    print a number for a run whose output was wrong."""
    env = dict(os.environ, **{CHILD_ENV: "1"})
    for attempt in (1, 2):
        try:
            proc = subprocess.run(cmd, env=env, stdout=subprocess.PIPE,
                                  timeout=timeout)
        except subprocess.TimeoutExpired:
            print(f"bench attempt {attempt} timed out after {timeout} s; "
                  f"{'retrying' if attempt == 1 else 'giving up'}",
                  file=sys.stderr)
            continue
        out = proc.stdout.decode()
        if proc.returncode == 0 and out.strip():
            sys.stdout.write(out.splitlines()[-1] + "\n")
            return 0
        print(f"bench attempt {attempt} failed (rc={proc.returncode}); "
              f"not retried", file=sys.stderr)
        return 1
    return 1


def _supervised_main(argv=None) -> int:
    """Check the arguments here (``--help`` and errors answer at once),
    then run the benchmark in a supervised child."""
    argv = sys.argv[1:] if argv is None else list(argv)
    parser().parse_args(argv)
    return supervise([sys.executable, os.path.abspath(__file__), *argv])


if __name__ == "__main__":
    sys.exit(main() if os.environ.get(CHILD_ENV) else _supervised_main())
