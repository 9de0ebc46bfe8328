"""Reproducible performance matrix of the PyTorch / CUDA port: geometries x
content x paths (counterpart of ``scripts/perf_matrix.py``).

    python scripts/perf_matrix_torch.py [--frames 30] [--iters 20]
    python scripts/perf_matrix_torch.py --device cpu --frames 2 --iters 2

Measures decode throughput (each staged rotation checked equal to its
frames first, distinct inputs per timed call, CUDA events on a card; the
port's ``bench`` methodology) for:
  - B1 (``csrc/decode_images.cu``) on the shared-table video batch at
    2048x1536 (the reference geometry) and 1920x1080 (the common video
    geometry), on synthetic and photographic content, and with the delta2d
    precoder on the photo (``bench.run_video``);
  - the MHVT decode, B1 and the fold on the device: plain gray, motion,
    color, u16, and color with motion (``bench.run_temporal`` and
    ``run_temporal_ext``);
  - the multithreaded C++ host decoder (``device="native"``) on the photo
    at 2048x1536, on the host clock (``bench.run_native``).
Prints a markdown table to stdout.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from metalhuffman_tpu_torch import bench  # noqa: E402
from metalhuffman_tpu_torch.utils import examples  # noqa: E402

TARGET_GBPS = 0.094  #: the reference's 2048x1536 at 30 FPS


def main(argv=None) -> list:
    """Run the matrix -> its rows, (geometry, content, path, GB/s) each."""
    ap = examples.parser(__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", type=int, default=2)
    args = ap.parse_args(argv)
    dev = args.device
    b1 = ("B1 CUDA kernel" if torch.device(dev).type == "cuda"
          else "B1 plain version")
    common = dict(content="photo", variants=args.variants, device=dev)

    rows = []
    for h, w in ((1536, 2048), (1080, 1920)):
        for content in ("synthetic", "photo"):
            gbps, _reps, _spread = bench.run_video(
                h, w, args.frames, args.iters, content=content,
                device=dev, variants=args.variants)
            rows.append((f"{w}x{h}", content, b1, gbps))

    # delta2d precoder: the kernel reconstructs the 2-D predictor in
    # registers, so expect parity
    gbps, _reps, _spread = bench.run_video(
        1536, 2048, args.frames, args.iters, precoder="delta2d", **common)
    rows.append(("2048x1536", "photo", f"{b1}, delta2d", gbps))

    # MHVT: B1 on the residual planes, then the fold on the device (the
    # group fold, the MC fold, and the color and u16 plane folds)
    gbps, _reps, _spread = bench.run_temporal(
        1536, 2048, args.frames, args.iters, **common)
    rows.append(("2048x1536", "photo", "MHVT fold (plain gray)", gbps))
    for label, kw in (("MHVT fold (motion)", {"motion": True}),
                      ("MHVT fold (color)", {"inner": "color"}),
                      ("MHVT fold (u16)", {"inner": "u16"}),
                      ("MHVT fold (color+motion)",
                       {"inner": "color", "motion": True})):
        gbps, _reps, _spread = bench.run_temporal_ext(
            1536, 2048, args.frames, args.iters, **common, **kw)
        rows.append(("2048x1536", "photo", label, gbps))

    # the host C++ decoder on the reference geometry, real-photo content,
    # on every core of the host
    gbps, _reps, _spread = bench.run_native(1536, 2048, args.frames,
                                            args.iters, content="photo")
    rows.append(("2048x1536", "photo", "C++ host (all cores)", gbps))

    print(f"\n## Decode throughput ({args.frames} frames/batch, "
          f"device={examples.card(dev)})\n")
    print(f"| geometry | content | path | GB/s | vs {TARGET_GBPS} GB/s "
          "target |")
    print("|---|---|---|---|---|")
    for geom, content, path, gbps in rows:
        print(f"| {geom} | {content} | {path} | {gbps:.2f} | "
              f"{gbps / TARGET_GBPS:.0f}x |")
    return rows


if __name__ == "__main__":
    main()
