"""Multi-GPU scaling report of the PyTorch / CUDA port: the sharded decode
and encode against the number of ranks (counterpart of
``examples/scaling_report.py``).

    python examples/scaling_report_torch.py                    # every GPU
    python examples/scaling_report_torch.py --device cpu --world 4

For each world size 1, 2, 4 ... up to ``--world`` it starts one process per
rank (NCCL with one rank per GPU on a card, gloo ranks on the CPU), which
each run:

- decode: ``frame_stream.decode_shared_sharded`` (B1 on the rank's range of
  block rows, its code words staged per call) and ``gather_shared`` (one
  all-gather), over two staged frame-order rotations alternated in the
  timed loop; the gathered frames must equal the source;
- encode: ``encode_symbols_sharded`` (``encode_stream`` on the rank's
  symbol range, the histogram summed over the group), byte-identical to
  the host encoder (``native.encode_symbols``).

Times come from CUDA events on a card and from the host clock on the CPU.
Rank 0 reports. With one GPU only world 1 runs: the report then gives the
cost of the sharded path and of its gather over the single-device decode,
not scaling. The TPU tile staging of the original (``image_plan_for``,
``tile_layout_images``, ``pad_offsets_grid``) has no counterpart: the
kernels read the stream at each block's own bit offset.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from metalhuffman_tpu_torch import native  # noqa: E402
from metalhuffman_tpu_torch.core import blocks  # noqa: E402
from metalhuffman_tpu_torch.models import frame_stream  # noqa: E402
from metalhuffman_tpu_torch.parallel import mesh, multihost  # noqa: E402
from metalhuffman_tpu_torch.parallel import shard_encode  # noqa: E402
from metalhuffman_tpu_torch.utils import examples, fixtures  # noqa: E402
from metalhuffman_tpu_torch.utils.profiling import elapsed_s  # noqa: E402

TIMEOUT = 900  #: seconds for every rank of one world size
WORLDS = (1, 2, 4, 8, 16, 32)


def geometry(device: torch.device, frames: int) -> tuple[int, int, int]:
    """(T, H, W): ``frames`` x 2048x1536 on a card, 2x64x1024 on the CPU."""
    if device.type == "cuda":
        return frames, 1536, 2048
    return 2, 64, 1024


def rank_device(device: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: GPU ``index + rank`` of ``cuda[:index]``, or
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", (dev.index or 0) + rank)
    return dev


def run_rank(args) -> dict:
    """One rank of one world size: the decode and encode checks and times;
    rank 0 prints its report lines and returns the numbers."""
    dev = rank_device(args.device, args.rank)
    rank, world = multihost.initialize(args.init_method, args.world_size,
                                       args.rank, device=dev)
    try:
        t, h, w = geometry(dev, args.frames)
        base = fixtures.synthetic(t, h, w)
        variants = [base, np.roll(base, 1, axis=0)]
        streams = [frame_stream.encode_frames_shared(f) for f in variants]

        def step(v):
            local, _ = frame_stream.decode_shared_sharded(
                streams[v], t, h, w, device=dev)
            return local

        def gathered(v):
            return frame_stream.gather_shared(step(v), t, h, w)

        ok = all(np.array_equal(gathered(v).cpu().numpy(), f)
                 for v, f in enumerate(variants))

        def loop(fn):
            def run():
                for i in range(args.iters):
                    fn(i % 2)
            return elapsed_s(dev, run) / args.iters

        loop(gathered)  # warm up
        dt_local = loop(step)
        dt = loop(gathered)
        single = None
        if world == 1:
            single = loop(lambda v: frame_stream.decode_frames_shared(
                streams[v], t, h, w, device=dev))
        dist.barrier()

        blk = np.concatenate([blocks.image_to_blocks(f) for f in base])
        syms = native.delta_encode(blk.ravel(), 64)
        ref = native.encode_symbols(syms, 64)
        m = mesh.make_mesh(device=dev.type)
        enc = shard_encode.encode_symbols_sharded(syms, mesh=m, device=dev)
        enc_ok = (np.array_equal(enc.code_bytes, ref.code_bytes)
                  and np.array_equal(enc.block_offsets, ref.block_offsets))
        dt_enc = elapsed_s(dev, lambda: shard_encode.encode_symbols_sharded(
            syms, mesh=m, device=dev))
        oks = [None] * world
        dist.all_gather_object(oks, (ok, enc_ok))
    finally:
        dist.destroy_process_group()
    result = {"world": world, "payload_mb": base.size / 1e6,
              "local_ms": dt_local * 1e3, "decode_ms": dt * 1e3,
              "gbps": base.size / dt / 1e9, "encode_ms": dt_enc * 1e3,
              "single_ms": None if single is None else single * 1e3,
              "bit_exact": all(o[0] for o in oks),
              "byte_identical": all(o[1] for o in oks)}
    if rank == 0:
        print(json.dumps(result))
    return result


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, world: int) -> dict:
    """Start ``world`` rank processes of this script and wait for them ->
    rank 0's numbers. A rank that fails, or a world past ``TIMEOUT``,
    exits 1 (every rank killed)."""
    init = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ)
    if torch.device(args.device).type == "cpu":
        env["OMP_NUM_THREADS"] = "1"  # gloo ranks share the host's cores
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--device", args.device,
         "--frames", str(args.frames), "--iters", str(args.iters),
         "--init-method", init, "--world-size", str(world), "--rank",
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        print(f"world {world}: the ranks did not finish in {TIMEOUT} s")
        sys.exit(1)
    finally:
        for p in procs:  # past the deadline or after a failure: no orphans
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(f"world {world} rank {r} failed:\n{out}")
            sys.exit(1)
    return json.loads(outs[0].strip().splitlines()[-1])


def main(argv=None) -> list:
    """Run the report -> one dict of numbers per world size; exits 1 when a
    decode or an encode differs from its source."""
    ap = examples.parser(__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=None,
                    help="the largest world size (default: every GPU of "
                         "the host, 1 on the CPU)")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--init-method", help=argparse.SUPPRESS)
    ap.add_argument("--world-size", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:  # one rank, started by launch()
        return [run_rank(args)]

    dev = torch.device(args.device)
    gpus = torch.cuda.device_count() if dev.type == "cuda" else None
    top = args.world or (gpus if gpus is not None else 1)
    if gpus is not None and (dev.index or 0) + top > gpus:
        raise SystemExit(f"NCCL runs one rank per GPU: world {top} from "
                         f"{dev} needs {top} GPUs, this host has {gpus}")
    t, h, w = geometry(dev, args.frames)
    counts = [n for n in WORLDS if n <= top]
    print(f"device={examples.card(dev)} worlds={counts} "
          f"payload={t * h * w / 1e6:.0f} MB frame={w}x{h}x{t} "
          f"path=B1 on each rank's block rows + one all-gather")
    if counts == [1]:
        print("one rank only: the numbers are the cost of the sharded path "
              "and of its gather over the single-device decode, not scaling")
    results = []
    for n in counts:
        r = launch(args, n)
        results.append(r)
        eff = r["gbps"] / (results[0]["gbps"] * n) * 100
        print(f"  {n:2d} rank(s): {r['decode_ms']:8.2f} ms  "
              f"{r['gbps']:7.3f} GB/s  scaling {eff:5.1f}%  "
              f"bit-exact={r['bit_exact']}  (local step "
              f"{r['local_ms']:.2f} ms, the gather "
              f"{r['decode_ms'] - r['local_ms']:.2f} ms"
              + ("" if r["single_ms"] is None else
                 f"; single-device decode {r['single_ms']:.2f} ms") + ")")
        if not r["bit_exact"]:
            sys.exit(1)
    print("encode (encode_stream on each rank's range + splice):")
    for r in results:
        print(f"  {r['world']:2d} rank(s): {r['encode_ms']:8.2f} ms "
              f"end-to-end  byte-identical={r['byte_identical']}")
        if not r["byte_identical"]:
            sys.exit(1)
    return results


if __name__ == "__main__":
    main()
