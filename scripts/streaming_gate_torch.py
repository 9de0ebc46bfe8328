"""One-command re-certification of the port's streamed decode, end to end
(counterpart of the decode half of ``scripts/streaming_gate.py``, its
stages 1-6).

    python scripts/streaming_gate_torch.py                # on the card
    python scripts/streaming_gate_torch.py --device cpu   # plain versions

It drives the port's CLI, one subprocess per command (``python -m
metalhuffman_tpu_torch ... --device D``, the processes a user runs), and
holds every output to its source frames:

  1. gray MHV2 of several segments, with per-frame CRCs: decode-video
     --streaming, verify --streaming (the end-bit check per segment)
  2. a corrupted CRC trailer must fail the streamed verify
  3. MHTC color (sub-green) over MHV2 segments: streamed decode
  4. MHTC u16 over MHV2 segments: streamed decode
  5. MHVT temporal + motion, keyint 4, per-frame CRCs: streamed decode
     (the fold on the device), verify --streaming, --frame N --check
  6. MHTS (a table per frame): decode-video --streaming --check

The port has no streaming writer (the JAX package's ``stream_writer`` is
host only), so the containers are written with the port's library:
``frame_stream.encode_frames_segmented`` with a small ``max_segment_bits``
and ``write_segmented``, ``color.wrap``, ``temporal.wrap`` and
``write_stream``. Stages 7 (resegment) and 8 (--append) rest on that writer
and are not ported. Prints one PASS line per stage and exits nonzero on the
first failure.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from metalhuffman_tpu_torch.core import blocks  # noqa: E402
from metalhuffman_tpu_torch.models import color as color_mod  # noqa: E402
from metalhuffman_tpu_torch.models import frame_stream, temporal  # noqa: E402
from metalhuffman_tpu_torch.models.config import CodecConfig  # noqa: E402
from metalhuffman_tpu_torch.utils import examples, fixtures  # noqa: E402

TIMEOUT = 600  #: seconds for one CLI command


def segmented(planes: np.ndarray, per: int, frame_crcs=None) -> bytes:
    """(N, H, W) uint8 planes -> an MHV2 of ``per`` planes a segment (the
    last one shorter), recording the planes' CRC-32."""
    n, h, w = planes.shape
    bh, bw = blocks.block_grid(h, w, 8)
    bits = per * bh * bw * 64 * frame_stream._SEG_BITS_PER_SYMBOL
    cfg = CodecConfig()
    segs = frame_stream.encode_frames_segmented(planes, cfg,
                                                max_segment_bits=bits)
    if [ft for _, ft in segs][:1] != [min(per, n)]:
        raise ValueError(f"expected segments of {per} planes, got "
                         f"{[ft for _, ft in segs]}")
    return frame_stream.write_segmented(
        segs, h, w, cfg, source_crc32=zlib.crc32(planes.tobytes()),
        frame_crcs=frame_crcs)


def corrupt_trailer(blob: bytes) -> bytes:
    """``blob`` with its recorded CRC-32 changed."""
    bad = bytearray(blob)
    bad[frame_stream._trailer_offset(blob)] ^= 0x5A
    return bytes(bad)


def main(argv=None) -> int:
    ap = examples.parser(__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args(argv)

    dev = ["--device", args.device]
    h, w, t = args.height, args.width, args.frames

    img = fixtures.render_frame("bridge")
    img = np.tile(img, ((h - 1) // img.shape[0] + 1,
                        (w - 1) // img.shape[1] + 1))[:h, :w]
    gray = np.stack([np.roll(img, (3 * i, 5 * i), (0, 1))
                     for i in range(t)])
    color = np.stack([gray, np.roll(gray, 2, 2), np.roll(gray, 4, 2)],
                     axis=-1)
    u16 = ((gray.astype(np.uint16) << 4) | (gray >> 4)).astype(np.uint16)

    tmp = Path(tempfile.mkdtemp(prefix="mht_gate_torch_"))

    def run(*a, expect_fail=False):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "metalhuffman_tpu_torch", *a],
            capture_output=True, text=True, cwd=str(REPO), timeout=TIMEOUT)
        dt = time.perf_counter() - t0
        if expect_fail:
            if r.returncode == 0:
                print(f"FAIL (expected failure): {' '.join(a)}\n{r.stdout}")
                sys.exit(1)
            return r
        if r.returncode != 0:
            print(f"FAIL: {' '.join(a)}\n{r.stdout}\n{r.stderr}")
            sys.exit(1)
        print(f"  ok ({dt:5.1f} s)  {' '.join(a[:4])}", flush=True)
        return r

    def check(path, want, what):
        got = np.load(path)
        if got.dtype != want.dtype or not np.array_equal(got, want):
            print(f"FAIL: {what} not bit-exact")
            sys.exit(1)
        print(f"PASS  {what}: bit-exact", flush=True)

    try:
        # the containers, written by the port's library
        (tmp / "g.mhv2").write_bytes(segmented(
            gray, 3, frame_stream.compute_frame_crcs(gray)))
        planes = color_mod.to_subgreen(color).transpose(0, 3, 1, 2)
        (tmp / "c.mhtc").write_bytes(color_mod.wrap(
            segmented(planes.reshape(-1, h, w), 2 * 3), 3,
            color_mod.LAYOUT_VIDEO, color_mod.KIND_U8,
            color_mod.CS_SUBGREEN))
        planes = np.stack([(u16 >> 8).astype(np.uint8),
                           (u16 & 0xFF).astype(np.uint8)], axis=1)
        (tmp / "u.mhtc").write_bytes(color_mod.wrap(
            segmented(planes.reshape(-1, h, w), 2 * 2), 2,
            color_mod.LAYOUT_VIDEO, color_mod.KIND_U16))
        res, mvs = temporal.temporal_encode_mc(gray, 4)
        (tmp / "t.mhvt").write_bytes(temporal.wrap(
            segmented(res, 3), 4, source_crc32=zlib.crc32(gray.tobytes()),
            mvs=mvs, frame_crcs=frame_stream.compute_frame_crcs(gray)))
        (tmp / "s.mhts").write_bytes(frame_stream.write_stream(
            frame_stream.encode_frames(gray), h, w,
            source_crc32s=[zlib.crc32(f.tobytes()) for f in gray]))

        # 1) gray MHV2 streamed + streamed verify (end-bit per segment)
        run("decode-video", str(tmp / "g.mhv2"), str(tmp / "g_out.npy"),
            "--streaming", *dev)
        check(tmp / "g_out.npy", gray, "gray MHV2 streamed decode")
        run("verify", str(tmp / "g.mhv2"), "--streaming", *dev)
        print("PASS  gray MHV2 verify --streaming (end-bit per segment)",
              flush=True)

        # 2) corruption must fail the streamed chain
        (tmp / "g_bad.mhv2").write_bytes(
            corrupt_trailer((tmp / "g.mhv2").read_bytes()))
        run("verify", str(tmp / "g_bad.mhv2"), "--streaming", *dev,
            expect_fail=True)
        print("PASS  corrupted CRC fails streamed verify", flush=True)

        # 3) color (sub-green) streamed
        run("decode-video", str(tmp / "c.mhtc"), str(tmp / "c_out.npy"),
            "--streaming", *dev)
        check(tmp / "c_out.npy", color, "MHTC color streamed decode")

        # 4) u16 streamed
        run("decode-video", str(tmp / "u.mhtc"), str(tmp / "u_out.npy"),
            "--streaming", *dev)
        check(tmp / "u_out.npy", u16, "MHTC u16 streamed decode")

        # 5) temporal + motion: streamed decode through the device fold,
        #    streamed verify, checked random access
        run("decode-video", str(tmp / "t.mhvt"), str(tmp / "t_out.npy"),
            "--streaming", *dev)
        check(tmp / "t_out.npy", gray, "MHVT temporal+MC streamed decode")
        run("verify", str(tmp / "t.mhvt"), "--streaming", *dev)
        print("PASS  MHVT verify --streaming (chained CRC + FCRC per chunk)",
              flush=True)
        n = t - 2
        run("decode-video", str(tmp / "t.mhvt"), str(tmp / "t_f.npy"),
            "--frame", str(n), "--check", *dev)
        check(tmp / "t_f.npy", gray[n], f"MHVT --frame {n} --check")

        # 6) MHTS streamed checked decode
        run("decode-video", str(tmp / "s.mhts"), str(tmp / "s_out.npy"),
            "--streaming", "--check", *dev)
        check(tmp / "s_out.npy", gray, "MHTS streamed checked decode")

        # 7) and 8) rest on the streaming writer, which is not ported
        print("SKIP  7) resegment and 8) capture resume (--append): not "
              "ported (the JAX package's host-only streaming writer)",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(f"\nSTREAMING GATE: ALL PASS (device {args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
