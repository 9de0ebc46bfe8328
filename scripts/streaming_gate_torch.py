"""One-command re-certification of the port's streaming family, end to end
(counterpart of ``scripts/streaming_gate.py``).

    python scripts/streaming_gate_torch.py                # on the card
    python scripts/streaming_gate_torch.py --device cpu   # plain versions

It drives the port's CLI, one subprocess per command (``python -m
metalhuffman_tpu_torch ... --device D``, the processes a user runs), through
every streaming writer/reader pair and holds every output to its source
frames:

  1. gray MHV2: encode-video --streaming (segments of 3, per-frame CRCs),
     decode-video --streaming, verify --streaming (the end-bit check per
     segment)
  2. a corrupted CRC trailer must fail the streamed verify
  3. MHTC color (sub-green): streamed both directions
  4. MHTC u16: streamed both directions
  5. MHVT temporal + motion (the trailer layout), keyint 4, per-frame CRCs:
     streamed encode, streamed decode (the fold on the device), verify
     --streaming, --frame N --check
  6. MHTS (a table per frame): streamed encode, decode-video --streaming
     --check
  7. resegment (streamed, file to file), then verify --streaming and a
     streamed decode
  8. capture resume: --append continues the temporal container in place
     (its open keyframe group decoded on the device), byte-identical to
     the one-shot capture

Prints one PASS line per check and exits nonzero on the first failure.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from metalhuffman_tpu_torch.models import frame_stream  # noqa: E402
from metalhuffman_tpu_torch.utils import examples, fixtures  # noqa: E402

TIMEOUT = 600  #: seconds for one CLI command


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
        np.save(tmp / "gray.npy", gray)
        np.save(tmp / "color.npy", color)
        np.save(tmp / "u16.npy", u16)

        # 1) gray MHV2 streamed both directions + streamed verify (end-bit)
        run("encode-video", str(tmp / "gray.npy"), str(tmp / "g.mhv2"),
            "--streaming", "--segment-frames", "3", "--frame-crcs", *dev)
        run("decode-video", str(tmp / "g.mhv2"), str(tmp / "g_out.npy"),
            "--streaming", *dev)
        check(tmp / "g_out.npy", gray, "gray MHV2 streamed roundtrip")
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
        run("encode-video", str(tmp / "color.npy"), str(tmp / "c.mhtc"),
            "--streaming", "--color", "--subgreen", "--segment-frames", "2",
            *dev)
        run("decode-video", str(tmp / "c.mhtc"), str(tmp / "c_out.npy"),
            "--streaming", *dev)
        check(tmp / "c_out.npy", color, "MHTC color streamed roundtrip")

        # 4) u16 streamed
        run("encode-video", str(tmp / "u16.npy"), str(tmp / "u.mhtc"),
            "--streaming", "--gray16", "--segment-frames", "2", *dev)
        run("decode-video", str(tmp / "u.mhtc"), str(tmp / "u_out.npy"),
            "--streaming", *dev)
        check(tmp / "u_out.npy", u16, "MHTC u16 streamed roundtrip")

        # 5) temporal + motion, streamed encode (the trailer layout),
        #    streamed decode through the device fold, streamed verify,
        #    checked random access
        run("encode-video", str(tmp / "gray.npy"), str(tmp / "t.mhvt"),
            "--streaming", "--temporal", "--motion", "--keyint", "4",
            "--frame-crcs", "--segment-frames", "3", *dev)
        run("decode-video", str(tmp / "t.mhvt"), str(tmp / "t_out.npy"),
            "--streaming", *dev)
        check(tmp / "t_out.npy", gray, "MHVT temporal+MC streamed roundtrip")
        run("verify", str(tmp / "t.mhvt"), "--streaming", *dev)
        print("PASS  MHVT verify --streaming (chained CRC + FCRC per chunk)",
              flush=True)
        n = t - 2
        run("decode-video", str(tmp / "t.mhvt"), str(tmp / "t_f.npy"),
            "--frame", str(n), "--check", *dev)
        check(tmp / "t_f.npy", gray[n], f"MHVT --frame {n} --check")

        # 6) MHTS streamed encode + streamed checked decode
        run("encode-video", str(tmp / "gray.npy"), str(tmp / "s.mhts"),
            "--streaming", "--per-frame-tables", *dev)
        run("decode-video", str(tmp / "s.mhts"), str(tmp / "s_out.npy"),
            "--streaming", "--check", *dev)
        check(tmp / "s_out.npy", gray, "MHTS streamed checked roundtrip")

        # 7) streamed resegment feeds the streamed verify
        run("resegment", str(tmp / "g.mhv2"), str(tmp / "g2.mhv2"),
            "--segment-frames", "2")
        run("verify", str(tmp / "g2.mhv2"), "--streaming", *dev)
        run("decode-video", str(tmp / "g2.mhv2"), str(tmp / "g2_out.npy"),
            "--streaming", *dev)
        check(tmp / "g2_out.npy", gray, "resegmented archive streamed decode")

        # 8) capture resume: half the frames, then --append the rest; the
        #    file must equal the one-shot temporal capture byte for byte
        half = t // 2
        np.save(tmp / "h1.npy", gray[:half])
        np.save(tmp / "h2.npy", gray[half:])
        targs = ["--streaming", "--temporal", "--motion", "--keyint", "4",
                 "--frame-crcs", "--segment-frames", str(half), *dev]
        run("encode-video", str(tmp / "h1.npy"), str(tmp / "resume.mhvt"),
            *targs)
        run("encode-video", str(tmp / "h2.npy"), str(tmp / "resume.mhvt"),
            "--append", *targs)
        run("encode-video", str(tmp / "gray.npy"), str(tmp / "one.mhvt"),
            *targs)
        if (tmp / "resume.mhvt").read_bytes() != (
                tmp / "one.mhvt").read_bytes():
            print("FAIL: resumed capture != one-shot capture bytes")
            sys.exit(1)
        print("PASS  capture resume (--append): byte-identical to one-shot",
              flush=True)
        run("decode-video", str(tmp / "resume.mhvt"),
            str(tmp / "resume_out.npy"), "--streaming", *dev)
        check(tmp / "resume_out.npy", gray, "resumed capture streamed decode")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(f"\nSTREAMING GATE: ALL PASS (device {args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
