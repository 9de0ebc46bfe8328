"""Constant-memory capture -> serve loop of the PyTorch / CUDA port:
streaming encode and decode (counterpart of
``examples/streaming_pipeline.py``).

    python examples/streaming_pipeline_torch.py               # on the card
    python examples/streaming_pipeline_torch.py --device cpu  # plain versions

Frames are produced one at a time and consumed chunk by chunk, so peak
memory is one MHV2 segment, whatever the clip's length:

1. ``StreamingEncoder``      push frames -> MHV2 segments written as they fill
2. ``iter_frames_segmented`` streamed decode, source CRC chained per chunk
3. ``ColorStreamingEncoder`` the same for MHTC color (sub-green planes)
4. ``iter_temporal_video``   streamed MHVT serving, group-aligned chunks
5. ``TemporalStreamingEncoder`` + ``append=True``: a capture that STOPS
   (clean close) and RESUMES in place — byte-identical to never stopping

Encodes run on the host; every decode, and the resumed capture's decode of
its open keyframe group, runs on ``--device``. Exits nonzero when a decoded
array or the resumed file differs from its source.
"""

from __future__ import annotations

import io
import os
import sys
import tempfile
import zlib
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from metalhuffman_tpu_torch.models import (  # noqa: E402
    color, frame_stream, temporal)
from metalhuffman_tpu_torch.models.config import CodecConfig  # noqa: E402
from metalhuffman_tpu_torch.models.stream_writer import (  # noqa: E402
    ColorStreamingEncoder, StreamingEncoder, TemporalStreamingEncoder)
from metalhuffman_tpu_torch.utils import examples, fixtures  # noqa: E402


def camera(n, img):
    """A frame source that never holds more than one frame."""
    for t in range(n):
        yield np.roll(img, (3 * t, 16 * t), axis=(0, 1))


def main(argv=None) -> dict:
    """Run steps 1-5 -> {"blobs": name -> container bytes, "decoded": name
    -> (decoded array, its source)}; raises ValueError on a mismatch."""
    args = examples.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = args.device
    decoded: dict = {}
    img = fixtures.render_frame("bridge")
    h, w = img.shape
    n = 24
    cfg = CodecConfig()

    # 1. streaming encode: frames pushed one at a time, segments written
    #    the moment they fill (capped at 6 frames a segment, so the buffer
    #    never holds more than 6 raw frames of the 24-frame clip)
    sink = io.BytesIO()
    with StreamingEncoder(sink, h, w, cfg, max_segment_frames=6,
                          frame_crcs=True) as enc:
        for frame in camera(n, img):
            enc.push(frame)
    stats = enc.stats
    blob = sink.getvalue()
    print(f"streamed encode: {stats.total_frames} frames {h}x{w} -> "
          f"MHV2[{stats.num_segments} segments] {stats.bytes_written} bytes "
          f"({stats.bytes_written/(n*h*w):.1%} of raw), peak buffer "
          f"{min(enc.segment_frames, 6)} frames")

    # 2. streamed decode on the device: a chunk per segment, their CRCs
    #    chained and compared with the recorded whole-payload CRC
    segs, _t, _h, _w, _bd, _delta = frame_stream.read_segmented(blob)
    crc, chunks = 0, []
    for chunk in frame_stream.iter_frames_segmented(segs, h, w, cfg,
                                                    device=dev):
        crc = zlib.crc32(np.ascontiguousarray(chunk).tobytes(), crc)
        chunks.append(chunk)  # a real consumer writes and drops it here
    examples.same("iter_frames_segmented", np.concatenate(chunks),
                  np.stack(list(camera(n, img))), decoded)
    if crc != frame_stream.source_crc32(blob):
        raise ValueError("iter_frames_segmented: the chained CRC-32 differs "
                         "from the recorded one")
    print(f"streamed decode: {n} frames served in "
          f"{len(segs)} chunks, bit-exact, chained CRC == recorded CRC")

    # 3. the same loop for color: MHTC wraps a streamed inner MHV2
    cframes = np.stack([np.stack([f, np.roll(f, 9, 1), np.roll(f, 21, 0)],
                                 axis=-1)
                        for f in camera(4, img[:512, :512])])
    csink = io.BytesIO()
    with ColorStreamingEncoder(csink, 512, 512, channels=3, config=cfg,
                               colorspace=color.CS_SUBGREEN,
                               max_segment_frames=2) as cenc:
        for f in cframes:
            cenc.push(f)
    examples.same("decode_color_video",
                  color.decode_color_video_from_bytes(csink.getvalue(), dev),
                  cframes, decoded)
    print(f"streamed color encode: {cenc.stats.total_frames} frames -> MHTC "
          f"{cenc.stats.bytes_written} bytes "
          f"({cenc.stats.bytes_written/cframes.size:.1%}), decoded bit-exact")

    # 4. streamed temporal serving: an MHVT container decoded and folded in
    #    keyframe-group-aligned chunks; each residual decodes once and the
    #    outer CRC chains across chunks
    frames = np.stack(list(camera(12, img)))
    tblob = temporal.encode_temporal_video(
        frames, CodecConfig(temporal=True, keyint=4, motion=True))
    print(f"temporal: 12 frames -> MHVT[keyint 4, motion] {len(tblob)} "
          f"bytes ({len(tblob)/frames.size:.1%})")
    served = [chunk for _base, chunk in temporal.iter_temporal_video(
        tblob, dev, chunk_frames=4)]
    examples.same("iter_temporal_video", np.concatenate(served), frames,
                  decoded)
    print(f"streamed temporal serving: {len(served)} group chunks, "
          "bit-exact, chained CRC verified")

    # 5. capture resume: stop after 6 frames (a finalized container), come
    #    back and append the rest; the open keyframe group decodes on the
    #    device to give the predictor, the CRC and motion tables chain,
    #    the cadence continues, and the file equals a capture that never
    #    stopped
    scfg = CodecConfig(temporal=True, keyint=3, motion=True)
    with tempfile.TemporaryDirectory() as tmp:
        cap = Path(tmp) / "capture.mhvt"
        with TemporalStreamingEncoder(cap, h, w, scfg, max_segment_frames=3,
                                      frame_crcs=True) as enc1:
            for f in frames[:6]:
                enc1.push(f)  # ... a stop here leaves a finalized file
        with TemporalStreamingEncoder(cap, h, w, scfg, max_segment_frames=3,
                                      append=True, device=dev) as enc2:
            for f in frames[6:]:
                enc2.push(f)  # resumed in place
        resumed = cap.read_bytes()
    one_shot = io.BytesIO()
    with TemporalStreamingEncoder(one_shot, h, w, scfg,
                                  max_segment_frames=3,
                                  frame_crcs=True) as enc3:
        enc3.push(frames)
    if resumed != one_shot.getvalue():
        raise ValueError("capture resume: the appended file differs from "
                         "the one-shot capture")
    examples.same("decode_temporal_video",
                  temporal.decode_temporal_video(resumed, dev), frames,
                  decoded)
    print(f"capture resume: 6 + 6 frames appended in place == one-shot "
          f"capture bytes ({enc2.stats.bytes_written} B), bit-exact")
    print("OK")
    return {"blobs": {"mhv2": blob, "color": csink.getvalue(),
                      "temporal": tblob, "resumed": resumed},
            "decoded": decoded}


if __name__ == "__main__":
    main()
