"""Video workflow of the PyTorch / CUDA port end to end: encode ->
stream-decode -> random access -> verify -> surgery (counterpart of
``examples/video_pipeline.py``).

    python examples/video_pipeline_torch.py                 # on the card
    python examples/video_pipeline_torch.py --device cpu    # plain versions

Walks the video surface: shared-table batch encode with the delta2d
precoder, the streaming decoder, temporal random access (one frame's blocks
only), the end-bit integrity check, temporal prediction with motion
compensation, a spatio-temporal region, and lossless container surgery
(extract and concat, no re-encode). Exits nonzero when a decoded array
differs from its source.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import metalhuffman_tpu_torch as mt  # noqa: E402
from metalhuffman_tpu_torch.models import (  # noqa: E402
    frame_stream, surgery, temporal)
from metalhuffman_tpu_torch.models.config import CodecConfig  # noqa: E402
from metalhuffman_tpu_torch.utils import examples, fixtures  # noqa: E402


def main(argv=None) -> dict:
    """Run steps 1-9 -> {"blobs": name -> container bytes, "decoded": name ->
    (decoded array, its source)}; raises ValueError on a mismatch."""
    args = examples.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = args.device
    decoded: dict = {}

    # 1. a short photographic clip (the committed bridge asset, panned)
    img = fixtures.render_frame("bridge")
    frames = np.stack([np.roll(img, 16 * t, axis=1) for t in range(6)])
    t, h, w = frames.shape
    print(f"clip: {t} frames {h}x{w} ({frames.size/1e6:.1f} MB raw)")

    # 2. encode with the 2-D predictor (smaller on photos, decoded at full
    #    speed: the kernel reconstructs it in registers)
    cfg = CodecConfig(delta2d=True)
    blob = mt.encode_video(frames, cfg)
    print(f"MHTV: {len(blob)} bytes ({len(blob)/frames.size:.1%} of raw), "
          f"mode=delta2d, CRC recorded")

    # 3. decode the whole batch (one kernel launch; decode_video verifies
    #    the recorded CRC)
    examples.same("decode_video", mt.decode_video(blob, dev), frames, decoded)
    print("batch decode: bit-exact, CRC verified")

    # 4. streaming: batches queue on the device (t+1 stages while t
    #    decodes), the pattern for long clips and MHV2 segments
    stream, _t, _h, _w, _bd, _delta = frame_stream.read_shared(blob)
    dec = frame_stream.StreamingDecoder(cfg, device=dev)
    handle = dec.submit(stream, t, h, w)
    examples.same("StreamingDecoder", dec.result(handle), frames, decoded)
    print("streaming decode: bit-exact")

    # 5. temporal random access: frame 4 alone, 1/T of the work
    one = frame_stream.decode_frame(stream, 4, h, w, cfg, device=dev)
    examples.same("decode_frame 4", one, frames[4], decoded)
    print("random-access frame 4: bit-exact")

    # 6. integrity: the kernel emits each block's end-bit position; a
    #    corrupt stream fails here (and the CRC backstops code
    #    substitutions that preserve block lengths)
    prep = frame_stream.prepare_shared(stream, t, h, w, cfg, device=dev,
                                       check=True)
    out, err = frame_stream.decode_shared_step_checked(prep, cfg)
    if err.any():
        raise ValueError(f"end-bit check flagged {int(err.sum())} blocks")
    examples.same("decode_shared_step_checked", out, frames, decoded)
    print(f"on-device end-bit check: {err.size} blocks ok")

    # 7. temporal prediction with global motion compensation: this clip is
    #    a pan, so frame differencing alone would lose; the per-frame
    #    motion vector cancels the pan, and measuring keeps whichever
    #    coding is smallest
    tblob, kind, _used = temporal.encode_video_best(
        frames, CodecConfig(delta2d=True, temporal=True, motion=True))
    examples.same("decode_video temporal", mt.decode_video(tblob, dev),
                  frames, decoded)
    examples.same("decode_temporal_frame 4",
                  temporal.decode_temporal_frame(tblob, 4, dev), frames[4],
                  decoded)
    print(f"temporal best: kept {kind}, {len(tblob)} bytes "
          f"({len(tblob)/frames.size:.1%} vs {len(blob)/frames.size:.1%} "
          f"plain), bit-exact incl. random access")

    # 8. spatio-temporal ROI: a 256x256 crop of frames [2, 5); neither the
    #    rest of each frame nor the other frames are decoded
    roi = frame_stream.decode_video_region(blob, 2, 5, 512, 512, 256, 256,
                                           cfg, device=dev)
    examples.same("decode_video_region", roi,
                  frames[2:5, 512:768, 512:768], decoded)
    print("spatio-temporal ROI: bit-exact (region blocks only)")

    # 9. lossless container surgery: cut frames [1, 5) and splice, with no
    #    re-encode; the CRCs combine algebraically
    part = surgery.extract_video(blob, 1, 5)
    examples.same("decode_video extract", mt.decode_video(part, dev),
                  frames[1:5], decoded)
    joined = surgery.concat_videos([part, blob])
    examples.same("decode_video concat", mt.decode_video(joined, dev),
                  np.concatenate([frames[1:5], frames]), decoded)
    print(f"surgery: extract+concat bit-exact, zero re-encode "
          f"({len(part)} + {len(blob)} -> {len(joined)} bytes)")
    print("video pipeline OK")
    return {"blobs": {"video": blob, "temporal": tblob, "extract": part,
                      "concat": joined}, "decoded": decoded, "kind": kind}


if __name__ == "__main__":
    main()
