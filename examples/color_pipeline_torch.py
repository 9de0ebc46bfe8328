"""Color and 16-bit workflow of the PyTorch / CUDA port: MHTC containers
over the plane stream (counterpart of ``examples/color_pipeline.py``).

    python examples/color_pipeline_torch.py                 # on the card
    python examples/color_pipeline_torch.py --device cpu    # plain versions

Planar RGB images and video, and uint16 grayscale (depth maps) as hi/lo
byte planes: every plane rides the shared-table batch, one canonical table
and one kernel launch for all planes, with the CRC check and temporal
random access. Exits nonzero when a decoded array differs from its source.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import metalhuffman_tpu_torch as mt  # noqa: E402
from metalhuffman_tpu_torch.models import color  # noqa: E402
from metalhuffman_tpu_torch.models.config import CodecConfig  # noqa: E402
from metalhuffman_tpu_torch.utils import examples, fixtures  # noqa: E402


def main(argv=None) -> dict:
    """Run the color pipeline -> {"blobs": name -> container bytes,
    "decoded": name -> (decoded array, its source)}; raises ValueError on a
    mismatch."""
    args = examples.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = args.device
    decoded: dict = {}

    # 1. a synthetic color photo: the committed bridge asset as luma, with
    #    smooth chroma ramps (natural-photo-like channel statistics)
    luma = fixtures.render_frame("bridge").astype(np.int32)
    h, w = luma.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cb = 30 * np.sin(xx / 97.0) + 10 * np.cos(yy / 61.0)
    cr = 25 * np.cos(xx / 83.0) - 12 * np.sin(yy / 53.0)
    img = np.stack([
        np.clip(luma + 1.4 * cr, 0, 255),
        np.clip(luma - 0.34 * cb - 0.71 * cr, 0, 255),
        np.clip(luma + 1.77 * cb, 0, 255),
    ], axis=-1).astype(np.uint8)
    print(f"color image: {h}x{w}x3 ({img.size / 1e6:.1f} MB raw)")

    # 2. color image roundtrip (delta2d precoder; 3 planes, one launch)
    cfg = CodecConfig(delta2d=True)
    blob = mt.encode_color_image(img, cfg)
    examples.same("decode_color_image", mt.decode_color_image(blob, dev),
                  img, decoded)
    print(f"MHTC image: {len(blob)} bytes ({len(blob)/img.size:.1%}), "
          f"bit-exact, CRC verified")

    # 3. color video + temporal random access (frame 2's planes only)
    frames = np.stack([np.roll(img, 24 * t, axis=1) for t in range(4)])
    vblob = mt.encode_color_video(frames, cfg)
    examples.same("decode_color_video", mt.decode_color_video(vblob, dev),
                  frames, decoded)
    examples.same("decode_color_frame 2",
                  color.decode_color_frame(vblob, 2, dev), frames[2], decoded)
    print(f"MHTC video: {len(vblob)} bytes "
          f"({len(vblob)/frames.size:.1%}), batch + frame-2 random access "
          f"bit-exact")

    # 4. 16-bit depth map: hi/lo byte planes; the hi plane of smooth depth
    #    content is near-constant and compresses to almost nothing
    depth = (20000 + 40 * luma + 8 * yy).astype(np.uint16)
    dblob = color.encode_gray16_to_bytes(depth, cfg)
    examples.same("decode_gray16", color.decode_gray16_from_bytes(dblob, dev),
                  depth, decoded)
    print(f"MHTC gray16: {len(dblob)} bytes "
          f"({len(dblob)/(depth.size*2):.1%} of the 16-bit raw), bit-exact")
    return {"blobs": {"image": blob, "video": vblob, "gray16": dblob},
            "decoded": decoded}


if __name__ == "__main__":
    main()
