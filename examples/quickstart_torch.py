"""Quickstart of the PyTorch / CUDA port: the API surface in one runnable
script (counterpart of ``examples/quickstart.py``).

    python examples/quickstart_torch.py                 # on the card
    python examples/quickstart_torch.py --device cpu    # plain versions

Every decode runs on ``--device``: the CUDA kernels on a card, their plain
PyTorch versions on the CPU. Exits nonzero when a decoded array differs
from its source.
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import metalhuffman_tpu_torch as mt  # noqa: E402
from metalhuffman_tpu_torch.core import container  # noqa: E402
from metalhuffman_tpu_torch.models.config import CodecConfig  # noqa: E402
from metalhuffman_tpu_torch.models.image_codec import ImageCodec  # noqa: E402
from metalhuffman_tpu_torch.utils import debug, examples, fixtures  # noqa: E402


def main(argv=None) -> dict:
    """Run the quickstart -> {"blobs": name -> container bytes, "decoded":
    name -> (decoded array, its source)}; raises ValueError on a
    mismatch."""
    args = examples.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = args.device
    decoded: dict = {}

    # 1. a test frame (the reference's fixture configs, rebuilt)
    img = fixtures.render_frame("image1")  # 512x512 photo-like
    print(f"frame: {img.shape}, {img.size} bytes")

    # 2. one-call container round trip (CRC-verified)
    cfg = CodecConfig()
    blob = mt.encode_image(img, cfg)
    examples.same("decode_image", mt.decode_image(blob, device=dev), img,
                  decoded)
    print(f"MHT1 container: {len(blob)} bytes ({len(blob)/img.size:.1%}), "
          "bit-exact")

    # 3. the explicit pipeline: encode once, stage once, decode per tick
    codec = ImageCodec(cfg)
    stream = codec.encode(img)
    prep = codec.prepare(stream, *img.shape, device=dev)
    examples.same("decode_step", codec.decode_step(prep), img, decoded)
    print(debug.stream_summary(stream))

    # 4. video: shared canonical table, whole batch in one kernel launch
    frames = np.stack([fixtures.render_frame("16x16_ident"),
                       fixtures.render_frame("16x16_ident2")])
    vblob = mt.encode_video(frames, cfg)
    examples.same("decode_video", mt.decode_video(vblob, dev), frames,
                  decoded)
    print(f"MHTV container: {len(vblob)} bytes for {len(frames)} frames")

    # 4b. the delta2d precoder (mode 3): smaller streams at full decode
    #     speed (the kernel reconstructs the 2-D predictor in registers)
    best, _used = codec.encode_best(img)  # measures none/delta/delta2d
    print(f"encode_best: predictor={best.predictor!r} "
          f"{best.compressed_size} bytes (delta was {stream.compressed_size})")

    # 5. files via the CLI-equivalent API
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "frame.mht")
        with open(path, "wb") as f:
            f.write(blob)
        with open(path, "rb") as f:
            _s2, h, w, bd, delta, crc = container.read_frame(f.read())
        print(f"read back: {h}x{w} block_dim={bd} delta={delta} "
              f"crc={'yes' if crc else 'no'}")

    # 6. inspect one block's decode, symbol by symbol
    tr = debug.trace_block(stream, 0, delta=cfg.delta)
    print("block 0, first 3 symbols: "
          + ", ".join(f"bits[{t.bit_offset}:{t.bit_offset+t.width}]="
                      f"'{t.pattern}'->{t.value}" for t in tr[:3]))
    print("quickstart OK")
    return {"blobs": {"image": blob, "video": vblob}, "decoded": decoded}


if __name__ == "__main__":
    main()
