"""S1: the image decode with coalesced strip stores, and its plain version.

Counterpart of the TPU prototype ``scratch/kernel_strips.py``
(``decode_strips``, body ``make_kernel``), which made the decode kernel emit
image strips. :func:`decode_strips` (``csrc/decode_strips.cu``) decodes 256
consecutive 8x8 blocks per CUDA block into a shared-memory strip and stores
it by pixel row with 16-byte stores; it writes B1's bytes
(:func:`..ops.decode_cuda.decode_images` with the 1-D delta), so its plain
version is B1's.

Run on the card (from the root of a checkout)::

    python3 -m metalhuffman_tpu_torch.probes.strips

decodes the prototype's 30x1536x2048 batch, checks it against the frames
("strips correct") and times the kernel beside B1.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import _build
from ..ops import decode_cuda
from . import card, measure_interleaved, median, require_cuda

#: kernel launches made by the wrapper in this process
launches = {"decode_strips": 0}


def decode_strips_plain(words: torch.Tensor, offsets: torch.Tensor,
                        symbols: torch.Tensor, bounds, adj, *,
                        num_frames: int, bh: int, bw: int) -> torch.Tensor:
    """Plain PyTorch version of the strip kernel: B1's, 1-D delta."""
    return decode_cuda.decode_images_plain(
        words, offsets, symbols, bounds, adj, num_frames=num_frames, bh=bh,
        bw=bw, delta=True)


def decode_strips(words: torch.Tensor, offsets: torch.Tensor,
                  symbols: torch.Tensor, bounds, adj, *, num_frames: int,
                  bh: int, bw: int) -> torch.Tensor:
    """Decode a staged shared-table batch of 8x8 blocks with the 1-D delta
    -> (T, bh*8, bw*8) uint8, the inputs and output of
    :func:`..ops.decode_cuda.decode_images`. CPU tensors run
    :func:`decode_strips_plain`; CUDA tensors launch the kernel."""
    nb = num_frames * bh * bw
    if decode_cuda._check_inputs(words, offsets, symbols, bounds, adj,
                                 nb) == "cpu":
        return decode_strips_plain(words, offsets, symbols, bounds, adj,
                                   num_frames=num_frames, bh=bh, bw=bw)
    out = torch.empty((num_frames, bh * 8, bw * 8), dtype=torch.uint8,
                      device=words.device)
    if nb:
        _build.launch("decode_strips", words.device, words.data_ptr(),
                      words.numel(), offsets.data_ptr(), nb, bh, bw,
                      *decode_cuda._table_args(bounds, adj),
                      symbols.data_ptr(), out.data_ptr())
        launches["decode_strips"] += 1
    return out


def prototype_frames(t: int, h: int, w: int) -> np.ndarray:
    """The prototype's frames (``kernel_strips.main``): one seeded noise
    stream over all frames, the gradient panned 3 px per frame."""
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([
        np.clip(96 + 80 * np.sin((xx + 3 * i) / 97.0) * np.cos(yy / 71.0)
                + rng.normal(0, 3.0, (h, w)), 0, 255).astype(np.uint8)
        for i in range(t)])


def main(argv=None) -> int:
    from ..models import frame_stream as fs

    argv = sys.argv[1:] if argv is None else argv
    if argv:
        print("usage: python3 -m metalhuffman_tpu_torch.probes.strips",
              file=sys.stderr)
        return 2
    device = require_cuda()
    t, h, w = 30, 1536, 2048
    frames = prototype_frames(t, h, w)
    # a second input: the frames in another order (same table, other bits)
    preps = [fs.prepare_shared(fs.encode_frames_shared(f), t, h, w,
                               device=device)
             for f in (frames, np.roll(frames, 1, axis=0))]

    def args(p):
        return (p.words, p.offsets, p.symbols, p.bounds, p.adj)

    def geo(p):
        return dict(num_frames=t, bh=p.bh, bw=p.bw)

    out = decode_strips(*args(preps[0]), **geo(preps[0]))
    ok = np.array_equal(
        fs.frames_from_raw(out, t, h, w).cpu().numpy(), frames)
    print("strips correct:", ok)
    if not ok:
        return 1
    fns = {
        "B1 decode_images": lambda i: decode_cuda.decode_images(
            *args(preps[i]), **geo(preps[i]), delta=True),
        "S1 decode_strips": lambda i: decode_strips(*args(preps[i]),
                                                    **geo(preps[i])),
    }
    name = card()
    for label, ms in measure_interleaved(fns, len(preps)).items():
        med = median(ms)
        print(f"{label:18s} {med:8.4f} ms (min {ms[0]:.4f}, max {ms[-1]:.4f})"
              f"  {frames.size / med / 1e6:7.2f} GB/s decoded, {t}x{w}x{h}, "
              f"on {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
