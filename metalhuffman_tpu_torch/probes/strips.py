"""S1: the image decode with bulk copies on both sides, and its plain
version.

Counterpart of the TPU prototype ``scratch/kernel_strips.py``
(``decode_strips``, body ``make_kernel``), which made the decode kernel emit
image strips. :func:`decode_strips` (``csrc/decode_strips.cu``) decodes 256
consecutive 8x8 blocks per CUDA block with B1's lookup-table step: it copies
the CUDA block's span of code words into shared memory with one bulk copy
(:func:`cta_spans`), decodes into a strip in shared memory, and stores each
pixel row's runs with bulk copies (:func:`strip_stores`). Its second form
(``prefetch=True``) is a persistent grid that copies the next run's span
while it decodes the current one. Both write B1's bytes
(:func:`..ops.decode_cuda.decode_images` with the 1-D delta), so their plain
version is B1's.

Run on the card (from the root of a checkout)::

    python3 -m metalhuffman_tpu_torch.probes.strips

decodes the prototype's 30x1536x2048 batch, checks both forms against the
frames ("strips correct") and times them beside B1, with each one's CUDA
blocks per SM and registers.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import _build
from ..ops import decode_cuda
from . import card, measure_interleaved, median, require_cuda

#: kernel launches made by the wrapper in this process
launches = {"decode_strips": 0}
#: blocks per CUDA block, and the span buffer in words of the one-shot and
#: the prefetching form (``csrc/decode_strips.cu``: ``kThreads``,
#: ``kSpanWords``, ``kPrefetchSpanWords``)
CTA_BLOCKS = 256
SPAN_WORDS = 8200
PREFETCH_SPAN_WORDS = 4100
#: the two forms: name -> the wrapper's ``prefetch``
FORMS = {"strips": False, "prefetch": True}
#: slots of a strip row, and the most runs a CUDA block with an odd bw
#: stores by bulk copies (``kSlots``, ``kMaxRuns``)
SLOTS = CTA_BLOCKS + 8
MAX_RUNS = 7


def cta_spans(offsets: torch.Tensor, n_words: int,
              span_words: int = SPAN_WORDS) -> torch.Tensor:
    """The code words each CUDA block of the kernel holds in shared memory
    -> (n_ctas, 2) int64 ``[lo, hi)`` word indices.

    ``offsets``: the (n_blocks,) int32 bit offsets, read as u32; ``n_words``
    the words of the buffer. ``lo`` is the 16-byte word boundary at or below
    the CUDA block's first offset; ``hi`` the word after the last one a
    refill of its blocks reads in a well-formed stream (the next CUDA
    block's first offset, word index plus 3; the buffer's end for the last
    CUDA block) rounded up to 16 bytes, at most ``span_words`` past ``lo``
    and at most ``n_words``. A malformed index can give ``hi == lo``.
    """
    off = offsets.to(torch.int64) & 0xFFFFFFFF
    lo = (off[::CTA_BLOCKS] >> 5) & ~3
    end = torch.tensor([n_words], dtype=torch.int64, device=off.device)
    need = torch.cat([(off[CTA_BLOCKS::CTA_BLOCKS] >> 5) + 3, end])
    hi = torch.minimum(torch.minimum((need + 3) & ~3, lo + span_words), end)
    return torch.stack([lo, torch.maximum(hi, lo)], 1)


def strip_stores(b0: int, n: int, bw: int) -> tuple[list, list]:
    """What the kernel's CUDA block of blocks ``b0 .. b0+n-1`` does with its
    strip, for an image ``bw`` blocks wide -> (slots, stores).

    ``slots[dy][k]``: the strip slot that row ``dy`` of local block ``k``
    goes to (a strip row has :data:`SLOTS`, 8 bytes each, 16-byte aligned).
    ``stores``: ``(bulk, dy, first slot, byte offset in the image, bytes)``
    in the order the kernel makes them: per pixel row, each run of blocks
    of one block row as one bulk copy, its odd end blocks as plain 8-byte
    stores; with an odd ``bw`` each run shifted so that slot and image
    position agree in 16-byte parity; with more than :data:`MAX_RUNS` runs
    of an odd ``bw``, only plain stores.
    """
    r0, r1 = b0 // bw, (b0 + n - 1) // bw
    odd = bw % 2 == 1
    bulk = not odd or r1 - r0 < MAX_RUNS
    shift = odd and bulk
    slots = [[k + (((b0 + k) // bw - r0 + (dy + r0) % 2) if shift else 0)
              for k in range(n)] for dy in range(8)]
    row_bytes = 8 * bw
    stores = []
    if not bulk:
        for k in range(n):
            r = (b0 + k) // bw
            stores += [(False, dy, k, (8 * r + dy) * row_bytes
                        + 8 * (b0 + k - r * bw), 8) for dy in range(8)]
        return slots, stores
    for dy in range(8):
        for r in range(r0, r1 + 1):
            first = r * bw
            kb, ke = max(first - b0, 0), min(first + bw - b0, n)
            sh = (r - r0) + (dy + r0) % 2 if shift else 0

            def dst(kk, r=r, first=first):
                return (8 * r + dy) * row_bytes + 8 * (b0 + kk - first)
            if dst(kb) % 16:
                stores.append((False, dy, kb + sh, dst(kb), 8))
                kb += 1
            if (ke - kb) % 2:
                ke -= 1
                stores.append((False, dy, ke + sh, dst(ke), 8))
            if ke > kb:
                stores.append((True, dy, kb + sh, dst(kb), 8 * (ke - kb)))
    return slots, stores


def decode_strips_plain(words: torch.Tensor, offsets: torch.Tensor,
                        code: decode_cuda.Code, *, num_frames: int, bh: int,
                        bw: int) -> torch.Tensor:
    """Plain PyTorch version of the strip kernel: B1's, 1-D delta."""
    return decode_cuda.decode_images_plain(
        words, offsets, code, num_frames=num_frames, bh=bh, bw=bw, delta=True)


def decode_strips(words: torch.Tensor, offsets: torch.Tensor,
                  code: decode_cuda.Code, *, num_frames: int, bh: int,
                  bw: int, prefetch: bool = False) -> torch.Tensor:
    """Decode a staged shared-table batch of 8x8 blocks with the 1-D delta
    -> (T, bh*8, bw*8) uint8, the inputs and output of
    :func:`..ops.decode_cuda.decode_images`. CPU tensors run
    :func:`decode_strips_plain`; CUDA tensors launch the kernel, in its
    prefetching form with ``prefetch``, with the code's lookup table; its
    bulk copies need 16-byte aligned words."""
    nb = num_frames * bh * bw
    if decode_cuda._check_inputs(words, offsets, code, nb) == "cpu":
        return decode_strips_plain(words, offsets, code,
                                   num_frames=num_frames, bh=bh, bw=bw)
    decode_cuda._check_table(code, words)
    if words.data_ptr() % 16:
        raise ValueError("decode_strips copies the words 16 bytes at a time: "
                         "they must be 16-byte aligned")
    out = torch.empty((num_frames, bh * 8, bw * 8), dtype=torch.uint8,
                      device=words.device)
    if nb:
        _build.launch("decode_strips", words.device, words.data_ptr(),
                      words.numel(), offsets.data_ptr(), nb, bw,
                      code.entries.data_ptr(), code.entries.numel(),
                      int(code.t2_in_smem), int(prefetch), out.data_ptr())
        launches["decode_strips"] += 1
    return out


def launch_shape(n_blocks: int, code: decode_cuda.Code,
                 prefetch: bool = False) -> dict:
    """The launch :func:`decode_strips` makes over ``n_blocks`` blocks with
    ``code`` (on its CUDA device), as
    :func:`..ops.decode_cuda.launch_shape` gives B1's."""
    shape = (ctypes.c_int * 6)()
    with torch.cuda.device(code.entries.device):
        err = _build.lib("decode_strips").mht_decode_strips_shape(
            n_blocks, code.entries.numel(), int(code.t2_in_smem),
            int(prefetch), shape)
    if err:
        raise RuntimeError(f"mht_decode_strips_shape failed: CUDA error {err}")
    return dict(zip(("ctas_per_sm", "grid", "dyn_smem", "static_smem",
                     "registers", "local_bytes"), shape))


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
        return (p.words, p.offsets, p.code)

    def geo(p):
        return dict(num_frames=t, bh=p.bh, bw=p.bw)

    for form, prefetch in FORMS.items():
        out = decode_strips(*args(preps[0]), **geo(preps[0]),
                            prefetch=prefetch)
        ok = np.array_equal(
            fs.frames_from_raw(out, t, h, w).cpu().numpy(), frames)
        print(f"strips correct ({form}):", ok)
        if not ok:
            return 1
    spans = cta_spans(preps[0].offsets, preps[0].words.numel())
    size = 4 * (spans[:, 1] - spans[:, 0]).double()
    print(f"code spans: mean {size.mean():.0f} B, max {size.max():.0f} B "
          f"over {spans.shape[0]} CUDA blocks")
    p0 = preps[0]
    fns = {"B1 decode_images": lambda i: decode_cuda.decode_images(
        *args(preps[i]), **geo(preps[i]), delta=True)}
    shapes = {"B1 decode_images": decode_cuda.launch_shape(
        "decode_images", p0.words.numel(), p0.offsets.numel(), p0.code)}
    for form, prefetch in FORMS.items():
        fns[f"S1 {form}"] = (lambda i, prefetch=prefetch: decode_strips(
            *args(preps[i]), **geo(preps[i]), prefetch=prefetch))
        shapes[f"S1 {form}"] = launch_shape(p0.offsets.numel(), p0.code,
                                            prefetch)
    name = card()
    for label, ms in measure_interleaved(fns, len(preps)).items():
        med = median(ms)
        sh = shapes[label]
        print(f"{label:18s} {med:8.4f} ms (min {ms[0]:.4f}, max {ms[-1]:.4f})"
              f"  {frames.size / med / 1e6:7.2f} GB/s decoded, "
              f"{sh['ctas_per_sm']} CTAs/SM, {sh['registers']} registers, "
              f"grid {sh['grid']}, {t}x{w}x{h}, on {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
