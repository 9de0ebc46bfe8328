"""S2: timing variants of the image decode (B1), and their plain version.

Counterpart of the TPU ablation ``scratch/ablate_decode.py``
(``build_variant``, body ``make_kernel_variant``). :func:`ablate_decode`
(``csrc/ablate_decode.cu``) decodes a staged shared-table batch of 8x8 blocks
with the 1-D delta as one of :data:`VARIANTS`, each changing one thing of B1's
body (the source's header comment says which):

- ``base``: B1's body (15 compares, an adj lookup); TPU ``gatheradj``;
- ``pruned``: compares only for the table's code lengths, the fused
  width/adj accumulator; TPU ``base`` and ``maxw``;
- ``lut``: the two-level 8/8 lookup table of :mod:`..core.tables`;
- ``ilp2``: two blocks' chains per thread; TPU ``g12``/``g16``;
- ``xorfold``: base's decode with one u64 store per block, the XOR of its 8
  row words: the store ablation.

All but ``xorfold`` write B1's (T, bh*8, bw*8) uint8 image, so their plain
version is B1's; ``xorfold`` writes (T*bh*bw,) int64, the plain image's
rows folded by :func:`xor_fold`.

Run on the card (from the root of a checkout)::

    python3 -m metalhuffman_tpu_torch.probes.ablate_decode [--content
        synthetic] [variant ...]

decodes 30 photo frames of 2048x1536 (and the same frames rolled 16 px to
the right, a second input), holds each variant equal to ``base`` and to the
plain version, and times them in interleaved rounds beside B1.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..core import tables
from ..ops import decode_cuda
from . import card, measure_interleaved, median, require_cuda

#: the variants, in the order of the kernel's variant ids
VARIANTS = ("base", "pruned", "lut", "ilp2", "xorfold")
MAX_TERMS = 15

#: kernel launches made by the wrapper in this process
launches = {"ablate_decode": 0}


@dataclass(frozen=True)
class LutTables:
    """The ``lut`` variant's two-level 8/8 table on one device, entries
    ``width * 256 + symbol`` as u16 bits in int16 tensors."""

    t1: torch.Tensor  # (256,)
    t2: torch.Tensor  # (num_t2 * 256,); table 0 is all zero

    @property
    def num_t2(self) -> int:
        return self.t2.numel() // 256


def lut_tables(widths: np.ndarray, device) -> LutTables:
    """The two-level table of a 256-entry width table, staged on ``device``."""
    st = tables.build_split_tables(widths)

    def stage(sym, width):
        ent = tables.pack_entries(sym, width).astype(np.uint16).view(np.int16)
        return torch.from_numpy(ent).to(device)

    return LutTables(stage(st.t1_symbol, st.t1_width),
                     stage(st.t2_symbol, st.t2_width))


def pruned_terms(bounds, adj) -> tuple[tuple, tuple, int]:
    """``pruned``'s compare terms -> (bounds, increments, base).

    As the TPU pruned them (``make_kernel_variant``): a bound of 0 always
    holds and goes into the base width and adj; a bound of 2^16 or more
    never holds and is dropped. Code lengths absent from the table share
    their bound with the next length, so equal bounds merge into one term
    whose increment counts every length it starts. An increment is ``n +
    256 * (adj step)``, and ``base = base_w + 256 * (base_adj + 2^16)``,
    so the width is the low byte of the sum and adj the rest less 2^16.
    """
    base_w, base_adj = 1, int(adj[0])
    t_bounds, t_incs = [], []
    for length in range(2, 17):
        b = int(bounds[length - 1])
        step = int(adj[length - 1]) - int(adj[length - 2])
        if b == 0:
            base_w += 1
            base_adj += step
        elif b < 1 << 16:
            if t_bounds and t_bounds[-1] == b:
                t_incs[-1] += 1 + 256 * step
            else:
                t_bounds.append(b)
                t_incs.append(1 + 256 * step)
    return tuple(t_bounds), tuple(t_incs), base_w + 256 * (base_adj + (1 << 16))


@functools.lru_cache(maxsize=16)
def _pruned_args(bounds: tuple, adj: tuple):
    """The kernel's ``pruned`` arguments (term count, bounds, increments,
    base), made once per table so that a timed call does B1's host work."""
    t_bounds, t_incs, base = pruned_terms(bounds, adj)
    return (len(t_bounds), (ctypes.c_uint32 * MAX_TERMS)(*t_bounds),
            (ctypes.c_int32 * MAX_TERMS)(*t_incs), base)


def xor_fold(img: torch.Tensor, num_frames: int, bh: int, bw: int):
    """(T, bh*8, bw*8) uint8 image -> (T*bh*bw,) int64: each 8x8 block's 8
    row words (little-endian u64) XORed, in raster block order."""
    rows = img.view(num_frames, bh, 8, bw, 8).permute(0, 1, 3, 2, 4)
    rows = rows.contiguous().view(torch.int64).view(-1, 8)
    out = rows[:, 0].clone()
    for dy in range(1, 8):
        out ^= rows[:, dy]
    return out


def ablate_decode_plain(words: torch.Tensor, offsets: torch.Tensor,
                        symbols: torch.Tensor, bounds, adj, *,
                        num_frames: int, bh: int, bw: int, variant: str):
    """Plain PyTorch version of every variant: B1's with the 1-D delta,
    XOR-folded for ``xorfold``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    img = decode_cuda.decode_images_plain(
        words, offsets, symbols, bounds, adj, num_frames=num_frames, bh=bh,
        bw=bw, delta=True)
    if variant == "xorfold":
        return xor_fold(img, num_frames, bh, bw)
    return img


def ablate_decode(words: torch.Tensor, offsets: torch.Tensor,
                  symbols: torch.Tensor, bounds, adj, *, num_frames: int,
                  bh: int, bw: int, variant: str,
                  lut: LutTables | None = None):
    """Decode a staged shared-table batch of 8x8 blocks with the 1-D delta
    as ``variant``: the inputs of :func:`..ops.decode_cuda.decode_images`,
    and for ``lut`` the table's :func:`lut_tables` on the same device.
    Returns (T, bh*8, bw*8) uint8, or for ``xorfold`` (T*bh*bw,) int64.
    CPU tensors run :func:`ablate_decode_plain`; CUDA tensors launch the
    kernel."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    nb = num_frames * bh * bw
    if decode_cuda._check_inputs(words, offsets, symbols, bounds, adj,
                                 nb) == "cpu":
        return ablate_decode_plain(words, offsets, symbols, bounds, adj,
                                   num_frames=num_frames, bh=bh, bw=bw,
                                   variant=variant)
    t1 = t2 = None
    n_t2 = 0
    if variant == "lut":
        if lut is None:
            raise ValueError("the lut variant needs lut_tables(widths, device)")
        for name, x in (("t1", lut.t1), ("t2", lut.t2)):
            if (x.device != words.device or x.dtype != torch.int16
                    or x.dim() != 1 or not x.is_contiguous()):
                raise ValueError(f"lut.{name} must be a contiguous 1-D int16 "
                                 f"tensor on {words.device}")
        if lut.t1.numel() != 256 or not 1 <= lut.num_t2 <= 256 \
                or lut.t2.numel() % 256:
            raise ValueError("lut needs 256 T1 entries and 1..256 T2 tables")
        t1, t2, n_t2 = lut.t1.data_ptr(), lut.t2.data_ptr(), lut.num_t2
    shape = (nb,) if variant == "xorfold" else (num_frames, bh * 8, bw * 8)
    out = torch.empty(shape, dtype=torch.int64 if variant == "xorfold"
                      else torch.uint8, device=words.device)
    if nb:
        terms = (_pruned_args(tuple(bounds), tuple(adj))
                 if variant == "pruned" else (0, None, None, 0))
        _build.launch(
            "ablate_decode", words.device, words.data_ptr(), words.numel(),
            offsets.data_ptr(), nb, bh, bw,
            *decode_cuda._table_args(bounds, adj), symbols.data_ptr(),
            VARIANTS.index(variant), *terms, t1, t2, n_t2, out.data_ptr())
        launches["ablate_decode"] += 1
    return out


def main(argv=None) -> int:
    from ..models import frame_stream as fs
    from ..utils import fixtures

    ap = argparse.ArgumentParser(
        prog="python3 -m metalhuffman_tpu_torch.probes.ablate_decode",
        description="Time the variants of the image decode on the card.")
    ap.add_argument("variants", nargs="*", choices=VARIANTS, metavar="variant",
                    help=f"any of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--content", choices=("photo", "synthetic"),
                    default="photo")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    variants = args.variants or list(VARIANTS)
    device = require_cuda()
    t, h, w = 30, 1536, 2048
    if args.content == "synthetic":
        base = fixtures.synthetic(t, h, w)
    else:
        base = fixtures.photo_frames(h, w, t)
    frame_sets = [base, np.roll(base, 16, axis=2)]
    staged = []
    for frames in frame_sets:
        stream = fs.encode_frames_shared(frames)
        staged.append((fs.prepare_shared(stream, t, h, w, device=device),
                       lut_tables(stream.widths, device)))

    def call(variant, i):
        p, lut = staged[i]
        return ablate_decode(p.words, p.offsets, p.symbols, p.bounds, p.adj,
                             num_frames=t, bh=p.bh, bw=p.bw, variant=variant,
                             lut=lut)

    for i, (p, _) in enumerate(staged):
        plain = decode_cuda.decode_images_plain(
            p.words, p.offsets, p.symbols, p.bounds, p.adj, num_frames=t,
            bh=p.bh, bw=p.bw, delta=True)
        ref = call("base", i)
        for v in variants:
            got = call(v, i)
            want = (xor_fold(ref, t, p.bh, p.bw) if v == "xorfold" else ref)
            plain_v = (xor_fold(plain, t, p.bh, p.bw) if v == "xorfold"
                       else plain)
            if not (torch.equal(got, want) and torch.equal(got, plain_v)):
                print(f"  !! {v} output mismatch vs base or plain (input {i})")
                return 1
    print(f"every variant == base == plain on {len(staged)} inputs; "
          f"T2 tables: {staged[0][1].num_t2}, compare terms: "
          f"{len(pruned_terms(staged[0][0].bounds, staged[0][0].adj)[0])}")
    fns = {"B1 decode_images": lambda i: decode_cuda.decode_images(
        staged[i][0].words, staged[i][0].offsets, staged[i][0].symbols,
        staged[i][0].bounds, staged[i][0].adj, num_frames=t,
        bh=staged[i][0].bh, bw=staged[i][0].bw, delta=True)}
    fns.update({v: (lambda i, v=v: call(v, i)) for v in variants})
    name = card()
    for label, ms in measure_interleaved(fns, len(staged)).items():
        med = median(ms)
        print(f"{label:22s} {med:8.4f} ms (min {ms[0]:.4f}, max {ms[-1]:.4f})"
              f"  {base.size / med / 1e6:7.2f} GB/s decoded, {args.content} "
              f"{t}x{w}x{h}, on {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
