"""S2: timing variants of the image decode (B1), and their plain version.

Counterpart of the TPU ablation ``scratch/ablate_decode.py``
(``build_variant``, body ``make_kernel_variant``). :func:`ablate_decode`
(``csrc/ablate_decode.cu``) decodes a staged shared-table batch of 8x8 blocks
with the 1-D delta as one of :data:`VARIANTS`, each changing one thing of a
body (the source's header comment says which). Two families:

- B1's body before its lookup-table redesign, the interval body:
  - ``base``: 15 compares, an adj lookup; TPU ``gatheradj``;
  - ``pruned``: compares only for the table's code lengths, the fused
    width/adj accumulator; TPU ``base`` and ``maxw``;
  - ``lut``: the two-level 8/8 lookup table of :mod:`..core.tables`;
  - ``ilp2``: two blocks' chains per thread; TPU ``g12``/``g16``;
  - ``xorfold``: base's decode with one u64 store per block, the XOR of
    its 8 row words: the store ablation.
- B1's body as it is now (:data:`B1_FAMILY`), on B1's 11/5 lookup table
  (the :class:`..ops.decode_cuda.Code`'s, as
  :func:`..ops.decode_cuda.decode_images` reads it):
  - ``b1``: B1's body unchanged, the yardstick;
  - ``b1_esc32``: u32 entries whose escapes hold the secondary table's
    index (:func:`esc32_entries`, ``table32=``);
  - ``b1_refill64``: the refill from two aligned 8-byte loads;
  - ``b1_row8``: 8 symbols per refill from a 128-bit window;
  - ``b1_esc32_row8``: the two together;
  - ``b1_s1smem``: ``b1`` with S1's shared memory beside the table, unused,
    so at S1's residency: the control of :mod:`.strips`.

All but ``xorfold`` write B1's (T, bh*8, bw*8) uint8 image, so their plain
version is B1's; ``xorfold`` writes (T*bh*bw,) int64, the plain image's
rows folded by :func:`xor_fold`.

Run on the card (from the root of a checkout)::

    python3 -m metalhuffman_tpu_torch.probes.ablate_decode [--content
        synthetic] [variant ...]

decodes 30 photo frames of 2048x1536 (and the same frames rolled 16 px to
the right, a second input), holds each variant equal to ``base`` and to the
plain version, and times them in interleaved rounds beside B1, with each
one's CUDA blocks per SM and registers.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import re
import sys
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..core import tables
from ..ops import decode_cuda
from . import card, measure_interleaved, median, require_cuda
from . import sass_opcodes as _sass_opcodes

#: the variants, in the order of the kernel's variant ids
VARIANTS = ("base", "pruned", "lut", "ilp2", "xorfold", "b1", "b1_esc32",
            "b1_refill64", "b1_row8", "b1_esc32_row8", "b1_s1smem")
#: the variants of B1's lookup-table body; those on :func:`esc32_table`;
#: those whose refills load 8 bytes at a time
B1_FAMILY = VARIANTS[5:]
ESC32_VARIANTS = ("b1_esc32", "b1_esc32_row8")
WIDE_REFILLS = ("b1_refill64", "b1_row8", "b1_esc32_row8")
MAX_TERMS = 15
#: a ``b1_esc32`` T1 entry with this bit escapes; its other bits are the
#: index of its secondary table in the whole table (``csrc/ablate_decode.cu``)
ESC32 = 0x80000000

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


def esc32_entries(meta: decode_cuda.CanonicalMeta) -> np.ndarray:
    """``b1_esc32``'s table of ``meta`` -> (n,) uint32: the entries of
    :func:`..ops.decode_cuda.lookup_entries` as u32, each T1 escape
    ``ESCAPE | t`` made ``ESC32 | (2**LUT_K1 + t * 2**(16 - LUT_K1))``, the
    index of secondary table t's first entry in the whole table. A window
    that escapes reads entry ``(e & ~ESC32) | (window & (2**(16-LUT_K1) -
    1))``. T1 takes 8 KB, a complete code's T2 at most 24 KB."""
    k1, k2 = decode_cuda.LUT_K1, 16 - decode_cuda.LUT_K1
    ent = decode_cuda.lookup_entries(meta).astype(np.uint32)
    t1 = ent[: 1 << k1]  # a view: the escapes are rewritten in place
    esc = (t1 & decode_cuda.ESCAPE) != 0
    t1[esc] = ESC32 | ((1 << k1) + ((t1[esc] ^ decode_cuda.ESCAPE) << k2))
    return ent


@dataclass(frozen=True)
class Esc32Table:
    """``b1_esc32``'s table (:func:`esc32_entries`) staged on a device, the
    u32 entries as int32 bits."""

    entries: torch.Tensor  # (2**LUT_K1 + num_t2 * 2**(16-LUT_K1),) int32

    @property
    def nbytes(self) -> int:
        return 4 * self.entries.numel()

    @property
    def t2_in_smem(self) -> bool:
        """True when the kernel stages the whole table in shared memory."""
        return self.nbytes <= decode_cuda.T2_SMEM_MAX_BYTES


def esc32_table(widths: np.ndarray, device) -> Esc32Table:
    """The ``b1_esc32`` table of a 256-entry width table, staged on
    ``device``."""
    ent = esc32_entries(decode_cuda.canonical_meta(widths)).view(np.int32)
    return Esc32Table(torch.from_numpy(ent).to(device))


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
                        code: decode_cuda.Code, *, num_frames: int, bh: int,
                        bw: int, variant: str):
    """Plain PyTorch version of every variant: B1's with the 1-D delta,
    XOR-folded for ``xorfold``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    img = decode_cuda.decode_images_plain(
        words, offsets, code, num_frames=num_frames, bh=bh, bw=bw, delta=True)
    if variant == "xorfold":
        return xor_fold(img, num_frames, bh, bw)
    return img


def _check_table32(table32: Esc32Table | None, words: torch.Tensor) -> None:
    """Validate the :func:`esc32_table` a CUDA launch takes."""
    if table32 is None:
        raise ValueError("the b1_esc32 variants need esc32_table(widths, "
                         "device)")
    x = table32.entries
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("table32.entries must be a contiguous 1-D int32 "
                         "tensor")
    if x.device != words.device:
        raise ValueError(f"table32 is on {x.device}, words on {words.device}")
    t1, per_t2 = 1 << decode_cuda.LUT_K1, 1 << (16 - decode_cuda.LUT_K1)
    if (x.numel() < t1 or (x.numel() - t1) % per_t2
            or (x.numel() - t1) // per_t2 > t1 or x.data_ptr() % 16):
        raise ValueError(f"table32.entries ({x.numel()}) is no 16-byte "
                         "aligned 11/5 table")


def _lut_args(variant: str, lut: LutTables | None, words: torch.Tensor):
    """The ``lut`` variant's (t1, t2, n_t2) kernel arguments."""
    if variant != "lut":
        return None, None, 0
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
    return lut.t1.data_ptr(), lut.t2.data_ptr(), lut.num_t2


def _b1_args(variant: str, code: decode_cuda.Code, table32,
             words: torch.Tensor):
    """The b1 family's (table, table_entries, t2_smem) kernel arguments:
    the code's lookup table, or ``table32`` for the esc32 variants."""
    if variant not in B1_FAMILY:
        return None, 0, 0
    if variant in ESC32_VARIANTS:
        _check_table32(table32, words)
        table = table32
    else:
        decode_cuda._check_table(code, words)
        table = code
    if variant in WIDE_REFILLS and words.data_ptr() % 8:
        raise ValueError(f"{variant} reads the words 8 bytes at a time: they "
                         "must be 8-byte aligned")
    return (table.entries.data_ptr(), table.entries.numel(),
            int(table.t2_in_smem))


def ablate_decode(words: torch.Tensor, offsets: torch.Tensor,
                  code: decode_cuda.Code, *, num_frames: int, bh: int,
                  bw: int, variant: str, lut: LutTables | None = None,
                  table32: Esc32Table | None = None):
    """Decode a staged shared-table batch of 8x8 blocks with the 1-D delta
    as ``variant``: the inputs of :func:`..ops.decode_cuda.decode_images`
    (the interval variants read the code's interval table, the b1 family
    its lookup table), and on the same device, for ``lut`` the table's
    :func:`lut_tables`, for ``b1_esc32`` and ``b1_esc32_row8``
    :func:`esc32_table` (``table32``). Returns (T, bh*8, bw*8) uint8, or
    for ``xorfold`` (T*bh*bw,) int64. CPU tensors run
    :func:`ablate_decode_plain`; CUDA tensors launch the kernel."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    nb = num_frames * bh * bw
    if decode_cuda._check_inputs(words, offsets, code, nb) == "cpu":
        return ablate_decode_plain(words, offsets, code,
                                   num_frames=num_frames, bh=bh, bw=bw,
                                   variant=variant)
    lut_args = _lut_args(variant, lut, words)
    b1_args = _b1_args(variant, code, table32, words)
    shape = (nb,) if variant == "xorfold" else (num_frames, bh * 8, bw * 8)
    out = torch.empty(shape, dtype=torch.int64 if variant == "xorfold"
                      else torch.uint8, device=words.device)
    if nb:
        terms = (_pruned_args(code.bounds, code.adj)
                 if variant == "pruned" else (0, None, None, 0))
        _build.launch(
            "ablate_decode", words.device, words.data_ptr(), words.numel(),
            offsets.data_ptr(), nb, bh, bw,
            *decode_cuda._table_args(code), code.symbols.data_ptr(),
            VARIANTS.index(variant), *terms, *lut_args, *b1_args,
            out.data_ptr())
        launches["ablate_decode"] += 1
    return out


def launch_shape(variant: str, n_blocks: int, code: decode_cuda.Code, *,
                 lut: LutTables | None = None,
                 table32: Esc32Table | None = None) -> dict:
    """The launch :func:`ablate_decode` makes for ``variant`` over
    ``n_blocks`` blocks with ``code`` and these tables (on a CUDA device), as
    :func:`..ops.decode_cuda.launch_shape` gives B1's: resident CUDA blocks
    per SM, grid, dynamic and static shared memory per CUDA block,
    registers and local (spill) bytes per thread."""
    n_terms = (_pruned_args(code.bounds, code.adj)[0]
               if variant == "pruned" else 0)
    n_t2 = lut.num_t2 if variant == "lut" else 0
    tab = table32 if variant in ESC32_VARIANTS else code
    entries, t2_smem = ((tab.entries.numel(), int(tab.t2_in_smem))
                        if variant in B1_FAMILY else (0, 0))
    shape = (ctypes.c_int * 6)()
    fn = _build.lib("ablate_decode").mht_ablate_decode_shape
    device = (tab.entries.device if variant in B1_FAMILY
              else lut.t1.device if variant == "lut" else None)
    with torch.cuda.device(device):
        err = fn(n_blocks, VARIANTS.index(variant), n_terms, n_t2, entries,
                 t2_smem, shape)
    if err:
        raise RuntimeError(f"mht_ablate_decode_shape failed: CUDA error {err}")
    return dict(zip(("ctas_per_sm", "grid", "dyn_smem", "static_smem",
                     "registers", "local_bytes"), shape))


def sass_opcodes() -> dict[str, Counter]:
    """Variant of the b1 family -> the count of each SASS opcode in its
    kernel's instance with T2 in shared memory, from ``cuobjdump -sass``."""
    counts = {}
    for function, ops in _sass_opcodes("ablate_decode").items():
        m = re.search(r"b1_kernelILi(\d+)ELb1E", function)
        if m:
            counts[VARIANTS[int(m.group(1))]] = ops
    return counts


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
        p = fs.prepare_shared(stream, t, h, w, device=device)
        staged.append((p, dict(lut=lut_tables(stream.widths, device),
                               table32=esc32_table(stream.widths, device))))

    def call(variant, i):
        p, tabs = staged[i]
        return ablate_decode(p.words, p.offsets, p.code, num_frames=t,
                             bh=p.bh, bw=p.bw, variant=variant, **tabs)

    for i, (p, _) in enumerate(staged):
        plain = decode_cuda.decode_images_plain(
            p.words, p.offsets, p.code, num_frames=t, bh=p.bh, bw=p.bw,
            delta=True)
        ref = call("base", i)
        for v in variants:
            got = call(v, i)
            want = (xor_fold(ref, t, p.bh, p.bw) if v == "xorfold" else ref)
            plain_v = (xor_fold(plain, t, p.bh, p.bw) if v == "xorfold"
                       else plain)
            if not (torch.equal(got, want) and torch.equal(got, plain_v)):
                print(f"  !! {v} output mismatch vs base or plain (input {i})")
                return 1
    p0, tabs0 = staged[0]
    print(f"every variant == base == plain on {len(staged)} inputs; "
          f"T2 tables: {tabs0['lut'].num_t2} (8/8), {p0.code.num_t2} "
          f"(11/5), compare terms: "
          f"{len(pruned_terms(p0.code.bounds, p0.code.adj)[0])}")
    fns = {"B1 decode_images": lambda i: decode_cuda.decode_images(
        staged[i][0].words, staged[i][0].offsets, staged[i][0].code,
        num_frames=t, bh=staged[i][0].bh, bw=staged[i][0].bw, delta=True)}
    fns.update({v: (lambda i, v=v: call(v, i)) for v in variants})
    shapes = {"B1 decode_images": decode_cuda.launch_shape(
        "decode_images", p0.words.numel(), p0.offsets.numel(), p0.code)}
    shapes.update({v: launch_shape(v, p0.offsets.numel(), p0.code, **tabs0)
                   for v in variants})
    name = card()
    for label, ms in measure_interleaved(fns, len(staged)).items():
        med = median(ms)
        sh = shapes[label]
        print(f"{label:22s} {med:8.4f} ms (min {ms[0]:.4f}, max {ms[-1]:.4f})"
              f"  {base.size / med / 1e6:7.2f} GB/s decoded, "
              f"{sh['ctas_per_sm']} CTAs/SM, {sh['registers']} registers, "
              f"{args.content} {t}x{w}x{h}, on {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
