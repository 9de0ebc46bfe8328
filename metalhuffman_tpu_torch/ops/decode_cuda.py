"""Shared-table decode: the CUDA kernels, their plain versions, their staging.

Counterpart of ``metalhuffman_tpu/ops/decode_pallas.py``. Two kernels, both
reading the packed big-endian word stream at each block's own bit offset, so
the TPU staging (word rows, (8,128) tiles, feed permutation, ImagePlan
padding) has no counterpart here:

- :func:`decode_images` (``csrc/decode_images.cu``, TPU kernel
  ``decode_tiles_images``): 8x8 blocks stored at their image positions, a
  ``(T, bh*8, bw*8)`` uint8 tensor, frames padded only to whole blocks;
  block ``b`` of the raster block order (frames concatenated) lands at frame
  ``b // (bh*bw)``, block row ``(b % (bh*bw)) // bw``, block column
  ``b % bw``.
- :func:`decode_blocks` (``csrc/decode_blocks.cu``, TPU kernel
  ``decode_tiles``): blocks of any ``num_steps % 4 == 0`` symbols, an
  ``(nb, num_steps)`` uint8 tensor in the order of the offset index.

Both can also return each block's row-local end bit, ``(offset & 31)`` plus
the bits it consumed (the TPU kernel's ``emit_end`` carry), which
:func:`check_block_ends` holds against :func:`block_end_targets`.

Both kernels decode a symbol with one lookup in a two-level table,
:func:`lookup_entries`: the interval decode of :func:`_decode_plain` (the TPU
kernel's arithmetic) tabulated on every 16-bit window, so kernel and plain
version agree on any stream, malformed ones included. A stream's table is
built and staged once (:func:`lookup_table`; ``prepare_shared`` and
``decode_blocks_selection`` do it) and passed to every decode of it.

Each wrapper routes by the device of its tensors alone: CPU tensors take the
plain PyTorch version (the interval decode; the table is not read), CUDA
tensors the kernel, which needs the staged table (or an exception), anything
else raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..core import bitstream

#: zero u32 words appended after the stream (see :func:`prepare_stream`)
PAD_WORDS = 2
_M32 = 0xFFFFFFFF

#: the split of the 16-bit window (``csrc/decode_common.cuh::kK1``): T1
#: indexes the top 11 bits (4 KB), a secondary table the other 5; 11/5
#: decoded the 30x2048x1536 batches a few percent faster than 8/8 on the H100
#: (PERF.md)
LUT_K1 = 11
#: a T1 entry with this bit sends the window to secondary table ``entry ^
#: ESCAPE``; every other entry is ``width * 256 + symbol``, width 1..16
ESCAPE = 0x8000
#: tables up to this many bytes (T1 + T2) are staged whole into shared
#: memory; above, the kernels read T2 through L1
#: (``csrc/decode_common.cuh::kT2SmemMaxBytes``)
T2_SMEM_MAX_BYTES = 64 * 1024

#: kernel launches made by the wrappers in this process, by kernel name
launches = {"decode_images": 0, "decode_blocks": 0}
#: the same launches by path of the kernel: "<kernel> T2 smem" (the whole
#: table in shared memory) or "<kernel> T2 L1" (T2 through L1)
path_launches = {f"{name} T2 {where}": 0 for name in launches
                 for where in ("smem", "L1")}


@dataclass(frozen=True)
class CanonicalMeta:
    """Canonical-interval decode table of one 256-entry width table."""

    bounds: tuple  # (16,) int: B_L, left-justified start of the length-L region
    adj: tuple  # (16,) int: adj(w) = cum_w - first_code_w, for w = 1..16
    symbols: np.ndarray  # (256,) uint8: active symbols sorted by (width, symbol)


def canonical_meta(widths: np.ndarray) -> CanonicalMeta:
    """Interval-decode parameters from the 256-byte width table."""
    widths = np.asarray(widths, dtype=np.int64)
    counts = np.bincount(widths[widths > 0], minlength=17)
    first_rj = np.zeros(17, dtype=np.int64)
    code = 0
    for length in range(1, 17):
        first_rj[length] = code
        code = (code + int(counts[length])) << 1
    cum = np.zeros(17, dtype=np.int64)
    np.cumsum(counts[:16], out=cum[1:])
    lengths = np.arange(1, 17)
    bounds = first_rj[1:] << (16 - lengths)
    adj = cum[1:] - first_rj[1:]
    active = np.nonzero(widths)[0]
    order = np.lexsort((active, widths[active]))
    symbols = np.zeros(256, dtype=np.uint8)
    symbols[: active.size] = active[order]
    return CanonicalMeta(
        bounds=tuple(int(b) for b in bounds),
        adj=tuple(int(v) for v in adj),
        symbols=symbols,
    )


def interval_windows(meta: CanonicalMeta) -> tuple[np.ndarray, np.ndarray]:
    """(width, symbol) of the interval decode on every 16-bit window: the
    step of :func:`_decode_plain` and ``decode_common.cuh::decode_group``,
    ``w = 1 + #{bounds[1:] <= window}``, ``symbol = symbols[(adj[w-1] +
    (window >> (16 - w))) & 255]``. Two (65536,) int64 arrays."""
    win = np.arange(1 << 16, dtype=np.int64)
    # the count of bounds[1:] <= window, by bisection: the bounds never
    # decrease with L (first_rj[L+1] << (15-L) is (first_rj[L] + counts[L])
    # << (16-L)), over-subscribed and malformed tables included
    w = 1 + np.searchsorted(np.asarray(meta.bounds[1:], np.int64), win,
                            side="right")
    idx = np.asarray(meta.adj, np.int64)[w - 1] + (win >> (16 - w))
    return w, meta.symbols[idx & 255].astype(np.int64)


def lookup_entries(meta: CanonicalMeta) -> np.ndarray:
    """The kernels' two-level lookup table of ``meta`` -> (n,) uint16.

    :func:`interval_windows` tabulated: T1, ``2**LUT_K1`` entries indexed by
    the window's top ``LUT_K1`` bits, then the secondary tables of
    ``2**(16-LUT_K1)`` entries indexed by the rest. A T1 entry is direct,
    ``width * 256 + symbol``, when every window under its prefix decodes to
    that pair with ``width <= LUT_K1``; otherwise it is ``ESCAPE | t`` and
    secondary table ``t`` (in ascending prefix order) spells the function out
    over the prefix's windows. Every decoded entry has width >= 1, and no
    slot is reserved, so a width table that escapes from every prefix (a
    malformed one can) takes ``2**LUT_K1`` secondary tables: 132 KB.
    """
    return _lookup_entries(meta.bounds, meta.adj, meta.symbols.tobytes())


@functools.lru_cache(maxsize=32)
def _lookup_entries(bounds: tuple, adj: tuple, symbols: bytes) -> np.ndarray:
    meta = CanonicalMeta(bounds, adj, np.frombuffer(symbols, np.uint8))
    w, sym = interval_windows(meta)
    e = ((w << 8) | sym).reshape(1 << LUT_K1, 1 << (16 - LUT_K1))
    direct = (e == e[:, :1]).all(1) & ((e[:, 0] >> 8) <= LUT_K1)
    t1 = np.where(direct, e[:, 0], ESCAPE | (np.cumsum(~direct) - 1))
    out = np.concatenate([t1, e[~direct].ravel()]).astype(np.uint16)
    out.flags.writeable = False  # shared by every caller of the cache
    return out


@dataclass(frozen=True)
class LookupTable:
    """A stream's lookup table (:func:`lookup_entries`) staged on a device:
    the u16 entries as int16 bits, T1 then the secondary tables."""

    entries: torch.Tensor  # (2**LUT_K1 + num_t2 * 2**(16-LUT_K1),) int16

    @property
    def num_t2(self) -> int:
        return (self.entries.numel() - (1 << LUT_K1)) >> (16 - LUT_K1)

    @property
    def nbytes(self) -> int:
        return 2 * self.entries.numel()

    @property
    def t2_in_smem(self) -> bool:
        """True when the kernels stage the whole table in shared memory."""
        return self.nbytes <= T2_SMEM_MAX_BYTES


def lookup_table(meta: CanonicalMeta, device) -> LookupTable:
    """Build ``meta``'s lookup table and stage it on ``device``."""
    ent = lookup_entries(meta).view(np.int16).copy()
    return LookupTable(torch.from_numpy(ent).to(device))


def stream_window(stream, block_size: int):
    """The code bytes a stream's blocks of ``block_size`` symbols reach and
    their u32 offsets into them -> (code, offsets).

    From the word of the lowest offset to 16 * ``block_size`` bits past the
    highest (no code is longer than 16 bits, so no block, well-formed or
    not, reads further), with the offsets rebased by that multiple of 32
    bits, which keeps every ``>> 5`` and ``& 31`` of the decode. A whole
    stream keeps all its words; a frame slice of a long segment
    (``frame_slice``) stages its own frames' words, not the segment's.
    """
    offsets = np.asarray(stream.block_offsets, dtype=np.uint32)
    code = stream.code_bytes
    if offsets.size:
        lo_word = int(offsets.min()) >> 5
        hi_word = (int(offsets.max()) + 16 * block_size) // 32 + 1
        code = code[4 * lo_word : 4 * hi_word]
        offsets = offsets - np.uint32(32 * lo_word)
    return code, offsets


def prepare_stream(stream):
    """Host staging of an EncodedStream -> (meta, words, offsets).

    ``words`` is the big-endian u32 word stream as int32 (same bits) with
    ``PAD_WORDS`` zero words appended; ``offsets`` the u32 block bit offsets
    as int32 (same bits; consumers read them as unsigned). The decode paths
    stage the same words with :func:`stage_words`, byte-swapped on the
    device.

    Two pad words are enough, at any block size: a well-formed block's
    last 4-symbol group starts at a bit ``p <= total_bits - 4`` (each of its
    symbols takes at least one bit) and reads words ``p>>5 .. (p>>5)+2``,
    while the unpadded stream already holds ``ceil(total_bits/32) >=
    ((total_bits-4)>>5) + 1`` words. The kernels clamp the refill index to
    ``n_words - 3`` besides, so a malformed offset index cannot read past
    the buffer.
    """
    meta = canonical_meta(stream.widths)
    words = bitstream.bytes_to_be_words(stream.code_bytes, pad_words=PAD_WORDS)
    offsets = np.asarray(stream.block_offsets, dtype=np.uint32)
    return meta, words.view(np.int32), offsets.view(np.int32)


def stage_words(codes, device) -> tuple[torch.Tensor, list[int]]:
    """Code byte arrays -> their big-endian u32 words as one int32 tensor on
    ``device`` (the ``words`` of :func:`prepare_stream`, each array's words
    followed by ``PAD_WORDS`` zero words), and the word where each array's
    words start.

    The bytes are copied to the device as they are and byte-swapped there,
    so the host does no per-word work (on a long segment that work took
    longer than the copy; PERF.md).
    """
    n_words = [(c.size + 3) // 4 + PAD_WORDS for c in codes]
    starts = np.cumsum([0] + n_words).tolist()
    buf = torch.zeros(4 * starts[-1], dtype=torch.uint8, device=device)
    for c, at in zip(codes, starts):
        buf[4 * at : 4 * at + c.size].copy_(
            torch.from_numpy(np.ascontiguousarray(c, dtype=np.uint8)))
    words = buf.view(-1, 4).flip(1).contiguous().view(torch.int32).view(-1)
    return words, starts[:-1]


def max_block_bits(block_offsets: np.ndarray, total_bits: int) -> int:
    """Largest encoded block size in bits (offsets are ascending)."""
    offs = np.asarray(block_offsets, dtype=np.int64)
    if offs.size == 0:
        return 0
    ends = np.append(offs[1:], np.int64(total_bits))
    return int((ends - offs).max())


def _mode(delta: bool, delta2d: bool) -> int:
    if delta and delta2d:
        raise ValueError("delta2d replaces the 1-D delta: pass delta=False")
    return 2 if delta2d else int(delta)


def _decode_plain(words: torch.Tensor, offsets: torch.Tensor,
                  symbols: torch.Tensor, bounds, adj, num_steps: int,
                  mode: int):
    """Plain PyTorch decode, one lane per block -> ((nb, num_steps) int64
    symbols with the precoder undone, (nb,) int32 row-local end bits).

    All arithmetic is int64 with explicit 32-bit masks, because ``>>`` on a
    signed int32 tensor is arithmetic while the decode needs logical shifts.
    """
    dev = words.device
    nb = offsets.numel()
    w64 = words.to(torch.int64) & _M32
    last = words.numel() - 3
    start = offsets.to(torch.int64) & _M32
    pos = start
    b_tab = torch.tensor(bounds[1:], dtype=torch.int64, device=dev)
    adj_t = torch.tensor(adj, dtype=torch.int64, device=dev)
    syms = symbols.to(torch.int64)
    out = torch.empty((nb, num_steps), dtype=torch.int64, device=dev)
    for g in range(num_steps // 4):
        wi = torch.clamp(pos >> 5, max=last)
        s = pos & 31
        w0, w1, w2 = w64[wi], w64[wi + 1], w64[wi + 2]
        # 64-bit window left-justified at pos, as two 32-bit halves;
        # >>1 >>(31-s) in place of >>(32-s) keeps the shift below 32
        hi0 = ((w0 << s) | ((w1 >> 1) >> (31 - s))) & _M32
        hi1 = ((w1 << s) | ((w2 >> 1) >> (31 - s))) & _M32
        t = torch.zeros_like(pos)
        for k in range(4):
            top = torch.where(t < 32, hi0, hi1)
            u = t & 31
            win32 = ((top << u) | ((hi1 >> 1) >> (31 - u))) & _M32
            window = win32 >> 16
            w = 1 + (window[:, None] >= b_tab).sum(1)
            idx = adj_t[w - 1] + (window >> (16 - w))
            out[:, 4 * g + k] = syms[idx & 255]
            t = t + w
        pos = pos + t
    if mode == 1:
        out = torch.cumsum(out, 1)
    elif mode == 2:  # 8x8 only: row 0 along the row, then down the columns
        sq = out.view(nb, 8, 8)
        sq[:, 0] = torch.cumsum(sq[:, 0], 1)
        out = torch.cumsum(sq, 1).view(nb, 64)
    end = ((start & 31) + (pos - start)).to(torch.int32)
    return out & 0xFF, end


def decode_images_plain(words: torch.Tensor, offsets: torch.Tensor,
                        symbols: torch.Tensor, bounds, adj, *,
                        num_frames: int, bh: int, bw: int, delta: bool,
                        delta2d: bool = False, emit_end: bool = False):
    """Plain PyTorch version of the image kernel: the same output as
    :func:`decode_images`, (out, end) with ``emit_end``."""
    out, end = _decode_plain(words, offsets, symbols, bounds, adj, 64,
                             _mode(delta, delta2d))
    img = out.to(torch.uint8).view(num_frames, bh, bw, 8, 8).permute(
        0, 1, 3, 2, 4).reshape(num_frames, bh * 8, bw * 8)
    return (img, end) if emit_end else img


def _check_steps(num_steps: int, delta2d: bool) -> None:
    if num_steps % 4 or not 4 <= num_steps <= 256:
        raise ValueError(
            f"num_steps ({num_steps}) must be a multiple of 4 in [4, 256] "
            "(blocks of 2, 4, 8 or 16)")
    if delta2d and num_steps != 64:
        raise ValueError("in-kernel delta2d needs 8x8 blocks (num_steps 64); "
                         "other sizes fold it after the decode")


def decode_blocks_plain(words: torch.Tensor, offsets: torch.Tensor,
                        symbols: torch.Tensor, bounds, adj, *, num_steps: int,
                        delta: bool, delta2d: bool = False,
                        emit_end: bool = False):
    """Plain PyTorch version of the packed-block kernel: the same output as
    :func:`decode_blocks`, (out, end) with ``emit_end``."""
    _check_steps(num_steps, delta2d)
    out, end = _decode_plain(words, offsets, symbols, bounds, adj, num_steps,
                             _mode(delta, delta2d))
    out = out.to(torch.uint8)
    return (out, end) if emit_end else out


def _check_inputs(words, offsets, symbols, bounds, adj, n_blocks: int) -> str:
    """Validate a wrapper's inputs; return the device type they lie on."""
    for name, x, dtype in (("words", words, torch.int32),
                           ("offsets", offsets, torch.int32),
                           ("symbols", symbols, torch.uint8)):
        if x.dtype != dtype or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor")
        if x.device != words.device:
            raise ValueError(f"{name} is on {x.device}, words on {words.device}")
    if offsets.numel() != n_blocks:
        raise ValueError(f"{offsets.numel()} block offsets for {n_blocks} blocks")
    if symbols.numel() != 256 or len(bounds) != 16 or len(adj) != 16:
        raise ValueError("the table needs 256 symbols, 16 bounds, 16 adj")
    if words.numel() < 3:
        raise ValueError("the word stream needs at least 3 words")
    kind = words.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no decode for tensors on {words.device}")
    return kind


def _table_args(bounds, adj):
    """The interval table as the probes' kernels take it (two C arrays)."""
    return (ctypes.c_uint32 * 16)(*bounds), (ctypes.c_int32 * 16)(*adj)


def _check_table(table: LookupTable | None, words: torch.Tensor) -> None:
    """Validate the lookup table a CUDA decode launches with."""
    if table is None:
        raise ValueError(
            "a CUDA decode needs the stream's staged lookup table (table=; "
            "prepare_shared stages it as .table, lookup_table builds it)")
    x = table.entries
    if x.dtype != torch.int16 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("table.entries must be a contiguous 1-D int16 tensor")
    if x.device != words.device:
        raise ValueError(f"table is on {x.device}, words on {words.device}")
    t1, per_t2 = 1 << LUT_K1, 1 << (16 - LUT_K1)
    if (x.numel() < t1 or (x.numel() - t1) % per_t2 or table.num_t2 > t1
            or x.data_ptr() % 16):
        raise ValueError(f"table.entries ({x.numel()}) is no 16-byte aligned "
                         f"{LUT_K1}/{16 - LUT_K1} table")


def _table_path(name: str, table: LookupTable) -> str:
    return f"{name} T2 {'smem' if table.t2_in_smem else 'L1'}"


def _launch(name: str, words: torch.Tensor, table: LookupTable, *args) -> None:
    """Launch kernel ``name`` on the current stream of ``words``' device:
    ``mht_<name>(words, n_words, *args[:k], table..., *args[k:])`` where the
    table's three arguments follow the geometry (k = 4 for the image kernel,
    3 for the packed-block one)."""
    from .. import _build

    k = 4 if name == "decode_images" else 3
    _build.launch(name, words.device, words.data_ptr(), words.numel(),
                  *args[:k], table.entries.data_ptr(), table.entries.numel(),
                  int(table.t2_in_smem), *args[k:])
    launches[name] += 1
    path_launches[_table_path(name, table)] += 1


def launch_shape(name: str, n_words: int, n_blocks: int,
                 table: LookupTable, *, mode: int = 1,
                 num_steps: int = 64) -> dict:
    """The grid kernel ``name`` launches over ``n_blocks`` blocks of
    ``n_words`` code words with ``table`` (on its CUDA device), and the
    kernel's attributes: resident CUDA blocks per SM (for B2, under its
    cap), grid, dynamic and static shared memory per CUDA block, registers
    and local (spill) bytes per thread."""
    from .. import _build

    shape = (ctypes.c_int * 6)()
    geo = ((n_blocks,) if name == "decode_images"
           else (n_words, n_blocks, num_steps))
    fn = getattr(_build.lib(name), f"mht_{name}_shape")
    with torch.cuda.device(table.entries.device):
        err = fn(*geo, table.entries.numel(), int(table.t2_in_smem), mode,
                 shape)
    if err:
        raise RuntimeError(f"mht_{name}_shape failed: CUDA error {err}")
    return dict(zip(("ctas_per_sm", "grid", "dyn_smem", "static_smem",
                     "registers", "local_bytes"), shape))


def _check_out(out: torch.Tensor | None, shape: tuple, words: torch.Tensor,
               align: int) -> None:
    """Validate the ``out`` a caller gave a wrapper (None passes): ``align``
    is the widest store the kernel makes into it, in bytes."""
    if out is not None and (
            out.dtype != torch.uint8 or tuple(out.shape) != shape
            or not out.is_contiguous() or out.device != words.device
            or out.data_ptr() % align):
        raise ValueError(f"out must be a contiguous, {align}-byte aligned "
                         f"uint8 {shape} tensor on {words.device}")


def _plain_into(out: torch.Tensor | None, result, emit_end: bool):
    """A plain version's result, copied into ``out`` when there is one."""
    if out is None:
        return result
    out.copy_(result[0] if emit_end else result)
    return (out, result[1]) if emit_end else out


def decode_images(words: torch.Tensor, offsets: torch.Tensor,
                  symbols: torch.Tensor, bounds, adj, *, num_frames: int,
                  bh: int, bw: int, delta: bool, delta2d: bool = False,
                  emit_end: bool = False, table: LookupTable | None = None,
                  out: torch.Tensor | None = None):
    """Decode a staged shared-table batch of 8x8 blocks -> (T, bh*8, bw*8)
    uint8, and with ``emit_end`` also the (T*bh*bw,) int32 row-local end
    bits in stream order. With ``out`` the frames go there (the MHTS batch
    decode writes each frame's launch into one (T, H, W) tensor).

    ``words``: (n,) int32 big-endian code words (:func:`prepare_stream`);
    ``offsets``: (T*bh*bw,) int32 block bit offsets (read as u32);
    ``symbols``: (256,) uint8 canonical symbol order; ``bounds``/``adj``:
    the 16-entry interval table (host ints); ``table``: the same code's
    :func:`lookup_table` on the tensors' device. CPU tensors run
    :func:`decode_images_plain` on the interval table; CUDA tensors launch
    the kernel with ``table``, and raise without it.
    """
    mode = _mode(delta, delta2d)
    nb = num_frames * bh * bw
    kind = _check_inputs(words, offsets, symbols, bounds, adj, nb)
    _check_out(out, (num_frames, bh * 8, bw * 8), words, 16)
    if kind == "cpu":
        return _plain_into(out, decode_images_plain(
            words, offsets, symbols, bounds, adj, num_frames=num_frames,
            bh=bh, bw=bw, delta=delta, delta2d=delta2d, emit_end=emit_end),
            emit_end)
    _check_table(table, words)
    if out is None:
        out = torch.empty((num_frames, bh * 8, bw * 8), dtype=torch.uint8,
                          device=words.device)
    end = (torch.empty(nb, dtype=torch.int32, device=words.device)
           if emit_end else None)
    if nb:
        _launch("decode_images", words, table, offsets.data_ptr(), nb, bh, bw,
                mode, out.data_ptr(), None if end is None else end.data_ptr())
    return (out, end) if emit_end else out


def decode_blocks(words: torch.Tensor, offsets: torch.Tensor,
                  symbols: torch.Tensor, bounds, adj, *, num_steps: int,
                  delta: bool, delta2d: bool = False, emit_end: bool = False,
                  table: LookupTable | None = None,
                  out: torch.Tensor | None = None):
    """Decode staged blocks of ``num_steps`` symbols -> (nb, num_steps)
    uint8 in the order of ``offsets``, and with ``emit_end`` also the (nb,)
    int32 row-local end bits. With ``out`` the blocks go there.

    The inputs are those of :func:`decode_images`; ``offsets`` may be in any
    order and may repeat. ``delta2d`` (in-kernel 2-D predictor) needs
    ``num_steps == 64``. CPU tensors run :func:`decode_blocks_plain`; CUDA
    tensors launch the kernel with ``table``, and raise without it.
    """
    mode = _mode(delta, delta2d)
    _check_steps(num_steps, delta2d)
    nb = offsets.numel()
    kind = _check_inputs(words, offsets, symbols, bounds, adj, nb)
    # 16-byte stores where a block is a multiple of 16 symbols, else 4-byte
    _check_out(out, (nb, num_steps), words, 16 if num_steps % 16 == 0 else 4)
    if kind == "cpu":
        return _plain_into(out, decode_blocks_plain(
            words, offsets, symbols, bounds, adj, num_steps=num_steps,
            delta=delta, delta2d=delta2d, emit_end=emit_end), emit_end)
    _check_table(table, words)
    if out is None:
        out = torch.empty((nb, num_steps), dtype=torch.uint8,
                          device=words.device)
    end = (torch.empty(nb, dtype=torch.int32, device=words.device)
           if emit_end else None)
    if nb:
        _launch("decode_blocks", words, table, offsets.data_ptr(), nb,
                num_steps, mode, out.data_ptr(),
                None if end is None else end.data_ptr())
    return (out, end) if emit_end else out


# -- stream-integrity check ----------------------------------------------------
#
# A canonical Huffman stream self-synchronizes only if every bit is intact:
# any flipped/lost bit desyncs the decoder, and the block then ends at the
# wrong bit position with overwhelming probability. Each kernel's end-bit
# output compared against ``(offset & 31) + block_bits`` (known from the offset
# index) yields a per-block corruption mask with no extra decode work. (A
# corruption that preserves total bit length within a block passes this
# check; pair it with the container CRC for whole-payload integrity.)

def block_end_targets(block_offsets, last_end_bit: int | None) -> np.ndarray:
    """Stream-order expected row-local end bit per block -> (nb,) int32.

    ``last_end_bit`` is the bit position where the LAST block ends (equal to
    the stream's exact total bits when there is no partial tail). Pass None
    when unknown (e.g. the stream may carry tail symbols past the last
    whole block): the last block is then marked -1 = unchecked.
    """
    offs = np.asarray(block_offsets, dtype=np.int64)
    if offs.size == 0:
        return np.zeros(0, np.int32)
    if last_end_bit is None:
        ends = np.append(offs[1:], offs[-1])  # placeholder, masked below
    else:
        ends = np.append(offs[1:], np.int64(last_end_bit))
    t = ((offs & 31) + (ends - offs)).astype(np.int32)
    if last_end_bit is None:
        t[-1] = -1
    return t


def last_block_window(stream, block_size: int) -> tuple | None:
    """Byte-rounded ``(lo, hi)`` window for the LAST block's row-local end bit.

    The offset index has no successor for the last block; when the stream
    carries no tail symbols, that block ends at the stream's exact bit count,
    known from the code bytes only up to byte rounding. None when the
    stream is empty or has tail symbols (the last end stays unchecked).
    """
    nb = stream.block_offsets.size
    if nb == 0 or stream.num_symbols != nb * block_size:
        return None
    total_bits = 8 * (stream.code_bytes.size - bitstream.READ_AHEAD_PAD_BYTES)
    off_last = int(stream.block_offsets[-1])
    hi = (off_last & 31) + (total_bits - off_last)
    return hi - 7, hi


def check_block_ends(end_bits, targets):
    """End bits vs targets (-1 = don't check) -> flat bool err mask.

    Takes numpy arrays or tensors (on any one device) in the same block
    order, and returns the same kind.
    """
    e = end_bits.reshape(-1)
    t = targets.reshape(-1)
    return (e != t) & (t >= 0)
