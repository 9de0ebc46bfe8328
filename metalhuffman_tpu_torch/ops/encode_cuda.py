"""Device encode: the stream kernel, the row-packing kernel, their plain
versions, and the hybrid encode path.

Counterpart of ``metalhuffman_tpu/ops/encode_pallas.py``. The canonical
table is built on the host from a histogram taken on the device; the
symbols are encoded on the device straight into the final stream
(:func:`encode_stream`, kernel ``csrc/encode_stream.cu``: a count pass, an
int64 prefix sum of the per-block counts, a pack pass that writes every
block's codes at its bit offset). That replaces both the TPU kernel
``encode_rows`` and the host merge of its rows (``native.merge_rows``),
which exist apart only because Mosaic has no per-lane addressing. The
stream is byte-identical to :func:`..native.encode_symbols` (and so to the
JAX package's encoders).

:func:`encode_rows` (kernel ``csrc/encode_rows.cu``) stays the exact
counterpart of the TPU kernel's own output: each block of 64 symbols packed
into a padded ``(nb, wmax+1)`` int32 word row, block-major, with the bit
count in word ``wmax``. The TPU staging (``pack_code_tables``' (8,128) pair
tables, ``_stage_symbols``, ``_rows_block_major``) and the ranged deposit of
``used_width_band`` have no counterpart, since a CUDA thread addresses its
own words.

:func:`encode_stream` and :func:`encode_rows` route by the device of their
tensors alone: CPU tensors take the plain version, CUDA tensors the kernel
(or an exception), anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..core.container import EncodedStream

BLOCK_SYMBOLS = 64  # the kernel packs blocks of 8x8 symbols
_M32 = 0xFFFFFFFF
#: blocks per step of the plain version (bounds its int64 temporaries)
_PLAIN_CHUNK = 1 << 16

#: kernel launches made by the wrappers in this process, by kernel name (one
#: per ``encode_stream`` call: its count and pack passes)
launches = {"encode_stream": 0, "encode_rows": 0}


def canonical_table(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host: the (256,) uint8 code widths and uint16 left-justified canonical
    codes of the symbol frequencies of ``data`` (1-D uint8)."""
    # torch's CPU histogram reads the bytes as they are; np.bincount first
    # widens all of them to int64
    freqs = torch.bincount(torch.from_numpy(data), minlength=256).numpy()
    widths = native.code_lengths(freqs)
    return widths, native.canonical_codes(widths)


def block_bits(body: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Host: the (nb,) uint32 bit count of each block of an (nb, 64) uint8
    array under ``widths``."""
    return widths[body].sum(axis=1, dtype=np.uint32)


def code_table(widths: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """(256,) widths and left-justified 16-bit codes -> the kernel's (256,)
    int32 table: ``(code << 16) | width``, the same bits as the u32."""
    ent = (np.asarray(codes, np.uint32) << 16) | np.asarray(widths, np.uint32)
    return ent.view(np.int32)


def encode_rows_plain(symbols: torch.Tensor, table: torch.Tensor, *,
                      wmax: int) -> torch.Tensor:
    """Plain PyTorch version of the packer: the same (nb, wmax+1) int32 rows
    as :func:`encode_rows`.

    Each code lands at its block-local bit offset (a cumsum of the widths)
    as two 32-bit parts, the word it starts in and the next; the codes of a
    block cover disjoint bits, so adding the parts into the row ORs them.
    All arithmetic is int64 with explicit masks, because ``>>`` on a signed
    int32 tensor is arithmetic.
    """
    nb = symbols.shape[0]
    ent_tab = table.to(torch.int64) & _M32
    rows = torch.empty((nb, wmax + 1), dtype=torch.int32, device=symbols.device)
    # a block's last code starts at bit <= 63*16, so its parts reach word 32
    ncol = max(wmax, 33)
    for lo in range(0, nb, _PLAIN_CHUNK):
        ent = ent_tab[symbols[lo:lo + _PLAIN_CHUNK].to(torch.int64)]
        w = ent & 0xFF
        # the code's top w bits, left-justified in 32 (as the kernel takes them)
        c32 = ent & (((1 << w) - 1) << (32 - w))
        start = torch.cumsum(w, 1) - w
        wi, sh = start >> 5, start & 31
        words = torch.zeros((ent.shape[0], ncol), dtype=torch.int64,
                            device=symbols.device)
        words.scatter_add_(1, wi, c32 >> sh)
        words.scatter_add_(1, wi + 1, (c32 & ((1 << sh) - 1)) << (32 - sh))
        words = words[:, :wmax]  # bits past 32*wmax are dropped, as the kernel does
        words = torch.where(words >= 1 << 31, words - (1 << 32), words)
        rows[lo:lo + _PLAIN_CHUNK, :wmax] = words.to(torch.int32)
        rows[lo:lo + _PLAIN_CHUNK, wmax] = w.sum(1).to(torch.int32)
    return rows


def _check_table(symbols: torch.Tensor, table: torch.Tensor) -> str:
    """Validate the table and where both tensors lie; return the device
    type."""
    if (table.dtype != torch.int32 or tuple(table.shape) != (256,)
            or not table.is_contiguous()):
        raise ValueError("table must be a contiguous (256,) int32 tensor")
    if table.device != symbols.device:
        raise ValueError(f"table is on {table.device}, symbols on "
                         f"{symbols.device}")
    kind = symbols.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no encode for tensors on {symbols.device}")
    return kind


def _check_inputs(symbols: torch.Tensor, table: torch.Tensor,
                  wmax: int) -> str:
    """Validate the row packer's inputs; return the device type they lie
    on."""
    if (symbols.dtype != torch.uint8 or symbols.dim() != 2
            or symbols.shape[1] != BLOCK_SYMBOLS or not symbols.is_contiguous()):
        raise ValueError(f"symbols must be a contiguous (nb, {BLOCK_SYMBOLS}) "
                         "uint8 tensor")
    if wmax < 1:
        raise ValueError(f"wmax ({wmax}) must be at least 1")
    return _check_table(symbols, table)


def encode_rows(symbols: torch.Tensor, table: torch.Tensor, *,
                wmax: int) -> torch.Tensor:
    """Pack blocks of 64 symbols -> (nb, wmax+1) int32 rows.

    ``symbols``: (nb, 64) uint8, block-major; ``table``: (256,) int32 from
    :func:`code_table` (widths 0..16). Row ``b`` holds block ``b``'s codes
    MSB-first in words ``0..wmax-1`` (big-endian-semantic u32 bits, zero
    padded; bits past ``32*wmax`` are dropped) and its bit count in word
    ``wmax``. CPU tensors run :func:`encode_rows_plain`; CUDA tensors launch
    the kernel.
    """
    if _check_inputs(symbols, table, wmax) == "cpu":
        return encode_rows_plain(symbols, table, wmax=wmax)
    nb = symbols.shape[0]
    rows = torch.empty((nb, wmax + 1), dtype=torch.int32, device=symbols.device)
    if nb:
        from .. import _build

        _build.launch("encode_rows", symbols.device, symbols.data_ptr(), nb,
                      table.data_ptr(), wmax, rows.data_ptr())
        launches["encode_rows"] += 1
    return rows


def _check_stream_inputs(symbols: torch.Tensor, table: torch.Tensor) -> str:
    """Validate the stream encoder's inputs; return the device type they lie
    on."""
    if (symbols.dtype != torch.uint8 or symbols.dim() != 1
            or not symbols.is_contiguous()):
        raise ValueError("symbols must be a contiguous 1-D uint8 tensor")
    if symbols.numel() == 0:
        raise ValueError("empty input")
    return _check_table(symbols, table)


def _check_overflow(full_bits: int, n: int) -> None:
    """Raise as the host encoder does when the complete blocks' ``full_bits``
    plus 16 bits for each tail symbol reach 2^32 (u32 block offsets)."""
    if full_bits + 16 * (n % BLOCK_SYMBOLS) >= 1 << 32:
        raise ValueError(native.OVERFLOW_ERROR)


def encode_stream_plain(symbols: torch.Tensor, table: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Plain PyTorch version of the stream encoder: the same (stream bytes,
    complete-block offsets, total bits) as :func:`encode_stream`.

    Each code lands at its absolute bit offset (the block offsets' prefix
    sum plus a cumsum of the widths inside each chunk of blocks) as two
    32-bit parts, the word it starts in and the next; codes cover disjoint
    bits, so adding the parts into the stream's words ORs them. All
    arithmetic is int64 with explicit masks.
    """
    n = symbols.numel()
    dev = symbols.device
    ent_tab = table.to(torch.int64) & _M32
    w_tab = ent_tab & 0xFF
    step = _PLAIN_CHUNK * BLOCK_SYMBOLS
    bits = torch.empty(-(-n // BLOCK_SYMBOLS), dtype=torch.int64, device=dev)
    for lo in range(0, n, step):
        w = w_tab[symbols[lo:lo + step].to(torch.int64)]
        w = torch.nn.functional.pad(w, (0, -w.numel() % BLOCK_SYMBOLS))
        blk = w.view(-1, BLOCK_SYMBOLS).sum(1)
        bits[lo // BLOCK_SYMBOLS: lo // BLOCK_SYMBOLS + blk.numel()] = blk
    incl = torch.cumsum(bits, 0)
    n_full = n // BLOCK_SYMBOLS
    _check_overflow(int(incl[n_full - 1]) if n_full else 0, n)
    total = int(incl[-1])
    excl = incl - bits
    nbytes = (total + 7) // 8 + 2  # +2 read-ahead pad
    # one spare word: a code ending on the last word boundary adds an empty
    # second part past it
    words = torch.zeros(-(-nbytes // 4) + 1, dtype=torch.int64, device=dev)
    for lo in range(0, n, step):
        ent = ent_tab[symbols[lo:lo + step].to(torch.int64)]
        w = ent & 0xFF
        # the code's top w bits, left-justified in 32 (as the kernel takes them)
        c32 = ent & (((1 << w) - 1) << (32 - w))
        start = excl[lo // BLOCK_SYMBOLS] + torch.cumsum(w, 0) - w
        wi, sh = start >> 5, start & 31
        words.scatter_add_(0, wi, c32 >> sh)
        words.scatter_add_(0, wi + 1, (c32 & ((1 << sh) - 1)) << (32 - sh))
    stream = torch.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)], 1)
    offsets = excl[:n_full]  # < 2^32: as int32 with the same 32 bits
    offsets = torch.where(offsets >= 1 << 31, offsets - (1 << 32), offsets)
    return (stream.to(torch.uint8).view(-1)[:nbytes],
            offsets.to(torch.int32), total)


def _count_pass(symbols: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The kernel's count pass on CUDA tensors: the int32 bit count of every
    block of 64 symbols, the last one partial."""
    from .. import _build

    bits = torch.empty(-(-symbols.numel() // BLOCK_SYMBOLS), dtype=torch.int32,
                       device=symbols.device)
    _build.launch("encode_stream", symbols.device, symbols.data_ptr(),
                  symbols.numel(), table.data_ptr(), bits.data_ptr(), None,
                  None, None, 0)
    return bits


def _pack_pass(symbols: torch.Tensor, table: torch.Tensor, incl: torch.Tensor,
               nbytes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's pack pass on CUDA tensors, given the inclusive int64
    prefix sum of the block counts: the stream's first ``nbytes`` bytes and
    the complete blocks' int32 offsets."""
    from .. import _build

    words = torch.zeros(-(-nbytes // 4), dtype=torch.int32,
                        device=symbols.device)
    offsets = torch.empty(symbols.numel() // BLOCK_SYMBOLS, dtype=torch.int32,
                          device=symbols.device)
    _build.launch("encode_stream", symbols.device, symbols.data_ptr(),
                  symbols.numel(), table.data_ptr(), None, incl.data_ptr(),
                  words.data_ptr(), offsets.data_ptr(), 1)
    return words.view(torch.uint8)[:nbytes], offsets


def encode_stream(symbols: torch.Tensor, table: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Encode ``symbols`` -> (stream bytes, block offsets, total bits).

    ``symbols``: (n,) uint8, in blocks of 64, the last one partial when 64
    does not divide n; ``table``: (256,) int32 from :func:`code_table`.
    Returns the MSB-first stream as (total+7)//8 + 2 uint8 (the +2
    read-ahead pad is zero), the int32 bits of the u32 bit offset of each
    complete block, and the stream's bit count; the stream of
    :func:`..native.encode_symbols`. Raises ``ValueError`` as it does when
    offsets could pass 2^32, before the stream is allocated. CPU tensors run
    :func:`encode_stream_plain`; CUDA tensors launch the kernel's count pass,
    take the prefix sum (one sync, for the total), then its pack pass.
    """
    if _check_stream_inputs(symbols, table) == "cpu":
        return encode_stream_plain(symbols, table)
    n = symbols.numel()
    n_full = n // BLOCK_SYMBOLS
    incl = torch.cumsum(_count_pass(symbols, table), 0, dtype=torch.int64)
    full_bits, total = incl[[max(n_full - 1, 0), -1]].tolist()
    _check_overflow(full_bits if n_full else 0, n)
    stream, offsets = _pack_pass(symbols, table, incl, (total + 7) // 8 + 2)
    launches["encode_stream"] += 1
    return stream, offsets, total


def encode_symbols_hybrid(data: np.ndarray, block_size: int = 64,
                          n_threads: int = 0, *,
                          device="cuda") -> EncodedStream:
    """Device encode -> EncodedStream (byte-identical to
    :func:`..native.encode_symbols`).

    The symbols go to ``device`` once; their histogram is taken there and
    the canonical table built on the host from it; :func:`encode_stream`
    writes the stream, and it and the complete blocks' offsets come back. A
    partial tail block (``n % 64`` symbols) is packed after the last
    complete block; the offset index covers complete blocks only. Input
    shorter than one block goes to the host encoder (``n_threads`` 0 =
    hardware concurrency).
    """
    if block_size != BLOCK_SYMBOLS:
        raise ValueError(
            f"hybrid encoder supports block_size={BLOCK_SYMBOLS} only "
            "(the kernel is specialized to 8x8 blocks); use native")
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    if data.size == 0:
        raise ValueError("empty input")
    if data.size < block_size:  # nothing for the device to do
        return native.encode_symbols(data, block_size, n_threads)

    symbols = torch.from_numpy(data).to(device)
    widths = native.code_lengths(
        torch.bincount(symbols, minlength=256).cpu().numpy())
    table = torch.from_numpy(
        code_table(widths, native.canonical_codes(widths))).to(device)
    code, offsets, _ = encode_stream(symbols, table)
    return EncodedStream(num_symbols=data.size, widths=widths,
                         code_bytes=code.cpu().numpy(),
                         block_offsets=offsets.cpu().numpy().view(np.uint32))
