"""Hybrid device encode: the stage-1 CUDA packer, its plain version, the path.

Counterpart of ``metalhuffman_tpu/ops/encode_pallas.py``. The canonical
table is built on the host; stage 1 packs each block of 64 symbols into a
padded word row on the device (:func:`encode_rows`, kernel
``csrc/encode_rows.cu``, TPU kernel ``encode_rows``); stage 2 merges the rows
into the stream on the host (:func:`..native.merge_rows`); a partial tail
block is packed on the host and bit-appended. The stream is byte-identical
to :func:`..native.encode_symbols` (and so to the JAX package's encoders).

Symbols go to the device as an ``(nb, 64)`` uint8 tensor in the order of the
offset index, with no tile padding, and the rows come back as ``(nb,
wmax+1)`` int32, block-major, with the bit count in word ``wmax``: the TPU
staging (``pack_code_tables``' (8,128) pair tables, ``_stage_symbols``,
``_rows_block_major``) and the ranged deposit of ``used_width_band`` have no
counterpart, since a CUDA thread addresses its own row.

:func:`encode_rows` routes by the device of its tensors alone: CPU tensors
take :func:`encode_rows_plain`, CUDA tensors the kernel (or an exception),
anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..core import bitstream
from ..core.container import EncodedStream

BLOCK_SYMBOLS = 64  # the kernel packs blocks of 8x8 symbols
_M32 = 0xFFFFFFFF
#: blocks per step of the plain version (bounds its int64 temporaries)
_PLAIN_CHUNK = 1 << 16

#: kernel launches made by the wrapper in this process, by kernel name
launches = {"encode_rows": 0}


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


def _check_inputs(symbols: torch.Tensor, table: torch.Tensor,
                  wmax: int) -> str:
    """Validate the wrapper's inputs; return the device type they lie on."""
    if (symbols.dtype != torch.uint8 or symbols.dim() != 2
            or symbols.shape[1] != BLOCK_SYMBOLS or not symbols.is_contiguous()):
        raise ValueError(f"symbols must be a contiguous (nb, {BLOCK_SYMBOLS}) "
                         "uint8 tensor")
    if (table.dtype != torch.int32 or tuple(table.shape) != (256,)
            or not table.is_contiguous()):
        raise ValueError("table must be a contiguous (256,) int32 tensor")
    if table.device != symbols.device:
        raise ValueError(f"table is on {table.device}, symbols on "
                         f"{symbols.device}")
    if wmax < 1:
        raise ValueError(f"wmax ({wmax}) must be at least 1")
    kind = symbols.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no encode for tensors on {symbols.device}")
    return kind


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


def _append_tail_bits(code: np.ndarray, total_bits: int,
                      tail_packed: np.ndarray, tail_bits: int) -> np.ndarray:
    """Append a short packed bit run at ``total_bits`` (host, boundary-OR)."""
    lead = total_bits & 7
    out_bytes = (total_bits + tail_bits + 7) // 8 + 2  # +2 read-ahead pad
    out = np.zeros(out_bytes, dtype=np.uint8)
    n_full = (total_bits + 7) // 8
    out[:n_full] = code[:n_full]
    shifted = np.zeros(((lead + tail_bits + 7) // 8) * 8, dtype=np.uint8)
    shifted[lead:lead + tail_bits] = np.unpackbits(tail_packed)[:tail_bits]
    packed = np.packbits(shifted)
    base = total_bits >> 3
    out[base] |= packed[0]  # the only byte both runs may share
    out[base + 1: base + packed.size] = packed[1:]
    return out


def encode_symbols_hybrid(data: np.ndarray, block_size: int = 64,
                          n_threads: int = 0, *,
                          device="cuda") -> EncodedStream:
    """Hybrid device/host encode -> EncodedStream (byte-identical to
    :func:`..native.encode_symbols`).

    The canonical table and the per-block bit counts are computed on the
    host; :func:`encode_rows` packs the rows on ``device``; the host merges
    them (``n_threads`` 0 = hardware concurrency). A partial tail block
    (``n % 64`` symbols) is packed on the host and bit-appended: the offset
    index covers complete blocks only. Input shorter than one block goes to
    the host encoder.
    """
    if block_size != BLOCK_SYMBOLS:
        raise ValueError(
            f"hybrid encoder supports block_size={BLOCK_SYMBOLS} only "
            "(the kernel is specialized to 8x8 blocks); use native")
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    if data.size == 0:
        raise ValueError("empty input")

    widths, codes = canonical_table(data)

    n_blocks = data.size // block_size
    if n_blocks == 0:  # nothing for the device to do
        return native.encode_symbols(data, block_size, n_threads)
    body = data[: n_blocks * block_size].reshape(n_blocks, block_size)

    # per-block bit counts (host): drive wmax, the merge and the offsets
    bits_pb = block_bits(body, widths)
    if int(bits_pb.astype(np.int64).sum()) + 16 * (data.size % block_size) \
            >= 1 << 32:
        raise ValueError(native.OVERFLOW_ERROR)
    wmax = int(bits_pb.max()) // 32 + 2  # ceil + 1 spare (merge bound check)

    rows = encode_rows(torch.from_numpy(body).to(device),
                       torch.from_numpy(code_table(widths, codes)).to(device),
                       wmax=wmax)
    rows = rows[:, :wmax].contiguous().cpu().numpy().view(np.uint32)
    code, offsets, total_bits = native.merge_rows(rows, bits_pb, n_threads)

    tail = data[n_blocks * block_size:]
    if tail.size:
        tail_packed, tail_offs = bitstream.pack_bits(tail, codes, widths)
        code = _append_tail_bits(
            code, total_bits, tail_packed, int(tail_offs[-1]))
    return EncodedStream(num_symbols=data.size, widths=widths,
                         code_bytes=code, block_offsets=offsets)
