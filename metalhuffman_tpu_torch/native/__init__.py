"""The port's host C++ codec (``src/mht_codec.cpp``) with ctypes bindings.

A copy of ``metalhuffman_tpu/native``, byte-identical to the original
(tests hold them equal). The encode half: the canonical table
(:func:`code_lengths`, :func:`canonical_codes`), canonical Huffman encode
(serial and multithreaded), the row merge of the hybrid device encoder
(:func:`merge_rows`) and the per-block 1-D and 2-D delta precoders. The
decode half is the host decoder that ``device="native"`` selects on every
decode surface of the port (:func:`decode_blocks`, multithreaded over block
ranges), with the serial decoders (:func:`decode_serial`,
:func:`decode_serial_split` over :func:`build_split_tables`) and the delta
inverses. g++ builds the library at first use into a content-hashed ``.so``
under ``build/metalhuffman_tpu_torch/`` (:mod:`.._build`). There is no NumPy
fallback: a missing g++ or a failed build raises with the compiler's output,
and a corrupt stream raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path

import numpy as np

from .. import _build
from ..core.container import EncodedStream

SRC = Path(__file__).parent / "src" / "mht_codec.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIB: ctypes.CDLL | None = None

#: the ``device`` value that selects the host C++ decoder in place of a torch
#: device (the JAX package's ``backend="native"``)
NATIVE = "native"


def is_native(device) -> bool:
    """True when ``device`` selects the host C++ decoder; never implied by
    a missing GPU or a failed build."""
    return isinstance(device, str) and device == NATIVE


def library_path() -> Path:
    """Content-hashed path of the host codec library."""
    return _build.hashed_path("libmht_codec", GXX_FLAGS, (SRC,))


def build() -> Path:
    """Compile the host codec library if it is not built yet; return its path."""
    out = library_path()
    if not out.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(
                "g++ not found on PATH: the host codec of metalhuffman_tpu_torch "
                "builds with g++ at first use")
        _build.compile_all([([gxx, *GXX_FLAGS, str(SRC)], out)])
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        i64 = ctypes.c_int64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        enc = [u8p, i64, i64, u8p, u8p, i64, ctypes.POINTER(i64), u32p,
               ctypes.POINTER(i64)]
        lib.mht_code_lengths.argtypes = [ctypes.POINTER(i64), u8p]
        lib.mht_canonical_codes.argtypes = [u8p, ctypes.POINTER(ctypes.c_uint16)]
        lib.mht_encode.argtypes = enc
        lib.mht_encode_mt.argtypes = enc + [ctypes.c_int]
        lib.mht_merge_rows.argtypes = [u32p, u32p, i64, i64, u8p, i64,
                                       ctypes.POINTER(i64), u32p,
                                       ctypes.POINTER(i64), ctypes.c_int]
        lib.mht_delta_encode.argtypes = [u8p, i64, i64, u8p]
        lib.mht_delta2d_encode.argtypes = [u8p, i64, i64, u8p]
        lib.mht_delta_decode.argtypes = [u8p, i64, i64, u8p]
        lib.mht_delta2d_decode.argtypes = [u8p, i64, i64, u8p]
        lib.mht_decode_serial.argtypes = [u8p, i64, u8p, i64, i64, u8p]
        lib.mht_decode_blocks.argtypes = [u8p, i64, u8p, u32p, i64, i64,
                                          ctypes.c_int, u8p, ctypes.c_int]
        lib.mht_build_split_tables.argtypes = [
            u8p, ctypes.c_int, u8p, u8p, u8p, u8p, i64,
            ctypes.POINTER(ctypes.c_int32)]
        lib.mht_decode_serial_split.argtypes = [u8p, i64, u8p, i64, i64,
                                                ctypes.c_int, u8p]
        for fn in (lib.mht_code_lengths, lib.mht_canonical_codes,
                   lib.mht_encode, lib.mht_encode_mt, lib.mht_merge_rows,
                   lib.mht_delta_encode, lib.mht_delta2d_encode,
                   lib.mht_delta_decode, lib.mht_delta2d_decode,
                   lib.mht_decode_serial, lib.mht_decode_blocks,
                   lib.mht_build_split_tables, lib.mht_decode_serial_split):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


#: the error of an encode whose stream would need bit offsets past 2^32
OVERFLOW_ERROR = ("stream exceeds 2^32 bits — u32 block offsets overflow; "
                  "split the input (e.g. per-frame or segmented MHTV)")


def code_lengths(freqs: np.ndarray) -> np.ndarray:
    """(256,) symbol frequencies -> (256,) uint8 Huffman code lengths (<= 16;
    0 for an absent symbol)."""
    freqs = np.ascontiguousarray(freqs, dtype=np.int64)
    widths = np.zeros(256, dtype=np.uint8)
    rc = _lib().mht_code_lengths(
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _u8p(widths))
    if rc:
        raise RuntimeError(f"mht_code_lengths failed: {rc}")
    return widths


def canonical_codes(widths: np.ndarray) -> np.ndarray:
    """(256,) code lengths -> (256,) uint16 left-justified canonical codes."""
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    codes = np.zeros(256, dtype=np.uint16)
    rc = _lib().mht_canonical_codes(
        _u8p(widths), codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc:
        raise RuntimeError(f"mht_canonical_codes failed: {rc}")
    return codes


def encode_symbols(data: np.ndarray, block_size: int = 64,
                   n_threads: int = 0) -> EncodedStream:
    """Full canonical Huffman encode -> EncodedStream.

    ``n_threads``: 0 = auto (hardware concurrency); 1 = the serial encoder.
    Output is identical for any thread count (two-pass deterministic pack).
    """
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    if data.size == 0:
        raise ValueError("empty input")
    lib = _lib()
    widths = np.zeros(256, dtype=np.uint8)
    capacity = 2 * data.size + 16
    # np.empty: the C encoder zeroes exactly the bytes it produces
    code_bytes = np.empty(capacity, dtype=np.uint8)
    n_blocks = data.size // block_size
    offsets = np.empty(max(n_blocks, 1), dtype=np.uint32)
    code_len = ctypes.c_int64()
    total_bits = ctypes.c_int64()
    args = (_u8p(data), data.size, block_size, _u8p(widths), _u8p(code_bytes),
            capacity, ctypes.byref(code_len), _u32p(offsets),
            ctypes.byref(total_bits))
    if n_threads == 1:
        rc = lib.mht_encode(*args)
    else:
        rc = lib.mht_encode_mt(*args, n_threads)
    if rc == -7:
        raise ValueError(OVERFLOW_ERROR)
    if rc:
        raise RuntimeError(f"mht_encode failed: {rc}")
    # in-place shrink: releases the 2n worst-case tail without a copy
    code_bytes.resize(code_len.value, refcheck=False)
    return EncodedStream(
        num_symbols=data.size,
        widths=widths,
        code_bytes=code_bytes,
        block_offsets=offsets[:n_blocks],
    )


def merge_rows(rows: np.ndarray, block_bits: np.ndarray, n_threads: int = 0):
    """Stage 2 of the hybrid device encoder: padded per-block word rows ->
    (code_bytes incl. +2 pad, block_offsets u32, total_bits).

    ``rows`` is (n_blocks, row_words) uint32: each block's MSB-first packed
    bits as big-endian-semantic words, zero-padded (the stage-1 kernel's
    output without its count word). ``block_bits`` is the (n_blocks,) bit
    count of each block. Multithreaded bit-shift memcpy on the host
    (``n_threads`` 0 = hardware concurrency); the output is byte-identical to
    :func:`encode_symbols` packing the same symbols, for any thread count.
    """
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    block_bits = np.ascontiguousarray(block_bits, dtype=np.uint32)
    n_blocks, row_words = rows.shape
    if block_bits.shape != (n_blocks,):
        raise ValueError("block_bits must be (n_blocks,)")
    capacity = (int(block_bits.astype(np.int64).sum()) + 7) // 8 + 16
    code_bytes = np.zeros(capacity, dtype=np.uint8)
    offsets = np.zeros(n_blocks, dtype=np.uint32)
    code_len = ctypes.c_int64()
    total_bits = ctypes.c_int64()
    rc = _lib().mht_merge_rows(
        _u32p(rows), _u32p(block_bits), n_blocks, row_words,
        _u8p(code_bytes), capacity, ctypes.byref(code_len), _u32p(offsets),
        ctypes.byref(total_bits), n_threads)
    if rc == -7:
        raise ValueError(OVERFLOW_ERROR)
    if rc == -2:
        raise RuntimeError(
            f"mht_merge_rows failed: {rc} (a row of {row_words} words is too "
            "short for its block's bit count)")
    if rc:
        raise RuntimeError(f"mht_merge_rows failed: {rc}")
    return code_bytes[: code_len.value], offsets, total_bits.value


def delta_encode(data: np.ndarray, block_size: int = 64) -> np.ndarray:
    """Per-block 1-D delta (first byte literal, then wrapping differences)."""
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    out = np.empty_like(data)  # C writes every byte
    _lib().mht_delta_encode(_u8p(data), data.size, block_size, _u8p(out))
    return out


def delta2d_encode(data: np.ndarray, block_dim: int = 8) -> np.ndarray:
    """2-D within-block predictor (container mode 3/4); whole blocks only."""
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    out = np.empty_like(data)  # C validates, then writes every byte
    rc = _lib().mht_delta2d_encode(_u8p(data), data.size, block_dim, _u8p(out))
    if rc:
        raise ValueError("delta2d needs a whole number of blocks")
    return out


# -- the decode half ---------------------------------------------------------

#: what the decoders' negative return codes mean
_DECODE_ERRORS = {
    -2: "k1 out of range",
    -3: "secondary tables past their buffer",
    -5: "a block reads past the end of the code bytes (truncated stream)",
    -6: "a window matches no code (corrupt stream)",
    -8: "block_size is not a perfect square (delta2d), or too many escape "
        "prefixes",
    -9: "an escape prefix collides with a short code",
}


def _check_decode(name: str, rc: int) -> None:
    if rc:
        raise RuntimeError(
            f"{name} failed: {rc} ({_DECODE_ERRORS.get(rc, 'unknown error')})")


def decode_blocks(stream: EncodedStream, *, delta: bool = True,
                  block_size: int = 64, n_threads: int = 0,
                  delta2d: bool = False) -> np.ndarray:
    """Multithreaded host decode of an EncodedStream -> (n_blocks,
    block_size) uint8.

    Threads split the block range (``n_threads`` 0 = hardware concurrency;
    the output is the same for any count) and each decodes four blocks'
    independent chains at a time from one 64K lookup table. ``delta``
    undoes the per-block 1-D delta; ``delta2d`` the 2-D predictor, in the
    same per-block loop. A stream of fewer than one block has no blocks to
    decode. A corrupt or truncated stream raises ``RuntimeError``.
    """
    nb = int(stream.block_offsets.size)
    if nb == 0:  # stream shorter than one block: no decodable block units
        return np.zeros((0, block_size), dtype=np.uint8)
    mode = 2 if delta2d else int(delta)
    code_bytes = np.ascontiguousarray(stream.code_bytes, dtype=np.uint8)
    widths = np.ascontiguousarray(stream.widths, dtype=np.uint8)
    offsets = np.ascontiguousarray(stream.block_offsets, dtype=np.uint32)
    out = np.empty((nb, block_size), dtype=np.uint8)  # C writes every byte
    _check_decode("mht_decode_blocks", _lib().mht_decode_blocks(
        _u8p(code_bytes), code_bytes.size, _u8p(widths), _u32p(offsets), nb,
        block_size, mode, _u8p(out), n_threads))
    return out


def decode_serial(code_bytes: np.ndarray, widths: np.ndarray,
                  num_symbols: int, start_bit: int = 0) -> np.ndarray:
    """Serial decode of ``num_symbols`` symbols from ``start_bit`` through
    one full 16-bit table -> (num_symbols,) uint8."""
    code_bytes = np.ascontiguousarray(code_bytes, dtype=np.uint8)
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    out = np.zeros(num_symbols, dtype=np.uint8)
    _check_decode("mht_decode_serial", _lib().mht_decode_serial(
        _u8p(code_bytes), code_bytes.size, _u8p(widths), num_symbols,
        start_bit, _u8p(out)))
    return out


def build_split_tables(widths: np.ndarray, k1: int = 8, k2: int = 8):
    """Two-level (k1, k2 = 16 - k1) split lookup tables ->
    ``core.tables.SplitTables``: T1 over the top k1 bits of the 16-bit
    window, escapes into 2^k2-entry secondary tables (slot 0 reserved)."""
    from ..core import tables

    if k1 + k2 != 16:
        raise ValueError("k1 + k2 must equal 16 (16-bit decode window)")
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    n1, n2 = 1 << k1, 1 << k2
    t1_sym = np.zeros(n1, dtype=np.uint8)
    t1_w = np.zeros(n1, dtype=np.uint8)
    t2_sym = np.zeros(256 * n2, dtype=np.uint8)
    t2_w = np.zeros(256 * n2, dtype=np.uint8)
    num_tables = ctypes.c_int32()
    _check_decode("mht_build_split_tables", _lib().mht_build_split_tables(
        _u8p(widths), k1, _u8p(t1_sym), _u8p(t1_w), _u8p(t2_sym),
        _u8p(t2_w), t2_sym.size, ctypes.byref(num_tables)))
    n = num_tables.value * n2
    return tables.SplitTables(t1_sym, t1_w, t2_sym[:n].copy(),
                              t2_w[:n].copy(), k1, k2)


def decode_serial_split(code_bytes: np.ndarray, widths: np.ndarray,
                        num_symbols: int, start_bit: int = 0,
                        k1: int = 8) -> np.ndarray:
    """Serial decode through the two-level split tables (the reference's
    ``decodeHuffmanBitsFromTables``, ``HuffmanUtil.cpp:830-1046``) ->
    (num_symbols,) uint8, equal to :func:`decode_serial`."""
    code_bytes = np.ascontiguousarray(code_bytes, dtype=np.uint8)
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    out = np.zeros(num_symbols, dtype=np.uint8)
    _check_decode("mht_decode_serial_split", _lib().mht_decode_serial_split(
        _u8p(code_bytes), code_bytes.size, _u8p(widths), num_symbols,
        start_bit, k1, _u8p(out)))
    return out


def delta_decode(deltas: np.ndarray, block_size: int = 64) -> np.ndarray:
    """Inverse of :func:`delta_encode`: a running sum per block."""
    deltas = np.ascontiguousarray(deltas, dtype=np.uint8).ravel()
    out = np.empty_like(deltas)  # C writes every byte
    _lib().mht_delta_decode(_u8p(deltas), deltas.size, block_size, _u8p(out))
    return out


def delta2d_decode(res: np.ndarray, block_dim: int = 8) -> np.ndarray:
    """Inverse of :func:`delta2d_encode`; whole blocks only."""
    res = np.ascontiguousarray(res, dtype=np.uint8).ravel()
    out = np.empty_like(res)  # C validates, then writes every byte
    rc = _lib().mht_delta2d_decode(_u8p(res), res.size, block_dim, _u8p(out))
    if rc:
        raise ValueError("delta2d needs a whole number of blocks")
    return out
