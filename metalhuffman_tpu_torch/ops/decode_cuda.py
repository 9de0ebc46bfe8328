"""Shared-table image decode: the CUDA kernel, its plain version, their staging.

Counterpart of ``metalhuffman_tpu/ops/decode_pallas.py`` for the image-emission
path (``decode_tiles_images``). The kernel (``csrc/decode_images.cu``) reads
the packed big-endian word stream at each block's own bit offset, so the TPU
staging (word rows, (8,128) tiles, feed permutation, ImagePlan padding) has no
counterpart here.

Output contract of :func:`decode_images`: a ``(T, bh*8, bw*8)`` uint8 tensor,
frames padded only to whole 8x8 blocks; block ``b`` of the raster block order
(frames concatenated) lands at frame ``b // (bh*bw)``, block row
``(b % (bh*bw)) // bw``, block column ``b % bw``.

The wrapper routes by the device of its tensors alone: CPU tensors take the
plain PyTorch version, CUDA tensors the kernel (or an exception), anything
else raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from metalhuffman_tpu.core import bitstream

#: zero u32 words appended after the stream (see :func:`prepare_stream`)
PAD_WORDS = 2
_M32 = 0xFFFFFFFF

#: kernel launches made by :func:`decode_images` in this process
launches = 0


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


def prepare_stream(stream):
    """Host staging of an EncodedStream -> (meta, words, offsets).

    ``words`` is the big-endian u32 word stream as int32 (same bits) with
    ``PAD_WORDS`` zero words appended; ``offsets`` the u32 block bit offsets
    as int32 (same bits; consumers read them as unsigned).

    Two pad words are enough: a well-formed block's last 4-symbol group
    starts at a bit ``p <= total_bits - 4`` (each of its symbols takes at
    least one bit) and reads words ``p>>5 .. (p>>5)+2``, while the unpadded
    stream already holds ``ceil(total_bits/32) >= ((total_bits-4)>>5) + 1``
    words. The kernel clamps the refill index to ``n_words - 3`` besides, so
    a malformed offset index cannot read past the buffer.
    """
    meta = canonical_meta(stream.widths)
    words = bitstream.bytes_to_be_words(stream.code_bytes, pad_words=PAD_WORDS)
    offsets = np.asarray(stream.block_offsets, dtype=np.uint32)
    return meta, words.view(np.int32), offsets.view(np.int32)


def _mode(delta: bool, delta2d: bool) -> int:
    if delta and delta2d:
        raise ValueError("delta2d replaces the 1-D delta: pass delta=False")
    return 2 if delta2d else int(delta)


def decode_images_plain(words: torch.Tensor, offsets: torch.Tensor,
                        symbols: torch.Tensor, bounds, adj, *,
                        num_frames: int, bh: int, bw: int, delta: bool,
                        delta2d: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one lane per block, 64 steps.

    All arithmetic is int64 with explicit 32-bit masks, because ``>>`` on a
    signed int32 tensor is arithmetic while the decode needs logical shifts.
    """
    mode = _mode(delta, delta2d)
    dev = words.device
    nb = offsets.numel()
    w64 = words.to(torch.int64) & _M32
    last = words.numel() - 3
    pos = offsets.to(torch.int64) & _M32
    b_tab = torch.tensor(bounds[1:], dtype=torch.int64, device=dev)
    adj_t = torch.tensor(adj, dtype=torch.int64, device=dev)
    syms = symbols.to(torch.int64)
    out = torch.empty((nb, 64), dtype=torch.int64, device=dev)
    for g in range(16):
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
    elif mode == 2:
        sq = out.view(nb, 8, 8)
        sq[:, 0] = torch.cumsum(sq[:, 0], 1)
        out = torch.cumsum(sq, 1).view(nb, 64)
    blocks = (out & 0xFF).to(torch.uint8)
    return blocks.view(num_frames, bh, bw, 8, 8).permute(0, 1, 3, 2, 4).reshape(
        num_frames, bh * 8, bw * 8)


def decode_images(words: torch.Tensor, offsets: torch.Tensor,
                  symbols: torch.Tensor, bounds, adj, *, num_frames: int,
                  bh: int, bw: int, delta: bool,
                  delta2d: bool = False) -> torch.Tensor:
    """Decode a staged shared-table batch -> (T, bh*8, bw*8) uint8.

    ``words``: (n,) int32 big-endian code words (:func:`prepare_stream`);
    ``offsets``: (T*bh*bw,) int32 block bit offsets (read as u32);
    ``symbols``: (256,) uint8 canonical symbol order; ``bounds``/``adj``:
    the 16-entry interval table (host ints). CPU tensors run
    :func:`decode_images_plain`; CUDA tensors launch the kernel.
    """
    global launches
    mode = _mode(delta, delta2d)
    nb = num_frames * bh * bw
    for name, x, dtype in (("words", words, torch.int32),
                           ("offsets", offsets, torch.int32),
                           ("symbols", symbols, torch.uint8)):
        if x.dtype != dtype or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor")
        if x.device != words.device:
            raise ValueError(f"{name} is on {x.device}, words on {words.device}")
    if offsets.numel() != nb:
        raise ValueError(f"{offsets.numel()} block offsets for {nb} blocks")
    if symbols.numel() != 256 or len(bounds) != 16 or len(adj) != 16:
        raise ValueError("the table needs 256 symbols, 16 bounds, 16 adj")
    if words.numel() < 3:
        raise ValueError("the word stream needs at least 3 words")
    kind = words.device.type
    if kind == "cpu":
        return decode_images_plain(
            words, offsets, symbols, bounds, adj, num_frames=num_frames,
            bh=bh, bw=bw, delta=delta, delta2d=delta2d)
    if kind != "cuda":
        raise ValueError(f"no decode for tensors on {words.device}")
    from .. import _build

    out = torch.empty((num_frames, bh * 8, bw * 8), dtype=torch.uint8,
                      device=words.device)
    if nb == 0:
        return out
    b_arr = (ctypes.c_uint32 * 16)(*bounds)
    a_arr = (ctypes.c_int32 * 16)(*adj)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.lib().mht_decode_images(
            words.data_ptr(), words.numel(), offsets.data_ptr(), nb, bh, bw,
            b_arr, a_arr, symbols.data_ptr(), mode, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"mht_decode_images launch failed: CUDA error {err}")
    launches += 1
    return out
