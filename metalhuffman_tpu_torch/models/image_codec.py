"""Grayscale image codec: the single-image pipeline of the port.

Counterpart of ``metalhuffman_tpu/models/image_codec.py``: image -> zero
padded blocks -> per-block delta -> canonical Huffman bitstream + per-block
bit offsets on the host (the port's C++ encoder), then decode on the device
and the byte-exact check the reference runs in its capture path
(``AAPLRenderer.m:1849-1876``).

A whole image is a one-frame shared-table batch, so it stages and decodes
through ``frame_stream``: 8x8 blocks in one launch of the image kernel
(``decode_images``), other block sizes through the packed-block kernel
(``decode_blocks``). A selection of blocks (``decode_region``) always takes
the packed-block kernel, which reads its offsets in any order.

``device`` takes the place of the JAX package's ``backend``: CUDA tensors run
the kernels, CPU tensors their plain PyTorch versions, and ``device="native"``
the host C++ decoder (``native.decode_blocks``), which stages nothing.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from .. import native
from ..core import bitstream, blocks, container, delta as delta_mod
from ..ops import decode_cuda
from . import frame_stream
from .config import CodecConfig

#: a staged image: a one-frame ``frame_stream.PreparedShared``
PreparedFrame = frame_stream.PreparedShared


class ImageCodec:
    """Encode/decode grayscale images with device-parallel Huffman decode."""

    def __init__(self, config: CodecConfig | None = None):
        self.config = config or CodecConfig()

    # -- encode (host) ------------------------------------------------------

    def encode(self, img: np.ndarray) -> container.EncodedStream:
        """(H, W) uint8 image -> blocked, precoded canonical Huffman stream.

        With ``config.zero_init`` each block's root byte moves to the
        stream's uncoded ``block_init`` side array and its stream slot
        becomes a zero delta.
        """
        img = np.asarray(img)
        if img.ndim != 2:
            raise ValueError("img must be (H, W)")
        return frame_stream.encode_frames_shared(img[None], self.config)

    def encode_best(self, img: np.ndarray):
        """Encode with no precoder, the 1-D delta and the 2-D delta; keep the
        smallest stream (counterpart of the JAX package's
        ``ImageCodec.encode_best``).

        Returns ``(stream, delta_used)``; the stream's ``predictor`` says
        whether the 2-D delta won, and the MHT1 header records both.
        """
        cfg = self.config
        blk = blocks.image_to_blocks(img, cfg.block_dim).ravel()
        plain = native.encode_symbols(blk, block_size=cfg.block_size)
        deltas = native.encode_symbols(
            native.delta_encode(blk, cfg.block_size),
            block_size=cfg.block_size)
        d2 = dataclasses.replace(
            native.encode_symbols(
                native.delta2d_encode(blk, cfg.block_dim),
                block_size=cfg.block_size),
            predictor="2d")
        best = min((plain, deltas, d2), key=lambda s: s.compressed_size)
        return best, best is not plain

    def encode_to_bytes(self, img: np.ndarray) -> bytes:
        """Image -> on-disk MHT1 container (records a source CRC-32)."""
        h, w = img.shape
        return container.write_frame(
            self.encode(img), h, w, self.config.block_dim, self.config.delta,
            source_crc32=zlib.crc32(np.ascontiguousarray(img).tobytes()),
        )

    # -- decode (device) ----------------------------------------------------

    def prepare(self, stream: container.EncodedStream, height: int,
                width: int, *, device="cuda") -> PreparedFrame:
        """Stage a stream's decode inputs on ``device`` (upload analog)."""
        return frame_stream.prepare_shared(stream, 1, height, width,
                                           self.config, device=device)

    def decode_step(self, prep: PreparedFrame) -> torch.Tensor:
        """Device decode: PreparedFrame -> (H, W) uint8 tensor on its device
        (one kernel launch, plus the zero-init fold where the stream has
        it)."""
        return frame_stream.decode_shared_step(prep, self.config)[0]

    def decode(self, data: bytes | container.EncodedStream, height=None,
               width=None, *, device="cuda") -> np.ndarray:
        """Container bytes (or a stream) -> (H, W) uint8 numpy image.

        For container input the header's block_dim and precoder are
        authoritative (they travel with the stream) and the recorded source
        CRC-32 is checked; a raw stream is decoded with the codec's config.
        """
        crc = 0
        codec = self
        if isinstance(data, (bytes, bytearray, memoryview)):
            stream, height, width, block_dim, use_delta, crc = (
                container.read_frame(bytes(data)))
            codec = ImageCodec(dataclasses.replace(
                self.config, block_dim=block_dim, delta=use_delta,
                delta2d=stream.predictor == "2d"))
        else:
            stream = data
            if height is None or width is None:
                raise ValueError("height/width required when passing a raw stream")
        out = codec.decode_step(
            codec.prepare(stream, height, width, device=device)).cpu().numpy()
        if crc and zlib.crc32(out.tobytes()) != crc:
            raise ValueError(
                "decoded image fails the container's source CRC-32 "
                "(corrupt stream or decoder mismatch)")
        return out

    def decode_region(self, stream: container.EncodedStream, height: int,
                      width: int, y0: int, x0: int, rh: int, rw: int,
                      check: bool = False, *, device="cuda") -> np.ndarray:
        """Decode only the blocks covering a region -> (rh, rw) uint8 crop.

        Random access is what the per-block offset index buys: the selected
        blocks ride the packed-block kernel as a shorter offset index, and
        the rest of the image is never decoded. With ``check`` the end-bit
        integrity check verifies exactly the touched blocks and raises
        ValueError on corruption (whole-payload CRCs cannot cover a crop).
        """
        bd = self.config.block_dim
        _bh, bw = blocks.block_grid(height, width, bd)
        if not (0 <= y0 and y0 + rh <= height and 0 <= x0 and x0 + rw <= width):
            raise ValueError("region out of bounds")
        by0, bx0 = y0 // bd, x0 // bd
        by1, bx1 = (y0 + rh - 1) // bd + 1, (x0 + rw - 1) // bd + 1
        sel = (np.arange(by0, by1)[:, None] * bw
               + np.arange(bx0, bx1)[None, :]).ravel()
        gh, gw = (by1 - by0) * bd, (bx1 - bx0) * bd  # region block grid px
        oy, ox = y0 - by0 * bd, x0 - bx0 * bd
        region = decode_blocks_selection(stream, sel, gh, gw, self.config,
                                         check=check, device=device)
        if check:
            region, err = region
            if err.any():
                bad = sel[err]
                raise ValueError(
                    f"region integrity check failed: {int(err.sum())} of "
                    f"{sel.size} touched blocks corrupt (first at block "
                    f"row {int(bad[0]) // bw}, col {int(bad[0]) % bw})")
        return region[oy : oy + rh, ox : ox + rw].cpu().numpy()

    def roundtrip_verify(self, img: np.ndarray, *,
                         device="cuda") -> container.EncodedStream:
        """Encode+decode+byte-compare (reference: ``AAPLRenderer.m:1849-1876``)."""
        stream = self.encode(img)
        out = self.decode(stream, *img.shape, device=device)
        if not np.array_equal(out, img):
            diff = int(np.sum(out != img))
            raise AssertionError(f"roundtrip mismatch: {diff} bytes differ")
        return stream


def selection_end_targets(stream: container.EncodedStream,
                          sel: np.ndarray) -> np.ndarray:
    """Expected row-local end bit for each SELECTED block -> (n_sel,) int32.

    The stream-order targets of :func:`..ops.decode_cuda.block_end_targets`
    taken at ``sel``: ``(offset & 31) + length``, unchanged by rebasing
    offsets by a multiple of 32 bits. The stream's LAST block stays -1 =
    unchecked here; the caller window-checks it.
    """
    return decode_cuda.block_end_targets(stream.block_offsets, None)[
        np.asarray(sel, np.int64)]


def _check_selection_ends(stream: container.EncodedStream, sel: np.ndarray,
                          end_bits: np.ndarray,
                          block_size: int) -> np.ndarray:
    """End bits (selection order) vs the offset index -> (n_sel,) bool err."""
    targets = selection_end_targets(stream, sel)
    end = np.asarray(end_bits, np.int64).reshape(-1)[: sel.size]
    err = decode_cuda.check_block_ends(end, targets)
    window = decode_cuda.last_block_window(stream, block_size)
    if window is not None:
        lo, hi = window
        last = np.asarray(sel) == stream.block_offsets.size - 1
        err[last] = (end[last] < lo) | (end[last] > hi)
    return err


def stage_selection(stream: container.EncodedStream, sel: np.ndarray, *,
                    device="cuda"):
    """Stage the inputs of a selection's decode on ``device`` -> (words,
    offsets, code), the arguments of ``decode_cuda.decode_blocks`` (see
    :func:`decode_blocks_selection`)."""
    sub_offsets = stream.block_offsets[np.asarray(sel, np.int64)].astype(
        np.int64)
    total_bits = 8 * (stream.code_bytes.size - bitstream.READ_AHEAD_PAD_BYTES)
    lo_word = int(sub_offsets.min()) // 32
    hi_word = (int(sub_offsets.max())
               + decode_cuda.max_block_bits(stream.block_offsets, total_bits)
               ) // 32 + 1
    words, _ = decode_cuda.stage_words(
        [stream.code_bytes[4 * lo_word : 4 * hi_word]], device)
    offsets = (sub_offsets - 32 * lo_word).astype(np.uint32)
    return (words, torch.from_numpy(offsets.view(np.int32)).to(device),
            decode_cuda.stage_code(stream.widths, device))


def decode_blocks_selection(stream: container.EncodedStream,
                            sel: np.ndarray, gh: int, gw: int,
                            cfg: CodecConfig, check: bool = False, *,
                            device="cuda"):
    """Decode a SELECTION of a stream's blocks -> (gh, gw) uint8 tensor.

    ``sel`` indexes ``stream.block_offsets`` in the row-major order of the
    (gh//bd, gw//bd) output grid; it may hold any blocks in any order. One
    launch of the packed-block kernel decodes them, and only the word range
    the selected blocks can touch is converted and staged: from the first
    selected block's word to the last selected offset plus the largest block
    of the stream (an upper bound on every selected block), then the pad
    words. The slice is word-aligned, so rebasing the offsets by a multiple
    of 32 bits keeps every ``>> 5`` and ``& 31`` the same. The stream's code
    is staged with them.

    With ``check`` the return is ``(image, err_mask)``, ``err_mask`` an
    (n_sel,) bool numpy array in selection order from the kernel's end bits
    against the offset index.

    ``device="native"`` decodes the selection with the host C++ decoder
    into a CPU tensor; its ``check`` re-applies the forward precoder to the
    decoded blocks and sums their code widths for the end bits (the code is
    prefix-free, so re-encoding the decoded symbols gives the decoder's end
    position: the same check, computed from the other side).
    """
    sel = np.asarray(sel, np.int64)
    if native.is_native(device):
        return _decode_selection_native(stream, sel, gh, gw, cfg, check)
    blk = frame_stream.launch_staged(
        *stage_selection(stream, sel, device=device), cfg, emit_end=check)
    if check:
        blk, end = blk
    init = None
    if stream.block_init is not None:
        init = torch.from_numpy(stream.block_init[sel].astype(np.uint8)).to(
            device)
    img = frame_stream.launch_frames(blk, cfg, None, (1, gh, gw), init)[0]
    if check:
        return img, _check_selection_ends(stream, sel, end.cpu().numpy(),
                                          cfg.block_size)
    return img


def _decode_selection_native(stream: container.EncodedStream,
                             sel: np.ndarray, gh: int, gw: int,
                             cfg: CodecConfig, check: bool):
    """:func:`decode_blocks_selection` on the host C++ decoder."""
    bd = cfg.block_dim
    kdelta = cfg.delta and not cfg.delta2d
    sub_offsets = stream.block_offsets[sel]
    sub = container.EncodedStream(
        sel.size * cfg.block_size, stream.widths, stream.code_bytes,
        sub_offsets.astype(np.uint32), predictor=stream.predictor)
    blk = native.decode_blocks(sub, delta=kdelta, block_size=cfg.block_size,
                               delta2d=cfg.delta2d)
    err = None
    if check:
        if kdelta:
            raw = native.delta_encode(blk.ravel(), cfg.block_size)
        elif cfg.delta2d:
            raw = native.delta2d_encode(blk.ravel(), bd)
        else:
            raw = blk.ravel()
        bits = (stream.widths[raw].reshape(sel.size, cfg.block_size)
                .astype(np.int64).sum(axis=1))
        end = (sub_offsets.astype(np.int64) & 31) + bits
        err = _check_selection_ends(stream, sel, end, cfg.block_size)
    if stream.block_init is not None:
        blk = delta_mod.apply_block_init(blk, stream.block_init[sel])
    img = torch.from_numpy(np.ascontiguousarray(
        blocks.blocks_to_image(blk, gh, gw, bd)))
    return (img, err) if check else img
