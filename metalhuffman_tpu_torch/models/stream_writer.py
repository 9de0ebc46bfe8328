"""Memory-bounded streaming video writers (push frames -> a container on
disk), and in-place append to what they wrote.

Counterpart of ``metalhuffman_tpu/models/stream_writer.py``. The batch
writers (:func:`frame_stream.encode_frames_segmented` +
:func:`frame_stream.write_segmented`) hold the whole (T, H, W) stack and the
whole serialized container in memory. The MHV2 layout is stream-friendly:
segments are self-contained shared-table streams laid down back to back, and
only two header fields (total frame count, segment count) depend on the
future. So frames are pushed incrementally, each full segment is encoded (on
the host, by the port's C++ encoder, as in the JAX package) and written out
as soon as its frames are buffered, and ``close()`` back-patches the two
header fields and appends the CRC trailer(s). Peak memory is one segment of
raw frames plus its encoded blob, independent of stream length.

Byte-level contract: for the same frames, config, and segment capacity, the
file this writer produces is **byte-identical** to
``write_segmented(encode_frames_segmented(frames, cfg), ...)`` and to the
JAX package's writer — same segmentation rule
(:func:`frame_stream.segment_frame_counts`), same pathological-overflow
halving, same trailers — regardless of how the frames were chunked across
``push()`` calls (gated by ``tests/test_torch_stream_writer.py``). A
sequence that fits a single segment is still written as MHV2 (with one
segment) rather than MHTV, because the magic is the first thing written and
the segment count is not known until ``close()``; every decode surface
treats a 1-segment MHV2 exactly like MHTV.

Only the temporal append decodes: it rebuilds the last true frame (the
predictor of the first appended residual) from the open keyframe group with
B1 and the device folds on ``device`` (default ``"cuda"``), where the JAX
package pins its host decoder. Every other path is host work.
"""

from __future__ import annotations

import dataclasses
import io
import struct
import zlib
from pathlib import Path

import numpy as np

from ..core import blocks
from ..core import container
from . import frame_stream
from .config import CodecConfig


@dataclasses.dataclass(frozen=True)
class StreamStats:
    """What ``close()`` wrote: frame/segment totals and the file size."""

    total_frames: int
    num_segments: int
    bytes_written: int
    source_crc32: int


class StreamingEncoder:
    """Push (T, H, W) uint8 frames, get an MHV2 container written as you go.

    Parameters
    ----------
    sink:
        A path (``str`` / ``Path``) opened for writing, or a seekable
        binary file object positioned where the container should start.
        Seekability is required: the MHV2 header's total-frame and
        segment counts are back-patched on ``close()``.
    height, width:
        Frame geometry; every pushed frame must match.
    config:
        Codec configuration. ``temporal`` is refused here — this class
        writes the bare residual/plain MHV2 stream; inter prediction
        streams through :class:`TemporalStreamingEncoder`, which wraps
        one of these in the MHVT trailer layout.
    max_segment_bits:
        Per-segment compressed-size budget (u32 block-offset cap), as in
        :func:`frame_stream.encode_frames_segmented`.
    max_segment_frames:
        Optional cap on frames per segment, to bound peak memory below
        the u32-derived capacity (which at small geometries can be
        millions of frames). Caps below the derived capacity change the
        segmentation — the output is then byte-identical to a batch
        encode with the same effective capacity, not to the default one.
    frame_crcs:
        Record the per-frame CRC-32 table (FCRC extension) so random
        access (``--frame N --check``) can verify single frames.

    Usage::

        with StreamingEncoder(path, h, w, cfg) as enc:
            for chunk in frame_source:   # any chunking, incl. 1 frame
                enc.push(chunk)
        stats = enc.stats   # after close; close() also returns them
    """

    _HEADER_FMT = "<IIIBBI"  # total_frames, h, w, block_dim, mode, n_seg

    def __init__(
        self,
        sink,
        height: int,
        width: int,
        config: CodecConfig | None = None,
        max_segment_bits: int = (1 << 32) - 1024,
        max_segment_frames: int | None = None,
        frame_crcs: bool = False,
        append: bool = False,
    ) -> None:
        cfg = config or CodecConfig()
        if cfg.temporal:
            raise ValueError(
                "StreamingEncoder writes the bare MHV2 stream; temporal "
                "(MHVT) streams through TemporalStreamingEncoder")
        if (cfg.zero_init or cfg.delta2d) and not cfg.delta:
            raise ValueError("zero_init/delta2d require delta precoding")
        if height <= 0 or width <= 0:
            raise ValueError("frame geometry must be positive")
        self._cfg = cfg
        self._h, self._w = int(height), int(width)
        bh, bw = blocks.block_grid(self._h, self._w, cfg.block_dim)
        frame_symbols = bh * bw * cfg.block_size
        per = max(1, int(
            max_segment_bits
            // (frame_symbols * frame_stream._SEG_BITS_PER_SYMBOL)))
        if max_segment_frames is not None:
            if max_segment_frames < 1:
                raise ValueError("max_segment_frames must be >= 1")
            per = min(per, int(max_segment_frames))
        self._per = per
        self._max_segment_bits = max_segment_bits
        self._want_fcrcs = bool(frame_crcs)
        self._fcrcs: list[int] = []
        self._crc = 0
        self._crc_valid = True  # False: combined CRC unrecordable (append
        #                         onto a file that records none)
        # (_poison() sets _closed so an enclosing writer's abort refuses
        # further pushes regardless of who owns the file handle)
        self._buf: list[np.ndarray] = []  # pending frames, each (H, W)
        self._buffered = 0
        self._total = 0
        self._n_seg = 0
        self._mode: int | None = None
        self._closed = False
        #: (trailer_start, original trailer bytes, original header bytes)
        #: when appending — failure RESTORES the original file instead of
        #: truncating to nothing
        self._restore: tuple | None = None
        self.stats: StreamStats | None = None

        if isinstance(sink, (str, Path)):
            self._fh: io.IOBase = open(sink, "r+b" if append else "wb")
            self._owns_fh = True
        else:
            self._fh = sink
            self._owns_fh = False
        if not (self._fh.seekable() and self._fh.writable()):
            raise ValueError(
                "sink must be a seekable writable binary file (the MHV2 "
                "header's frame/segment counts are patched on close)")
        self._base = self._fh.tell()
        try:
            if append:
                self._open_for_append()
            else:
                # placeholder header; totals patched on close()
                self._fh.write(frame_stream.SEGMENTED_MAGIC)
                self._fh.write(struct.pack(
                    self._HEADER_FMT, 0, self._h, self._w, cfg.block_dim,
                    0, 0))
        except BaseException:
            if self._owns_fh:
                self._fh.close()
            raise

    def _open_for_append(self) -> None:
        """Resume/append mode: parse the EXISTING finalized MHV2, seed the
        writer's state from it, and peel its trailer off.

        The capture-resume story: a crashed capture leaves either a valid
        container (closed cleanly) or — by the no-torn-container contract
        — nothing; appending to the valid container continues it in
        place. New frames chain onto
        the recorded CRC (``zlib.crc32(new, old)`` IS the CRC of the
        concatenated payload) and any FCRC table extends, so the result
        is byte-identical to ``surgery.concat_videos([old, new])`` of the
        same content (gated by test). Only segment headers and the small
        trailer are read — the payload bytes are never touched. A failed
        append RESTORES the original trailer/header: the pre-existing
        container survives any error.
        """
        fh = self._fh
        fh.seek(self._base)
        head = fh.read(22)
        if len(head) < 22 or head[:4] != frame_stream.SEGMENTED_MAGIC:
            raise ValueError(
                "append needs an existing segmented MHV2 container "
                "(`resegment` converts an MHTV losslessly)")
        total, h, w, bd, mode, n_seg = struct.unpack(self._HEADER_FMT,
                                                     head[4:])
        if (h, w) != (self._h, self._w):
            raise ValueError(
                f"existing container is {h}x{w}, not "
                f"{self._h}x{self._w}")
        if bd != self._cfg.block_dim:
            raise ValueError(
                f"existing container uses block_dim={bd}, the config "
                f"says {self._cfg.block_dim}")
        cfg = self._cfg
        want_mode = (4 if cfg.delta2d and cfg.zero_init else
                     3 if cfg.delta2d else 2 if cfg.zero_init else
                     int(cfg.delta))
        if mode != want_mode:
            # fail FAST with the config mismatch, not after a whole
            # segment of encode work trips _write_segment's internal
            # "segments must share one mode" invariant
            names = {0: "no precoding", 1: "delta", 2: "delta+zero-init",
                     3: "delta2d", 4: "delta2d+zero-init"}
            raise ValueError(
                f"existing container uses {names.get(mode, mode)}, the "
                f"config says {names.get(want_mode, want_mode)} — append "
                "must continue the same coding mode")
        pos = self._base + 22
        for i in range(n_seg):
            fh.seek(pos)
            rec = fh.read(12)
            if len(rec) < 12:
                raise ValueError(
                    f"truncated MHV2 container (segment {i} header)")
            _t, nb, ln = struct.unpack("<III", rec)
            pos += 12 + ln + 4 * nb + (nb if mode in (2, 4) else 0)
        fh.seek(pos)
        trailer = fh.read()
        if len(trailer) < 4:
            raise ValueError("truncated MHV2 container (trailer missing)")
        (crc,) = struct.unpack_from("<I", trailer, 0)
        old_fcrcs = None
        expected = 4
        if (len(trailer) >= 12
                and trailer[4:8] == frame_stream.FRAME_CRC_MAGIC):
            (n,) = struct.unpack_from("<I", trailer, 8)
            if len(trailer) < 12 + 4 * n:
                raise ValueError("truncated FCRC table")
            old_fcrcs = np.frombuffer(trailer, "<u4", count=n, offset=12)
            expected = 12 + 4 * n
        if len(trailer) != expected:
            # trailing bytes beyond the trailer mean the segment walk
            # landed in the wrong place (corrupt header/lengths) — an
            # append from here would splice at a garbage offset
            raise ValueError(
                "corrupt MHV2 container (segment walk does not land on "
                "the trailer — refusing to append)")
        self._total, self._n_seg, self._mode = total, n_seg, mode
        self._crc = crc
        self._crc_valid = crc != 0
        if old_fcrcs is not None:
            # the table continues whether or not the caller asked — a
            # plain append must never silently DROP recorded metadata
            self._want_fcrcs = True
            self._fcrcs = [int(c) for c in old_fcrcs]
        elif self._want_fcrcs:
            raise ValueError(
                "cannot start a per-frame CRC table mid-stream: the "
                "existing container records none (drop frame_crcs)")
        self._restore = (pos, trailer, head)
        fh.truncate(pos)
        fh.seek(pos)

    @property
    def segment_frames(self) -> int:
        """Frames per full segment — the peak raw-frame buffer length."""
        return self._per

    # -- frame intake ---------------------------------------------------------

    def push(self, frames: np.ndarray) -> None:
        """Buffer one (H, W) frame or a (T, H, W) chunk; encode full segments.

        Frames are copied into the buffer (the caller may reuse or mmap the
        input array). Encoding happens here, synchronously, whenever the
        buffer reaches the segment capacity — so a steady push loop does
        steady work instead of one giant close().

        Shape/dtype validation raises before any state changes (the
        stream stays usable); an encode or write failure mid-segment
        discards the stream like :meth:`abort` — the no-torn-container
        contract holds even for callers outside the context manager.
        """
        if self._closed:
            raise ValueError("push() after close()")
        arr = np.asarray(frames)
        if arr.ndim == 2:
            arr = arr[None]
        if arr.ndim != 3 or arr.shape[1:] != (self._h, self._w):
            raise ValueError(
                f"expected (T, {self._h}, {self._w}) frames, got "
                f"{arr.shape}")
        if arr.dtype != np.uint8:
            raise ValueError("frames must be uint8")
        try:
            for f in arr:
                fc = np.array(f, copy=True)  # one contiguous copy per frame
                self._crc = zlib.crc32(fc, self._crc)
                if self._want_fcrcs:
                    self._fcrcs.append(zlib.crc32(fc))
                self._buf.append(fc)
                self._buffered += 1
                # drain at segment granularity INSIDE the intake loop so a
                # large push never holds more than one segment buffered
                if self._buffered >= self._per:
                    self._emit(self._per)
        except BaseException:
            # an _emit failure leaves the sink mid-segment; truncate it
            # (abort) so a non-context-manager caller never keeps a torn
            # container on disk (validation above raised before any state
            # change, so it does NOT land here)
            self.abort()
            raise

    # -- segment emission -----------------------------------------------------

    def _emit(self, take: int) -> None:
        """Encode the first ``take`` buffered frames into segment(s).

        Mirrors the halving retry of ``encode_frames_segmented``: if the
        exact u32 offset check overflows (pathological content), the chunk
        is split in half and each half becomes its own segment.
        """
        plan = [take]
        while plan:
            k = plan.pop(0)
            chunk = np.stack(self._buf[:k])
            try:
                stream = frame_stream.encode_frames_shared(chunk, self._cfg)
            except ValueError:
                if k == 1:
                    raise  # single frame over 2^32 bits: nothing to split
                half = k // 2
                plan[0:0] = [half, k - half]
                continue
            self._write_segment(stream, k)
            del self._buf[:k]
            self._buffered -= k

    def _write_segment(self, stream: container.EncodedStream,
                       t: int) -> None:
        mode = frame_stream._stream_mode(stream, self._cfg.delta)
        if self._mode is None:
            self._mode = mode
        elif mode != self._mode:  # cannot happen with a fixed config
            raise ValueError("MHV2 segments must share one mode")
        core = stream.core_blob()
        self._fh.write(struct.pack(
            "<III", t, stream.block_offsets.size, len(core)))
        self._fh.write(core)
        self._fh.write(stream.block_offsets.astype("<u4").tobytes())
        if mode in (2, 4):
            self._fh.write(stream.block_init.astype(np.uint8).tobytes())
        self._n_seg += 1
        self._total += t

    # -- finalization ---------------------------------------------------------

    def close(self) -> StreamStats:
        """Flush the partial tail segment, write trailers, patch the header.

        A close() that fails — empty stream, a single frame overflowing
        the u32 offset cap, or an I/O error during the trailer/header
        writes — truncates the sink back to the start, like :meth:`abort`:
        no torn container is ever left behind.
        """
        if self._closed:
            if self.stats is None:
                raise ValueError(
                    "close() after a failed close()/abort() — the sink "
                    "was truncated, there is no container to finalize")
            return self.stats
        try:
            try:
                if self._buffered:
                    self._emit(self._buffered)
                if self._total == 0:
                    raise ValueError("cannot encode an empty frame stack")
                crc_out = self._crc & 0xFFFFFFFF if self._crc_valid else 0
                self._fh.write(struct.pack("<I", crc_out))
                if self._want_fcrcs:
                    self._fh.write(frame_stream._frame_crc_blob(
                        np.array(self._fcrcs, np.uint32)))
                end = self._fh.tell()
                self._fh.seek(self._base + 4)
                # mode byte: every segment agreed (see _write_segment)
                self._fh.write(struct.pack(
                    self._HEADER_FMT, self._total, self._h, self._w,
                    self._cfg.block_dim, self._mode, self._n_seg))
                self._fh.seek(end)
            except BaseException:
                self._discard()
                raise
            self.stats = StreamStats(
                total_frames=self._total, num_segments=self._n_seg,
                bytes_written=end - self._base,
                source_crc32=crc_out)
            return self.stats
        finally:
            self._closed = True
            if self._owns_fh:
                self._fh.close()

    def _discard(self) -> None:
        """Failure/abort cleanup: a fresh stream truncates to the start
        (no torn container); an APPEND restores the original trailer and
        header, so the pre-existing container survives intact."""
        if self._fh.closed:
            return
        if self._restore is not None:
            start, trailer, head = self._restore
            self._fh.truncate(start)
            self._fh.seek(start)
            self._fh.write(trailer)
            self._fh.seek(self._base)
            self._fh.write(head)
        else:
            self._fh.seek(self._base)
            self._fh.truncate(self._base)

    def _poison(self) -> None:
        """Refuse all further pushes (an enclosing writer aborted)."""
        self._closed = True

    def abort(self) -> None:
        """Discard everything written and close the sink without
        finalizing: truncate a fresh stream to nothing, or — in append
        mode — restore the original container untouched."""
        self._closed = True
        self._buf.clear()
        self._buffered = 0
        if self._fh.closed:
            return
        try:
            self._discard()
        finally:
            if self._owns_fh:
                self._fh.close()

    def __enter__(self) -> "StreamingEncoder":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()


class ColorStreamingEncoder:
    """Streaming MHTC writer: push color / 16-bit frames, stream the planes.

    MHTC's header is a fixed 8 bytes with nothing length-dependent in it
    (``color.wrap``), so the color/u16 story composes directly: write the
    MHTC header, then run a :class:`StreamingEncoder` over the plane
    stream at offset 8 (it back-patches only its own MHV2 header). Each
    pushed frame becomes its planes — (T, H, W, C) uint8 frame-major
    channel planes after the optional sub-green transform, or hi/lo byte
    planes for (T, H, W) uint16 — exactly the batch layout
    (``color.encode_color_video_to_bytes`` / ``encode_gray16_to_bytes``),
    so every MHTC decode surface reads the result unchanged.

    ``u16=True`` selects 16-bit grayscale (kind=1, 2 planes/frame);
    otherwise ``channels`` (3 or 4) u8 color with optional
    ``colorspace=color.CS_SUBGREEN``. ``frame_crcs`` records the inner
    per-PLANE CRC table, matching the batch writer — plane-level
    random-access verification.
    """

    def __init__(
        self,
        sink,
        height: int,
        width: int,
        channels: int | None = None,
        u16: bool = False,
        config: CodecConfig | None = None,
        colorspace: int | None = None,
        max_segment_bits: int = (1 << 32) - 1024,
        max_segment_frames: int | None = None,
        frame_crcs: bool = False,
        append: bool = False,
    ) -> None:
        from . import color

        if u16:
            if channels not in (None, 2):
                raise ValueError("u16 streams always carry 2 (hi/lo) planes")
            if colorspace not in (None, color.CS_IDENTITY):
                raise ValueError("colorspace applies to u8 color, not u16")
            channels, kind, cs = 2, color.KIND_U16, color.CS_IDENTITY
        else:
            if channels is None or not 1 <= channels <= 255:
                raise ValueError("u8 color needs channels in 1..255")
            cs = color.CS_IDENTITY if colorspace is None else colorspace
            if cs == color.CS_SUBGREEN and channels < 3:
                raise ValueError("sub-green needs at least 3 channels")
            kind = color.KIND_U8
        self._color = color
        self._u16 = bool(u16)
        self._c = int(channels)
        self._cs = cs
        self._append = bool(append)
        self._h, self._w = int(height), int(width)

        if isinstance(sink, (str, Path)):
            self._fh: io.IOBase = open(sink, "r+b" if append else "wb")
            self._owns_fh = True
        else:
            self._fh = sink
            self._owns_fh = False
        if not (self._fh.seekable() and self._fh.writable()):
            if self._owns_fh:
                self._fh.close()
            raise ValueError(
                "sink must be a seekable writable binary file (the inner "
                "MHV2 header's frame/segment counts are patched on close)")
        self._base = self._fh.tell()
        planes_per_frame = 2 if u16 else self._c
        try:
            want = color.COLOR_MAGIC + struct.pack(
                "<BBBB", self._c, color.LAYOUT_VIDEO, kind, cs)
            if append:
                # the MHTC header is immutable: append = validate it and
                # run the inner writer's append machinery at offset 8
                self._fh.seek(self._base)
                head = self._fh.read(8)
                if head[:4] != color.COLOR_MAGIC:
                    raise ValueError(
                        "append needs an existing MHTC container")
                if head != want:
                    raise ValueError(
                        "existing MHTC channels/layout/kind/colorspace "
                        "disagree with the requested configuration")
            else:
                self._fh.write(want)
            self._inner = StreamingEncoder(
                self._fh, height, width, config,
                max_segment_bits=max_segment_bits,
                max_segment_frames=(
                    None if max_segment_frames is None
                    else max_segment_frames * planes_per_frame),
                frame_crcs=frame_crcs, append=append)
        except BaseException:
            # leave neither a torn 8-byte MHTC header nor a leaked handle
            # (append mode wrote nothing: close the handle, touch nothing)
            try:
                if not append:
                    self._fh.seek(self._base)
                    self._fh.truncate(self._base)
            finally:
                if self._owns_fh:
                    self._fh.close()
            raise
        self._frames = self._inner._total // planes_per_frame
        self.stats: StreamStats | None = None

    def push(self, frames: np.ndarray) -> None:
        """Buffer one frame or a stack: (T, H, W, C) uint8 / (T, H, W) u16."""
        if (self.stats is not None or self._fh.closed
                or self._inner._closed):
            # guard BEFORE delegating: the inner writer's own "push()
            # after close()" error must not trip the abort wrapper below,
            # which would truncate an already-finalized container (the
            # _closed check covers an enclosing writer's abort/poison)
            raise ValueError("push() after close()")
        arr = np.asarray(frames)
        if self._u16:
            if arr.ndim == 2:
                arr = arr[None]
            if arr.ndim != 3 or arr.shape[1:] != (self._h, self._w):
                raise ValueError(
                    f"expected (T, {self._h}, {self._w}) u16 frames, got "
                    f"{arr.shape}")
            if arr.dtype != np.uint16:
                raise ValueError("u16 frames must be uint16")
            t = arr.shape[0]
            hi = (arr >> 8).astype(np.uint8)
            lo = (arr & 0xFF).astype(np.uint8)
            planes = np.stack([hi, lo], axis=1).reshape(
                t * 2, self._h, self._w)
        else:
            if arr.ndim == 3:
                arr = arr[None]
            if (arr.ndim != 4
                    or arr.shape[1:] != (self._h, self._w, self._c)):
                raise ValueError(
                    f"expected (T, {self._h}, {self._w}, {self._c}) "
                    f"frames, got {arr.shape}")
            if arr.dtype != np.uint8:
                raise ValueError("color frames must be uint8")
            t = arr.shape[0]
            planes = self._color._apply_cs(arr, self._cs).transpose(
                0, 3, 1, 2).reshape(t * self._c, self._h, self._w)
        try:
            self._inner.push(np.ascontiguousarray(planes))
        except BaseException:
            # the inner writer self-aborted (truncated to offset 8); also
            # drop the 8-byte MHTC header so no torn container remains
            self.abort()
            raise
        self._frames += t

    def close(self) -> StreamStats:
        """Finalize the inner stream; a failed close truncates everything.

        The inner close already truncates back to its own base (offset 8)
        on failure; this wrapper also removes the 8-byte MHTC header so
        the no-torn-container contract holds for the whole file.
        """
        if self.stats is not None:
            return self.stats
        try:
            inner = self._inner.close()
        except BaseException:
            # the inner's failure handling already restored (append) or
            # truncated (fresh) its own region; a fresh stream also drops
            # the 8-byte MHTC header, an append leaves the original file
            try:
                if not self._fh.closed and not self._append:
                    self._fh.seek(self._base)
                    self._fh.truncate(self._base)
            finally:
                if self._owns_fh and not self._fh.closed:
                    self._fh.close()
            raise
        self.stats = StreamStats(
            total_frames=self._frames, num_segments=inner.num_segments,
            bytes_written=inner.bytes_written + 8,
            source_crc32=inner.source_crc32)
        if self._owns_fh:
            self._fh.close()
        return self.stats

    def _discard(self) -> None:
        """Restore/cleanup for an enclosing writer's failure path: the
        8-byte MHTC header is immutable, so discarding is exactly the
        inner MHV2 writer's discard (restore in append mode, truncate to
        the inner base otherwise)."""
        self._inner._discard()

    def _poison(self) -> None:
        """Refuse all further pushes (an enclosing writer aborted)."""
        self._inner._poison()

    def abort(self) -> None:
        """Discard everything (incl. the MHTC header) and close the sink;
        in append mode the original container is restored instead."""
        if self._fh.closed:
            return
        try:
            self._inner.abort()
            if not self._append:
                self._fh.seek(self._base)
                self._fh.truncate(self._base)
        finally:
            if self._owns_fh:
                self._fh.close()

    def __enter__(self) -> "ColorStreamingEncoder":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()


class TemporalStreamingEncoder:
    """Streaming MHVT writer: push TRUE frames, stream inter-predicted video.

    Round 4 left the two flagship capabilities mutually exclusive: the
    batch temporal encoder (``temporal.encode_temporal_video``) needs the
    whole stack because the classic MHVT layout carries the motion-vector
    table and the inner length in its *header*, while the streaming
    writers refused ``temporal`` outright. The trailer layout
    (``temporal.FLAG_TRAILER``) removes the conflict: the header is laid
    down knowing only ``keyint`` and which tables WILL exist (flags), the
    motion/frame-CRC tables and source CRC follow the inner as a trailer,
    and the single back-patched field is the u64 inner length — so this
    writer holds exactly ONE previous true frame plus the inner writer's
    one-segment buffer, independent of stream length.

    Residual computation is inherently streamable: keyframes (every
    ``config.keyint`` frames) are literal, every other frame is the
    wrapping difference from its TRUE predecessor — optionally circularly
    shifted by a per-frame global motion vector estimated on push
    (``config.motion``). The residuals, vectors, and CRCs are exactly the
    batch encoder's (same ``estimate_motion``, same mod-2^8/2^16
    arithmetic), so the streamed file is **byte-identical** to
    ``temporal.wrap(batch_inner, ..., trailer=True)`` of the same content
    at the same segmentation (gated by test), and every existing decode
    surface — ``decode_temporal_video``, ``--frame``/``--frames`` random
    access, ``iter_temporal_video`` / ``decode-video --streaming``,
    ``verify``, surgery — reads it through the layout-agnostic
    ``temporal.unwrap``.

    Inner kinds mirror the batch wrappers: grayscale (default) streams an
    MHV2; ``channels=C`` streams color planes through an MHTC wrapper
    (optional ``colorspace=color.CS_SUBGREEN``); ``u16=True`` streams
    16-bit grayscale (residuals mod 65536 on the u16 values, THEN split
    to hi/lo planes — a small depth change never rolls the hi plane).

    The reference encodes once, in memory, and never writes a file
    (``AAPLRenderer.m:374-688``); this closes the capture loop it only
    hints at.

    ``device`` (default ``"cuda"``) is where an append decodes the open
    keyframe group: B1 (or B2 for other block sizes) and the device folds,
    then one fetch of the last true frame. A fresh stream never decodes.
    """

    def __init__(
        self,
        sink,
        height: int,
        width: int,
        config: CodecConfig | None = None,
        channels: int | None = None,
        u16: bool = False,
        colorspace: int | None = None,
        max_segment_bits: int = (1 << 32) - 1024,
        max_segment_frames: int | None = None,
        frame_crcs: bool = False,
        append: bool = False,
        device="cuda",
    ) -> None:
        from . import temporal

        cfg = config or CodecConfig()
        if cfg.keyint < 1:
            raise ValueError("keyint must be >= 1")
        self._temporal = temporal
        self._keyint = int(cfg.keyint)
        self._motion = bool(cfg.motion)
        self._want_fcrcs = bool(frame_crcs)
        self._h, self._w = int(height), int(width)
        self._u16 = bool(u16)
        self._c = None if channels is None else int(channels)
        self._colorspace = colorspace
        if self._u16 and self._c not in (None, 2):
            raise ValueError("u16 streams always carry 2 (hi/lo) planes")
        if isinstance(sink, (str, Path)):
            self._fh: io.IOBase = open(sink, "r+b" if append else "wb")
            self._owns_fh = True
        else:
            self._fh = sink
            self._owns_fh = False
        if not (self._fh.seekable() and self._fh.writable()):
            if self._owns_fh:
                self._fh.close()
            raise ValueError(
                "sink must be a seekable writable binary file (the u64 "
                "inner length and the inner MHV2 header are patched on "
                "close)")
        self._base = self._fh.tell()
        self._prev: np.ndarray | None = None
        self._t = 0
        self._fl: int | None = None  # short first group (append resumes it)
        self._mvs: list[tuple[int, int]] = []
        self._fcrcs: list[int] = []
        self._crc = 0
        self._crc_valid = True
        self._restore: tuple | None = None
        self._device = device
        inner_cfg = temporal._inner_config(cfg)
        try:
            if append:
                self._open_for_append(inner_cfg, max_segment_bits,
                                      max_segment_frames)
            else:
                flags = temporal.FLAG_TRAILER
                if self._motion:
                    flags |= temporal.FLAG_MOTION
                if self._want_fcrcs:
                    flags |= temporal.FLAG_FRAME_CRCS
                self._fh.write(temporal.TEMPORAL_MAGIC + struct.pack(
                    temporal._HEADER, self._keyint, flags, 0))
                self._fh.write(struct.pack("<Q", 0))  # u64, patched on close
                self._inner = self._make_inner(
                    inner_cfg, max_segment_bits, max_segment_frames,
                    append=False)
        except BaseException:
            try:
                if append:
                    # _open_for_append may have truncated the outer
                    # tables before the inner writer's constructor
                    # raised (e.g. a block_dim mismatch the inner walk
                    # detects) — restore the original file, never leave
                    # it torn
                    if self._restore is not None and not self._fh.closed:
                        end, tables, head = self._restore
                        self._fh.truncate(end)
                        self._fh.seek(end)
                        self._fh.write(tables)
                        self._fh.seek(self._base)
                        self._fh.write(head)
                else:
                    self._fh.seek(self._base)
                    self._fh.truncate(self._base)
            finally:
                if self._owns_fh:
                    self._fh.close()
            raise
        self.stats: StreamStats | None = None

    def _make_inner(self, inner_cfg, max_segment_bits, max_segment_frames,
                    append: bool):
        """The inner residual writer for this stream's kind — ONE factory
        for the fresh and append paths, so their arguments cannot drift."""
        if self._u16:
            return ColorStreamingEncoder(
                self._fh, self._h, self._w, u16=True, config=inner_cfg,
                max_segment_bits=max_segment_bits,
                max_segment_frames=max_segment_frames, append=append)
        if self._c is not None:
            return ColorStreamingEncoder(
                self._fh, self._h, self._w, channels=self._c,
                config=inner_cfg, colorspace=self._colorspace,
                max_segment_bits=max_segment_bits,
                max_segment_frames=max_segment_frames, append=append)
        return StreamingEncoder(
            self._fh, self._h, self._w, inner_cfg,
            max_segment_bits=max_segment_bits,
            max_segment_frames=max_segment_frames, append=append)

    def _open_for_append(self, inner_cfg, max_segment_bits,
                         max_segment_frames) -> None:
        """Resume a temporally-predicted capture in place.

        Requires the TRAILER layout (this writer's own output; a batch
        header-layout file splices with ``surgery.concat_videos``). The
        previous TRUE frame — the predictor for the first appended
        residual — comes from one range decode of the open keyframe
        group's planes and the folds on ``device``, of which only the
        last frame is fetched; the keyframe cadence continues from
        the recorded ``first_len``/``keyint``, the motion/FCRC tables
        seed from the old trailer, and the chained outer CRC extends
        (``zlib.crc32(new, old)``). The inner MHV2 appends through
        :class:`StreamingEncoder`'s own append machinery. Failure
        restores the original file completely (outer header + inner
        header/trailer + outer tables).
        """
        import struct as struct_mod

        temporal = self._temporal
        fh = self._fh
        fh.seek(0, 2)
        fsize = fh.tell()
        fh.seek(self._base)
        head12 = fh.read(12)
        if len(head12) < 12 or head12[:4] != temporal.TEMPORAL_MAGIC:
            raise ValueError("append needs an existing MHVT container")
        keyint, flags, _il32 = struct_mod.unpack_from("<HHI", head12, 4)
        if not flags & temporal.FLAG_TRAILER:
            raise ValueError(
                "append needs the streamed (trailer) MHVT layout; splice "
                "header-layout files with surgery.concat_videos")
        if keyint != self._keyint:
            raise ValueError(
                f"existing container uses keyint={keyint}, the config "
                f"says {self._keyint}")
        if bool(flags & temporal.FLAG_MOTION) != self._motion:
            raise ValueError(
                "motion-compensation presence must match the existing "
                "container (it records "
                + ("a" if flags & temporal.FLAG_MOTION else "no")
                + " motion table)")
        b8 = fh.read(8)
        if len(b8) < 8:
            raise ValueError("truncated MHVT container (u64 inner length)")
        (inner_len,) = struct_mod.unpack("<Q", b8)
        fl = keyint
        inner_start = self._base + 20
        if flags & temporal.FLAG_FIRST_LEN:
            b2 = fh.read(2)
            if len(b2) < 2:
                raise ValueError("truncated MHVT container (first_len)")
            (fl,) = struct_mod.unpack("<H", b2)
            inner_start += 2
            if not 1 <= fl <= keyint:
                raise ValueError(
                    "corrupt MHVT container (first keyframe group length "
                    f"{fl} outside 1..keyint={keyint})")
        inner_end = inner_start + inner_len
        if inner_end + 4 > fsize:
            raise ValueError(
                "truncated MHVT container (inner/trailer missing)")
        # trailer tables + CRC: small, read whole; header bytes for restore
        fh.seek(self._base)
        head = fh.read(inner_start - self._base)
        fh.seek(inner_end)
        tables = fh.read()
        mvs, fcrcs, tpos = temporal._parse_tables(tables, 0, flags)
        if len(tables) < tpos + 4:
            raise ValueError(
                "truncated MHVT container (inner/trailer missing)")
        (tcrc,) = struct_mod.unpack_from("<I", tables, tpos)
        # inner kind: bare MHV2 (gray) or MHTC wrapper (color / u16) —
        # must agree with this writer's requested kind; the inner
        # writer's own append validation re-checks the exact header
        from . import color as color_mod

        fh.seek(inner_start)
        magic4 = fh.read(4)
        want_mhtc = self._u16 or self._c is not None
        ppf = 2 if self._u16 else (self._c if self._c is not None else 1)
        if magic4 == color_mod.COLOR_MAGIC:
            if not want_mhtc:
                raise ValueError(
                    "existing container holds a color/u16 (MHTC) stream "
                    "— construct the writer with channels=/u16= to "
                    "append to it")
            # validate the full MHTC header BEFORE the predictor decode:
            # a channels/kind/colorspace mismatch must fail here with a
            # clear message, not after folding planes under wrong
            # parameters (the inner writer re-checks the same bytes)
            mh = fh.read(4)
            want_kind = (color_mod.KIND_U16 if self._u16
                         else color_mod.KIND_U8)
            want_cs = (color_mod.CS_IDENTITY if self._colorspace is None
                       or self._u16 else self._colorspace)
            if len(mh) < 4 or (mh[0], mh[1], mh[2], mh[3]) != (
                    ppf, color_mod.LAYOUT_VIDEO, want_kind, want_cs):
                raise ValueError(
                    "existing MHTC channels/layout/kind/colorspace "
                    "disagree with the requested configuration")
            mhv2_at = inner_start + 8
        else:
            if want_mhtc:
                raise ValueError(
                    "existing container holds a grayscale stream — drop "
                    "channels=/u16= to append to it")
            mhv2_at = inner_start
        fh.seek(mhv2_at)
        ih = fh.read(22)
        if len(ih) < 22 or ih[:4] != frame_stream.SEGMENTED_MAGIC:
            raise ValueError(
                "append needs a segmented MHV2 inner (the streamed "
                "layout)")
        t_planes, h, w, ibd, mode, n_seg = struct_mod.unpack("<IIIBBI",
                                                             ih[4:])
        if t_planes == 0 or t_planes % ppf:
            raise ValueError(
                "corrupt MHVT container (unrecognized inner stream)")
        t = t_planes // ppf
        if (h, w) != (self._h, self._w):
            raise ValueError(
                f"existing container is {h}x{w}, not "
                f"({self._h}, {self._w})")
        # ALL cheap config/corruption validation runs BEFORE the
        # predictor decode below — a doomed append must not pay (or risk
        # miscomputing under) the last-group materialization
        if self._motion and (mvs is None or mvs.shape[0] != t):
            raise ValueError(
                "corrupt MHVT container (motion table length disagrees "
                "with the frame count)")
        if fcrcs is not None and fcrcs.shape[0] != t:
            raise ValueError(
                "corrupt MHVT container (frame CRC table length "
                "disagrees with the frame count)")
        if fcrcs is None and self._want_fcrcs:
            raise ValueError(
                "cannot start a per-frame CRC table mid-stream: the "
                "existing container records none (drop frame_crcs)")
        # previous TRUE frame — the predictor for the first appended
        # residual. Constant memory: walk the inner's segment HEADERS
        # (12 bytes each) and materialize only the segments covering the
        # last keyframe group's PLANES (<= keyint*ppf), never the archive
        kf = temporal._group_start(t - 1, keyint, fl)
        kf_planes = kf * ppf
        pos = mhv2_at + 22
        base_f = 0
        span_base = None
        parts = []
        span_frames = 0
        for i in range(n_seg):
            fh.seek(pos)
            rec = fh.read(12)
            if len(rec) < 12:
                raise ValueError(
                    f"truncated MHV2 container (segment {i} header)")
            ts, nb, ln = struct_mod.unpack("<III", rec)
            seg_len = 12 + ln + 4 * nb + (nb if mode in (2, 4) else 0)
            if base_f + ts > kf_planes:  # overlaps [kf_planes, t_planes)
                if span_base is None:
                    span_base = base_f
                fh.seek(pos)
                parts.append(fh.read(seg_len))
                span_frames += ts
            pos += seg_len
            base_f += ts
        if span_base is None or base_f != t_planes:
            raise ValueError(
                "corrupt MHVT container (inner frame count disagrees "
                "with its segments)")
        mini = (frame_stream.SEGMENTED_MAGIC + struct_mod.pack(
            "<IIIBBI", span_frames, h, w, ibd, mode,
            len(parts)) + b"".join(parts))
        # decoded and folded on the device; only the last frame comes back
        planes, _h, _w = frame_stream.decode_range(
            mini, kf_planes - span_base, t_planes - span_base,
            to_host=False, device=self._device)
        planes = planes.reshape(-1, h, w)
        if self._u16:
            cinfo = (2, color_mod.KIND_U16, color_mod.CS_IDENTITY)
        elif self._c is not None:
            cinfo = (self._c, color_mod.KIND_U8,
                     color_mod.CS_IDENTITY if self._colorspace is None
                     else self._colorspace)
        else:
            cinfo = None
        # the span [kf, t) lies inside ONE keyframe group (kf = its
        # start), so the plain group fold applies; MC folds with the
        # recorded vectors for exactly those frames (validated above)
        prev = temporal.fold_planes(planes, keyint,
                                    mvs[kf:t] if self._motion else None,
                                    None, cinfo)[-1]
        self._prev = prev.cpu().numpy()
        self._t = t
        self._fl = fl if fl != keyint else None
        if self._motion:
            self._mvs = [(int(v[0]), int(v[1])) for v in mvs]
        if fcrcs is not None:
            self._want_fcrcs = True
            self._fcrcs = [int(c) for c in fcrcs]
        self._crc = tcrc
        self._crc_valid = tcrc != 0
        self._restore = (inner_end, tables, head)
        fh.truncate(inner_end)
        fh.seek(inner_start)
        self._inner = self._make_inner(
            inner_cfg, max_segment_bits, max_segment_frames, append=True)

    # -- frame intake ---------------------------------------------------------

    def _validate(self, frames: np.ndarray) -> np.ndarray:
        arr = np.asarray(frames)
        if self._u16:
            if arr.ndim == 2:
                arr = arr[None]
            if arr.ndim != 3 or arr.shape[1:] != (self._h, self._w):
                raise ValueError(
                    f"expected (T, {self._h}, {self._w}) u16 frames, got "
                    f"{arr.shape}")
            if arr.dtype != np.uint16:
                raise ValueError("u16 frames must be uint16")
        elif self._c is not None:
            if arr.ndim == 3:
                arr = arr[None]
            if (arr.ndim != 4
                    or arr.shape[1:] != (self._h, self._w, self._c)):
                raise ValueError(
                    f"expected (T, {self._h}, {self._w}, {self._c}) "
                    f"frames, got {arr.shape}")
            if arr.dtype != np.uint8:
                raise ValueError("color frames must be uint8")
        else:
            if arr.ndim == 2:
                arr = arr[None]
            if arr.ndim != 3 or arr.shape[1:] != (self._h, self._w):
                raise ValueError(
                    f"expected (T, {self._h}, {self._w}) frames, got "
                    f"{arr.shape}")
            if arr.dtype != np.uint8:
                raise ValueError("frames must be uint8")
        return arr

    def push(self, frames: np.ndarray) -> None:
        """Buffer TRUE frame(s); residuals stream into the inner writer.

        Exactly one previous true frame is held between calls. Validation
        raises before any state change; an inner encode/write failure
        aborts the stream (no torn container), as with the plain writers.
        """
        if self.stats is not None or self._fh.closed:
            raise ValueError("push() after close()")
        arr = self._validate(frames)
        for f in arr:
            fc = np.ascontiguousarray(f)
            self._crc = zlib.crc32(fc, self._crc)
            if self._want_fcrcs:
                self._fcrcs.append(zlib.crc32(fc))
            i = self._t
            fl = self._fl if self._fl is not None else self._keyint
            mv = (0, 0)
            if i == 0 or (i >= fl and (i - fl) % self._keyint == 0):
                res = fc
            elif self._motion:
                mv = self._temporal.estimate_motion(self._prev, fc)
                pred = (np.roll(self._prev, mv, axis=(0, 1))
                        if mv != (0, 0) else self._prev)
                res = fc - pred  # unsigned wraparound IS the residual
            else:
                res = fc - self._prev
            if self._motion:
                self._mvs.append(mv)
            try:
                self._inner.push(res)
            except BaseException:
                self.abort()
                raise
            self._prev = np.array(fc, copy=True)
            self._t += 1

    # -- finalization ---------------------------------------------------------

    def close(self) -> StreamStats:
        """Finalize: close the inner stream, append the trailer tables +
        source CRC, patch the u64 inner length. A failed close truncates
        the sink back to the start (no torn container)."""
        if self.stats is not None:
            return self.stats
        if self._fh.closed:
            raise ValueError(
                "close() after a failed close()/abort() — the sink was "
                "truncated, there is no container to finalize")
        try:
            try:
                inner = self._inner.close()  # patches the inner header(s)
                if self._motion:
                    mv = np.asarray(self._mvs, np.int16).reshape(-1, 2)
                    self._fh.write(struct.pack("<I", mv.shape[0])
                                   + mv.astype("<i2").tobytes())
                if self._want_fcrcs:
                    fc = np.asarray(self._fcrcs, np.uint32)
                    self._fh.write(struct.pack("<I", fc.shape[0])
                                   + fc.astype("<u4").tobytes())
                crc_out = self._crc & 0xFFFFFFFF if self._crc_valid else 0
                self._fh.write(struct.pack("<I", crc_out))
                end = self._fh.tell()
                # the ONE back-patched field: u64 inner length at base+12
                self._fh.seek(self._base + 12)
                self._fh.write(struct.pack("<Q", inner.bytes_written))
                self._fh.seek(end)
            except BaseException:
                self._discard()
                raise
            self.stats = StreamStats(
                total_frames=self._t, num_segments=inner.num_segments,
                bytes_written=end - self._base,
                source_crc32=crc_out)
            return self.stats
        finally:
            if self._owns_fh and not self._fh.closed:
                self._fh.close()

    def _discard(self) -> None:
        """Failure/abort cleanup: fresh streams truncate to the start; an
        APPEND restores the inner writer's header/trailer and the outer
        header/tables, leaving the original container intact."""
        if self._fh.closed:
            return
        if self._restore is not None:
            self._inner._discard()  # inner header + trailer back in place
            end, tables, head = self._restore
            self._fh.truncate(end)
            self._fh.seek(end)
            self._fh.write(tables)
            self._fh.seek(self._base)
            self._fh.write(head)
        else:
            self._fh.seek(self._base)
            self._fh.truncate(self._base)

    def abort(self) -> None:
        """Discard everything written and close the sink without
        finalizing; in append mode the original container is restored."""
        if self._fh.closed:
            return
        try:
            if self._restore is not None:
                self._discard()
                self._inner._poison()  # any inner kind refuses pushes
            else:
                self._inner.abort()
                self._fh.seek(self._base)
                self._fh.truncate(self._base)
        finally:
            if self._owns_fh:
                self._fh.close()

    def __enter__(self) -> "TemporalStreamingEncoder":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()


class MHTSStreamingEncoder:
    """Streaming MHTS writer: push frames, each becomes a self-contained
    per-frame-table record written immediately.

    MHTS is the MOST naturally streamable container in the format — every
    record is a complete MHT1 blob (its own canonical table, offsets, and
    recorded source CRC), and the only future-dependent header field is
    the u32 frame count, back-patched on ``close()``. Peak memory is ONE
    frame (raw + its encoded record), independent of stream length.

    Byte contract: for the same frames and config, the file equals the
    batch ``frame_stream.write_stream(frame_stream.encode_frames(frames,
    cfg), h, w, cfg, source_crc32s=[crc32(f) for f in frames])`` —
    exactly the CLI's ``encode-video --per-frame-tables`` bytes — no
    matter how frames were chunked across ``push()`` (gated by test).

    Reference analog: the per-frame self-contained encode loop,
    ``HuffmanUtil.cpp:1051-1131`` — which never holds more than the frame
    it is encoding; this preserves that property at container scale,
    where the batch writer did not.
    """

    def __init__(
        self,
        sink,
        height: int,
        width: int,
        config: CodecConfig | None = None,
        append: bool = False,
    ) -> None:
        from .image_codec import ImageCodec

        cfg = config or CodecConfig()
        if cfg.temporal:
            raise ValueError(
                "MHTSStreamingEncoder writes per-frame-table records; "
                "temporal (MHVT) wraps shared-table streams — drop one")
        if (cfg.zero_init or cfg.delta2d) and not cfg.delta:
            raise ValueError("zero_init/delta2d require delta precoding")
        if height <= 0 or width <= 0:
            raise ValueError("frame geometry must be positive")
        self._cfg = cfg
        self._codec = ImageCodec(cfg)
        self._h, self._w = int(height), int(width)
        self._t = 0
        self._crc = 0  # chained, for stats only (MHTS records per-frame)
        self._restore: tuple | None = None
        self.stats: StreamStats | None = None

        if isinstance(sink, (str, Path)):
            self._fh: io.IOBase = open(sink, "r+b" if append else "wb")
            self._owns_fh = True
        else:
            self._fh = sink
            self._owns_fh = False
        if not (self._fh.seekable() and self._fh.writable()):
            if self._owns_fh:
                self._fh.close()
            raise ValueError(
                "sink must be a seekable writable binary file (the MHTS "
                "frame count is patched on close)")
        self._base = self._fh.tell()
        try:
            if append:
                self._open_for_append()
            else:
                self._fh.write(frame_stream.STREAM_MAGIC)
                self._fh.write(struct.pack("<I", 0))  # patched on close
        except BaseException:
            if self._owns_fh:
                self._fh.close()
            raise

    def _open_for_append(self) -> None:
        """Resume/append: records are self-contained, so appending to an
        MHTS is a seek to the end + a count patch at close — the walk
        reads only each record's 18-byte head (geometry validation),
        never the payloads. New records may use a different precoder
        (mixed per-record modes are a decoded surface already). Failure
        truncates back to the original end: the pre-existing container
        survives."""
        fh = self._fh
        fh.seek(0, 2)
        fsize = fh.tell()
        fh.seek(self._base)
        head = fh.read(8)
        if len(head) < 8 or head[:4] != frame_stream.STREAM_MAGIC:
            raise ValueError("append needs an existing MHTS container")
        (count,) = struct.unpack_from("<I", head, 4)
        if count == 0:
            raise ValueError("empty MHTS stream")
        pos = self._base + 8
        for i in range(count):
            fh.seek(pos)
            rec = fh.read(22)
            if len(rec) < 22:
                raise ValueError(
                    f"truncated MHTS container (record {i} incomplete)")
            (rec_len,) = struct.unpack_from("<I", rec, 0)
            h, w, _nb, bd, mode = struct.unpack_from("<IIIBB", rec, 8)
            if (h, w) != (self._h, self._w):
                raise ValueError(
                    f"existing container is {h}x{w}, not "
                    f"{self._h}x{self._w}")
            if bd != self._cfg.block_dim:
                raise ValueError(
                    f"existing container uses block_dim={bd}, the "
                    f"config says {self._cfg.block_dim}")
            if (mode != 0) != bool(self._cfg.delta):
                # batch readers require one delta-ness across records
                # (per-record PREDICTORS may differ; delta vs none not)
                raise ValueError(
                    "existing container records "
                    + ("delta" if mode else "non-delta")
                    + " frames — append must keep the same delta-ness "
                    "(per-record delta/delta2d predictors may differ)")
            pos += 4 + rec_len
            if pos > fsize:
                # never truncate(pos) past EOF: that would zero-EXTEND a
                # truncated file and bake the corruption in silently
                raise ValueError(
                    f"truncated MHTS container (record {i} payload ends "
                    "past the file)")
        self._t = count
        self._restore = (pos, head)
        fh.truncate(pos)
        fh.seek(pos)

    def push(self, frames: np.ndarray) -> None:
        """Encode + write frame(s) immediately — no segment buffering.

        Validation raises before any state change; an encode/write
        failure truncates the sink (no torn container), as with the
        other streaming writers.
        """
        if self.stats is not None or self._fh.closed:
            raise ValueError("push() after close()")
        arr = np.asarray(frames)
        if arr.ndim == 2:
            arr = arr[None]
        if arr.ndim != 3 or arr.shape[1:] != (self._h, self._w):
            raise ValueError(
                f"expected (T, {self._h}, {self._w}) frames, got "
                f"{arr.shape}")
        if arr.dtype != np.uint8:
            raise ValueError("frames must be uint8")
        try:
            for f in arr:
                fc = np.ascontiguousarray(f)
                crc = zlib.crc32(fc)
                self._crc = zlib.crc32(fc, self._crc)
                rec = container.write_frame(
                    self._codec.encode(fc), self._h, self._w,
                    self._cfg.block_dim, self._cfg.delta, source_crc32=crc)
                self._fh.write(struct.pack("<I", len(rec)))
                self._fh.write(rec)
                self._t += 1
        except BaseException:
            self.abort()
            raise

    def close(self) -> StreamStats:
        """Patch the frame count; a failed close truncates the sink."""
        if self.stats is not None:
            return self.stats
        if self._fh.closed:
            raise ValueError(
                "close() after a failed close()/abort() — the sink was "
                "truncated, there is no container to finalize")
        try:
            try:
                if self._t == 0:
                    raise ValueError("cannot encode an empty frame stack")
                end = self._fh.tell()
                self._fh.seek(self._base + 4)
                self._fh.write(struct.pack("<I", self._t))
                self._fh.seek(end)
            except BaseException:
                self._discard()
                raise
            self.stats = StreamStats(
                total_frames=self._t, num_segments=self._t,
                bytes_written=end - self._base,
                source_crc32=self._crc & 0xFFFFFFFF)
            return self.stats
        finally:
            if self._owns_fh and not self._fh.closed:
                self._fh.close()

    def _discard(self) -> None:
        """Failure/abort cleanup: truncate a fresh stream to nothing; an
        APPEND truncates back to the original end and restores the
        original count header."""
        if self._fh.closed:
            return
        if self._restore is not None:
            end, head = self._restore
            self._fh.truncate(end)
            self._fh.seek(self._base)
            self._fh.write(head)
        else:
            self._fh.seek(self._base)
            self._fh.truncate(self._base)

    def abort(self) -> None:
        """Discard everything written and close the sink without
        finalizing; in append mode the original container is restored."""
        if self._fh.closed:
            return
        try:
            self._discard()
        finally:
            if self._owns_fh:
                self._fh.close()

    def __enter__(self) -> "MHTSStreamingEncoder":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()
