"""Lossless container surgery: extract frame ranges and splice containers
WITHOUT re-encoding.

Counterpart of ``metalhuffman_tpu/models/surgery.py``; the outputs are
byte-identical to the JAX package's. The per-block bit-offset index makes
every frame's bits an addressable span, so a frame range can be cut out of a
container by TRIMMING the code bytes and rebasing the offsets — no decode,
no encode, bit-identical payloads. Splicing goes the other way: each input
becomes (or contributes) MHV2 segments, each keeping its own canonical
table. Integrity metadata survives for free: whole-payload CRCs combine
algebraically (``core.crc.crc32_combine``) from the inputs' recorded CRCs or
a sliced per-frame FCRC table — gigabytes of video are never re-read.

The reference has no containers at all (its encoded stream lives only in
memory, ``AAPLRenderer.m:577-585``); this is the editing/ingestion surface
a production codec needs. CLI: ``python -m metalhuffman_tpu_torch extract``
/ ``concat`` / ``resegment``.

Supported: MHTV, MHV2, MHTS (verbatim record splices — the per-frame
tables make it the easiest surgery in the format), MHTC video (plane
ranges), MHVT. An MHVT extract may start ANYWHERE: a start inside a
keyframe group re-encodes ONLY that group (the start frame becomes a
literal keyframe — at most keyint frames decode and re-encode) and splices
every later group losslessly; the output records the short first group
(``FLAG_FIRST_LEN``) so the fold's group boundaries stay on the original
keyframes. That decode is the only device work here: it runs B1 and the
folds on ``extract_video``'s ``device`` (default ``"cuda"``), where the JAX
package pins its host decoder. Concat requires whole keyframe groups on
every input but the last — the group fold restarts cleanly only at keyframe
boundaries.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import bitstream, blocks, container
from ..core.crc import crc32_concat
from . import color as color_mod, frame_stream, temporal as temporal_mod
from .config import CodecConfig


def _trim_stream(stream: container.EncodedStream, b0: int, b1: int,
                 block_size: int) -> container.EncodedStream:
    """Sub-stream of whole blocks [b0, b1) with TRIMMED code bytes.

    The slice starts at the first block's byte, offsets rebase by that
    whole-byte amount (preserving all //8 and %8 math), bits of foreign
    blocks in the final byte are masked to zero (byte-deterministic
    output), and the read-ahead pad is re-appended.
    """
    nb = int(stream.block_offsets.size)
    offs = stream.block_offsets.astype(np.int64)
    start_bit = int(offs[b0])
    total_bits = 8 * (stream.code_bytes.size - bitstream.READ_AHEAD_PAD_BYTES)
    end_bit = int(offs[b1]) if b1 < nb else total_bits
    lo_byte = start_bit // 8
    hi_byte = -(-end_bit // 8)
    code = np.concatenate([
        np.asarray(stream.code_bytes[lo_byte:hi_byte], np.uint8),
        np.zeros(bitstream.READ_AHEAD_PAD_BYTES, np.uint8)])
    if end_bit % 8:  # mask the next block's bits out of the final byte
        keep = end_bit % 8
        code[hi_byte - lo_byte - 1] &= (0xFF00 >> keep) & 0xFF
    init = None if stream.block_init is None else stream.block_init[b0:b1]
    return container.EncodedStream(
        (b1 - b0) * block_size, stream.widths, code,
        (offs[b0:b1] - 8 * lo_byte).astype(np.uint32), init,
        predictor=stream.predictor)


def _frame_nbytes(blob: bytes) -> int:
    """Raw byte length of ONE frame unit of a video container (for CRC
    combination): gray h*w, color h*w*C, u16 h*w*2."""
    if blob[:4] == color_mod.COLOR_MAGIC:
        inner, ch, _layout, kind, _cs = color_mod.unwrap(blob)
        per_plane = _frame_nbytes(inner)
        return per_plane * (2 if kind == color_mod.KIND_U16 else ch)
    if blob[:4] == frame_stream.SHARED_MAGIC:
        _s, _t, h, w, _bd, _d = frame_stream.read_shared(blob)
        return h * w
    segs, _t, h, w, _bd, _d = frame_stream.read_segmented(blob)
    return h * w


def _cfg_like(video: bytes) -> CodecConfig:
    """CodecConfig reproducing a video container's own coding mode, so a
    re-encoded span splices against it (concat checks geometry AND mode)."""
    if video[:4] == frame_stream.SHARED_MAGIC:
        stream, _t, _h, _w, bd, delta = frame_stream.read_shared(video)
    elif video[:4] == frame_stream.SEGMENTED_MAGIC:
        segs, _t, _h, _w, bd, delta = frame_stream.read_segmented(video)
        stream = segs[0][0]
    else:
        raise ValueError("not a video container")
    return dataclasses.replace(
        CodecConfig(), block_dim=bd, delta=delta,
        delta2d=stream.predictor == "2d",
        zero_init=stream.block_init is not None,
        temporal=False, motion=False, frame_crcs=False)


def _encode_like(inner: bytes, frames: np.ndarray) -> bytes:
    """Encode a residual stack into a NEW container of ``inner``'s kind and
    coding mode (block_dim, precoder, colorspace), so the result concats
    against spans trimmed losslessly out of ``inner``."""
    from .. import encode_video

    if inner[:4] == color_mod.COLOR_MAGIC:
        inner2, _ch, _layout, kind, cs = color_mod.unwrap(inner)
        cfg = _cfg_like(inner2)
        if kind == color_mod.KIND_U16:
            return color_mod.encode_gray16_to_bytes(frames, cfg)
        return color_mod.encode_color_video_to_bytes(frames, cfg,
                                                     colorspace=cs)
    return encode_video(frames, _cfg_like(inner))


def _mhts_spans(data: bytes):
    """MHTS -> (spans, count, geom, end): raw byte spans per record
    (INCLUDING each u32 length prefix), the declared frame count, the
    shared (h, w, bd, delta_bool) geometry, and the offset one past the
    last record. Length-checked so truncation is a clean ValueError.
    MHTS records are self-contained, so surgery on them is pure byte
    splicing — no trim, no rebase, no CRC algebra (each record carries
    its own per-frame CRC)."""
    import struct

    spans, geom = [], None
    count = pos = 0
    for i, off, rec_len in frame_stream._iter_record_spans(data):
        if rec_len < 18:
            raise ValueError(
                f"truncated MHTS container (record {i} incomplete)")
        h, w, _nb, bd, mode = struct.unpack_from("<IIIBB", data, off + 4)
        g = (h, w, bd, mode != 0)
        if geom is None:
            geom = g
        elif geom != g:
            raise ValueError("MHTS frames must share geometry")
        spans.append((off - 4, 4 + rec_len))
        pos = off + rec_len
        count = i + 1
    if geom is None:
        raise ValueError("empty MHTS stream")
    return spans, count, geom, pos


def _extract_mhts(data: bytes, a: int, b: int,
                  info: dict | None = None) -> bytes:
    """MHTS extract: records [a, b) copied verbatim + a new count — the
    easiest surgery in the format (per-frame CRCs travel inside the
    records)."""
    import struct

    spans, count, _geom, _end = _mhts_spans(data)
    if not 0 <= a < b <= count:
        raise ValueError(f"frames [{a}, {b}) out of range ({count} frames)")
    if info is not None:
        info["reencoded_frames"] = 0
    lo = spans[a][0]
    hi = spans[b - 1][0] + spans[b - 1][1]
    return (frame_stream.STREAM_MAGIC + struct.pack("<I", b - a)
            + data[lo:hi])


def _extract_temporal(data: bytes, a: int, b: int,
                      info: dict | None = None, device="cuda") -> bytes:
    """MHVT extract: lossless when ``a`` is a keyframe, else the FIRST
    group re-keys (decode + re-encode of < keyint frames) and every later
    group splices losslessly; the short first group is recorded in the
    output header (``FLAG_FIRST_LEN``) so group boundaries stay put."""
    inner, keyint, _crc, mvs, fcrcs, first_len = temporal_mod.unwrap(data)
    t_total = temporal_mod._inner_frame_count(inner)
    if t_total is None or not 0 <= a < b <= t_total:
        raise ValueError(f"frames [{a}, {b}) out of range")
    fb = _frame_nbytes(inner)
    fc = None if fcrcs is None else fcrcs[a:b]
    crc = (crc32_concat([(int(c), fb) for c in fc])
           if fc is not None and fc.size else 0)
    g = temporal_mod._group_start(a, keyint, first_len)
    if info is not None:
        # what the CLI reports: frames re-encoded by a mid-group start
        info["reencoded_frames"] = (
            0 if a == g
            else min(b, first_len if a < first_len else g + keyint) - a)
    if a == g:
        # keyframe start: bit-identical trim of every group
        # (frame indices pass through: the MHTC branch multiplies to plane
        # indices itself; _frame_nbytes already returns TRUE-frame bytes)
        new_inner = extract_video(inner, a, b)
        mv = None if mvs is None else mvs[a:b]
        out_fl = first_len - a if a < first_len else keyint
    else:
        # mid-group start: re-key ONLY this group, splice the rest. The
        # < keyint frames decode on the device; the re-encode is host work
        next_key = first_len if a < first_len else g + keyint
        cut = min(b, next_key)
        frames = temporal_mod.decode_temporal_range(data, a, cut,
                                                    device=device)
        if mvs is not None:
            # residuals [a+1, cut) are identical under the original
            # vectors (each predicts from the previous TRUE frame);
            # only frame a changes, residual -> literal keyframe
            mv_first = np.asarray(mvs[a:cut], np.int16).copy()
            mv_first[0] = 0
            res, mv_first = temporal_mod.temporal_encode_mc(
                frames, cut - a, mv_first)
        else:
            res = temporal_mod.temporal_encode(frames, cut - a)
            mv_first = None
        parts = [_encode_like(inner, res)]
        if cut < b:
            parts.append(extract_video(inner, cut, b))
        new_inner = concat_videos(parts)
        mv = (None if mvs is None
              else np.concatenate([mv_first, mvs[cut:b]]))
        out_fl = cut - a
    if not (out_fl < keyint and b - a > out_fl):
        out_fl = None  # full first group, or the stream ends inside it
    return temporal_mod.wrap(new_inner, keyint, source_crc32=crc,
                             mvs=mv, frame_crcs=fc, first_len=out_fl)


def extract_video(data: bytes, a: int, b: int,
                  info: dict | None = None, device="cuda") -> bytes:
    """Frames [a, b) of a video container -> a NEW standalone container,
    without re-encoding (bit-identical code spans, trimmed + rebased).

    The output records a whole-payload CRC combined from the input's
    per-frame FCRC table when present (and the sliced table itself);
    without a table the CRC is unrecorded (0) — extraction never decodes
    (except an MHVT start inside a keyframe group, which re-encodes THAT
    group only; see :func:`_extract_temporal`).

    ``info``, when given, is filled with what extraction actually did
    (``reencoded_frames``: 0 for a pure splice) so callers report it
    without re-deriving the keyframe-group math. ``device`` is where an
    MHVT mid-group start decodes; nothing else here touches a device.
    """
    if data[:4] == temporal_mod.TEMPORAL_MAGIC:
        return _extract_temporal(data, a, b, info, device)
    if data[:4] == frame_stream.STREAM_MAGIC:
        return _extract_mhts(data, a, b, info)
    if data[:4] == color_mod.COLOR_MAGIC:
        inner, ch, layout, kind, cs = color_mod.unwrap(data)
        if layout != color_mod.LAYOUT_VIDEO:
            raise ValueError("extract_video needs a video container")
        n = 2 if kind == color_mod.KIND_U16 else ch
        return color_mod.wrap(extract_video(inner, a * n, b * n), ch,
                              layout, kind, cs)
    if data[:4] == frame_stream.SHARED_MAGIC:
        stream, t, h, w, bd, delta = frame_stream.read_shared(data)
        segs = [(stream, t)]
    elif data[:4] == frame_stream.SEGMENTED_MAGIC:
        segs, t, h, w, bd, delta = frame_stream.read_segmented(data)
    else:
        raise ValueError("not a video container")
    if not 0 <= a < b <= t:
        raise ValueError(f"frames [{a}, {b}) out of range ({t} frames)")
    bh, bw = blocks.block_grid(h, w, bd)
    per = bh * bw
    out_segs, base = [], 0
    for stream, ft in segs:
        lo, hi = max(a, base), min(b, base + ft)
        if lo < hi:
            out_segs.append((_trim_stream(
                stream, (lo - base) * per, (hi - base) * per, bd * bd),
                hi - lo))
        base += ft
    cfg = dataclasses.replace(CodecConfig(), block_dim=bd, delta=delta)
    fcrcs = frame_stream.read_frame_crcs(data)
    fc = None if fcrcs is None else fcrcs[a:b]
    crc = (crc32_concat([(int(c), h * w) for c in fc])
           if fc is not None and fc.size else 0)
    if len(out_segs) == 1:
        return frame_stream.write_shared(
            out_segs[0][0], b - a, h, w, cfg, source_crc32=crc,
            frame_crcs=fc)
    return frame_stream.write_segmented(out_segs, h, w, cfg,
                                        source_crc32=crc, frame_crcs=fc)


def concat_videos(blobs: list[bytes]) -> bytes:
    """Splice video containers end to end WITHOUT re-encoding.

    Inputs must agree on geometry, block_dim, and precoder mode; each
    input's streams become MHV2 segments keeping their own canonical
    tables. Whole-payload CRC combines from the inputs' recorded CRCs
    (recorded only when EVERY input records one); FCRC tables concatenate
    when every input has one. MHVT inputs must agree on keyint/motion
    presence and every input but the last must contain whole keyframe
    groups (the group fold restarts only at keyframe boundaries).
    """
    if not blobs:
        raise ValueError("nothing to concatenate")
    if len(blobs) == 1:
        return blobs[0]
    kind = blobs[0][:4]

    def _family(magic: bytes) -> bytes:
        # MHTV and MHV2 are the same payload family (single- vs multi-
        # segment); the video branch below splices them freely
        return (b"MHV*" if magic in (frame_stream.SHARED_MAGIC,
                                     frame_stream.SEGMENTED_MAGIC)
                else magic)

    if any(_family(x[:4]) != _family(kind) for x in blobs):
        raise ValueError("cannot concatenate different container kinds")
    if kind == temporal_mod.TEMPORAL_MAGIC:
        parts = [temporal_mod.unwrap(x) for x in blobs]
        keyint = parts[0][1]
        if any(p[1] != keyint for p in parts):
            raise ValueError("MHVT inputs must share one keyint")
        has_mv = [p[3] is not None for p in parts]
        if any(has_mv) != all(has_mv):
            raise ValueError(
                "cannot mix motion-compensated and plain MHVT inputs")
        if any(p[5] != keyint for p in parts[1:]):
            raise ValueError(
                "an MHVT input with a short first keyframe group can only "
                "lead a splice (later inputs must start on a plain "
                "keyframe boundary); re-extract it with an aligned start")
        counts = [temporal_mod._inner_frame_count(p[0]) for p in parts]
        if any(c is None for c in counts):
            raise ValueError("corrupt MHVT container (unrecognized inner)")
        first_len = parts[0][5]
        for i, c in enumerate(counts[:-1]):
            fl = first_len if i == 0 else keyint
            if c < fl or (c - fl) % keyint:
                raise ValueError(
                    "every MHVT input but the last must contain whole "
                    f"keyframe groups (length {c} does not end on a "
                    f"keyframe boundary for keyint {keyint})")
        inner = concat_videos([p[0] for p in parts])
        mvs = (np.concatenate([p[3] for p in parts])
               if all(has_mv) else None)
        fcs = [p[4] for p in parts]
        fc = np.concatenate(fcs) if all(f is not None for f in fcs) else None
        fb = _frame_nbytes(parts[0][0])
        crcs = [p[2] for p in parts]
        crc = (crc32_concat(
            [(c, n * fb) for c, n in zip(crcs, counts)])
            if all(crcs) else 0)
        out_fl = first_len if first_len < keyint else None
        return temporal_mod.wrap(inner, keyint, source_crc32=crc, mvs=mvs,
                                 frame_crcs=fc, first_len=out_fl)
    if kind == frame_stream.STREAM_MAGIC:
        import struct

        total, geom, runs = 0, None, []
        for x in blobs:
            _spans, count, g, end = _mhts_spans(x)
            if geom is None:
                geom = g
            elif geom != g:
                raise ValueError(
                    f"geometry/mode mismatch: {geom} vs {g}")
            total += count
            runs.append(x[8:end])  # the record region, verbatim
        return (frame_stream.STREAM_MAGIC + struct.pack("<I", total)
                + b"".join(runs))
    if kind == color_mod.COLOR_MAGIC:
        parts = [color_mod.unwrap(x) for x in blobs]
        meta = {(p[1], p[2], p[3], p[4]) for p in parts}
        if len(meta) != 1:
            raise ValueError(
                "MHTC inputs must share channels/layout/kind/colorspace")
        ch, layout, k2, cs = meta.pop()
        if layout != color_mod.LAYOUT_VIDEO:
            raise ValueError("concat_videos needs video containers")
        return color_mod.wrap(concat_videos([p[0] for p in parts]), ch,
                              layout, k2, cs)
    all_segs, geom, crc_parts, fcs = [], None, [], []
    for x in blobs:
        if x[:4] == frame_stream.SHARED_MAGIC:
            stream, t, h, w, bd, delta = frame_stream.read_shared(x)
            segs = [(stream, t)]
        elif x[:4] == frame_stream.SEGMENTED_MAGIC:
            segs, t, h, w, bd, delta = frame_stream.read_segmented(x)
        else:
            raise ValueError("not a video container")
        if geom is None:
            geom = (h, w, bd, delta)
        elif geom != (h, w, bd, delta):
            raise ValueError(
                f"geometry/mode mismatch: {geom} vs {(h, w, bd, delta)}")
        all_segs.extend(segs)
        crc_parts.append((frame_stream.source_crc32(x), t * h * w))
        fcs.append(frame_stream.read_frame_crcs(x))
    h, w, bd, delta = geom
    cfg = dataclasses.replace(CodecConfig(), block_dim=bd, delta=delta)
    crc = (crc32_concat(crc_parts) if all(c for c, _ in crc_parts) else 0)
    fc = (np.concatenate(fcs) if all(f is not None for f in fcs) else None)
    return frame_stream.write_segmented(all_segs, h, w, cfg,
                                        source_crc32=crc, frame_crcs=fc)


def resegment_video(data: bytes, frames_per_segment: int) -> bytes:
    """Re-cut a video container's SEGMENT structure without re-encoding.

    Any MHTV/MHV2 — bare, inside MHTC (color/u16), or inside MHVT — becomes
    an MHV2 whose segments hold at most ``frames_per_segment`` frames, each
    a bit-identical trimmed span of an input segment (:func:`_trim_stream`;
    the canonical table repeats per segment — a few hundred bytes each is
    the only growth). Purpose: a monolithic archive gains the segment
    granularity that bounds streamed-decode memory
    (``decode-video --streaming``) and random-access staging.

    Segments can only be SPLIT this way, never merged: each carries its own
    canonical table, so joining spans from different tables would need a
    re-encode (input segments already shorter than the target stay as
    they are). Whole-payload CRC and any FCRC table carry over verbatim —
    the payload is unchanged. ``frames_per_segment`` counts TRUE frames at
    every level (planes for MHTC inners, residuals for MHVT are 1:1).
    """
    if frames_per_segment < 1:
        raise ValueError("frames_per_segment must be >= 1")
    if data[:4] == frame_stream.STREAM_MAGIC:
        raise ValueError(
            "MHTS has no segment structure to re-cut — every record is "
            "already self-contained (streaming decode reads it one frame "
            "at a time); use extract/concat for range surgery")
    if data[:4] == temporal_mod.TEMPORAL_MAGIC:
        inner, keyint, crc, mvs, fcrcs, first_len = temporal_mod.unwrap(data)
        return temporal_mod.wrap(
            resegment_video(inner, frames_per_segment), keyint,
            source_crc32=crc, mvs=mvs, frame_crcs=fcrcs,
            first_len=first_len)
    if data[:4] == color_mod.COLOR_MAGIC:
        inner, ch, layout, kind, cs = color_mod.unwrap(data)
        if layout != color_mod.LAYOUT_VIDEO:
            raise ValueError("resegment_video needs a video container")
        n = 2 if kind == color_mod.KIND_U16 else ch
        return color_mod.wrap(
            resegment_video(inner, frames_per_segment * n), ch, layout,
            kind, cs)
    if data[:4] == frame_stream.SHARED_MAGIC:
        stream, t, h, w, bd, delta = frame_stream.read_shared(data)
        segs = [(stream, t)]
    elif data[:4] == frame_stream.SEGMENTED_MAGIC:
        segs, t, h, w, bd, delta = frame_stream.read_segmented(data)
    else:
        raise ValueError("not a video container")
    bh, bw = blocks.block_grid(h, w, bd)
    per_blk = bh * bw
    out_segs = []
    for stream, ft in segs:
        for s in range(0, ft, frames_per_segment):
            take = min(frames_per_segment, ft - s)
            out_segs.append((_trim_stream(
                stream, s * per_blk, (s + take) * per_blk, bd * bd), take))
    cfg = dataclasses.replace(CodecConfig(), block_dim=bd, delta=delta)
    return frame_stream.write_segmented(
        out_segs, h, w, cfg,
        source_crc32=frame_stream.source_crc32(data),
        frame_crcs=frame_stream.read_frame_crcs(data))


# -- constant-memory file-to-file splicing ------------------------------------


def _scan_concat_source(view) -> dict:
    """Header-walk a bare MHTV/MHV2 buffer into segment-record SPANS.

    Returns geometry/mode, the recorded trailer CRC / FCRC table, and each
    segment record as a parts list — literal ``bytes`` to emit, or
    ``(offset, length)`` spans of ``view`` to copy — WITHOUT materializing
    core blobs: the whole scan reads fixed headers plus the (small) CRC
    tables, so :func:`concat_videos_streamed` runs at copy speed in
    constant memory.
    """
    import struct

    try:
        head = bytes(view[:4])
        if head == frame_stream.SHARED_MAGIC:
            t, h, w, nb, bd, mode = struct.unpack_from("<IIIIBB", view, 4)
            (core_len,) = struct.unpack_from("<I", view, 22)
            body = core_len + 4 * nb + (nb if mode in (2, 4) else 0)
            if 26 + body > len(view):
                raise ValueError("truncated container (payload incomplete)")
            # an MHTV payload becomes ONE MHV2 segment record: the 12-byte
            # record header is synthesized, core/offsets/init copy verbatim
            recs = [(t, [struct.pack("<III", t, nb, core_len), (26, body)])]
            tail = 26 + body
        elif head == frame_stream.SEGMENTED_MAGIC:
            t, h, w, bd, mode, n_seg = struct.unpack_from("<IIIBBI", view, 4)
            pos = 4 + 18
            recs = []
            for _ in range(n_seg):
                ft, nb, core_len = struct.unpack_from("<III", view, pos)
                rec_len = (12 + core_len + 4 * nb
                           + (nb if mode in (2, 4) else 0))
                if pos + rec_len > len(view):
                    raise ValueError(
                        "truncated container (segment record incomplete)")
                recs.append((ft, [(pos, rec_len)]))
                pos += rec_len
            tail = pos
        else:
            raise ValueError("not a video container")
    except struct.error:
        raise ValueError("truncated container (header incomplete)")
    # trailer detected by length, like source_crc32: containers written
    # before the CRC trailer existed parse as unrecorded, not as errors
    crc = (struct.unpack_from("<I", view, tail)[0]
           if tail + 4 <= len(view) else 0)
    fcrcs = None
    if (tail + 12 <= len(view)
            and bytes(view[tail + 4 : tail + 8]) == frame_stream.FRAME_CRC_MAGIC):
        (n,) = struct.unpack_from("<I", view, tail + 8)
        if tail + 12 + 4 * n > len(view):
            raise ValueError("truncated FCRC table")
        fcrcs = np.frombuffer(view, "<u4", count=n,
                              offset=tail + 12).astype(np.uint32)
    return dict(t=t, h=h, w=w, bd=bd, mode=mode, recs=recs, crc=crc,
                fcrcs=fcrcs)


def concat_videos_streamed(inputs, output) -> dict:
    """Splice video FILES end to end at constant memory (mmap -> copy).

    The file-to-file form of :func:`concat_videos` for archives bigger
    than RAM: inputs are memory-mapped, their segment records are copied
    span-by-span into the output (an MHTV payload becomes one MHV2
    segment record — only its 12-byte record header is synthesized), and
    the combined trailer is computed algebraically (``crc32_concat`` over
    the recorded CRCs; FCRC tables concatenate) exactly as the in-memory
    splice does. The output is byte-identical to
    ``concat_videos([Path(p).read_bytes() for p in inputs])``.

    Bare MHTV/MHV2 and MHTC (identical 8-byte wrapper headers) only;
    MHVT needs the in-memory splice (its wrapper header carries the
    whole-stream motion/CRC tables and group-alignment checks).

    Returns ``{"frames", "segments", "bytes"}`` for reporting.
    """
    import mmap
    import os
    import struct
    from pathlib import Path

    if not inputs:
        raise ValueError("nothing to concatenate")
    # the output is opened 'wb' while the inputs stay mmapped: writing
    # onto an input would truncate a live copy SOURCE (data loss + a
    # SIGBUS reading the vanished pages) — refuse up front
    out_res = Path(output).resolve()
    for p in inputs:
        pp = Path(p)
        if (pp.resolve() == out_res
                or (pp.exists() and out_res.exists()
                    and os.path.samefile(pp, out_res))):
            raise ValueError(
                f"output {output!s} is also an input — the streamed "
                "splice would truncate its own source; write to a new "
                "file (the in-memory concat_videos can splice in place)")
    if len(inputs) == 1:
        # match concat_videos([blob]) -> blob verbatim: scan for the
        # report, then a chunked file copy — constant memory either way
        import shutil

        src = Path(inputs[0])
        with open(src, "rb") as fin:
            m = mmap.mmap(fin.fileno(), 0, access=mmap.ACCESS_READ)
            v = memoryview(m)
            body = v[8:] if bytes(v[:4]) == color_mod.COLOR_MAGIC else v
            try:
                if bytes(v[:4]) == temporal_mod.TEMPORAL_MAGIC:
                    raise ValueError(
                        "concat_videos_streamed splices MHTV/MHV2/MHTC "
                        "files; MHVT wrappers need the in-memory "
                        "concat_videos")
                s = _scan_concat_source(body)
                info = {"frames": s["t"], "segments": len(s["recs"]),
                        "bytes": src.stat().st_size,
                        "crc_recorded": bool(s["crc"])}
            finally:
                # release the slice too: a traceback that holds the
                # scan's frame keeps it alive, and mmap.close() refuses
                # while any view exists
                body.release()
                v.release()
                m.close()
        with open(src, "rb") as fin, open(Path(output), "wb") as fout:
            shutil.copyfileobj(fin, fout, 8 << 20)
        return info
    files = [open(Path(p), "rb") for p in inputs]
    maps: list = []
    all_views: list = []  # every view ever taken, released before the maps
    try:
        maps = [mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                for f in files]
        views = [memoryview(m) for m in maps]
        all_views += views
        magics = [bytes(v[:4]) for v in views]
        if any(m == temporal_mod.TEMPORAL_MAGIC for m in magics):
            raise ValueError(
                "concat_videos_streamed splices MHTV/MHV2/MHTC files; "
                "MHVT wrappers need the in-memory concat_videos (their "
                "header carries whole-stream motion/CRC tables)")
        color_head = b""
        if magics[0] == color_mod.COLOR_MAGIC:
            heads = {bytes(v[:8]) for v in views}
            if len(heads) != 1:
                raise ValueError(
                    "MHTC inputs must share channels/layout/kind/colorspace")
            color_head = heads.pop()
            if color_head[5] != color_mod.LAYOUT_VIDEO:
                raise ValueError("concat needs video containers")
            views = [v[8:] for v in views]
            all_views += views
        scans = [_scan_concat_source(v) for v in views]
        geom = {(s["h"], s["w"], s["bd"], s["mode"]) for s in scans}
        if len(geom) != 1:
            raise ValueError(f"geometry/mode mismatch across inputs: {geom}")
        h, w, bd, mode = geom.pop()
        total = sum(s["t"] for s in scans)
        n_seg = sum(len(s["recs"]) for s in scans)
        crc = (crc32_concat([(s["crc"], s["t"] * h * w) for s in scans])
               if all(s["crc"] for s in scans) else 0)
        fc = (np.concatenate([s["fcrcs"] for s in scans])
              if all(s["fcrcs"] is not None for s in scans) else None)
        written = 0
        with open(Path(output), "wb") as out:
            def emit(b):
                nonlocal written
                out.write(b)
                written += len(b)

            emit(color_head)
            emit(frame_stream.SEGMENTED_MAGIC + struct.pack(
                "<IIIBBI", total, h, w, bd, mode, n_seg))
            for s, v in zip(scans, views):
                for _ft, parts in s["recs"]:
                    for p in parts:
                        if isinstance(p, bytes):
                            emit(p)
                        else:
                            off, ln = p
                            step = 8 << 20  # copy spans in 8 MB slices
                            for a in range(off, off + ln, step):
                                emit(v[a : min(a + step, off + ln)])
            emit(struct.pack("<I", crc & 0xFFFFFFFF))
            if fc is not None:
                emit(frame_stream.FRAME_CRC_MAGIC
                     + struct.pack("<I", fc.shape[0])
                     + fc.astype("<u4").tobytes())
        return {"frames": total, "segments": n_seg, "bytes": written,
                "crc_recorded": bool(crc)}
    finally:
        # release views BEFORE closing the maps (an exported view keeps
        # mmap.close() raising BufferError), and do it explicitly rather
        # than leaning on refcount GC — a traceback holding these frames
        # would otherwise pin large mappings alive
        for v in reversed(all_views):
            v.release()
        for mp in maps:
            mp.close()
        for fobj in files:
            fobj.close()


def resegment_video_streamed(input_path, output_path,
                             frames_per_segment: int) -> dict:
    """File-to-file :func:`resegment_video` at constant memory.

    The archives resegmenting exists for — monolithic files bigger than
    RAM — cannot go through the in-memory path (it materializes trimmed
    copies of every segment). This walker re-cuts them mmap-to-file:
    widths/code/init regions copy as byte spans (the final code byte of
    each cut is masked exactly as :func:`_trim_stream` does), and each
    output segment's offset table is rebased in bounded chunks. Output is
    **byte-identical** to ``resegment_video(data, n)`` (gated by test).
    Bare MHTV/MHV2 and MHTC; MHVT routes through the in-memory form (its
    wrapper tables are header-resident and small anyway).

    Returns ``{"frames", "segments", "bytes", "crc_recorded"}``.
    """
    import mmap
    import os
    import struct
    from pathlib import Path

    if frames_per_segment < 1:
        raise ValueError("frames_per_segment must be >= 1")
    src, dst = Path(input_path), Path(output_path)
    if (src.resolve() == dst.resolve()
            or (src.exists() and dst.exists()
                and os.path.samefile(src, dst))):
        raise ValueError(
            "output path is also the input — the streamed re-cut would "
            "truncate its own source; write to a new file")
    per = int(frames_per_segment)
    written = 0
    with open(src, "rb") as fin, open(dst, "wb") as out:
        m = mmap.mmap(fin.fileno(), 0, access=mmap.ACCESS_READ)
        view = memoryview(m)
        sub = None
        try:
            def emit(b):
                nonlocal written
                out.write(b)
                written += len(b)

            def emit_span(buf, off, ln, mask_last=None):
                step = 8 << 20
                end = off + ln
                last = end - (1 if mask_last is not None else 0)
                for a in range(off, last, step):
                    emit(buf[a : min(a + step, last)])
                if mask_last is not None:
                    emit(bytes([buf[end - 1] & mask_last]))

            if bytes(view[:4]) == temporal_mod.TEMPORAL_MAGIC:
                raise ValueError(
                    "resegment_video_streamed re-cuts MHTV/MHV2/MHTC "
                    "files; MHVT routes through resegment_video (its "
                    "wrapper tables are header-resident)")
            base = 0
            if bytes(view[:4]) == color_mod.COLOR_MAGIC:
                ch, layout, kind, _cs = struct.unpack_from("<BBBB", view, 4)
                if layout != color_mod.LAYOUT_VIDEO:
                    raise ValueError(
                        "resegment_video needs a video container")
                emit(bytes(view[:8]))
                base = 8
                per *= 2 if kind == color_mod.KIND_U16 else ch
            sub = view[base:]
            scan = _scan_concat_source(sub)
            h, w, bd, mode = scan["h"], scan["w"], scan["bd"], scan["mode"]
            bh, bw = blocks.block_grid(h, w, bd)
            per_blk = bh * bw
            # field offsets per input record (scan spans are whole records)
            fields = []
            for ft, parts in scan["recs"]:
                if isinstance(parts[0], bytes):  # MHTV: synthesized header
                    core_off, core_len = 26, struct.unpack("<III",
                                                           parts[0])[2]
                else:
                    rec_off = parts[0][0]
                    _ft, _nb, core_len = struct.unpack_from(
                        "<III", sub, rec_off)
                    core_off = rec_off + 12
                offs_off = core_off + core_len
                init_off = offs_off + 4 * ft * per_blk
                fields.append((ft, core_off, core_len, offs_off, init_off))
            n_out = sum(-(-ft // per) for ft, *_ in fields)
            emit(frame_stream.SEGMENTED_MAGIC + struct.pack(
                "<IIIBBI", scan["t"], h, w, bd, mode, n_out))
            for ft, core_off, core_len, offs_off, init_off in fields:
                nb = ft * per_blk
                code_off = core_off + 264
                total_bits = 8 * (core_len - 264
                                  - bitstream.READ_AHEAD_PAD_BYTES)
                for s in range(0, ft, per):
                    take = min(per, ft - s)
                    b0, b1 = s * per_blk, (s + take) * per_blk
                    (start_bit,) = struct.unpack_from(
                        "<I", sub, offs_off + 4 * b0)
                    end_bit = (struct.unpack_from(
                        "<I", sub, offs_off + 4 * b1)[0]
                        if b1 < nb else total_bits)
                    lo, hi = start_bit // 8, -(-end_bit // 8)
                    core_out = (264 + (hi - lo)
                                + bitstream.READ_AHEAD_PAD_BYTES)
                    emit(struct.pack("<III", take, b1 - b0, core_out))
                    emit(struct.pack("<II", container.MAGIC,
                                     (b1 - b0) * bd * bd))
                    emit_span(sub, core_off + 8, 256)  # canonical width table
                    keep = end_bit % 8
                    emit_span(sub, code_off + lo, hi - lo,
                              mask_last=((0xFF00 >> keep) & 0xFF
                                         if keep else None))
                    emit(b"\x00" * bitstream.READ_AHEAD_PAD_BYTES)
                    # offset table, rebased in bounded chunks
                    step = 1 << 20
                    for a in range(b0, b1, step):
                        n = min(step, b1 - a)
                        offs = np.frombuffer(
                            sub, "<u4", count=n,
                            offset=offs_off + 4 * a).astype(np.int64)
                        emit((offs - 8 * lo).astype("<u4").tobytes())
                    if mode in (2, 4):
                        emit_span(sub, init_off + b0, b1 - b0)
            emit(struct.pack("<I", scan["crc"] & 0xFFFFFFFF))
            if scan["fcrcs"] is not None:
                emit(frame_stream.FRAME_CRC_MAGIC
                     + struct.pack("<I", scan["fcrcs"].shape[0])
                     + scan["fcrcs"].astype("<u4").tobytes())
            return {"frames": scan["t"], "segments": n_out,
                    "bytes": written, "crc_recorded": bool(scan["crc"])}
        finally:
            # release the slice explicitly: a traceback that holds the
            # walk's frames keeps it alive, and mmap.close() refuses while
            # any view exists (the BufferError would replace the error)
            if sub is not None:
                sub.release()
            view.release()
            m.close()
