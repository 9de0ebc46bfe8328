"""The MHVT temporal fold on the card: the CUDA kernel's wrapper, the tables
the host builds for it, and a NumPy emulation of the kernel's walk.

``csrc/temporal_fold.cu`` folds every keyframe group of a (T, H, W[, C])
uint8 or uint16 stack of residual frames in place, in one launch: a CUDA
block owns whole keyframe rows of one group, keeps their previous frame in
shared memory (rows too wide for it: reads it back from device memory) and
walks the group's slots, so each residual is read once and each frame
written once (the source's note has the design). The plain
versions are the torch folds of ``models/temporal.py`` (``temporal_fold``,
``temporal_fold_mc``), which fold CPU tensors; those route a CUDA tensor
here, and :func:`fold` launches the kernel or raises.

The host side is :func:`fold_tables`: the groups of ``temporal._groups`` as
a table of (keyframe, length) and, per frame, the row shift accumulated from
the group's keyframe and the frame's own column shift in bytes, a few dozen
ints passed to the kernel by value (no copy to the card, no stream
synchronisation). Groups that need more frames than one table holds split
into launches of whole groups; a group longer than a table into pieces that
overlap by one frame (a piece's keyframe is the frame its predecessor
folded last). :func:`emulate` walks a table over a NumPy stack with the
kernel's indexing (its chunks, their misalignment and the wrap seam), which
the CPU tests hold to the host folds and the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: kernel launches made by :func:`fold` in this process
launches = {"temporal_fold": 0}

#: ``csrc/temporal_fold.cu``'s constants: threads of a CUDA block, the
#: chunks a thread loads at once, the frames and groups of one table, the
#: dynamic shared memory a block may take on the H100
THREADS = 256
CHUNKS_PER_THREAD = 4
TABLE_FRAMES = 256
TABLE_GROUPS = 128
SMEM_MAX = 232448
#: int32s of a table as the C entry reads it: n_groups, start, len, cy, sx
TABLE_INTS = 1 + 2 * TABLE_GROUPS + 2 * TABLE_FRAMES


def is_card(frames: torch.Tensor) -> bool:
    """True for a tensor the kernel folds (on a CUDA device)."""
    return frames.device.type == "cuda"


def fold_geometry(h: int, row_bytes: int,
                  ptr: int) -> tuple[int, int, bool]:
    """(bytes a thread moves at once, keyframe rows of a CUDA block, whether
    the block keeps the previous frame in shared memory) for frames of ``h``
    rows of ``row_bytes`` bytes at address ``ptr``: the widest access of 16,
    8, 4, 2 or 1 bytes that every row start allows, and rows enough for
    ``THREADS * CHUNKS_PER_THREAD`` chunks, within the shared memory of the
    two buffers of the previous frame; rows of which two do not fit there
    (over ``SMEM_MAX // 2`` bytes) read it back from device memory."""
    vec = next(v for v in (16, 8, 4, 2, 1)
               if row_bytes % v == 0 and ptr % v == 0)
    rows = min(h, max(1, THREADS * CHUNKS_PER_THREAD // (row_bytes // vec)))
    most = SMEM_MAX // (2 * _pitch(row_bytes))
    if most < 1:
        return vec, rows, False
    return vec, min(rows, most), True


def _pitch(row_bytes: int) -> int:
    """A row's bytes in the kernel's shared memory (16-byte aligned)."""
    return -(-row_bytes // 16) * 16


def fold_tables(spans, mv, h: int, pixel_bytes: int) -> list:
    """The kernel's launches for the keyframe groups ``spans`` ((start,
    groups, length), ``temporal._groups``) -> [(first frame, (TABLE_INTS,)
    int32 table)], frames of the table counted from the first.

    ``mv``: (T, 2) int64 vectors already reduced mod (H, W), or None for
    the group fold. A frame's row shift ``cy`` is the group's vectors' rows
    summed from the keyframe, mod ``h``; its column shift ``sx`` its own
    vector's column in bytes. A group of one frame has nothing to fold and
    no entry."""
    pieces = []
    for start, groups, n in spans:
        if n < 2:
            continue
        for k in range(start, start + groups * n, n):
            end = k + n
            while True:
                stop = min(end, k + TABLE_FRAMES)
                pieces.append((k, stop - k))
                if stop == end:
                    break
                k = stop - 1  # the next piece opens on this one's last frame
    moves = None if mv is None else mv.tolist()
    out = []
    i = 0
    while i < len(pieces):
        frame0 = pieces[i][0]
        j = i + 1
        while (j < len(pieces) and j - i < TABLE_GROUPS
               and pieces[j][0] >= sum(pieces[j - 1])
               and sum(pieces[j]) - frame0 <= TABLE_FRAMES):
            j += 1
        table = np.zeros(TABLE_INTS, np.int32)
        table[0] = j - i
        table[1 : 1 + j - i] = [k - frame0 for k, _ in pieces[i:j]]
        table[1 + TABLE_GROUPS : 1 + TABLE_GROUPS + j - i] = [
            n for _, n in pieces[i:j]]
        if moves is not None:
            cy, sx = [], []  # frames frame0 .. the last piece's end
            for k, n in pieces[i:j]:
                pad = k - frame0 - len(cy)  # frames of no piece, read never
                cy += [0] * (pad + 1)
                sx += [0] * (pad + 1)
                acc = 0
                for dy, dx in moves[k + 1 : k + n]:
                    acc = (acc + dy) % h
                    cy.append(acc)
                    sx.append(dx * pixel_bytes)
            at = 1 + 2 * TABLE_GROUPS
            table[at : at + len(cy)] = cy
            table[at + TABLE_FRAMES : at + TABLE_FRAMES + len(sx)] = sx
        out.append((frame0, table))
        i = j
    return out


def fold(frames: torch.Tensor, spans, mv=None) -> torch.Tensor:
    """Fold the keyframe groups ``spans`` of ``frames`` (a contiguous (T,
    H, W[, C]) uint8 or uint16 CUDA tensor) in place with the kernel, on
    the current stream, motion-compensated by ``mv`` ((T, 2) int64 reduced
    mod (H, W)) or with none; returns ``frames``. One launch per table of
    :func:`fold_tables`; raises on anything the kernel does not take and if
    the launch fails."""
    from .. import _build

    if not is_card(frames):
        raise ValueError(f"the CUDA fold needs a CUDA tensor, not one on "
                         f"{frames.device}")
    if frames.dtype not in (torch.uint8, torch.uint16):
        raise ValueError("temporal prediction needs uint8/uint16 frames")
    if not frames.is_contiguous():
        raise ValueError("the folds work in place on a contiguous tensor")
    if frames.dim() < 3:
        raise ValueError("frames must be (T, H, W[, C])")
    t, h, w = frames.shape[:3]
    if mv is not None and np.shape(mv) != (t, 2):
        raise ValueError("the motion table must be (T, 2)")
    if frames.numel() == 0:
        return frames
    pixel_bytes = frames.element_size() * math.prod(frames.shape[3:])
    row_bytes = w * pixel_bytes
    vec, rows, shared = fold_geometry(h, row_bytes, frames.data_ptr())
    frame_bytes = h * row_bytes
    for frame0, table in fold_tables(spans, mv, h, pixel_bytes):
        _build.launch("temporal_fold", frames.device,
                      frames.data_ptr() + frame0 * frame_bytes, h, row_bytes,
                      frames.element_size(), vec, rows, int(shared),
                      table.ctypes.data)
        launches["temporal_fold"] += 1
    return frames


def emulate(stack: np.ndarray, table: np.ndarray, vec: int,
            elem_bytes: int) -> None:
    """The kernel's walk of one ``table`` over ``stack``, in NumPy, in
    place: ``stack`` is the (frames, H, row bytes) uint8 view of the frames
    from the launch's first, ``vec`` and ``elem_bytes`` as the launch's.

    As each CUDA block does for its rows: the keyframe's rows are the
    chains' previous frame; at each slot chain row r sits at image row (r +
    cy) mod H, and the chunk of ``vec`` bytes at column c adds the previous
    frame's bytes from c - sx (mod the row) on, taken from the two aligned
    chunks that cover them (the second wrapped to 0 at the row's end), in
    the element type."""
    dtype = np.uint8 if elem_bytes == 1 else np.dtype("<u2")
    _t, h, rb = stack.shape
    n_groups = int(table[0])
    starts = table[1 : 1 + TABLE_GROUPS]
    lens = table[1 + TABLE_GROUPS : 1 + 2 * TABLE_GROUPS]
    cys = table[1 + 2 * TABLE_GROUPS : 1 + 2 * TABLE_GROUPS + TABLE_FRAMES]
    sxs = table[1 + 2 * TABLE_GROUPS + TABLE_FRAMES :]
    cols = np.arange(0, rb, vec)
    lane = np.arange(vec)
    for g in range(n_groups):
        k, n = int(starts[g]), int(lens[g])
        prev = stack[k].copy()
        for f in range(k + 1, k + n):
            cy, sh = int(cys[f]), int(sxs[f])
            a = (rb - sh) % vec
            o = cols - sh
            o[o < 0] += rb
            c0 = o - a
            c1 = c0 + vec
            c1[c1 == rb] = 0
            both = np.concatenate([c0[:, None] + lane, c1[:, None] + lane], 1)
            window = np.ascontiguousarray(
                prev[:, both[:, a : a + vec].ravel()])
            rows = (np.arange(h) + cy) % h
            out = (stack[f][rows].view(dtype) + window.view(dtype)).view(
                np.uint8)
            stack[f][rows] = out
            prev = out
