"""Codec configuration: the fields of ``metalhuffman_tpu.models.CodecConfig``
that the port reads, with the same names and defaults."""

from __future__ import annotations

import numbers
from dataclasses import dataclass

#: the largest block_dim: every container records it in one byte
MAX_BLOCK_DIM = 255


@dataclass(frozen=True)
class CodecConfig:
    """Block geometry and precoder of a stream (reference: the compile-time
    ``#define`` switches of ``AAPLShaderTypes.h:109-123``)."""

    block_dim: int = 8  # HUFF_BLOCK_DIM: 1 .. MAX_BLOCK_DIM
    delta: bool = True  # per-block 1-D delta precoding
    #: each block's root byte ships uncoded in a side array and its stream
    #: slot becomes a zero delta (requires delta=True)
    zero_init: bool = False
    #: 2-D within-block predictor (row 0 delta-left, rows 1.. delta-up);
    #: requires delta=True, composes with zero_init
    delta2d: bool = False
    #: record a per-frame CRC-32 table in video containers (the MHTV/MHV2
    #: FCRC extension trailer), so random access (``decode_range``) verifies
    #: exactly the frames it returns; 4 bytes per frame
    frame_crcs: bool = False
    #: inter-frame residuals in an MHVT wrapper (``models.temporal``): frames
    #: become wrapping residuals against the previous frame, with a literal
    #: keyframe every ``keyint``; video encodes only, decode reads the magic
    temporal: bool = False
    keyint: int = 8  #: keyframe interval (bounds random-access decode work)
    #: with temporal: per-frame global motion compensation, the predictor
    #: being the previous frame circularly shifted by an integer (dy, dx)
    motion: bool = False

    def __post_init__(self):
        # any size the containers' header byte can record: the kernels
        # decode a block's last 1-3 symbols as a short group
        bd = self.block_dim
        if (isinstance(bd, bool) or not isinstance(bd, numbers.Integral)
                or not 1 <= bd <= MAX_BLOCK_DIM):
            raise ValueError(f"block_dim {bd!r} is not an integer in "
                             f"[1, {MAX_BLOCK_DIM}]")

    @property
    def block_size(self) -> int:
        return self.block_dim * self.block_dim
