"""Codec configuration: the fields of ``metalhuffman_tpu.models.CodecConfig``
that the port reads, with the same names and defaults."""

from __future__ import annotations

from dataclasses import dataclass

#: square block sizes the decode kernels take (a multiple of 4 symbols each)
BLOCK_DIMS = (2, 4, 8, 16)


@dataclass(frozen=True)
class CodecConfig:
    """Block geometry and precoder of a stream (reference: the compile-time
    ``#define`` switches of ``AAPLShaderTypes.h:109-123``)."""

    block_dim: int = 8  # HUFF_BLOCK_DIM: 2, 4, 8 or 16
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
        # the kernels decode 4 symbols per refill, as the TPU kernel does
        # (decode_pallas.py:431-435 refuses num_steps % 4)
        if self.block_dim not in BLOCK_DIMS:
            raise ValueError(
                f"block_dim {self.block_dim} is not one of {BLOCK_DIMS}")

    @property
    def block_size(self) -> int:
        return self.block_dim * self.block_dim
