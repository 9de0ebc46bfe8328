"""Codec configuration: the fields of ``metalhuffman_tpu.models.CodecConfig``
that the shared-table video path reads, with the same names and defaults."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CodecConfig:
    """Block geometry and precoder of a stream (reference: the compile-time
    ``#define`` switches of ``AAPLShaderTypes.h:109-123``)."""

    block_dim: int = 8  # HUFF_BLOCK_DIM
    delta: bool = True  # per-block 1-D delta precoding
    #: each block's root byte ships uncoded in a side array and its stream
    #: slot becomes a zero delta (requires delta=True)
    zero_init: bool = False
    #: 2-D within-block predictor (row 0 delta-left, rows 1.. delta-up);
    #: requires delta=True, composes with zero_init
    delta2d: bool = False

    @property
    def block_size(self) -> int:
        return self.block_dim * self.block_dim
