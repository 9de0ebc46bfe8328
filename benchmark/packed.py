"""What the readers of the packed-block cells share: the staged cells of a
plain configuration whose block size is not 8, which the port decodes with
B2 (``decode_blocks_kernel``) and a torch relayout of the blocks into
frames, the stretch its ``blocks`` mark opens.

``system.stage`` counts a call's symbols with 8x8 geometry, a quarter of
B2's at 16x16, so the symbols B2 writes are counted here from the
configuration and the mix.
"""

from __future__ import annotations

#: B2's kernel in the trace
B2 = "decode_blocks_kernel"


def packed(run) -> bool:
    """Whether the run is a plain staged cell's at a block size other
    than 8."""
    codec = run.config["codec"]
    return (run.kind == "staged" and not codec["temporal"]
            and codec.get("block_dim", 8) != 8)


def symbols(config: dict, mix: dict) -> int:
    """The symbols one staged call's B2 writes: every frame's blocks whole,
    edge blocks padded, T x ceil(H/bd)*bd x ceil(W/bd)*bd."""
    bd = config["codec"]["block_dim"]
    return (mix["clip_frames"] * -(-config["height"] // bd) * bd
            * -(-config["width"] // bd) * bd)
