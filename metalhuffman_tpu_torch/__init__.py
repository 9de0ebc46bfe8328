"""metalhuffman_tpu_torch: the PyTorch / CUDA port of metalhuffman_tpu.

The JAX package ``metalhuffman_tpu`` is the reference; this package decodes
the same containers with PyTorch and hand-written CUDA kernels for Hopper
(``csrc/``, built with nvcc at first use). It shares the JAX package's host
codec (``metalhuffman_tpu.core`` and the C++ ``native`` encoder), which
imports no JAX, and imports no JAX itself.

- ``ops.decode_cuda``: the shared-table image decode kernel, its plain
  PyTorch version and the stream staging.
- ``models.frame_stream``: shared-table (MHTV) video encode, container I/O
  and batched decode.
"""

__version__ = "0.1.0"


def decode_video(blob: bytes, device):
    """MHTV container bytes -> (T, H, W) uint8 numpy frames, decoded on
    ``device`` and checked against the recorded source CRC-32.

    The container fixes block_dim and precoder; ``device`` picks the decode
    route (the CUDA kernel or, on the CPU, its plain version). Segmented
    (MHV2) and temporal (MHVT) containers are not ported yet.
    """
    from .models import frame_stream
    from .models.config import CodecConfig

    if blob[:4] == b"MHV2":
        raise NotImplementedError(
            "segmented MHV2 containers are still to port "
            "(ROADMAP.md queue A item 7)")
    if blob[:4] == b"MHVT":
        raise NotImplementedError(
            "temporal MHVT containers are still to port "
            "(ROADMAP.md queue A item 8)")
    stream, t, h, w, bd, delta = frame_stream.read_shared(blob)
    cfg = CodecConfig(block_dim=bd, delta=delta,
                      delta2d=stream.predictor == "2d")
    frames = frame_stream.decode_frames_shared(
        stream, t, h, w, cfg, device=device).cpu().numpy()
    frame_stream.verify_source_crc32(frames, frame_stream.source_crc32(blob))
    return frames
