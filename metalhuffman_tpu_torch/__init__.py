"""metalhuffman_tpu_torch: the PyTorch / CUDA port of metalhuffman_tpu.

The JAX package ``metalhuffman_tpu`` is the reference; this package encodes
and decodes the same containers with PyTorch, its own host codec (``core``,
and the C++ encoder in ``native``, built with g++ at first use) and
hand-written CUDA kernels for Hopper (``csrc/``, built with nvcc at first
use). It imports no JAX and nothing of the JAX package.

- ``ops.decode_cuda``: the decode kernels (8x8 images, packed blocks of
  any size from 1x1 to 255x255), their plain PyTorch versions, the stream
  staging and the end-bit integrity check.
- ``ops.encode_cuda``: the hybrid device encoder
  (``encode_symbols_hybrid``): the row-packing kernel for 8x8 blocks, its
  plain PyTorch version, and the host row merge and tail.
- ``models.frame_stream``: video encode and container I/O: shared-table
  MHTV, segmented MHV2 (segments that fit u32 block offsets, decoded two in
  flight), per-frame-table MHTS, the per-frame CRC extension; batched and
  checked decode, and random access (``decode_range``, ``decode_frame``,
  ``decode_video_region``).
- ``models.image_codec``: the single-image codec (MHT1), region decode.
- ``models.color``: color and 16-bit grayscale images and videos as planes
  over the video containers (MHTC), and the plane fold on the device.
- ``models.temporal``: temporal video (MHVT): inter-frame residuals, with
  or without global motion compensation, folded on the device after the
  decode.
- ``models.stream_writer``: the streaming writers (MHV2, MHTC, MHVT, MHTS
  written as frames are pushed, at the memory of one segment) and their
  in-place append; ``models.surgery``: lossless extract, concat and
  resegment, with the CRCs combined by ``core.crc``. Host work, but for
  the temporal append's open keyframe group and an MHVT extract that
  starts inside a keyframe group, which decode on the caller's device.
- ``parallel``: multi-GPU decode and encode over ``torch.distributed``
  (NCCL for CUDA tensors, gloo for CPU tensors): each rank runs the kernels
  on its contiguous block range, and one gather puts the ranges in stream
  order.

Every entry point decodes (and the hybrid encoder packs) on the card unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"


def encode_image(img, config=None) -> bytes:
    """(H, W) uint8 grayscale image -> MHT1 container bytes (host encode,
    with the source CRC-32)."""
    from .models.image_codec import ImageCodec

    return ImageCodec(config).encode_to_bytes(img)


def decode_image(blob: bytes, device="cuda"):
    """MHT1 container bytes -> (H, W) uint8 numpy image, decoded on
    ``device`` and checked against the recorded source CRC-32."""
    from .models.image_codec import ImageCodec

    return ImageCodec().decode(blob, device=device)


def encode_color_image(img, config=None) -> bytes:
    """(H, W, C) uint8 image -> MHTC color container bytes (host encode)."""
    from .models import color

    return color.encode_color_to_bytes(img, config)


def decode_color_image(blob: bytes, device="cuda"):
    """MHTC color container (or a legacy bare MHTV of planes) -> (H, W, C)
    uint8, decoded on ``device`` and CRC-checked."""
    from .models import color

    return color.decode_color_from_bytes(blob, device)


def encode_color_video(frames, config=None) -> bytes:
    """(T, H, W, C) uint8 frames -> MHTC color video container bytes, or
    with ``config.temporal`` inter-frame residuals in an MHVT wrapper."""
    from .models import color

    if config is not None and config.temporal:
        from .models import temporal

        return temporal.encode_temporal_color_video(frames, config)
    return color.encode_color_video_to_bytes(frames, config)


def decode_color_video(blob: bytes, device="cuda"):
    """MHTC (or temporal MHVT) color video -> (T, H, W, C) uint8, decoded on
    ``device`` and CRC-checked."""
    from .models import color

    if blob[:4] == b"MHVT":
        from .models import temporal

        return temporal.decode_temporal_video(blob, device)
    return color.decode_color_video_from_bytes(blob, device)


def encode_video(frames, config=None) -> bytes:
    """(T, H, W) uint8 frames -> MHTV container bytes (host encode), or
    segmented MHV2 when the stream could pass u32 block offsets.

    Records the CRC-32 of the source frames, and with ``config.frame_crcs``
    a per-frame CRC table for random access. With ``config.temporal`` the
    frames become inter-frame residuals in an MHVT wrapper (keyframe every
    ``config.keyint``, motion compensation under ``config.motion``).
    """
    import zlib

    import numpy as np

    from .models import frame_stream

    frames_arr = np.asarray(frames)
    if config is not None and config.temporal:
        from .models import temporal

        return temporal.encode_temporal_video(frames_arr, config)
    t, h, w = frames_arr.shape
    crc = zlib.crc32(np.ascontiguousarray(frames_arr).tobytes())
    fcrcs = None
    if config is not None and config.frame_crcs:
        fcrcs = frame_stream.compute_frame_crcs(frames_arr)
    segs = frame_stream.encode_frames_segmented(frames_arr, config)
    if len(segs) == 1:
        return frame_stream.write_shared(
            segs[0][0], t, h, w, config, source_crc32=crc, frame_crcs=fcrcs)
    return frame_stream.write_segmented(segs, h, w, config, source_crc32=crc,
                                        frame_crcs=fcrcs)


def decode_video(blob: bytes, device="cuda"):
    """MHTV, MHV2 or MHVT container bytes -> numpy frames, decoded on
    ``device`` and checked against the recorded source CRC-32.

    The container fixes block_dim and precoder; ``device`` picks the decode
    route (the CUDA kernels or, on the CPU, their plain versions). MHV2
    segments decode two in flight. MHTV and MHV2 give (T, H, W) uint8; an
    MHVT gives the reconstructed true frames, (T, H, W) uint8, (T, H, W, C)
    uint8 or (T, H, W) uint16 after its inner container, folded on
    ``device`` and fetched once.
    """
    from .models import frame_stream

    if blob[:4] == b"MHVT":
        from .models import temporal

        return temporal.decode_temporal_video(blob, device)
    segs, t, h, w, cfg = frame_stream.read_video(blob)
    if len(segs) > 1:
        frames = frame_stream.decode_frames_segmented(segs, h, w, cfg,
                                                      device=device)
    else:
        frames = frame_stream.decode_frames_shared(
            segs[0][0], t, h, w, cfg, device=device).cpu().numpy()
    frame_stream.verify_source_crc32(frames, frame_stream.source_crc32(blob))
    return frames
