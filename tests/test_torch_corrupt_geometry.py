"""The port refuses a video container whose geometry was corrupted, with
ValueError, where the JAX package's native path raises ValueError,
ZeroDivisionError or RuntimeError.

Each byte of the geometry fields of a small MHTV (the frame count, height,
width, block count and block_dim: bytes 4-20) and of an MHV2 (its frame
count, height, width and block_dim, bytes 4-16, and its first segment
header's frame count and block count, bytes 22-29) is set in turn to 0x00,
0x14 and 0xff (a byte that already holds the value is left out). The port
decodes on the CPU; the reference runs ``backend="native"``, its host
decoder, so no JAX program compiles.
"""

import zlib

import numpy as np
import pytest
import torch

import metalhuffman_tpu
import metalhuffman_tpu_torch
from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models.config import CodecConfig

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

FRAMES = (np.arange(2 * 7 * 19).reshape(2, 7, 19) * 3 % 256).astype(np.uint8)


def _mhtv() -> bytes:
    return metalhuffman_tpu_torch.encode_video(FRAMES[:1])


def _mhv2() -> bytes:
    cfg = CodecConfig()
    segs = tfs.encode_frames_segmented(FRAMES, cfg)
    return tfs.write_segmented(segs, 7, 19, cfg,
                               source_crc32=zlib.crc32(FRAMES.tobytes()))


BLOBS = {"MHTV": _mhtv(), "MHV2": _mhv2()}
FIELDS = {"MHTV": range(4, 21),
          "MHV2": [*range(4, 17), *range(22, 30)]}
CASES = [(kind, pos, val) for kind, positions in FIELDS.items()
         for pos in positions for val in (0x00, 0x14, 0xFF)
         if BLOBS[kind][pos] != val]


def test_blobs_decode_clean():
    assert BLOBS["MHTV"][:4] == b"MHTV" and BLOBS["MHV2"][:4] == b"MHV2"
    np.testing.assert_array_equal(
        metalhuffman_tpu_torch.decode_video(BLOBS["MHTV"], "cpu"), FRAMES[:1])
    np.testing.assert_array_equal(
        metalhuffman_tpu_torch.decode_video(BLOBS["MHV2"], "cpu"), FRAMES)


@pytest.mark.parametrize("kind,pos,val", CASES,
                         ids=[f"{k}-byte{p}-0x{v:02x}" for k, p, v in CASES])
def test_corrupt_geometry_raises_value_error(kind, pos, val):
    bad = bytearray(BLOBS[kind])
    bad[pos] = val
    bad = bytes(bad)
    with pytest.raises(ValueError):
        metalhuffman_tpu_torch.decode_video(bad, "cpu")
    with pytest.raises((ValueError, ZeroDivisionError, RuntimeError)):
        metalhuffman_tpu.decode_video(bad, JaxConfig(backend="native"))
