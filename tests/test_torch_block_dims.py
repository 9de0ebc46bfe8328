"""Block sizes beyond 2/4/8/16 on the port: 1x1 to 255x255, as the containers
record them, against the JAX package.

The packed-block kernel's plain version (``decode_cuda.decode_blocks`` on
CPU tensors) is held, bytes and end bits, to the JAX package's XLA decode
(``decode_xla.decode_blocks``) at 1, 9, 25, 36, 144 and 1024 symbols a block:
the sizes whose last group has 1, 2 or 3 symbols and multiples of 4 that are
no multiple of 16. Then JAX blobs at block_dim 1, 3, 5, 6, 12 and 32, under
every precoder, go through each decode surface of the port on ``device="cpu"``
(the kernels' plain versions) and ``device="native"`` (the host C++ decoder),
each against the JAX package's host decoder (``backend="native"``) and the
source; the port's host encoders write the JAX package's bytes. Every
comparison is exact (tolerance 0). The JAX side runs its host codec and one
XLA decode per size, so no Pallas kernel is interpreted.
"""

import io
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metalhuffman_tpu as jmt
import metalhuffman_tpu_torch as mt
from metalhuffman_tpu import native as jnative
from metalhuffman_tpu.core import bitstream
from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import ImageCodec as JaxImageCodec
from metalhuffman_tpu.models import frame_stream as jfs
from metalhuffman_tpu.models import stream_writer as jsw
from metalhuffman_tpu.models import surgery as jsu
from metalhuffman_tpu.models import temporal as jtemporal
from metalhuffman_tpu.ops import decode_xla
from metalhuffman_tpu.ops import layout as jlayout
from metalhuffman_tpu_torch import cli
from metalhuffman_tpu_torch.core import blocks
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models import stream_writer as tsw
from metalhuffman_tpu_torch.models import surgery as tsu
from metalhuffman_tpu_torch.models import temporal as ttemporal
from metalhuffman_tpu_torch.models.config import CodecConfig
from metalhuffman_tpu_torch.models.image_codec import ImageCodec
from metalhuffman_tpu_torch.ops import decode_cuda
from metalhuffman_tpu_torch.parallel import shard_decode
from metalhuffman_tpu_torch.utils import imageio

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

BLOCK_DIMS = (1, 3, 5, 6, 12, 32)
PRECODERS = {
    "none": dict(delta=False),
    "delta": {},
    "zero_init": dict(zero_init=True),
    "delta2d": dict(delta2d=True),
}
CASES = [(bd, p) for bd in BLOCK_DIMS for p in PRECODERS]
DEVICES = ("cpu", "native")
T, H, W = 4, 37, 53  # no multiple of 3, 5, 6, 12 or 32


def _ids(v):
    return f"bd{v[0]}-{v[1]}"


def _pan(seed, t=T, h=H, w=W, c=None):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 90 + 40 * np.sin(xx / 4.0) + 30 * np.cos(yy / 3.0)
    img = np.clip(base + rng.normal(0, 5, (h, w)), 0, 255).astype(np.uint8)
    frames = np.stack([np.roll(img, (i, 2 * i), (0, 1)) for i in range(t)])
    if c is None:
        return frames
    return np.stack([frames + 17 * k for k in range(c)], -1).astype(np.uint8)


def _cfgs(bd, **kw):
    """The port's config and the JAX package's host-codec config."""
    return (CodecConfig(block_dim=bd, **kw),
            JaxConfig(backend="native", block_dim=bd, **kw))


# -- B2's plain version against the JAX package's XLA decode ------------------

STEPS = (1, 9, 25, 36, 144, 1024)


def _xla_decode(stream, n, delta):
    """decode_xla.decode_blocks with end bits, on the rows the JAX package
    stages for blocks of n symbols (``ImageCodec.prepare``'s width: the
    ``decode_stream`` convenience sizes its rows for 64-symbol blocks)."""
    t1, t2 = decode_xla.prepare_tables(stream.widths)
    total_bits = 8 * (stream.code_bytes.size - bitstream.READ_AHEAD_PAD_BYTES)
    width = jlayout.words_per_block(
        jlayout.max_block_bits(stream.block_offsets, total_bits), n)
    words, offsets, width = decode_xla.prepare_stream(stream, width)
    rows, bit_init = jlayout.build_layout_jax(jnp.asarray(words),
                                              jnp.asarray(offsets), width)
    blk, end = decode_xla.decode_blocks(
        rows, bit_init, jnp.asarray(t1), jnp.asarray(t2), num_steps=n,
        delta=delta, emit_end_bits=True)
    return np.asarray(blk), np.asarray(end)


@pytest.mark.parametrize("delta", [True, False], ids=["delta", "none"])
@pytest.mark.parametrize("n", STEPS)
def test_decode_blocks_plain_matches_xla(n, delta):
    rng = np.random.default_rng(n)
    p = 0.6 ** np.arange(40)
    sym = rng.choice(40, n * 6, p=p / p.sum()).astype(np.uint8)
    stream = jnative.encode_symbols(sym, block_size=n)
    want, want_end = _xla_decode(stream, n, delta)
    _meta, words, offsets = decode_cuda.prepare_stream(stream)
    got, end = decode_cuda.decode_blocks(
        torch.from_numpy(words), torch.from_numpy(offsets),
        decode_cuda.stage_code(stream.widths, "cpu"), num_steps=n,
        delta=delta, emit_end=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(end.numpy(), want_end)
    if not delta:
        np.testing.assert_array_equal(got.numpy().ravel(), sym)
    # the end bits are the offset index's: every block ends where the next
    # starts, the last at the stream's last code bit
    targets = decode_cuda.block_end_targets(
        stream.block_offsets,
        int(stream.block_offsets[-1]) + int(stream.widths[sym[-n:]].sum()))
    assert not decode_cuda.check_block_ends(end.numpy(), targets).any()


def test_block_dim_range():
    for bd in range(1, 256):
        assert CodecConfig(block_dim=bd).block_size == bd * bd
    for bad in (0, -1, 256, 2.5, "8", True, None):
        with pytest.raises(ValueError, match="block_dim"):
            CodecConfig(block_dim=bad)
    words = torch.zeros(8, dtype=torch.int32)
    code = decode_cuda.stage_code(np.full(256, 8, np.uint8), "cpu")
    for steps in (0, 65026):
        with pytest.raises(ValueError, match=r"\[1, 65025\]"):
            decode_cuda.decode_blocks(words, torch.zeros(1, dtype=torch.int32),
                                      code, num_steps=steps, delta=True)
    assert decode_cuda.MAX_STEPS == 255 * 255
    assert [decode_cuda.store_bytes(n) for n in (1, 9, 36, 144, 1024)] == [
        1, 1, 4, 16, 16]


def test_out_of_a_tail_size_may_start_at_any_byte():
    cfg, _jcfg = _cfgs(3)
    frames = _pan(1, t=1, h=9, w=12)
    stream = tfs.encode_frames_shared(frames, cfg)
    prep = tfs.prepare_shared(stream, 1, 9, 12, cfg, device="cpu")
    args = (prep.words, prep.offsets, prep.code)
    out = torch.empty(12 * 9 + 1, dtype=torch.uint8)[1:].view(12, 9)
    got = decode_cuda.decode_blocks(*args, num_steps=9, delta=True, out=out)
    assert got is out
    np.testing.assert_array_equal(
        out.numpy(), decode_cuda.decode_blocks(*args, num_steps=9,
                                               delta=True).numpy())


# -- the decode surfaces ---------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_mht1_image_and_regions(case):
    bd, name = case
    kw = PRECODERS[name]
    cfg, jcfg = _cfgs(bd, **kw)
    img = _pan(bd, t=1)[0]
    blob = jmt.encode_image(img, jcfg)
    assert mt.encode_image(img, cfg) == blob
    want = jmt.decode_image(blob, jcfg)
    np.testing.assert_array_equal(want, img)
    stream = ImageCodec(cfg).encode(img)
    jcodec = JaxImageCodec(jcfg)
    for device in DEVICES:
        np.testing.assert_array_equal(mt.decode_image(blob, device), want)
        for region in [(3, 5, 20, 31), (36, 52, 1, 1)]:
            y0, x0, rh, rw = region
            got = ImageCodec(cfg).decode_region(stream, H, W, *region,
                                                check=True, device=device)
            np.testing.assert_array_equal(got, img[y0:y0 + rh, x0:x0 + rw])
            np.testing.assert_array_equal(got, jcodec.decode_region(
                stream, H, W, *region, check=True))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_mhtv_and_mhv2_with_frame_crcs(case):
    bd, name = case
    kw = PRECODERS[name]
    cfg, jcfg = _cfgs(bd, frame_crcs=True, **kw)
    frames = _pan(10 + bd)
    mhtv = jmt.encode_video(frames, jcfg)
    assert mhtv[:4] == b"MHTV" and mt.encode_video(frames, cfg) == mhtv
    segs = jfs.encode_frames_segmented(frames, jcfg,
                                       max_segment_bits=2 * H * W * 10)
    assert len(segs) > 1
    mhv2 = jfs.write_segmented(segs, H, W, jcfg,
                               source_crc32=zlib.crc32(frames.tobytes()),
                               frame_crcs=jfs.compute_frame_crcs(frames))
    tsegs = tfs.encode_frames_segmented(frames, cfg,
                                        max_segment_bits=2 * H * W * 10)
    assert tfs.write_segmented(
        tsegs, H, W, cfg, source_crc32=zlib.crc32(frames.tobytes()),
        frame_crcs=tfs.compute_frame_crcs(frames)) == mhv2
    for blob in (mhtv, mhv2):
        np.testing.assert_array_equal(jmt.decode_video(blob, jcfg), frames)
        for device in DEVICES:
            np.testing.assert_array_equal(mt.decode_video(blob, device),
                                          frames)
            got, h, w = tfs.decode_range(blob, 1, 3, device=device)
            assert (h, w) == (H, W)
            np.testing.assert_array_equal(got, frames[1:3])
            np.testing.assert_array_equal(
                got, jfs.decode_range(blob, 1, 3, jcfg)[0])
            reg = tfs.decode_video_region(blob, 1, 4, 3, 5, 13, 29,
                                          check=True, device=device)
            np.testing.assert_array_equal(reg, frames[1:4, 3:16, 5:34])
            np.testing.assert_array_equal(reg, jfs.decode_video_region(
                blob, 1, 4, 3, 5, 13, 29, jcfg, check=True))


@pytest.mark.parametrize("bd", BLOCK_DIMS)
def test_mhts_batch_and_frames(bd):
    cfg, jcfg = _cfgs(bd)
    frames = _pan(20 + bd)
    crcs = [zlib.crc32(f.tobytes()) for f in frames]
    blob = jfs.write_stream(jfs.encode_frames(frames, jcfg), H, W, jcfg,
                            source_crc32s=crcs)
    assert tfs.write_stream(tfs.encode_frames(frames, cfg), H, W, cfg,
                            source_crc32s=crcs) == blob
    streams, h, w, got_bd, delta = tfs.read_stream(blob)
    assert (h, w, got_bd, delta) == (H, W, bd, True)
    out = tfs.decode_batch(tfs.prepare_batch(streams, H, W, cfg,
                                             device="cpu"), cfg)
    np.testing.assert_array_equal(out.numpy(), frames)
    for device in DEVICES:
        got, _h, _w = tfs.decode_range(blob, 1, 4, device=device)
        np.testing.assert_array_equal(got, frames[1:4])
        np.testing.assert_array_equal(got,
                                      jfs.decode_range(blob, 1, 4, jcfg)[0])
        for (i, f, err, crc), (_j, g, _e, jcrc) in zip(
                tfs.iter_stream_frames(blob, device=device),
                jfs.iter_stream_frames(blob, jcfg)):
            assert err is None and crc == jcrc == crcs[i]
            np.testing.assert_array_equal(f, g)


@pytest.mark.parametrize("bd", BLOCK_DIMS)
def test_mhvt_and_color(bd):
    cfg, jcfg = _cfgs(bd, temporal=True, keyint=3, motion=True,
                      frame_crcs=True)
    frames = _pan(30 + bd, t=5)
    blob = jmt.encode_video(frames, jcfg)
    assert blob[:4] == b"MHVT" and mt.encode_video(frames, cfg) == blob
    rgb = _pan(40 + bd, t=1, c=3)[0]
    ccfg, cjcfg = _cfgs(bd, delta2d=True)
    mhtc = jmt.encode_color_image(rgb, cjcfg)
    assert mt.encode_color_image(rgb, ccfg) == mhtc
    for device in DEVICES:
        np.testing.assert_array_equal(mt.decode_video(blob, device), frames)
        got = ttemporal.decode_temporal_range(blob, 2, 5, device)
        np.testing.assert_array_equal(got, frames[2:5])
        np.testing.assert_array_equal(
            got, jtemporal.decode_temporal_range(blob, 2, 5, jcfg))
        reg = ttemporal.decode_temporal_video_region(
            blob, 1, 5, 2, 3, 11, 17, check=True, device=device)
        np.testing.assert_array_equal(reg, frames[1:5, 2:13, 3:20])
        np.testing.assert_array_equal(
            reg, jtemporal.decode_temporal_video_region(
                blob, 1, 5, 2, 3, 11, 17, jcfg, check=True))
        np.testing.assert_array_equal(mt.decode_color_image(mhtc, device),
                                      rgb)
        np.testing.assert_array_equal(mt.decode_color_image(mhtc, device),
                                      jmt.decode_color_image(mhtc, cjcfg))


def _pushed(cls, frames, *args, **kw):
    """``frames`` pushed two at a time into ``cls(sink, *args, **kw)``."""
    sink = io.BytesIO()
    with cls(sink, *args, **kw) as enc:
        for a in range(0, len(frames), 2):
            enc.push(frames[a : a + 2])
    return sink.getvalue()


@pytest.mark.parametrize("bd", BLOCK_DIMS)
def test_streaming_writers_and_surgery(bd):
    frames = _pan(50 + bd, t=6)  # whole keyframe groups: MHVT concats
    cfg, jcfg = _cfgs(bd, delta2d=True, zero_init=True, frame_crcs=True)
    mhv2 = _pushed(tsw.StreamingEncoder, frames, H, W, config=cfg,
                   max_segment_frames=3, frame_crcs=True)
    assert mhv2 == _pushed(jsw.StreamingEncoder, frames, H, W, config=jcfg,
                           max_segment_frames=3, frame_crcs=True)
    tcfg, tjcfg = _cfgs(bd, temporal=True, keyint=3, motion=True,
                        frame_crcs=True)
    mhvt = _pushed(tsw.TemporalStreamingEncoder, frames, H, W, config=tcfg,
                   max_segment_frames=4, device="cpu")
    assert mhvt == _pushed(jsw.TemporalStreamingEncoder, frames, H, W,
                           config=tjcfg, max_segment_frames=4)
    for blob in (mhv2, mhvt):
        for device in DEVICES:
            np.testing.assert_array_equal(mt.decode_video(blob, device),
                                          frames)
        # an MHVT start inside a keyframe group decodes that group
        for a, b in ((1, 5), (2, 6)):
            cut = tsu.extract_video(blob, a, b, device="cpu")
            assert cut == jsu.extract_video(blob, a, b)
            np.testing.assert_array_equal(mt.decode_video(cut, "cpu"),
                                          frames[a:b])
        both = tsu.concat_videos([blob, blob])
        assert both == jsu.concat_videos([blob, blob])
        np.testing.assert_array_equal(mt.decode_video(both, "native"),
                                      np.concatenate([frames, frames]))
    again = tsu.resegment_video(mhv2, 2)
    assert again == jsu.resegment_video(mhv2, 2)
    np.testing.assert_array_equal(mt.decode_video(again, "cpu"), frames)


@pytest.mark.parametrize("world", [1, 3, 4])
@pytest.mark.parametrize("bd", [3, 12, 32])
def test_parallel_local_steps(bd, world):
    """Every rank's local step in turn, assembled as the gathers do."""
    frames = _pan(60 + bd)
    cfg, _jcfg = _cfgs(bd)
    stream = tfs.encode_frames_shared(frames, cfg)
    parts = [tfs.decode_shared_local(stream, T, H, W, cfg, rank=r,
                                     world=world, device="cpu")[0]
             for r in range(world)]
    got = tfs.frames_from_shards(parts, T, H, W, cfg)
    np.testing.assert_array_equal(got.numpy(), frames)
    prep = tfs.prepare_batch(tfs.encode_frames(frames, cfg), H, W, cfg,
                             device="cpu")
    data = 2 if world == 4 else 1
    layout = [list(range(i * (world // data), (i + 1) * (world // data)))
              for i in range(data)]
    parts = [tfs.decode_batch_local(prep, cfg, data=(r // len(layout[0]),
                                                     data),
                                    seq=(r % len(layout[0]), len(layout[0])))
             for r in range(world)]
    blk = shard_decode.assemble_grid(parts, layout)[:T, : prep.bh * prep.bw]
    np.testing.assert_array_equal(
        blocks.blocks_to_image_torch(blk, H, W, bd).numpy(), frames)


def test_block_dim_255_on_one_block():
    img = _pan(255, t=1, h=255, w=255)[0]
    cfg, jcfg = _cfgs(255)
    blob = jmt.encode_image(img, jcfg)
    assert mt.encode_image(img, cfg) == blob
    for device in DEVICES:
        np.testing.assert_array_equal(mt.decode_image(blob, device), img)


@pytest.mark.parametrize("bd", [5, 32])
def test_cli_encodes_as_the_jax_cli_does(bd, tmp_path):
    from metalhuffman_tpu import cli as jcli

    frames = _pan(70 + bd, t=3)
    img = tmp_path / "img.png"
    imageio.save_grayscale(frames[0], img)
    video = tmp_path / "video.npy"
    np.save(video, frames)
    for cmd, src, out in (("encode", img, "a.mht"),
                          ("encode-video", video, "a.mhtv")):
        ours, theirs = tmp_path / f"ours-{out}", tmp_path / f"jax-{out}"
        assert cli.main([cmd, str(src), str(ours), "--block-dim", str(bd)]) == 0
        assert jcli.main([cmd, str(src), str(theirs), "--block-dim", str(bd),
                          "--backend", "native"]) == 0
        assert ours.read_bytes() == theirs.read_bytes()
    decoded = tmp_path / "back.npy"
    assert cli.main(["decode-video", str(tmp_path / "ours-a.mhtv"),
                     str(decoded), "--device", "native"]) == 0
    np.testing.assert_array_equal(np.load(decoded), frames)


@pytest.mark.parametrize("device", DEVICES)
def test_cli_roundtrip_at_block_dim_3(device, tmp_path, capsys):
    path = tmp_path / "img.png"
    imageio.save_grayscale(_pan(3, t=1)[0], path)
    assert cli.main(["roundtrip", str(path), "--block-dim", "3",
                     "--device", device]) == 0
    assert f" bit-exact on {device}" in capsys.readouterr().out


def test_chip_smoke_phase_n_checks_run_on_cpu_tensors():
    """Phase N's B2 check, rehearsed where a wrapper takes the plain version
    (both sides of the comparison then are): its sizes and its bookkeeping."""
    assert chip_smoke.N_DIMS == BLOCK_DIMS
    assert set(chip_smoke.N_VIDEO) <= set(BLOCK_DIMS) >= set(
        chip_smoke.N_IMAGE) | set(chip_smoke.N_DELTA2D) | {chip_smoke.N_FCRC}
    frame = _pan(7, t=1, h=40, w=70)[0]
    for bd, kw in ((1, {"delta": False}), (5, {"delta": True}),
                   (12, {"delta2d": True})):
        assert chip_smoke.b2_case("cpu", "phase N", frame, bd, kw) == 0
