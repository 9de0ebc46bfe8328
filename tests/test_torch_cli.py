"""The port's CLI (``python -m metalhuffman_tpu_torch``) against the JAX
package's (``python -m metalhuffman_tpu``), and the host modules it brought
along: the ``--best`` searches, image IO, the debug views and the timers.

The same seeded numpy inputs (images of 48x64 and 64x96, videos of 10
frames of 48x64) go through both CLIs in one process. The JAX side runs
``--backend native`` (its host decoder) and host encodes only, so no Pallas
kernel is interpreted; every port command runs ``--device cpu`` (the
kernels' plain versions). Every comparison is exact (tolerance 0): encoded
files byte for byte, decoded files against the source and against the JAX
CLI's, and the text of ``info`` and ``inspect``.
"""

import dataclasses
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from metalhuffman_tpu import cli as jcli
from metalhuffman_tpu.core import decode_ref as jdecode_ref
from metalhuffman_tpu.core import canonical as jcanonical
from metalhuffman_tpu.core import tables as jtables
from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import ImageCodec as JaxImageCodec
from metalhuffman_tpu.models import color as jcolor
from metalhuffman_tpu.models import frame_stream as jfs
from metalhuffman_tpu.models import temporal as jtemporal
from metalhuffman_tpu.utils import imageio as jimageio
from metalhuffman_tpu_torch import cli, native
from metalhuffman_tpu_torch.core import canonical, decode_ref, tables
from metalhuffman_tpu_torch.models import color as tcolor
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models import temporal as ttemporal
from metalhuffman_tpu_torch.models.config import CodecConfig
from metalhuffman_tpu_torch.models.image_codec import ImageCodec
from metalhuffman_tpu_torch.utils import imageio, profiling

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

CPU = ["--device", "cpu"]
NATIVE = ["--backend", "native"]
H, W = 48, 64  # the videos' frames and the small image
T = 10


def _photo_like(h, w, seed, c=None):
    """Smooth gradients with noise: a precoder wins, like on a photo."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 100 + 40 * np.sin(xx / 5.0) + 30 * np.cos(yy / 4.0)
    if c is None:
        return np.clip(base + rng.normal(0, 4, (h, w)), 0, 255).astype(
            np.uint8)
    planes = [base + 12 * k + rng.normal(0, 4, (h, w)) for k in range(c)]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def _pan(img, t=T):
    return np.stack([np.roll(img, (i, 2 * i), axis=(0, 1)) for i in range(t)])


def _u16(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4096, shape).astype(np.uint16)
            + np.arange(shape[-1], dtype=np.uint16) * 131)


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    """The inputs on disk and as arrays."""
    root = tmp_path_factory.mktemp("cli")
    arrays = {
        "gray": _photo_like(64, 96, 0),
        "small": _photo_like(H, W, 1),
        "rgb": _photo_like(H, W, 2, c=3),
        "g16": _u16((H, W), 3),
        "video": _pan(_photo_like(H, W, 4)),
        "cvideo": _pan(_photo_like(H, W, 5, c=3)),
        "v16": _u16((T, H, W), 6),
    }
    paths = {
        "gray": root / "gray.png", "small": root / "small.png",
        "rgb": root / "rgb.png", "g16": root / "g16.npy",
        "video": root / "video.npy", "cvideo": root / "cvideo.npy",
        "v16": root / "v16.npy",
    }
    imageio.save_grayscale(arrays["gray"], paths["gray"])
    imageio.save_grayscale(arrays["small"], paths["small"])
    imageio.save_color(arrays["rgb"], paths["rgb"])
    for k in ("g16", "video", "cvideo", "v16"):
        np.save(paths[k], arrays[k])
    return root, paths, arrays


def _run(main, *argv):
    assert main([str(a) for a in argv]) == 0


def _exit_message(main, *argv) -> str:
    with pytest.raises(SystemExit) as e:
        main([str(a) for a in argv])
    assert e.value.code not in (0, None)
    return str(e.value.code)


ENCODES = {
    # id: (command, input, flags)
    "bd2": ("encode", "gray", ["--block-dim", "2"]),
    "bd4": ("encode", "gray", ["--block-dim", "4"]),
    "bd8": ("encode", "gray", []),
    "bd16": ("encode", "gray", ["--block-dim", "16"]),
    "no-delta": ("encode", "gray", ["--no-delta"]),
    "zero-init": ("encode", "gray", ["--zero-init"]),
    "delta2d": ("encode", "gray", ["--delta2d"]),
    "best": ("encode", "gray", ["--best"]),
    "color": ("encode", "rgb", ["--color"]),
    "color-subgreen": ("encode", "rgb", ["--color", "--subgreen"]),
    "color-best": ("encode", "rgb", ["--color", "--best"]),
    "gray16": ("encode", "g16", ["--gray16"]),
    "mhtv": ("encode-video", "video", []),
    "frame-crcs": ("encode-video", "video", ["--frame-crcs"]),
    "per-frame-tables": ("encode-video", "video", ["--per-frame-tables"]),
    "temporal": ("encode-video", "video", ["--temporal", "--keyint", "4"]),
    "temporal-motion": ("encode-video", "video",
                        ["--temporal", "--motion", "--frame-crcs"]),
    "video-best": ("encode-video", "video", ["--best"]),
    "best-fast": ("encode-video", "video",
                  ["--temporal", "--motion", "--best-fast"]),
    "video-color-subgreen": ("encode-video", "cvideo",
                             ["--color", "--subgreen"]),
    "video-gray16": ("encode-video", "v16", ["--gray16"]),
}


def _decoded(kind: str, path: Path):
    if path.suffix == ".npy":
        return np.load(path)
    return (imageio.load_color(path) if kind == "rgb"
            else imageio.load_grayscale(path))


@pytest.mark.parametrize("case", ENCODES)
def test_encode_and_decode_match_the_jax_cli(case, d, tmp_path):
    cmd, src, flags = ENCODES[case]
    _root, paths, arrays = d
    ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
    _run(cli.main, cmd, paths[src], ours, *flags)
    _run(jcli.main, cmd, paths[src], theirs, *flags)
    assert ours.read_bytes() == theirs.read_bytes()
    # both CLIs decode the file to the source
    dec = "decode" if cmd == "encode" else "decode-video"
    suffix = ".npy" if src in ("g16",) or dec == "decode-video" else ".png"
    out_t, out_j = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
    _run(cli.main, dec, ours, out_t, *CPU)
    _run(jcli.main, dec, theirs, out_j, *NATIVE)
    got = _decoded(src, out_t)
    np.testing.assert_array_equal(got, arrays[src])
    np.testing.assert_array_equal(got, _decoded(src, out_j))


@pytest.fixture(scope="module")
def blobs(d):
    """JAX-CLI-written containers of every kind."""
    root, paths, _arrays = d
    made = {
        "mht1": ("encode", "gray", []),
        "mht1-zero-init": ("encode", "small", ["--zero-init", "--delta2d"]),
        "mhtv": ("encode-video", "video", ["--frame-crcs"]),
        "mhts": ("encode-video", "video", ["--per-frame-tables"]),
        "mhtc-image": ("encode", "rgb", ["--color", "--subgreen"]),
        "mhtc-video": ("encode-video", "cvideo", ["--color"]),
        "mhtc-u16": ("encode-video", "v16", ["--gray16"]),
        "mhvt": ("encode-video", "video", ["--temporal", "--keyint", "4",
                                           "--frame-crcs"]),
        "mhvt-mc": ("encode-video", "video", ["--temporal", "--motion"]),
        "mhvt-color": ("encode-video", "cvideo", ["--temporal", "--color"]),
        "mhv2": ("encode-video", "video", ["--streaming", "--segment-frames",
                                           "4", "--frame-crcs"]),
        "mhv2-color": ("encode-video", "cvideo",
                       ["--streaming", "--segment-frames", "3", "--color"]),
        "mhvt-streamed": ("encode-video", "video",
                          ["--streaming", "--segment-frames", "4",
                           "--temporal", "--motion", "--frame-crcs"]),
        "mhts-streamed": ("encode-video", "video",
                          ["--streaming", "--per-frame-tables"]),
    }
    out = {}
    for name, (cmd, src, flags) in made.items():
        out[name] = root / f"{name}.bin"
        _run(jcli.main, cmd, paths[src], out[name], *flags)
    return out


RANDOM_ACCESS = {
    # id: (container, flags, source, expected selection)
    "frames": ("mhtv", ["--frames", "2", "7"], "video",
               lambda a: a[2:7]),
    "frame": ("mhtv", ["--frame", "4"], "video", lambda a: a[4]),
    "region": ("mhtv", ["--region", "8", "16", "20", "24", "--frames", "1",
                        "4"], "video", lambda a: a[1:4, 8:28, 16:40]),
    "region-frame": ("mhv2", ["--region", "3", "5", "30", "40", "--frame",
                              "5", "--check"], "video",
                     lambda a: a[5, 3:33, 5:45]),
    "mhv2-frames": ("mhv2", ["--frames", "3", "9"], "video",
                    lambda a: a[3:9]),
    "mhts-frame": ("mhts", ["--frame", "3"], "video", lambda a: a[3]),
    "temporal-frame": ("mhvt", ["--frame", "6"], "video", lambda a: a[6]),
    "temporal-frames": ("mhvt-mc", ["--frames", "3", "9"], "video",
                        lambda a: a[3:9]),
    "temporal-region": ("mhvt", ["--region", "0", "8", "16", "16"], "video",
                        lambda a: a[:, 0:16, 8:24]),
    "color-frame": ("mhtc-video", ["--frame", "2"], "cvideo",
                    lambda a: a[2]),
    "color-region": ("mhtc-video", ["--region", "4", "4", "9", "17",
                                    "--frames", "6", "8"], "cvideo",
                     lambda a: a[6:8, 4:13, 4:21]),
    "u16": ("mhtc-u16", [], "v16", lambda a: a),
    "temporal-color": ("mhvt-color", ["--check"], "cvideo", lambda a: a),
    "temporal-mc-check": ("mhvt-mc", ["--check"], "video", lambda a: a),
    "mhts-check": ("mhts", ["--check"], "video", lambda a: a),
}


@pytest.mark.parametrize("case", RANDOM_ACCESS)
def test_decode_video_matches_the_jax_cli(case, d, blobs, tmp_path):
    name, flags, src, sel = RANDOM_ACCESS[case]
    out_t, out_j = tmp_path / "t.npy", tmp_path / "j.npy"
    _run(cli.main, "decode-video", blobs[name], out_t, *flags, *CPU)
    got = np.load(out_t)
    np.testing.assert_array_equal(got, sel(d[2][src]))
    # the JAX CLI's --check needs its Pallas kernel: compare without it
    jflags = [f for f in flags if f != "--check"]
    _run(jcli.main, "decode-video", blobs[name], out_j, *jflags, *NATIVE)
    np.testing.assert_array_equal(got, np.load(out_j))


def test_decode_video_writes_image_directories(d, blobs, tmp_path):
    _run(cli.main, "decode-video", blobs["mhtc-video"], tmp_path / "c",
         "--frames", "1", "3", *CPU)
    _run(cli.main, "decode-video", blobs["mhvt"], tmp_path / "g", *CPU)
    src = d[2]
    for i in (1, 2):
        np.testing.assert_array_equal(
            imageio.load_color(tmp_path / "c" / f"frame_{i:05d}.png"),
            src["cvideo"][i])
    assert len(list((tmp_path / "g").glob("frame_*.png"))) == T
    np.testing.assert_array_equal(
        imageio.load_grayscale(tmp_path / "g" / "frame_00007.png"),
        src["video"][7])


STREAMED = {
    "mhv2": ("mhv2", "video"),
    "mhv2-check": ("mhv2", "video", "--check"),
    "mhv2-color": ("mhv2-color", "cvideo"),
    "mhvt": ("mhvt-streamed", "video"),
    "mhts": ("mhts-streamed", "video", "--check"),
}


@pytest.mark.parametrize("case", STREAMED)
def test_streaming_decode_of_jax_streamed_files(case, d, blobs, tmp_path,
                                                capsys):
    name, src, *flags = STREAMED[case]
    out = tmp_path / "s.npy"
    _run(cli.main, "decode-video", blobs[name], out, "--streaming", *flags,
         *CPU)
    np.testing.assert_array_equal(np.load(out), d[2][src])
    capsys.readouterr()
    _run(cli.main, "verify", blobs[name], "--streaming", *CPU)
    assert capsys.readouterr().out.rstrip().endswith("PASS")


INFO = ["mht1", "mht1-zero-init", "mhtv", "mhts", "mhtc-image", "mhtc-video",
        "mhtc-u16", "mhvt", "mhvt-mc", "mhv2", "mhvt-streamed"]
INSPECT = {
    "mht1": ["--table", "--block", "0"],
    "mht1-zero-init": ["--block", "5"],
    "mhtv": ["--block", "17"],
    "mhtc-image": ["--block", "2"],
    "mhvt": ["--table", "--block", "1"],
}


@pytest.mark.parametrize("name", INFO)
def test_info_prints_the_jax_text(name, blobs, capsys):
    _run(jcli.main, "info", blobs[name])
    want = capsys.readouterr().out
    _run(cli.main, "info", blobs[name])
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("name", INSPECT)
def test_inspect_prints_the_jax_text(name, blobs, capsys):
    _run(jcli.main, "inspect", blobs[name], *INSPECT[name])
    want = capsys.readouterr().out
    _run(cli.main, "inspect", blobs[name], *INSPECT[name])
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("name", ["mht1", "mhtv", "mhv2", "mhts", "mhtc-image",
                                  "mhtc-u16", "mhvt-mc", "mhvt-color"])
def test_verify_passes_on_clean_files(name, blobs, capsys):
    _run(cli.main, "verify", blobs[name], *CPU)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "PASS"
    # the end-bit check runs on the CPU too
    assert any(ln.split()[:2] == ["end-bit", "check"]
               and ln.split()[2] == "ok" for ln in lines)


def _flipped_segment(blob: bytes, seg: int):
    """The MHV2 rewritten with one code bit of segment ``seg`` flipped, the
    first bit past its middle whose flip the end-bit check sees -> (blob,
    the checked iterator's per-segment (frames, err))."""
    segs, t, h, w, bd, delta = tfs.read_segmented(blob)
    cfg = CodecConfig(block_dim=bd, delta=delta)
    stream = segs[seg][0]
    for bit in range(4 * stream.code_bytes.size, 8 * stream.code_bytes.size):
        code = stream.code_bytes.copy()
        code[bit // 8] ^= 128 >> (bit % 8)
        bad = list(segs)
        bad[seg] = (dataclasses.replace(stream, code_bytes=code), segs[seg][1])
        checked = list(tfs.iter_frames_segmented_checked(bad, h, w, cfg,
                                                         device="cpu"))
        if checked[seg][2].any():
            out = tfs.write_segmented(bad, h, w, cfg,
                                      source_crc32=tfs.source_crc32(blob))
            return out, [(fr, err) for _si, fr, err in checked]
    raise AssertionError("no detectable flip")


def test_check_and_salvage(d, blobs, tmp_path):
    video = d[2]["video"]
    blob = blobs["mhv2"].read_bytes()
    assert [ft for _s, ft in tfs.read_segmented(blob)[0]] == [4, 4, 2]
    _run(cli.main, "decode-video", blobs["mhv2"], tmp_path / "c.npy",
         "--check", *CPU)
    np.testing.assert_array_equal(np.load(tmp_path / "c.npy"), video)
    bad, checked = _flipped_segment(blob, 1)
    path = tmp_path / "bad.mhv2"
    path.write_bytes(bad)
    msg = _exit_message(cli.main, "decode-video", path, tmp_path / "x.npy",
                        "--check", *CPU)
    assert msg.startswith("stream integrity check failed in segment 1")
    for streaming in ([], ["--streaming"]):
        out = tmp_path / f"s{len(streaming)}.npy"
        _run(cli.main, "decode-video", path, out, "--check", "--salvage",
             *streaming, *CPU)
        # exactly the blocks the mask names are zero-filled, through the
        # JAX package's salvage_blocks
        want = np.concatenate([jfs.salvage_blocks(fr.copy(), err, 8)[0]
                               for fr, err in checked])
        got = np.load(out)
        np.testing.assert_array_equal(got, want)
        n_bad = int(checked[1][1].sum())
        diff = (got != video).reshape(T, H // 8, 8, W // 8, 8).any((2, 4))
        assert 0 < diff.sum() <= n_bad
        assert not diff[:4].any() and not diff[8:].any()


def test_verify_fails_on_a_corrupt_crc_trailer(d, blobs, tmp_path):
    blob = bytearray(blobs["mhv2"].read_bytes())
    end = tfs._trailer_offset(bytes(blob))
    blob[end] ^= 0xFF
    path = tmp_path / "crc.mhv2"
    path.write_bytes(bytes(blob))
    for streaming in ([], ["--streaming"]):
        msg = _exit_message(cli.main, "verify", path, *streaming, *CPU)
        assert "CRC-32" in msg


def test_bench_on_the_cpu(capsys):
    # the JAX CLI's bench formats run_video's tuple as a float and raises
    _run(cli.main, "bench", "--device", "cpu", "--height", "64", "--width",
         "128", "--frames", "3", "--iters", "2")
    out = capsys.readouterr().out.strip().splitlines()[-1]
    gbps, unit, rest = out.split(" ", 2)
    assert float(gbps) > 0 and unit == "GB/s" and rest.endswith("n=5)")


FLAG_ERRORS = {
    # the JAX CLI's tests/test_cli.py::test_cli_flag_validation, and more
    "gray16-stack": ("encode", "v16", ["--gray16"]),
    "mhtc-per-frame-tables": ("encode-video", "cvideo",
                              ["--color", "--per-frame-tables"]),
    "subgreen-without-color": ("encode", "v16", ["--subgreen"]),
    "gray16-and-color": ("encode", "g16", ["--gray16", "--color"]),
    "motion-without-temporal": ("encode-video", "video", ["--motion"]),
    "best-fast-without-temporal": ("encode-video", "video", ["--best-fast"]),
    "best-fast-color": ("encode-video", "cvideo", ["--color", "--best-fast"]),
    "gray16-best": ("encode-video", "v16", ["--gray16", "--best"]),
    "temporal-per-frame-tables": ("encode-video", "video",
                                  ["--temporal", "--per-frame-tables"]),
}


@pytest.mark.parametrize("case", FLAG_ERRORS)
def test_flag_validation_gives_the_jax_messages(case, d, tmp_path):
    cmd, src, flags = FLAG_ERRORS[case]
    path = d[1][src]
    out = tmp_path / "o.bin"
    assert (_exit_message(cli.main, cmd, path, out, *flags)
            == _exit_message(jcli.main, cmd, path, out, *flags))
    assert not out.exists()


def test_decode_video_flag_errors(blobs, tmp_path):
    out = tmp_path / "o.npy"
    cases = [
        (blobs["mhtv"], ["--salvage"]),
        (blobs["mhtv"], ["--frames", "1", "3", "--check"]),
        (blobs["mhvt-mc"], ["--frame", "1", "--check"]),
        (blobs["mhtc-video"], ["--frame", "1", "--check"]),
        (blobs["mhv2"], ["--region", "0", "0", "8", "8", "--frame", "1",
                         "--frames", "1", "2"]),
        (blobs["mhv2"], ["--streaming", "--frame", "2"]),
        (blobs["mhvt"], ["--streaming", "--check"]),
        (blobs["mhtv"], ["--frame", "10"]),
    ]
    for path, flags in cases:
        # the JAX CLI refuses --check off its Pallas backend; each of these
        # refusals comes before any decode
        backend = ["--backend", "pallas" if "--check" in flags else "native"]
        assert (_exit_message(cli.main, "decode-video", path, out, *flags,
                              *CPU)
                == _exit_message(jcli.main, "decode-video", path, out,
                                 *flags, *backend))


# -- the searches ------------------------------------------------------------


def _same_stream(a, b):
    assert a.num_symbols == b.num_symbols and a.predictor == b.predictor
    for f in ("widths", "code_bytes", "block_offsets"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("bd", [4, 8])
def test_image_encode_best_matches_jax(bd, d):
    src = d[2]
    noise = np.random.default_rng(9).integers(0, 256, (H, W), np.uint8)
    for img in (src["gray"], noise):
        ours, used = ImageCodec(CodecConfig(block_dim=bd)).encode_best(img)
        theirs, jused = JaxImageCodec(JaxConfig(block_dim=bd)).encode_best(img)
        _same_stream(ours, theirs)
        assert used == jused


def test_color_best_matches_jax(d):
    rgb = d[2]["rgb"]
    assert tcolor.encode_color_best(rgb) == jcolor.encode_color_best(rgb)
    assert (tcolor.encode_color_best(rgb, CodecConfig(block_dim=4))
            == jcolor.encode_color_best(rgb, JaxConfig(block_dim=4)))
    two = rgb[..., :2].copy()  # no sub-green candidate below 3 channels
    assert tcolor.encode_color_best(two) == jcolor.encode_color_best(two)


def test_sample_indices_match_jax():
    for t in range(1, 80):
        for keyint in range(1, 13):
            assert (ttemporal._sample_indices(t, keyint)
                    == jtemporal._sample_indices(t, keyint))


def _video_cases(d):
    src = d[2]["video"]
    still = np.repeat(src[:1], T, axis=0)
    still[:, 10:20, 10:20] += np.arange(T, dtype=np.uint8)[:, None, None]
    noise = np.random.default_rng(11).integers(0, 256, (T, H, W), np.uint8)
    return {"pan": src, "still": still, "noise": noise}


FIELDS = ("block_dim", "delta", "zero_init", "delta2d", "frame_crcs",
          "temporal", "keyint", "motion")


@pytest.mark.parametrize("fast", [False, True], ids=["best", "best-fast"])
def test_video_searches_match_jax(fast, d):
    ours_fn = (ttemporal.encode_video_best_fast if fast
               else ttemporal.encode_video_best)
    theirs_fn = (jtemporal.encode_video_best_fast if fast
                 else jtemporal.encode_video_best)
    kinds = set()
    for name, frames in _video_cases(d).items():
        for motion in (False, True):
            kw = dict(keyint=4, motion=motion, frame_crcs=motion)
            blob, kind, used = ours_fn(frames, CodecConfig(**kw))
            jblob, jkind, jused = theirs_fn(frames, JaxConfig(**kw))
            assert (blob, kind) == (jblob, jkind), (name, motion)
            assert ([getattr(used, f) for f in FIELDS]
                    == [getattr(jused, f) for f in FIELDS])
            kinds.add(kind)
    assert kinds == {"plain", "temporal", "temporal+motion"}


# -- the copied host modules -------------------------------------------------


def test_canonical_codes_and_single_table_match_jax(d):
    stream = tfs.encode_frames_shared(d[2]["video"][:2])
    for widths in (stream.widths, np.eye(1, 256, 7, dtype=np.uint8)[0]):
        codes = canonical.canonical_codes(widths)
        np.testing.assert_array_equal(codes,
                                      jcanonical.canonical_codes(widths))
        np.testing.assert_array_equal(codes, native.canonical_codes(widths))
        for ours, theirs in zip(tables.build_single_table(widths),
                                jtables.build_single_table(widths)):
            np.testing.assert_array_equal(ours, theirs)


def test_decode_ref_matches_jax_and_the_port(d):
    frames = d[2]["video"][:2]
    stream = tfs.encode_frames_shared(frames, CodecConfig(delta=False))
    n = stream.num_symbols
    buf = np.concatenate([stream.code_bytes, np.zeros(3, np.uint8)])
    for bits in range(0, 8 * stream.code_bytes.size, 7):
        assert (decode_ref._window16(buf, bits)
                == jdecode_ref._window16(buf, bits))
    sym, wid = tables.build_single_table(stream.widths)
    single = jdecode_ref.decode_single_table(stream.code_bytes, sym, wid, n)
    split = jdecode_ref.decode_split_tables(
        stream.code_bytes, jtables.build_split_tables(stream.widths), n)
    np.testing.assert_array_equal(single, split)
    blocks = tfs.decode_frames_shared(stream, 2, H, W, CodecConfig(
        delta=False), device="cpu").numpy()
    from metalhuffman_tpu_torch.core import blocks as tblocks

    np.testing.assert_array_equal(
        single, np.concatenate([tblocks.image_to_blocks(f).ravel()
                                for f in blocks]))


def _tga(img: np.ndarray, top_left: bool) -> bytes:
    """An uncompressed TGA of a gray (H, W) or BGR (H, W, 3) image."""
    h, w = img.shape[:2]
    gray = img.ndim == 2
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 3 if gray else 2, 0, 0, 0, 0,
                       0, w, h, 8 if gray else 24, 0x20 if top_left else 0)
    rows = img if top_left else img[::-1]
    return head + np.ascontiguousarray(rows).tobytes()


def test_imageio_matches_jax(d, tmp_path):
    src = d[2]
    rgba = np.concatenate([src["rgb"], src["rgb"][..., :1]], axis=-1)
    cases = [("gray.gray", src["small"], "grayscale"),
             ("gray.png", src["small"], "grayscale"),
             ("rgb.png", src["rgb"], "color"),
             ("rgba.png", rgba, "color"),
             ("g16.png", src["g16"], "gray16"),
             ("g16.npy", src["g16"], "gray16")]
    for name, img, kind in cases:
        ours, theirs = tmp_path / f"t-{name}", tmp_path / f"j-{name}"
        getattr(imageio, f"save_{kind}")(img, ours)
        getattr(jimageio, f"save_{kind}")(img, theirs)
        assert ours.read_bytes() == theirs.read_bytes(), name
        got = getattr(imageio, f"load_{kind}")(ours)
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(
            got, getattr(jimageio, f"load_{kind}")(theirs))
    # color loads of gray files replicate the channel
    np.testing.assert_array_equal(
        imageio.load_color(tmp_path / "t-gray.gray"),
        jimageio.load_color(tmp_path / "t-gray.gray"))
    for top_left in (False, True):
        for img in (src["small"], src["rgb"][..., ::-1]):
            path = tmp_path / f"x{top_left}{img.ndim}.tga"
            path.write_bytes(_tga(img, top_left))
            np.testing.assert_array_equal(imageio.load_tga(path), img)
            for load in ("load_tga", "load_grayscale", "load_color"):
                np.testing.assert_array_equal(
                    getattr(imageio, load)(path),
                    getattr(jimageio, load)(path))


def test_profiling_times_and_traces(tmp_path):
    import torch

    x = torch.arange(1 << 12, dtype=torch.int32)
    dt, gbps = profiling.time_fn(torch.cumsum, x, 0, iters=3,
                                 payload_bytes=x.numel() * 4)
    assert dt > 0 and gbps > 0
    assert profiling.tensor_device((1, [None, x])) == torch.device("cpu")
    with pytest.raises(ValueError, match="device to time is unknown"):
        profiling.time_fn(sum, (1, 2))
    with profiling.Timer("t") as timer:
        timer.add_bytes(10)
    assert timer.count == 1 and "GB/s" in timer.report()
    with profiling.trace(tmp_path / "trace") as where:
        torch.cumsum(x, 0)
    assert (where / "trace.json").stat().st_size > 0


def test_image_commands_print_the_device(d, tmp_path, capsys):
    _root, paths, _arrays = d
    _run(cli.main, "roundtrip", paths["rgb"], "--color", *CPU)
    _run(cli.main, "roundtrip", paths["g16"], "--gray16", *CPU)
    _run(cli.main, "roundtrip", paths["small"], "--block-dim", "2", *CPU)
    _run(cli.main, "encode", paths["rgb"], tmp_path / "c.mhtc", "--color")
    _run(cli.main, "decode", tmp_path / "c.mhtc", tmp_path / "c.png", *CPU)
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(" bit-exact on ")[1].split(";")[0]
            for ln in out[:3]] == ["cpu"] * 3
    assert "(cpu)" in out[-1]
    np.testing.assert_array_equal(imageio.load_color(tmp_path / "c.png"),
                                  d[2]["rgb"])


# -- the streaming writer and surgery verbs ----------------------------------


def _said(capsys, root: Path) -> tuple[str, str]:
    """What a command printed, stdout and stderr, with ``root`` cut out of
    the paths and the timings (``in 0.01 s``, ``0.3 ms``) left out."""
    import re

    got = capsys.readouterr()
    return tuple(re.sub(r"\d+\.\d+ (s|ms)\b", "T", text.replace(
        str(root), "<dir>")) for text in (got.out, got.err))


def _both_clis(capsys, tmp_path, files: dict, *argv, port=CPU, jax=()):
    """Run ``argv`` through both CLIs, each in a directory of its own that
    holds ``files`` (name -> bytes); ``@name`` in ``argv`` is a path there.
    Both must print the same lines (less timings) and leave the same files
    -> the port's directory."""
    outs = []
    for main, extra, sub in ((cli.main, port, "t"), (jcli.main, jax, "j")):
        root = tmp_path / sub
        root.mkdir(exist_ok=True)
        for name, data in files.items():
            (root / name).write_bytes(data)
        args = [str(root / a[1:]) if str(a).startswith("@") else str(a)
                for a in argv]
        _run(main, *args, *extra)
        outs.append((_said(capsys, root), {
            p.name: p.read_bytes() for p in sorted(root.iterdir())}))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == outs[1][1]
    return tmp_path / "t", outs[0][0]


STREAMING_ENCODES = {
    # id: (input, flags)
    "gray": ("video", ["--segment-frames", "3", "--frame-crcs"]),
    "gray-default-capacity": ("video", ["--delta2d"]),
    "bd16-zero-init": ("video", ["--block-dim", "16", "--zero-init",
                                 "--segment-frames", "4"]),
    "color-subgreen": ("cvideo", ["--color", "--subgreen",
                                  "--segment-frames", "2"]),
    "gray16": ("v16", ["--gray16", "--segment-frames", "3",
                       "--frame-crcs"]),
    "temporal-motion": ("video", ["--temporal", "--motion", "--keyint", "4",
                                  "--segment-frames", "3", "--frame-crcs"]),
    "temporal-color": ("cvideo", ["--temporal", "--color", "--keyint", "3",
                                  "--segment-frames", "2"]),
    "temporal-gray16": ("v16", ["--temporal", "--gray16", "--keyint", "4"]),
    "per-frame-tables": ("video", ["--per-frame-tables"]),
}


@pytest.mark.parametrize("case", STREAMING_ENCODES)
def test_streaming_encode_matches_the_jax_cli(case, d, tmp_path, capsys):
    src, flags = STREAMING_ENCODES[case]
    _root, paths, arrays = d
    files = {"in.npy": paths[src].read_bytes()}
    root, (out, _err) = _both_clis(
        capsys, tmp_path, files, "encode-video", "@in.npy", "@o.bin",
        "--streaming", *flags, jax=NATIVE)
    assert "streamed]" in out
    dec = tmp_path / "d.npy"
    _run(cli.main, "decode-video", root / "o.bin", dec, *CPU)
    np.testing.assert_array_equal(np.load(dec), arrays[src])


APPENDS = {
    # id: (input, split, flags)
    "mhv2": ("video", 4, ["--segment-frames", "2", "--frame-crcs"]),
    "mhvt-motion-mid-group": ("video", 6, ["--temporal", "--motion",
                                           "--keyint", "4",
                                           "--segment-frames", "3",
                                           "--frame-crcs"]),
    "mhvt-color": ("cvideo", 4, ["--temporal", "--color", "--keyint", "2",
                                 "--segment-frames", "2"]),
    "mhts": ("video", 3, ["--per-frame-tables"]),
}


@pytest.mark.parametrize("case", APPENDS)
def test_append_matches_the_jax_cli_and_the_oneshot(case, d, tmp_path,
                                                    capsys):
    src, split, flags = APPENDS[case]
    frames = d[2][src]
    parts = {}
    for name, arr in (("a.npy", frames[:split]), ("b.npy", frames[split:]),
                      ("all.npy", frames)):
        np.save(tmp_path / name, arr)
        parts[name] = (tmp_path / name).read_bytes()
    root, _ = _both_clis(capsys, tmp_path, parts, "encode-video", "@a.npy",
                         "@cap.bin", "--streaming", *flags, jax=NATIVE)
    parts["cap.bin"] = (root / "cap.bin").read_bytes()
    root, (out, _err) = _both_clis(
        capsys, tmp_path, parts, "encode-video", "@b.npy", "@cap.bin",
        "--streaming", "--append", *flags, jax=NATIVE)
    assert ", appended," in out
    _run(cli.main, "encode-video", tmp_path / "all.npy", tmp_path / "one.bin",
         "--streaming", *flags)
    if split % 2 == 0 or "--per-frame-tables" in flags:
        assert (root / "cap.bin").read_bytes() == \
            (tmp_path / "one.bin").read_bytes()
    dec = tmp_path / "d.npy"
    _run(cli.main, "decode-video", root / "cap.bin", dec, *CPU)
    np.testing.assert_array_equal(np.load(dec), frames)


@pytest.fixture(scope="module")
def surgery_files(d):
    """JAX-CLI-written containers for the surgery verbs, as bytes."""
    root, paths, _arrays = d
    made = {
        "mhtv": ("video", ["--frame-crcs"], False),
        "mhtv-no-crc": ("video", [], False),
        "mhv2": ("video", ["--streaming", "--segment-frames", "3",
                           "--frame-crcs"], False),
        "mhts": ("video", ["--per-frame-tables"], False),
        "mhtc": ("cvideo", ["--color", "--subgreen", "--frame-crcs"], False),
        "mhvt": ("video", ["--temporal", "--keyint", "4", "--frame-crcs"],
                 False),
        "mhvt-mc": ("video", ["--temporal", "--motion", "--keyint", "4",
                              "--streaming", "--segment-frames", "3"], True),
    }
    out = {}
    for name, (src, flags, _streamed) in made.items():
        path = root / f"surgery-{name}.bin"
        _run(jcli.main, "encode-video", paths[src], path, *flags, *NATIVE)
        out[name] = path.read_bytes()
    return out


SURGERY = {
    # id: (argv with @file names, files, device flag)
    "extract-mhv2": (["extract", "@mhv2", "@o", "--frames", "2", "8"], True),
    "extract-no-crc-note": (["extract", "@mhtv-no-crc", "@o", "--frames",
                             "1", "4"], True),
    "extract-mhts-note": (["extract", "@mhts", "@o", "--frames", "3", "9"],
                          True),
    "extract-mhtc": (["extract", "@mhtc", "@o", "--frames", "0", "5"], True),
    "extract-mhvt-keyframe": (["extract", "@mhvt", "@o", "--frames", "4",
                               "10"], True),
    "extract-mhvt-mid-group": (["extract", "@mhvt", "@o", "--frames", "2",
                                "9"], True),
    "extract-mhvt-mc-mid-group-note": (["extract", "@mhvt-mc", "@o",
                                        "--frames", "5", "10"], True),
    "concat": (["concat", "@o", "@mhtv", "@mhv2"], False),
    "concat-fcrc-and-not": (["concat", "@o", "@mhtv", "@mhtv-no-crc"], False),
    "concat-streaming": (["concat", "@o", "@mhv2", "@mhtv", "--streaming"],
                         False),
    "concat-streaming-fcrc-and-not": (["concat", "@o", "@mhtv-no-crc", "@mhtv",
                                 "--streaming"], False),
    "concat-mhts-note": (["concat", "@o", "@mhts", "@mhts"], False),
    "resegment": (["resegment", "@mhtv", "@o", "--segment-frames", "3"],
                  False),
    "resegment-no-fcrc": (["resegment", "@mhtv-no-crc", "@o",
                          "--segment-frames", "4"], False),
    "resegment-mhtc": (["resegment", "@mhtc", "@o", "--segment-frames", "2"],
                       False),
    "resegment-mhvt": (["resegment", "@mhvt-mc", "@o", "--segment-frames",
                        "2"], False),
}


@pytest.mark.parametrize("case", SURGERY)
def test_surgery_verbs_match_the_jax_cli(case, surgery_files, tmp_path,
                                         capsys):
    argv, device = SURGERY[case]
    _root, (out, err) = _both_clis(capsys, tmp_path, surgery_files, *argv,
                                   port=CPU if device else ())
    assert out.strip()
    assert ("note" in case) == ("note:" in err)


SURGERY_ERRORS = {
    "extract-range": ["extract", "@mhtv", "@o", "--frames", "5", "12"],
    "extract-mhvt-range": ["extract", "@mhvt", "@o", "--frames", "3", "11"],
    "concat-kinds": ["concat", "@o", "@mhtv", "@mhts"],
    "concat-partial-groups": ["concat", "@o", "@mhvt", "@mhvt"],
    "concat-streaming-mhvt": ["concat", "@o", "@mhvt", "@mhvt",
                              "--streaming"],
    "resegment-zero": ["resegment", "@mhtv", "@o", "--segment-frames", "0"],
}


@pytest.mark.parametrize("case", SURGERY_ERRORS)
def test_surgery_errors_give_the_jax_messages(case, surgery_files, tmp_path):
    msgs = []
    for main in (cli.main, jcli.main):
        root = tmp_path / main.__module__
        root.mkdir()
        for name, data in surgery_files.items():
            (root / name).write_bytes(data)
        argv = [str(root / a[1:]) if a.startswith("@") else a
                for a in SURGERY_ERRORS[case]]
        msgs.append(_exit_message(main, *argv).replace(str(root), "<dir>"))
    assert msgs[0] == msgs[1]


STREAMING_FLAG_ERRORS = {
    "segment-frames-without-streaming": ("video", ["--segment-frames", "2"]),
    "append-without-streaming": ("video", ["--append"]),
    "append-to-nothing": ("video", ["--streaming", "--append"]),
    "streaming-best": ("video", ["--streaming", "--best"]),
    "streaming-best-fast": ("video", ["--streaming", "--temporal",
                                      "--best-fast"]),
    "streaming-motion-without-temporal": ("video", ["--streaming",
                                                    "--motion"]),
    "streaming-gray16-and-color": ("v16", ["--streaming", "--gray16",
                                           "--color"]),
    "streaming-mhts-temporal": ("video", ["--streaming", "--temporal",
                                          "--per-frame-tables"]),
    "streaming-mhts-color": ("cvideo", ["--streaming", "--color",
                                        "--per-frame-tables"]),
    "streaming-mhts-segments": ("video", ["--streaming",
                                          "--per-frame-tables",
                                          "--segment-frames", "2"]),
    "streaming-segment-frames-zero": ("video", ["--streaming",
                                                "--segment-frames", "0"]),
    "streaming-subgreen-without-color": ("video", ["--streaming",
                                                   "--subgreen"]),
    "streaming-gray16-not-u16": ("video", ["--streaming", "--gray16"]),
}


@pytest.mark.parametrize("case", STREAMING_FLAG_ERRORS)
def test_streaming_flag_errors_give_the_jax_messages(case, d, tmp_path):
    src, flags = STREAMING_FLAG_ERRORS[case]
    path = d[1][src]
    out = tmp_path / "o.bin"
    assert (_exit_message(cli.main, "encode-video", path, out, *flags, *CPU)
            == _exit_message(jcli.main, "encode-video", path, out, *flags,
                             *NATIVE))
    assert not out.exists()


def test_append_mismatch_is_the_jax_message_and_keeps_the_file(d, tmp_path):
    path = d[1]["video"]
    cap = tmp_path / "cap.mhvt"
    _run(cli.main, "encode-video", path, cap, "--streaming", "--temporal",
         "--keyint", "4")
    orig = cap.read_bytes()
    msgs = [_exit_message(main, "encode-video", path, cap, "--streaming",
                          "--temporal", "--keyint", "5", "--append", *extra)
            for main, extra in ((cli.main, CPU), (jcli.main, NATIVE))]
    assert msgs[0] == msgs[1] and "keyint" in msgs[0]
    assert cap.read_bytes() == orig


def test_streamed_surgery_errors_are_clean(surgery_files, tmp_path):
    # the JAX package's walker raises BufferError here (mmap.close() while
    # a slice of the map is still referenced); the port releases its views
    for name, data in surgery_files.items():
        (tmp_path / name).write_bytes(data)
    (tmp_path / "cut").write_bytes(surgery_files["mhv2"][:200])
    cases = [
        (["resegment", "mhts", "o", "--segment-frames", "2"],
         "not a video container"),
        (["resegment", "cut", "o", "--segment-frames", "2"],
         "truncated container"),
        (["concat", "o", "cut", "--streaming"], "truncated container"),
        (["concat", "o", "mhts", "mhtv", "--streaming"],
         "not a video container"),
    ]
    for argv, msg in cases:
        args = [str(tmp_path / a) if a in surgery_files or a in ("o", "cut")
                else a for a in argv]
        assert msg in _exit_message(cli.main, *args)


# -- --device native: the host C++ decoder ----------------------------------------

TNATIVE = ["--device", "native"]
NATIVE_DECODES = {
    # id: (command, container, flags, output suffix)
    "mht1": ("decode", "mht1", [], ".png"),
    "mht1-zero-init": ("decode", "mht1-zero-init", [], ".png"),
    "mhtc-image": ("decode", "mhtc-image", [], ".png"),
    "mhtv": ("decode-video", "mhtv", [], ".npy"),
    "mhv2": ("decode-video", "mhv2", [], ".npy"),
    "mhts": ("decode-video", "mhts", [], ".npy"),
    "mhvt": ("decode-video", "mhvt", [], ".npy"),
    "mhvt-mc": ("decode-video", "mhvt-mc", [], ".npy"),
    "mhvt-color": ("decode-video", "mhvt-color", [], ".npy"),
    "mhtc-u16": ("decode-video", "mhtc-u16", [], ".npy"),
    "frames": ("decode-video", "mhv2", ["--frames", "3", "9"], ".npy"),
    "frame": ("decode-video", "mhts", ["--frame", "3"], ".npy"),
    "region-check": ("decode-video", "mhv2",
                     ["--region", "3", "5", "30", "40", "--frames", "2", "7",
                      "--check"], ".npy"),
    "temporal-frames": ("decode-video", "mhvt-mc", ["--frames", "3", "9"],
                        ".npy"),
    "streamed": ("decode-video", "mhv2", ["--streaming"], ".npy"),
}


@pytest.mark.parametrize("case", NATIVE_DECODES)
def test_native_decodes_match_the_jax_cli(case, blobs, tmp_path):
    cmd, name, flags, suffix = NATIVE_DECODES[case]
    out_t, out_j = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
    _run(cli.main, cmd, blobs[name], out_t, *flags, *TNATIVE)
    _run(jcli.main, cmd, blobs[name], out_j, *flags, *NATIVE)
    assert out_t.read_bytes() == out_j.read_bytes()


NATIVE_REFUSALS = {
    # id: (container, flags)
    "mhtv": ("mhtv", []),
    "mhts": ("mhts", []),
    "mhvt": ("mhvt-mc", []),
    "mhtc": ("mhtc-video", []),
    "streamed-mhv2": ("mhv2", ["--streaming"]),
    "streamed-mhts": ("mhts-streamed", ["--streaming"]),
}


@pytest.mark.parametrize("case", NATIVE_REFUSALS)
def test_native_check_is_refused_with_the_jax_message(case, blobs, tmp_path):
    name, flags = NATIVE_REFUSALS[case]
    ours = _exit_message(cli.main, "decode-video", blobs[name],
                         tmp_path / "t.npy", "--check", *flags, *TNATIVE)
    theirs = _exit_message(jcli.main, "decode-video", blobs[name],
                           tmp_path / "j.npy", "--check", *flags, *NATIVE)
    assert ours == cli.NATIVE_CHECK_REFUSAL
    assert ours == theirs.replace("--backend pallas", "--device cuda").replace(
        "TPU", "CUDA")
    assert not (tmp_path / "t.npy").exists()


@pytest.mark.parametrize("name,flags", [
    ("mht1", []), ("mhtv", []), ("mhv2", []), ("mhts", []), ("mhvt-mc", []),
    ("mhtc-u16", []), ("mhv2", ["--streaming"]),
    ("mhts-streamed", ["--streaming"])])
def test_native_verify_prints_the_jax_lines(name, flags, blobs, capsys):
    _run(jcli.main, "verify", blobs[name], *flags, *NATIVE)
    want = capsys.readouterr().out.replace("--backend pallas",
                                           "--device cuda")
    _run(cli.main, "verify", blobs[name], *flags, *TNATIVE)
    got = capsys.readouterr().out
    assert got == want
    assert f"end-bit check  {cli.END_BIT_SKIPPED}" in got
    assert got.rstrip().endswith("PASS")


def test_device_native_parses_and_bench_refuses_it():
    ap_err = _exit_message(cli.main, "bench", "--device", "native")
    assert ap_err == "2"  # argparse refuses the value
    assert cli._device("native") == "native"
    assert cli._device("cpu") == "cpu"
