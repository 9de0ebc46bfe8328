"""The port's twins of the examples and scripts (``examples/*_torch.py``,
``scripts/*_torch.py``) on the CPU, and the MHVT throughput functions of the
port's ``bench``.

Each example twin's ``main(["--device", "cpu"])`` must return blobs
byte-equal to what the JAX package's host encoders write for the same
inputs, and decoded arrays equal to their sources. The JAX side runs only
its host encoders (``backend="native"``) and its fixtures: no Pallas
compile. The bridge photo is cut to its top-left 768x768 where the full
frame would make a test slow (the video twin's 256x256 region at (512,
512) still fits). The streaming pipeline twin prints the JAX example's
lines on that crop. The multi-process twins run as gloo ranks, the
streaming gate as a subprocess driving the port's CLI.
"""

import importlib.util
import io
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import metalhuffman_tpu as mh
from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import color as jcolor
from metalhuffman_tpu.models import stream_writer as jsw
from metalhuffman_tpu.models import surgery as jsurgery
from metalhuffman_tpu.models import temporal as jtemporal
from metalhuffman_tpu.utils import fixtures as jfx
from metalhuffman_tpu_torch import bench
from metalhuffman_tpu_torch.models import temporal as ttemporal
from metalhuffman_tpu_torch.utils import fixtures as tfx

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
TIMEOUT = 300  # seconds for a twin's subprocess


def _load(rel: str):
    """A twin's file as a module of its own."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def crop(monkeypatch):
    """``render_frame("bridge")`` in the port cut to 768x768 -> the crop."""
    cut = jfx.render_frame("bridge")[:768, :768].copy()
    full = tfx.render_frame
    monkeypatch.setattr(tfx, "render_frame", lambda name, path=None: (
        cut.copy() if name == "bridge" and path is None else full(name, path)))
    return cut


def _decoded_equal(out, labels):
    assert list(out["decoded"]) == labels
    for got, want in out["decoded"].values():
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    return {k: want for k, (_, want) in out["decoded"].items()}


def _native(**kw):
    return JaxConfig(backend="native", **kw)


def test_quickstart_twin(capsys):
    out = _load("examples/quickstart_torch.py").main(CPU)
    src = _decoded_equal(out, ["decode_image", "decode_step",
                               "decode_video"])
    img = jfx.render_frame("image1")
    frames = np.stack([jfx.render_frame("16x16_ident"),
                       jfx.render_frame("16x16_ident2")])
    np.testing.assert_array_equal(src["decode_image"], img)
    np.testing.assert_array_equal(src["decode_video"], frames)
    assert out["blobs"]["image"] == mh.encode_image(img, _native())
    assert out["blobs"]["video"] == mh.encode_video(frames, _native())
    text = capsys.readouterr().out
    assert "encode_best: predictor='2d'" in text
    assert text.strip().splitlines()[-1] == "quickstart OK"


def test_video_pipeline_twin(crop, capsys):
    out = _load("examples/video_pipeline_torch.py").main(CPU)
    src = _decoded_equal(out, [
        "decode_video", "StreamingDecoder", "decode_frame 4",
        "decode_shared_step_checked", "decode_video temporal",
        "decode_temporal_frame 4", "decode_video_region",
        "decode_video extract", "decode_video concat"])
    frames = np.stack([np.roll(crop, 16 * t, axis=1) for t in range(6)])
    np.testing.assert_array_equal(src["decode_video"], frames)
    np.testing.assert_array_equal(src["decode_video_region"],
                                  frames[2:5, 512:768, 512:768])
    assert out["blobs"]["video"] == mh.encode_video(
        frames, _native(delta2d=True))
    tblob, kind, _ = jtemporal.encode_video_best(
        frames, _native(delta2d=True, temporal=True, motion=True))
    assert out["kind"] == kind
    assert out["blobs"]["temporal"] == tblob
    part = jsurgery.extract_video(out["blobs"]["video"], 1, 5)
    assert out["blobs"]["extract"] == part
    assert out["blobs"]["concat"] == jsurgery.concat_videos(
        [part, out["blobs"]["video"]])
    np.testing.assert_array_equal(src["decode_video concat"],
                                  np.concatenate([frames[1:5], frames]))
    text = capsys.readouterr().out
    assert (f"surgery: extract+concat bit-exact, zero re-encode ({len(part)}"
            f" + {len(out['blobs']['video'])} -> "
            f"{len(out['blobs']['concat'])} bytes)") in text
    assert text.strip().splitlines()[-1] == "video pipeline OK"


def test_streaming_pipeline_twin_prints_the_jax_examples_lines(crop,
                                                               monkeypatch,
                                                               capsys):
    out = _load("examples/streaming_pipeline_torch.py").main(CPU)
    src = _decoded_equal(out, ["iter_frames_segmented", "decode_color_video",
                               "iter_temporal_video",
                               "decode_temporal_video"])
    ours = capsys.readouterr().out.strip().splitlines()
    # the JAX example on the same crop, its host decoder and its own files
    monkeypatch.setattr(jfx, "render_frame", lambda name, path=None: (
        crop.copy() if name == "bridge" else None))
    _load("examples/streaming_pipeline.py").main()
    assert ours == capsys.readouterr().out.strip().splitlines()
    assert ours[-1] == "OK"
    frames = np.stack([np.roll(crop, (3 * t, 16 * t), axis=(0, 1))
                       for t in range(24)])
    np.testing.assert_array_equal(src["iter_frames_segmented"], frames)
    np.testing.assert_array_equal(src["decode_temporal_video"], frames[:12])
    # the blobs, against the JAX package's writers on the same frames
    h, w = crop.shape
    sink = io.BytesIO()
    with jsw.StreamingEncoder(sink, h, w, _native(), max_segment_frames=6,
                              frame_crcs=True) as enc:
        enc.push(frames)
    assert out["blobs"]["mhv2"] == sink.getvalue()
    cframes = src["decode_color_video"]
    sink = io.BytesIO()
    with jsw.ColorStreamingEncoder(sink, 512, 512, channels=3,
                                   config=_native(),
                                   colorspace=jcolor.CS_SUBGREEN,
                                   max_segment_frames=2) as enc:
        enc.push(cframes)
    assert out["blobs"]["color"] == sink.getvalue()
    tcfg = _native(temporal=True, keyint=4, motion=True)
    assert out["blobs"]["temporal"] == jtemporal.encode_temporal_video(
        frames[:12], tcfg)
    sink = io.BytesIO()
    with jsw.TemporalStreamingEncoder(
            sink, h, w, _native(temporal=True, keyint=3, motion=True),
            max_segment_frames=3, frame_crcs=True) as enc:
        enc.push(frames[:12])
    assert out["blobs"]["resumed"] == sink.getvalue()


def test_color_pipeline_twin(crop):
    out = _load("examples/color_pipeline_torch.py").main(CPU)
    src = _decoded_equal(out, ["decode_color_image", "decode_color_video",
                               "decode_color_frame 2", "decode_gray16"])
    # the original's inputs, rebuilt from the same crop
    luma = crop.astype(np.int32)
    h, w = luma.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cb = 30 * np.sin(xx / 97.0) + 10 * np.cos(yy / 61.0)
    cr = 25 * np.cos(xx / 83.0) - 12 * np.sin(yy / 53.0)
    img = np.stack([np.clip(luma + 1.4 * cr, 0, 255),
                    np.clip(luma - 0.34 * cb - 0.71 * cr, 0, 255),
                    np.clip(luma + 1.77 * cb, 0, 255)],
                   axis=-1).astype(np.uint8)
    frames = np.stack([np.roll(img, 24 * t, axis=1) for t in range(4)])
    depth = (20000 + 40 * luma + 8 * yy).astype(np.uint16)
    np.testing.assert_array_equal(src["decode_color_image"], img)
    np.testing.assert_array_equal(src["decode_color_video"], frames)
    np.testing.assert_array_equal(src["decode_gray16"], depth)
    cfg = _native(delta2d=True)
    assert out["blobs"]["image"] == mh.encode_color_image(img, cfg)
    assert out["blobs"]["video"] == mh.encode_color_video(frames, cfg)
    assert out["blobs"]["gray16"] == jcolor.encode_gray16_to_bytes(depth, cfg)


MHVT_KINDS = {
    "gray": (bench.run_temporal, {}),
    "motion": (bench.run_temporal_ext, {"motion": True}),
    "color": (bench.run_temporal_ext, {"inner": "color"}),
    "u16": (bench.run_temporal_ext, {"inner": "u16"}),
    "color+motion": (bench.run_temporal_ext,
                     {"inner": "color", "motion": True}),
}


@pytest.mark.parametrize("kind", list(MHVT_KINDS))
def test_bench_mhvt_rates_and_checks(kind, monkeypatch):
    fn, kw = MHVT_KINDS[kind]
    args = dict(height=64, width=96, frames=4, iters=2, content="photo",
                variants=2, keyint=3, device="cpu", **kw)
    gbps, reps, spread = fn(**args)
    assert gbps > 0 and reps == bench.REPS and spread >= 0
    fold = ttemporal.fold_planes
    monkeypatch.setattr(ttemporal, "fold_planes",
                        lambda *a, **k: torch.zeros_like(fold(*a, **k)))
    with pytest.raises(ValueError, match="decode mismatch on variant 0"):
        fn(**args)


def test_bench_mhvt_refuses_an_unknown_inner():
    with pytest.raises(ValueError, match="unknown inner"):
        bench.run_temporal_ext(16, 16, 2, 1, inner="rgb", device="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_multihost_twin_on_two_gloo_ranks():
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "examples/multihost_decode_torch.py"),
         *CPU, "--init-method", init, "--world-size", "2", "--rank",
         str(rank)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        lines = out.strip().splitlines()
        assert f"[p{rank}] joined: 2 processes, gloo on cpu" in lines
        assert f"[p{rank}] bit-exact across 2 processes ((2,)) OK" in lines
        assert lines[-1].startswith(
            f"[p{rank}] encode byte-identical across 2 processes")


def test_scaling_report_twin_on_two_gloo_ranks(capsys):
    results = _load("examples/scaling_report_torch.py").main(
        [*CPU, "--world", "2", "--iters", "2"])
    assert [r["world"] for r in results] == [1, 2]
    assert all(r["bit_exact"] and r["byte_identical"] for r in results)
    assert results[0]["single_ms"] > 0 and results[1]["single_ms"] is None
    text = capsys.readouterr().out
    assert "frame=1024x64x2" in text and "scaling" in text


GATE_ARGS = [*CPU, "--height", "16", "--width", "64", "--frames", "6"]


def test_streaming_gate_twin_passes():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts/streaming_gate_torch.py"),
         *GATE_ARGS], cwd=ROOT, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "STREAMING GATE: ALL PASS (device cpu)"
    passes = [ln for ln in lines if ln.startswith("PASS")]
    assert len(passes) == 12
    assert "PASS  corrupted CRC fails streamed verify" in passes
    assert "PASS  resegmented archive streamed decode: bit-exact" in passes
    assert ("PASS  capture resume (--append): byte-identical to one-shot"
            in passes)
    assert not any(ln.startswith("SKIP") for ln in lines)


def test_streaming_gate_twin_fails_when_a_corrupt_trailer_is_accepted(
        monkeypatch, capsys):
    gate = _load("scripts/streaming_gate_torch.py")
    monkeypatch.setattr(gate, "corrupt_trailer", lambda blob: blob)
    with pytest.raises(SystemExit) as e:
        gate.main(GATE_ARGS)
    assert e.value.code == 1
    assert "FAIL (expected failure): verify" in capsys.readouterr().out


def test_perf_matrix_twin_table(monkeypatch, capsys):
    calls = []

    def runner(name, gbps):
        def run(h, w, frames, iters, **kw):
            calls.append((name, h, w, frames, iters, kw))
            return gbps, 5, 1.0
        return run

    monkeypatch.setattr(bench, "run_video", runner("video", 1.5))
    monkeypatch.setattr(bench, "run_temporal", runner("temporal", 0.94))
    monkeypatch.setattr(bench, "run_temporal_ext", runner("ext", 9.4))
    native_calls = []
    run_native = bench.run_native

    def native(*a, **kw):  # the real host decode, at 3 frames
        native_calls.append((a, kw))
        return run_native(*a, **kw)

    monkeypatch.setattr(bench, "run_native", native)
    rows = _load("scripts/perf_matrix_torch.py").main(
        [*CPU, "--frames", "3", "--iters", "4", "--variants", "2"])
    b1 = "B1 plain version"
    assert native_calls == [((1536, 2048, 3, 4), {"content": "photo"})]
    assert rows[-1][:3] == ("2048x1536", "photo", "C++ host (all cores)")
    assert rows[-1][3] > 0
    rows = rows[:-1]
    assert [r[:3] for r in rows] == [
        ("2048x1536", "synthetic", b1), ("2048x1536", "photo", b1),
        ("1920x1080", "synthetic", b1), ("1920x1080", "photo", b1),
        ("2048x1536", "photo", f"{b1}, delta2d"),
        ("2048x1536", "photo", "MHVT fold (plain gray)"),
        ("2048x1536", "photo", "MHVT fold (motion)"),
        ("2048x1536", "photo", "MHVT fold (color)"),
        ("2048x1536", "photo", "MHVT fold (u16)"),
        ("2048x1536", "photo", "MHVT fold (color+motion)")]
    assert [c[1:5] for c in calls] == (
        [(1536, 2048, 3, 4)] * 2 + [(1080, 1920, 3, 4)] * 2
        + [(1536, 2048, 3, 4)] * 6)
    assert all(c[5]["device"] == "cpu" and c[5]["variants"] == 2
               for c in calls)
    assert calls[4][5]["precoder"] == "delta2d"
    assert [c[5].get("motion", False) for c in calls[6:]] == [
        True, False, False, True]
    assert [c[5].get("inner", "gray") for c in calls[6:]] == [
        "gray", "color", "u16", "color"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert "## Decode throughput (3 frames/batch, device=cpu)" in lines
    assert "| geometry | content | path | GB/s | vs 0.094 GB/s target |" \
        in lines
    assert "| 2048x1536 | synthetic | B1 plain version | 1.50 | 16x |" in lines
    assert "| 2048x1536 | photo | MHVT fold (plain gray) | 0.94 | 10x |" \
        in lines
    assert any(ln.startswith("| 2048x1536 | photo | C++ host (all cores) | ")
               for ln in lines)
    assert "| 2048x1536 | photo | MHVT fold (u16) | 9.40 | 100x |" in lines
