"""The port's profiler marks and spans (``utils.profiling.mark`` and
``span``): none is built while no profiler records; under
``torch.profiler`` a range request records the marks ``range.stage``,
``range.decode`` and ``range.fetch`` and the span ``range.crc`` in that
order, and a fold call the mark ``fold``; no torch operator runs inside any
of them, so none would hold a device operation on a card; traced and
untraced calls give the same bytes. All on the CPU, with no JAX.
"""

import contextlib
import zlib

import numpy as np
import pytest
import torch

from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models import temporal
from metalhuffman_tpu_torch.models.config import CodecConfig
from metalhuffman_tpu_torch.utils import profiling

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

T, H, W = 5, 24, 40
RANGE = (1, 4)
#: the marks of one staged decode, in order
STAGE = ["range.stage", "range.decode"]
SPAN_NAMES = set(STAGE) | {"range.fetch", "range.crc", "fold"}


def _frames():
    rng = np.random.default_rng(7)
    img = np.clip(100 + 60 * np.sin(np.arange(W) / 5.0)[None, :]
                  + rng.normal(0, 6, (H, W)), 0, 255).astype(np.uint8)
    return np.stack([np.roll(img, (2 * i, 3 * i), (0, 1)) for i in range(T)])


@pytest.fixture(scope="module")
def containers():
    """{kind: parsed container} of one clip, every kind with per-frame
    CRCs: MHTV, MHV2 of two-frame segments, MHTS."""
    frames = _frames()
    cfg = CodecConfig(frame_crcs=True)
    fcrcs = tfs.compute_frame_crcs(frames)
    segs = tfs.encode_frames_segmented(frames, cfg,
                                       max_segment_bits=2 * H * W * 10)
    blobs = {
        "MHTV": tfs.write_shared(tfs.encode_frames_shared(frames, cfg), T, H,
                                 W, cfg, frame_crcs=fcrcs),
        "MHV2": tfs.write_segmented(segs, H, W, cfg, frame_crcs=fcrcs),
        "MHTS": tfs.write_stream(tfs.encode_frames(frames, cfg), H, W, cfg,
                                 source_crc32s=[zlib.crc32(f.tobytes())
                                                for f in frames]),
    }
    return frames, {k: tfs.parse_range_container(b) for k, b in blobs.items()}


@pytest.fixture(scope="module")
def residuals():
    """(residual planes, motion vectors) of a panned clip, keyframe every 4."""
    frames = _frames()
    res, mvs = temporal.temporal_encode_mc(frames, 4)
    assert np.any(mvs[1:])
    return frames, res, mvs


def _range(parsed):
    return tfs.decode_range_parsed(parsed, *RANGE, device="cpu")[0]


def _fold(res, mvs):
    return temporal.fold_planes(torch.from_numpy(res.copy()), 4, mvs, None,
                                None).numpy()


def _traced(fn, everything=False):
    """-> (``fn()``, [(start, end, name)] of the port's marks and spans it
    recorded, by start; with ``everything`` also the list of every event the
    profiler recorded)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events())
    spans = [ev for ev in events if ev[2] in SPAN_NAMES]
    return (out, spans, events) if everything else (out, spans)


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    one, two = profiling.span("range.crc"), profiling.span("fold")
    assert one is two and isinstance(one, contextlib.nullcontext)
    assert profiling.mark("fold") is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.span("fold") is not one


@pytest.mark.parametrize("case", ["MHTV", "MHV2", "MHTS", "fold"])
def test_untraced_calls_build_no_span(case, containers, residuals,
                                      monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name!r} built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    if case == "fold":
        frames, res, mvs = residuals
        np.testing.assert_array_equal(_fold(res, mvs), frames)
    else:
        frames, parsed = containers
        np.testing.assert_array_equal(_range(parsed[case]),
                                      frames[slice(*RANGE)])


@pytest.mark.parametrize("kind", ["MHTV", "MHV2", "MHTS"])
def test_range_request_records_its_spans_in_order(kind, containers):
    frames, parsed = containers
    out, spans = _traced(lambda: _range(parsed[kind]))
    np.testing.assert_array_equal(out, frames[slice(*RANGE)])
    n = RANGE[1] - RANGE[0]
    tail = ["range.fetch", "range.crc"]
    want = {"MHTV": STAGE + tail,
            # frames 1-3 straddle the segments [0, 2) and [2, 4)
            "MHV2": STAGE * 2 + tail,
            "MHTS": (STAGE + tail) * n}[kind]
    assert [name for _, _, name in spans] == want
    for i, (s, e, name) in enumerate(spans):
        # the four steps follow one another, none inside another
        assert all(sp[1] <= s for sp in spans[:i]), name


@pytest.mark.parametrize("motion", [True, False], ids=["mc", "group"])
def test_fold_records_one_fold_span(motion, residuals):
    frames, res, mvs = residuals
    if not motion:
        res, mvs = temporal.temporal_encode(frames, 4), None
    out, spans = _traced(lambda: _fold(res, mvs))
    np.testing.assert_array_equal(out, frames)
    assert [name for _, _, name in spans] == ["fold"]


@pytest.mark.parametrize("case", ["MHTV", "MHV2", "MHTS", "fold"])
def test_traced_and_untraced_bytes_are_identical(case, containers,
                                                  residuals):
    if case == "fold":
        _, res, mvs = residuals
        call = lambda: _fold(res, mvs)  # noqa: E731
    else:
        parsed = containers[1][case]
        call = lambda: _range(parsed)  # noqa: E731
    plain = call()
    traced, spans = _traced(call)
    assert spans and traced.tobytes() == plain.tobytes()


@pytest.mark.parametrize("case", ["MHTV", "MHV2", "MHTS", "fold"])
def test_no_torch_operator_runs_inside_a_mark_or_span(case, containers,
                                                      residuals):
    """A device operation is issued through a torch operator; one issued
    inside a mark or span would draw it on the card's timeline too."""
    if case == "fold":
        _, res, mvs = residuals
        call = lambda: _fold(res, mvs)  # noqa: E731
    else:
        parsed = containers[1][case]
        call = lambda: _range(parsed)  # noqa: E731
    _, spans, events = _traced(call, everything=True)
    ops = [ev for ev in events if ev[2].startswith("aten::")]
    assert spans and ops
    for sp in spans:
        assert not [op for op in ops if _inside(op, sp)], sp[2]
