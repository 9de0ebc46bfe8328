"""The seek cell ``mc8.range`` (random ranges of a motion-compensated MHVT
with a keyframe every 30 frames) on the CPU at a tiny size, and its
readers (its own ``seek.fold_ms`` and ``fold_roofline.seek``, and the
range cells' readers it shares) on traces made by hand and on the port's
marks recorded under the benchmark's :class:`~benchmark.trace.Recorder`."""

import time
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from benchmark import control, harness, loops, peaks, spans, trace

CELL = "mc8.range"
#: the readers only the seek cells read
SEEK = ("seek.fold_ms", "fold_roofline.seek")
#: the range cells' readers, which read a seek's marks too
RANGE = ("range.stage_ms", "range.fetch_ms", "range.crc_ms", "range.copy_ms",
         "range.host_ms", "range.decode_launches", "device_idle_pct.range")
READERS = SEEK + RANGE
SEED = 2**33 + 25
CPU = torch.device("cpu")
#: two keyframe groups of the cell's keyint, so requests cross a boundary
FRAMES = 60
US = 1_000


def _run_cell(bench, tiny_cell, trace_=False, **kw):
    cell, config, mix = tiny_cell(CELL)
    mix["clip_frames"] = FRAMES
    return harness.run_cell(bench, cell, config, mix, SEED, 0.3, trace_, CPU,
                            time.perf_counter(), **kw)


def test_the_cell_is_a_seek_into_two_keyframe_groups(bench):
    cell, config, mix = harness.find_cell(bench, CELL)
    assert mix["kind"] == "range" and mix["clip_frames"] == 2 * 30
    assert config["codec"]["temporal"] and config["codec"]["motion"]
    assert config["codec"]["keyint"] == 30 and config["codec"]["frame_crcs"]
    names = {m["name"] for m in harness.cell_metrics(bench, cell,
                                                     "per_layer")}
    assert names == set(READERS)
    ends = {m["name"] for m in harness.cell_metrics(bench, cell,
                                                    "end_to_end")}
    assert ends == {"range_p95_ms", "setup_s"}


@pytest.mark.parametrize("trace_", [False, True])
def test_the_cell_runs_correct_on_the_cpu(bench, tiny_cell, trace_):
    from metalhuffman_tpu_torch.models import temporal

    before = dict(temporal.seek_frames)
    out = _run_cell(bench, tiny_cell, trace_)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert out["checks"]["answers_compared"]["value"] >= 1
    if trace_:
        # the CPU runs no device operation: no device metric is read
        assert out["metrics"] == {}
    else:
        assert set(out["metrics"]) == {"range_p95_ms", "setup_s"}
    # every request decoded frames ahead of those it returned
    lead = temporal.seek_frames["lead"] - before["lead"]
    asked = temporal.seek_frames["asked"] - before["asked"]
    assert asked > 0 and lead > 0


def test_the_control_is_not_correct(bench, tiny_cell):
    out = _run_cell(bench, tiny_cell, subject=control)
    assert out["correct"] is False
    assert out["checks"]["wrong_bytes"]["value"] > 0


def _flip_fold(fold):
    def f(*a, **k):
        out = fold(*a, **k)
        out.view(-1)[out.numel() // 3] ^= 1
        return out
    return f


def test_a_fault_in_the_seeks_fold_is_not_correct(bench, tiny_cell,
                                                 monkeypatch):
    # the fold's output altered before the crop: the per-frame CRCs raise
    # where the flip lands in a frame returned, else the answer is right
    from metalhuffman_tpu_torch.models import temporal

    monkeypatch.setattr(temporal, "fold_planes",
                        _flip_fold(temporal.fold_planes))
    out = _run_cell(bench, tiny_cell)
    assert out["correct"] is False
    assert out["failed"] > 0


# -- the readers on traces made by hand ----------------------------------------


@dataclass
class Ev:
    """The four things ``trace.read`` asks of a kineto event."""

    _name: str
    _start_ns: int
    _dur_ns: int
    _dev: str = "cpu"

    def name(self):
        return self._name

    def start_ns(self):
        return self._start_ns

    def duration_ns(self):
        return self._dur_ns

    def device_type(self):
        return self._dev


def _span(name, start_ms, end_ms, dev="cpu"):
    return Ev(name, round(start_ms * 1000) * US,
              round((end_ms - start_ms) * 1000) * US, dev)


def _mark(name, at_ms):
    return _span(name, at_ms, at_ms + 0.002)


def _seek_trace():
    """A 20 ms window of three requests: two with the port's marks of a
    seek (``range.stage``, ``range.decode``, ``fold``, ``range.fetch``)
    and its ``range.crc`` span, the fold kernel 0.4 and 0.2 ms, a copy 0.5
    ms, a launch in the first request's decode and one in its fold; a third
    from a program without marks."""
    evs = [_span("window", 0, 20), _span("request", 1, 9),
           _span("request", 10, 18), _span("request", 18.5, 19.5)]
    for marks, crc in (((1, 3, 3.5, 5), (5.5, 8.5)),
                       ((10, 11, 11.2, 12), (12.2, 17))):
        evs += [_mark(n, t) for n, t in zip(
            ("range.stage", "range.decode", "fold", "range.fetch"), marks)]
        evs.append(_span("range.crc", *crc))
    evs += [_span("void temporal_fold_kernel<1, 16, true>(...)", 3.6, 4.0,
                  "cuda"),
            _span("void temporal_fold_kernel<1, 16, true>(...)", 11.3, 11.5,
                  "cuda"),
            _span("Memcpy DtoH (Device -> Pageable)", 5, 5.5, "cuda"),
            _span("cudaLaunchKernel", 3.2, 3.25),
            _span("cudaLaunchKernel", 3.55, 3.6)]
    return trace.read(evs, "cpu")


#: the window's requests: one frame at a keyframe (nothing to fold), four
#: frames five past the second group's keyframe, one frame of the first
#: group
CALLS = [(0, 1, 0.008, True), (35, 39, 0.008, True), (5, 6, 0.001, True)]


def _run(kind="range", temporal=True, tr=None):
    config = {"codec": {"temporal": temporal, "keyint": 30}, "height": 48,
              "width": 64}
    run = harness.Run(config, {"kind": kind})
    run.trace = tr
    if kind == "staged":
        run.window = loops.Window(start=0.0, end=0.02, calls=[1, 1])
    else:
        run.window = loops.Window(start=0.0, end=0.02, calls=list(CALLS))
    return run


def _want(name):
    want = {
        "seek.fold_ms": (1.5 + 0.8) / 3,
        "range.stage_ms": (2 + 1) / 3,
        "range.fetch_ms": (0.5 + 0.2) / 3,
        "range.crc_ms": (3 + 4.8) / 3,
        "range.copy_ms": 0.5 / 3,
        # each request's time less the device's busy time inside it
        "range.host_ms": ((8 - 0.9) + (8 - 0.2) + 1) / 3,
        # B1's launch in the first decode stretch, none in the second
        "range.decode_launches": 1 / 2,
        "device_idle_pct.range": 100 * (1 - (0.4 + 0.5 + 0.2) / 20),
    }
    if name in want:
        return want[name]
    # folds of frames [30, 39) and [0, 6), each one group: the frames read
    # once and all but the keyframe written once; [0, 1) folds nothing
    least = peaks.least_s((2 * 9 - 1 + 2 * 6 - 1) * 48 * 64)
    return 100 * least / (0.6e-3)


@pytest.mark.parametrize("name", READERS)
def test_reader_arithmetic(name):
    got = harness.reader(name)(_run(tr=_seek_trace()))
    assert got == pytest.approx(_want(name), rel=1e-6)


@pytest.mark.parametrize("name", SEEK)
def test_reader_reads_nothing_in_other_cells(name):
    for run in (_run("range", temporal=False, tr=_seek_trace()),
                _run("staged", temporal=True, tr=_seek_trace()),
                _run("staged", temporal=False, tr=_seek_trace())):
        assert harness.reader(name)(run) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_a_trace_or_a_device_operation(name):
    assert harness.reader(name)(_run()) is None
    tr = _seek_trace()
    tr.device.clear()
    assert harness.reader(name)(_run(tr=tr)) is None


@pytest.mark.parametrize("name", ("range.stage_ms",) + SEEK)
def test_reader_reads_nothing_from_a_program_without_the_seek(name):
    """The parent of the seek route: no fold mark in a request and no fold
    kernel; the staging's reader finds its marks, the fold's none."""
    tr = _seek_trace()
    tr.host[:] = [h for h in tr.host if h[2] != "fold"]
    tr.device[:] = [d for d in tr.device if "temporal_fold" not in d[2]]
    got = harness.reader(name)(_run(tr=tr))
    if name == "range.stage_ms":
        assert got == pytest.approx(1.0)
    else:
        assert got is None


def test_the_roofline_counts_only_spans_of_two_frames_or_more():
    run = _run(tr=_seek_trace())
    run.window.calls = [(0, 1, 0.001, True), (30, 31, 0.001, True)]
    assert harness.reader("fold_roofline.seek")(run) == 0.0


@pytest.mark.parametrize("a, b, frames", [
    (0, 2, 3),     # two frames of one group: the keyframe is only read
    (5, 6, 11),    # six frames from the keyframe 0
    (29, 31, 60),  # across the boundary: 31 frames, keyframes 0 and 30
    (59, 60, 59),  # the last frame: 30 frames from the keyframe 30
])
def test_the_roofline_counts_the_bytes_the_fold_moves(a, b, frames):
    run = _run(tr=_seek_trace())
    run.window.calls = [(a, b, 0.001, True)]
    want = 100 * peaks.least_s(frames * 48 * 64) / 0.6e-3
    assert harness.reader("fold_roofline.seek")(run) == pytest.approx(
        want, rel=1e-9)


# -- the port's marks of one seek, recorded on the CPU --------------------------


@pytest.fixture(scope="module")
def recorded():
    """One seek request [5, 7) into an MC MHVT with a keyframe every 4,
    recorded under the benchmark's ``Recorder`` -> the run."""
    import metalhuffman_tpu_torch as mt
    from metalhuffman_tpu_torch.models import frame_stream
    from metalhuffman_tpu_torch.models.config import CodecConfig

    rng = np.random.default_rng(5)
    img = rng.integers(90, 110, (24, 40), np.uint8)
    frames = np.stack([np.roll(img, (2 * i, 3 * i), (0, 1))
                       for i in range(8)])
    blob = mt.encode_video(frames, CodecConfig(
        temporal=True, keyint=4, motion=True, frame_crcs=True))
    parsed = frame_stream.parse_range_container(blob)
    rec = trace.Recorder()
    with rec:
        with rec.span("window"):
            with rec.span("request"):
                out = frame_stream.decode_range_parsed(parsed, 5, 7,
                                                       device="cpu")[0]
    np.testing.assert_array_equal(out, frames[5:7])
    run = _run(tr=rec.read())
    run.config["codec"]["keyint"] = 4
    run.config["height"], run.config["width"] = 24, 40
    run.window.calls = [(5, 7, 0.001, True)]
    return run


def test_recorder_keeps_the_seeks_marks_in_order(recorded):
    tr = recorded.trace
    (a, b), = tr.spans["request"]
    names = [(s, e, n) for s, e, n in tr.host if n in spans.PORT]
    assert [n for _, _, n in names] == [
        "range.stage", "range.decode", "fold", "range.fetch", "range.crc"]
    assert all(a <= s <= e <= b for s, e, _ in names)
    fold, = spans.stretches(tr, "fold", "request")
    fetch, = spans.stretches(tr, "range.fetch", "request")
    assert fold[1] == fetch[0]


@pytest.mark.parametrize("name", (
    "range.stage_ms", "range.fetch_ms", "range.crc_ms", "range.host_ms",
    "device_idle_pct.range") + SEEK)
def test_reader_reads_the_recorded_marks(name, recorded):
    # the CPU runs no device operation; one made by hand stands for the
    # card's fold kernel
    assert harness.reader(name)(recorded) is None
    recorded.trace.device.append((0.0, 1e-6, "temporal_fold_kernel"))
    try:
        value = harness.reader(name)(recorded)
    finally:
        recorded.trace.device.pop()
    assert value is not None and value > 0
