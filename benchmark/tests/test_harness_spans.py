"""The readers of the port's own marks and spans (``benchmark/spans.py``:
``range.stage_ms``, ``range.fetch_ms``, ``range.crc_ms``, ``fold.host_ms``,
``fold.launches``) on traces made by hand, and the port's marks and spans
under the benchmark's :class:`~benchmark.trace.Recorder` on the CPU."""

from dataclasses import dataclass

import numpy as np
import pytest

from benchmark import harness, loops, spans, trace

RANGE = ("range.stage_ms", "range.fetch_ms", "range.crc_ms")
FOLD = ("fold.host_ms", "fold.launches")
US = 1_000


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
    return Ev(name, int(start_ms * 1000) * US,
              int((end_ms - start_ms) * 1000) * US, dev)


def _mark(name, at_ms):
    return _span(name, at_ms, at_ms + 0.002)


def _range_trace():
    """A 20 ms window of two requests, each the port's three marks and its
    ``range.crc`` span, and a third request of a program without them; the
    runtime's calls inside a stretch do not end it."""
    evs = [_span("window", 0, 20), _span("request", 1, 9),
           _span("request", 10, 18), _span("request", 18.5, 19.5)]
    for marks, crc in (((1, 3, 3.5), (5.5, 8.5)),
                       ((10, 11, 11.2), (12.2, 17))):
        evs += [_mark(n, t) for n, t in zip(
            ("range.stage", "range.decode", "range.fetch"), marks)]
        evs.append(_span("range.crc", *crc))
    evs += [_span("Memcpy DtoH (Device -> Pageable)", 4, 5.5, "cuda"),
            _span("cudaMemcpyAsync", 3.6, 5.5),
            _span("cudaLaunchKernel", 11.05, 11.1)]
    return trace.read(evs, "cpu")


def _fold_trace():
    """A 10 ms window of two calls, each a ``fold`` mark and the fold's
    launches to the end of the call: B1 launched before the mark, four
    launches in the first fold, three (one ``cudaLaunchKernelExC``) in the
    second, a launch after the second call that does not count."""
    evs = [_span("window", 0, 10), _span("call", 0, 4), _span("call", 5, 9),
           _mark("fold", 1), _mark("fold", 6),
           _span("cudaLaunchKernel", 0.5, 0.51)]
    evs += [_span("cudaLaunchKernel", t, t + 0.01)
            for t in (1.2, 1.4, 2, 3, 6.5, 7)]
    evs += [_span("cudaLaunchKernelExC", 7.5, 7.51),
            _span("cudaMemcpyAsync", 6.1, 6.2),
            _span("cudaLaunchKernel", 9.5, 9.51),
            _span("elementwise_kernel", 2, 3, "cuda")]
    return trace.read(evs, "cpu")


def _run(kind, temporal=False, tr=None):
    run = harness.Run({"codec": {"temporal": temporal}}, {"kind": kind})
    run.trace = tr
    if kind == "staged":
        run.window = loops.Window(start=0.0, end=0.01, calls=[1, 1])
    else:
        run.window = loops.Window(start=0.0, end=0.02,
                                  calls=[(0, 1, 0.008, True),
                                         (2, 4, 0.008, True),
                                         (5, 6, 0.001, True)])
    return run


@pytest.mark.parametrize("name, want", [
    ("range.stage_ms", (2 + 1) / 3), ("range.fetch_ms", (2 + 1) / 3),
    ("range.crc_ms", (3 + 4.8) / 3)])
def test_range_reader_arithmetic(name, want):
    run = _run("range", tr=_range_trace())
    assert harness.reader(name)(run) == pytest.approx(want)


@pytest.mark.parametrize("name, want", [
    ("fold.host_ms", (3 + 3) / 2), ("fold.launches", (4 + 3) / 2)])
def test_fold_reader_arithmetic(name, want):
    run = _run("staged", temporal=True, tr=_fold_trace())
    assert harness.reader(name)(run) == pytest.approx(want)


def test_fold_launches_counts_only_launches_inside_fold_spans():
    tr = _fold_trace()
    launches = [s for s, _, n in tr.host if n.startswith("cudaLaunchKernel")]
    assert len(launches) == 9
    run = _run("staged", temporal=True, tr=tr)
    assert harness.reader("fold.launches")(run) * 2 == 7


@pytest.mark.parametrize("name", RANGE + FOLD)
def test_reader_reads_nothing_without_a_trace(name):
    temporal = name in FOLD
    run = _run("staged" if temporal else "range", temporal=temporal)
    assert harness.reader(name)(run) is None


@pytest.mark.parametrize("name", RANGE + FOLD)
def test_reader_reads_nothing_in_other_cells(name):
    runs = [_run("staged", temporal=False, tr=_fold_trace())]
    if name in FOLD:
        runs.append(_run("range", tr=_range_trace()))
    else:
        runs.append(_run("staged", temporal=True, tr=_range_trace()))
    for run in runs:
        assert harness.reader(name)(run) is None


@pytest.mark.parametrize("name", RANGE + FOLD)
def test_reader_reads_nothing_without_a_device_operation(name):
    temporal = name in FOLD
    tr = _fold_trace() if temporal else _range_trace()
    tr.device.clear()
    run = _run("staged" if temporal else "range", temporal=temporal, tr=tr)
    assert harness.reader(name)(run) is None


@pytest.mark.parametrize("name", RANGE + FOLD)
def test_reader_reads_nothing_from_a_program_without_spans(name):
    temporal = name in FOLD
    tr = _fold_trace() if temporal else _range_trace()
    tr.host[:] = [h for h in tr.host
                  if not h[2].startswith(("range.", "fold"))]
    run = _run("staged" if temporal else "range", temporal=temporal, tr=tr)
    assert harness.reader(name)(run) is None


@pytest.fixture(scope="module")
def recorded():
    """The port's marks and spans of one range request and one MHVT fold
    call, each recorded on the CPU under the benchmark's ``Recorder`` ->
    {kind: run}."""
    import torch

    from metalhuffman_tpu_torch.models import frame_stream, temporal
    from metalhuffman_tpu_torch.models.config import CodecConfig

    rng = np.random.default_rng(5)
    img = rng.integers(90, 110, (24, 40), np.uint8)
    frames = np.stack([np.roll(img, (2 * i, 3 * i), (0, 1))
                       for i in range(4)])
    cfg = CodecConfig(frame_crcs=True)
    blob = frame_stream.write_shared(
        frame_stream.encode_frames_shared(frames, cfg), 4, 24, 40, cfg,
        frame_crcs=frame_stream.compute_frame_crcs(frames))
    parsed = frame_stream.parse_range_container(blob)
    res, mvs = temporal.temporal_encode_mc(frames, 4)
    calls = {
        "range": lambda: frame_stream.decode_range_parsed(
            parsed, 1, 3, device="cpu")[0],
        "staged": lambda: temporal.fold_planes(
            torch.from_numpy(res.copy()), 4, mvs, None, None).numpy()}
    runs = {}
    for kind, call in calls.items():
        rec = trace.Recorder()
        with rec:
            with rec.span("window"):
                with rec.span("request" if kind == "range" else "call"):
                    out = call()
        np.testing.assert_array_equal(
            out, frames[1:3] if kind == "range" else frames)
        runs[kind] = _run(kind, temporal=kind == "staged", tr=rec.read())
    return runs


def test_recorder_keeps_the_port_spans_inside_the_request(recorded):
    tr = recorded["range"].trace
    (a, b), = tr.spans["request"]
    names = [(s, e, n) for s, e, n in tr.host if n.startswith("range.")]
    assert [n for _, _, n in names] == [
        "range.stage", "range.decode", "range.fetch", "range.crc"]
    assert all(a <= s <= e <= b for s, e, _ in names)
    got = [g for _, _, n in names
           for g in spans.stretches(tr, n, "request")]
    # the four stretches follow one another, from the first mark to the
    # end of the CRC-32's span
    assert len(got) == 4
    for (_, end), (start, _) in zip(got, got[1:]):
        assert end == start
    assert got[0][0] == names[0][0] and got[-1] == names[-1][:2]


@pytest.mark.parametrize("name", RANGE + FOLD)
def test_reader_reads_the_recorded_spans(name, recorded):
    run = recorded["staged" if name in FOLD else "range"]
    # the CPU runs no device operation, so the readers read nothing, as in
    # the harness's own CPU runs; one made by hand stands for the card's
    assert harness.reader(name)(run) is None
    run.trace.device.append((0.0, 1e-6, "elementwise_kernel"))
    try:
        value = harness.reader(name)(run)
    finally:
        run.trace.device.pop()
    if name == "fold.launches":
        assert value == 0  # nor does it launch a CUDA kernel
    else:
        assert value is not None and value > 0
