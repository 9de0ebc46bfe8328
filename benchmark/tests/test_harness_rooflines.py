"""The byte counts of the roofline metrics from shapes, and every per-layer
reader on a trace made by hand."""

from dataclasses import dataclass

import pytest

from benchmark import harness, loops, peaks, trace


def test_decode_bytes_from_shapes():
    # 94.4 MB of frames, 60 MB of code: chip_smoke.bound's count
    n_sym = 30 * 1536 * 2048
    words, offs = 15_000_000, 30 * 49152
    nbytes = 4 * words + 4 * offs + 256 + n_sym
    assert peaks.decode_least_s(words, offs, n_sym) == pytest.approx(
        nbytes / 3.35e12)
    # the bytes bind, not the 4 operations a symbol
    assert nbytes / 3.35e12 > 4 * n_sym / peaks.INT32_OPS_PER_S


def test_fold_bytes_from_shapes():
    fb = 30 * 1536 * 2048
    assert peaks.fold_least_s(fb) == pytest.approx(2 * fb / 3.35e12)
    assert peaks.fold_least_s(fb) * 1e3 == pytest.approx(0.0563, abs=1e-4)


@dataclass
class Ev:
    """The four things ``trace.read`` asks of a kineto event."""

    _name: str
    _start_ns: int
    _dur_ns: int
    _dev: str

    def name(self):
        return self._name

    def start_ns(self):
        return self._start_ns

    def duration_ns(self):
        return self._dur_ns

    def device_type(self):
        return self._dev


MS = 1_000_000


def _trace():
    """A 10 ms window: two requests of 4 ms; B1 0.5 ms and a copy 1 ms in
    the first, a fold op 2 ms in the second; a host op between."""
    evs = [Ev("window", 0, 10 * MS, "cpu"),
           Ev("request", 1 * MS, 4 * MS, "cpu"),
           Ev("request", 6 * MS, 4 * MS, "cpu"),
           Ev("aten::copy_", 1 * MS, 2 * MS, "cpu"),
           Ev("void decode_images_kernel<1>(...)", 2 * MS, MS // 2, "cuda"),
           Ev("Memcpy DtoH (Device -> Pageable)", 3 * MS, 1 * MS, "cuda"),
           Ev("index_elementwise_kernel", 7 * MS, 2 * MS, "cuda"),
           Ev("Memset (Device)", 12 * MS, 1 * MS, "cuda"),  # after the window
           Ev("request", 2 * MS, 3 * MS, "cuda")]  # the span's device mark
    return trace.read(evs, "cpu")


def test_trace_read_and_busy():
    tr = _trace()
    assert tr.window_s == pytest.approx(0.010)
    assert len(tr.device) == 3 and len(tr.spans["request"]) == 2
    assert tr.busy_s() == pytest.approx(0.0035)
    assert tr.busy_within(tr.spans["request"]) == pytest.approx(
        [0.0015, 0.002])
    gaps = tr.idle_gaps()
    assert sum(b - a for a, b in gaps) == pytest.approx(0.0065)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["index_elementwise_kernel",
                                   pytest.approx(0.002)]
    names = dict((n, s) for n, s in bd["idle_gaps"])
    assert names["request > aten::copy_"] == pytest.approx(0.0025)
    assert names["window"] == pytest.approx(0.003)
    assert sum(names.values()) == pytest.approx(0.0065)


def _run(kind, temporal=False):
    run = harness.Run({"height": 1536, "width": 2048,
                       "codec": {"temporal": temporal}}, {"kind": kind})
    run.trace = _trace()
    if kind == "staged":
        run.window = loops.Window(start=0.0, end=0.01, calls=[1, 1])
        run.shapes = [{"words": 1000, "offsets": 100, "symbols": 4096,
                       "frame_bytes": 4096}] * 2
    else:
        run.window = loops.Window(start=0.0, end=0.01,
                                  calls=[(0, 1, 0.004, True),
                                         (2, 4, 0.004, True)])
    return run


def test_readers_on_a_trace():
    read = harness.reader
    least = peaks.decode_least_s(1000, 100, 4096)
    run = _run("staged", temporal=True)
    assert read("b1_roofline.mhvt")(run) == pytest.approx(
        100 * least / 0.0005)
    fold = peaks.fold_least_s(4096) * 2
    assert read("fold_roofline")(run) == pytest.approx(100 * fold
                                                           / 0.002)
    assert read("device_idle_pct.mhvt")(run) == pytest.approx(65.0)
    assert read("mhvt_decode_gbps")(run) == pytest.approx(
        2 * 4096 / 0.01 / 1e9)
    for name in ("b1_roofline", "device_idle_pct.batch", "decode_gbps",
                 "device_idle_pct.range"):
        assert read(name)(run) is None, name
    run = _run("staged")
    assert read("b1_roofline")(run) == pytest.approx(100 * least / 0.0005)
    assert read("device_idle_pct.batch")(run) == pytest.approx(65.0)
    assert read("decode_gbps")(run) == pytest.approx(2 * 4096 / 0.01 / 1e9)
    for name in ("b1_roofline.mhvt", "fold_roofline", "device_idle_pct.mhvt",
                 "mhvt_decode_gbps"):
        assert read(name)(run) is None, name
    run = _run("range")
    assert read("range.copy_ms")(run) == pytest.approx(0.5)
    assert read("range.host_ms")(run) == pytest.approx(
        ((4 - 1.5) + (4 - 2)) / 2)
    assert read("range_p95_ms")(run) == pytest.approx(4.0)
    assert read("b1_roofline")(run) is None
    run.trace = None
    for name in ("range.copy_ms", "range.host_ms", "device_idle_pct.range"):
        assert read(name)(run) is None


def test_no_device_operation_reads_nothing():
    run = _run("range")
    run.trace.device.clear()
    for name in ("range.copy_ms", "range.host_ms", "device_idle_pct.range"):
        assert harness.reader(name)(run) is None
