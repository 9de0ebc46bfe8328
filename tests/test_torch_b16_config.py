"""The benchmark's 16x16-block configuration (``bridge-2048x1536-b16``, cell
``b16.batch``) on the CPU: the whole cell through the harness at tiny sizes,
the port's packed-block route (B2's plain version and the relayout) against
the plain reference and the 8x8 route, the port's ``blocks`` mark, and the
cell's readers (``b2_roofline``, ``relayout_roofline``, ``blocks.launches``,
``device_idle_pct.b16``) on traces made by hand.
"""

import copy
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pytest
import torch

from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models.config import CodecConfig

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness, loops, packed, peaks, spans, trace  # noqa: E402
from benchmark.reference import plain  # noqa: E402

CELL = "b16.batch"
OTHER_CELLS = ["bridge8.batch", "bridge8.range", "mc8.batch"]
READERS = ["b2_roofline", "relayout_roofline", "blocks.launches",
           "device_idle_pct.b16"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def _cell(bench, workload=CELL, size=None, frames=None):
    cell, config, mix = harness.find_cell(bench, workload)
    config, mix = copy.deepcopy(config), dict(mix)
    if size:
        config["height"], config["width"] = size
    if frames:
        mix["clip_frames"] = frames
    return cell, config, mix


# -- the whole cell, through the harness ----------------------------------


def test_the_cell_is_the_reference_clip_at_16x16(bench):
    cell, config, mix = _cell(bench)
    _, b8, _ = _cell(bench, "bridge8.batch")
    assert cell["config"] == "bridge-2048x1536-b16" and cell["chips"] == 1
    assert cell["traffic"] == "staged_batch"
    assert config["codec"] == dict(b8["codec"], block_dim=16)
    for key in ("height", "width", "frames_per_second"):
        assert config[key] == b8[key], key
    assert config["content"] == dict(b8["content"], pan_px=[0, 8])
    names = [m["name"] for m in harness.cell_metrics(bench, cell,
                                                     "per_layer")]
    assert names == READERS
    e2e = [m["name"] for m in harness.cell_metrics(bench, cell, "end_to_end")]
    assert e2e == ["decode_gbps", "setup_s"]


def test_no_seed_turns_the_clip_upside_down(bench):
    """B2's time depends on the clip's vertical orientation at the same code
    bytes, so the cell pans sideways alone: no seed flips it."""
    from benchmark import clips

    _, config, _ = _cell(bench)
    pans = {clips.pan(seed, config["content"]["pan_px"])
            for seed in range(2**31, 2**31 + 16)}
    assert pans == {(0, 8), (0, -8)}


@pytest.mark.parametrize("seed", [2**31 + 99, 4_200_000_017])
@pytest.mark.parametrize("size", [(48, 64), (40, 72)])
def test_the_cell_runs_correct_on_the_cpu(bench, size, seed):
    """40x72 leaves partial 16x16 blocks at the bottom and right edges."""
    cell, config, mix = _cell(bench, size=size, frames=9)
    out = harness.run_cell(bench, cell, config, mix, seed, 0.2, False, CPU,
                           time.perf_counter())
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["wrong_bytes"]["value"] == 0
    assert out["checks"]["answers_compared"]["value"] >= 1
    assert set(out["metrics"]) == {"decode_gbps", "setup_s"}


# -- the port's packed-block route ------------------------------------------


def _frames(t, h, w, seed):
    rng = np.random.default_rng(seed)
    base = np.clip(120 + 50 * np.sin(np.arange(w) / 4.0)[None, :]
                   + rng.normal(0, 9, (h, w)), 0, 255).astype(np.uint8)
    return np.stack([np.roll(base, (i, 2 * i), (0, 1)) for i in range(t)])


def _staged(frames, block_dim):
    cfg = CodecConfig(block_dim=block_dim, frame_crcs=True)
    t, h, w = frames.shape
    prep = tfs.prepare_shared(tfs.encode_frames_shared(frames, cfg), t, h, w,
                              cfg, device="cpu")
    return prep, cfg


@pytest.mark.parametrize("shape", [(3, 48, 64), (4, 40, 72), (2, 24, 16)])
def test_packed_route_equals_the_reference_and_the_8x8_route(shape, bench):
    frames = _frames(*shape, seed=sum(shape))
    _, config, _ = _cell(bench)
    order = np.arange(shape[0])
    want = plain.staged_answer(config["codec"], frames, order, (8, 8))
    prep16, cfg16 = _staged(frames, 16)
    got = tfs.decode_shared_step(prep16, cfg16, raw=True)
    np.testing.assert_array_equal(got.numpy(), want)
    prep8, cfg8 = _staged(frames, 8)
    raw8 = tfs.decode_shared_step(prep8, cfg8, raw=True)
    np.testing.assert_array_equal(
        got.numpy(), tfs.frames_from_raw(raw8, *shape).numpy())
    # each call's answer is a tensor of its own, not a view of another's
    again = tfs.decode_shared_step(prep16, cfg16, raw=True)
    assert got.is_contiguous() and again.is_contiguous()
    assert (got.untyped_storage().data_ptr()
            != again.untyped_storage().data_ptr())
    np.testing.assert_array_equal(again.numpy(), want)


@pytest.mark.parametrize("block_dim, marks", [(16, 1), (8, 0)])
def test_blocks_mark_once_a_call_at_16x16_only(block_dim, marks):
    prep, cfg = _staged(_frames(2, 32, 48, 3), block_dim)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            tfs.decode_shared_step(prep, cfg, raw=True)
    names = [e.name for e in prof.events()]
    assert names.count("blocks") == 3 * marks


def test_blocks_stretch_runs_from_the_mark_to_the_call_end():
    prep, cfg = _staged(_frames(2, 32, 48, 4), 16)
    rec = trace.Recorder()
    with rec:
        with rec.span("window"):
            for _ in range(2):
                with rec.span("call"):
                    tfs.decode_shared_step(prep, cfg, raw=True)
    tr = rec.read()
    calls = tr.spans["call"]
    got = spans.stretches(tr, "blocks", "call")
    assert len(got) == len(calls) == 2
    for (s, e), (a, b) in zip(got, calls):
        assert a <= s < e == b


# -- the readers, on traces made by hand --------------------------------------


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


def _ev(name, start_ms, end_ms, dev="cpu"):
    return Ev(name, int(start_ms * 1_000_000),
              int((end_ms - start_ms) * 1_000_000), dev)


B2_OP = "void decode_blocks_kernel<1>(unsigned int const*, ...)"
COPY_OP = "void at::native::elementwise_kernel<128, 4, ...>(...)"


def _trace():
    """A 10 ms window of two calls, each the ``blocks`` mark, B2 (2 ms) and
    the relayout's copy (0.5 ms) launched after it; a launch and a copy up
    before the first mark; a launch after the second call."""
    evs = [_ev("window", 0, 10), _ev("call", 0, 4), _ev("call", 5, 9),
           _ev("blocks", 1, 1.002), _ev("blocks", 6, 6.002),
           _ev("cudaLaunchKernel", 0.5, 0.51),
           _ev("Memcpy HtoD (Pageable -> Device)", 0.1, 0.2, "cuda")]
    for t in (1, 6):
        evs += [_ev("cudaLaunchKernel", t + 0.2, t + 0.21),
                _ev("cudaLaunchKernel", t + 0.4, t + 0.41),
                _ev(B2_OP, t + 0.5, t + 2.5, "cuda"),
                _ev(COPY_OP, t + 2.5, t + 3, "cuda")]
    evs.append(_ev("cudaLaunchKernel", 9.5, 9.51))
    return trace.read(evs, "cpu")


SHAPE = {"words": 14_000_000, "offsets": 368_640, "symbols": 0,
         "frame_bytes": 30 * 1536 * 2048}


def _run(bench, workload=CELL, tr=None):
    _, config, mix = _cell(bench, workload)
    run = harness.Run(config, mix)
    run.trace = _trace() if tr is None else tr
    if run.kind == "staged":
        run.window = loops.Window(start=0.0, end=0.01, calls=[1, 1])
        run.shapes = [SHAPE, SHAPE]
    else:
        run.window = loops.Window(start=0.0, end=0.01,
                                  calls=[(0, 1, 0.004, True),
                                         (2, 4, 0.004, True)])
    return run


def _want(name):
    n_sym = 30 * 1536 * 2048
    if name == "b2_roofline":
        least = peaks.decode_least_s(SHAPE["words"], SHAPE["offsets"], n_sym)
        return 100 * least / 0.002
    if name == "relayout_roofline":
        return 100 * 2 * peaks.least_s(2 * SHAPE["frame_bytes"]) / 0.001
    if name == "blocks.launches":
        return 2.0
    return 100 * (1 - 0.0051 / 0.010)


@pytest.mark.parametrize("name", READERS)
def test_reader_arithmetic(bench, name):
    assert harness.reader(name)(_run(bench)) == pytest.approx(_want(name))


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_in_the_other_cells(bench, name):
    for workload in OTHER_CELLS:
        assert harness.reader(name)(_run(bench, workload)) is None, workload


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_a_device_operation(bench, name):
    tr = _trace()
    tr.device.clear()
    assert harness.reader(name)(_run(bench, tr=tr)) is None
    run = _run(bench)
    run.trace = None
    assert harness.reader(name)(run) is None


def test_launches_read_nothing_from_a_program_without_the_mark(bench):
    tr = _trace()
    tr.host[:] = [h for h in tr.host if h[2] != "blocks"]
    assert harness.reader("blocks.launches")(_run(bench, tr=tr)) is None


@pytest.mark.parametrize("size, want", [
    ((1536, 2048), 30 * 1536 * 2048),
    ((40, 72), 30 * 48 * 80)])
def test_b2_symbol_count(bench, size, want):
    _, config, mix = _cell(bench, size=size)
    assert packed.symbols(config, mix) == want


def test_staged_shape_counts_8x8_geometry(bench):
    """Why the B2 reader counts symbols itself: ``system.stage`` counts
    ``bh * 8 * bw * 8`` a frame, a quarter of B2's at 16x16."""
    from benchmark import clips, system

    _, config, mix = _cell(bench, size=(48, 64), frames=3)
    clip, pan = clips.clip(config["content"], 48, 64, 3, 11)
    staged = system.stage(config, clip, np.arange(3), pan, CPU)
    assert packed.symbols(config, mix) == clip.size
    assert staged.shape["symbols"] * 4 == clip.size


# -- the relayout in words ------------------------------------------------------


@pytest.mark.parametrize("size", [(40, 72), (4, 72), (40, 8)])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
@pytest.mark.parametrize("block_dim", [1, 3, 4, 8, 12, 16, 32])
def test_relayout_in_words_equals_numpy(block_dim, dtype, size):
    """Whole and partial edge blocks, and frames one block row tall or one
    block column wide, where the words' copy would otherwise be a view."""
    from metalhuffman_tpu_torch.core import blocks

    rng = np.random.default_rng(block_dim)
    h, w = size
    bh, bw = blocks.block_grid(h, w, block_dim)
    nb = bh * bw
    # a slice one block in: the view in words must respect its offset
    big = torch.from_numpy(rng.integers(0, 256, (2, nb + 2, block_dim ** 2))
                           .astype(dtype))
    for blk in (big[:, :nb], big[:, 1:nb + 1]):
        got = blocks.blocks_to_image_torch(blk, h, w, block_dim)
        assert got.dtype == blk.dtype and got.shape == (2, h, w)
        for i in range(2):
            want = blocks.blocks_to_image(blk[i].numpy().astype(np.uint8), h,
                                          w, block_dim)
            np.testing.assert_array_equal(got[i].numpy().astype(np.uint8),
                                          want)


@pytest.mark.parametrize("block_dim, word", [
    (16, torch.int64), (8, torch.int64), (12, torch.int32), (2, torch.int16),
    (3, torch.uint8)])
def test_relayout_moves_block_rows_in_the_widest_words(block_dim, word):
    from metalhuffman_tpu_torch.core import blocks

    tiles = torch.zeros((2, 3, 4, block_dim, block_dim), dtype=torch.uint8)
    assert blocks._as_words(tiles).dtype == word
    # a view one byte in cannot be read in wider words
    odd = torch.zeros(1 + tiles.numel(), dtype=torch.uint8)[1:]
    assert blocks._as_words(odd.view(tiles.shape)).dtype == torch.uint8
