"""The port's benchmark: ``metalhuffman_tpu_torch/bench.py``'s modes and the
root ``bench_torch.py``, the twin of ``bench.py``, on the CPU (the kernels'
plain versions; no JAX Pallas compile).

Each mode checks its output before it times anything, so a clean return is
the assertion that its path decodes (or encodes) right; a wrong output
exits 1 and is not retried. The JAX side is ``bench.py``'s payload
construction and the JAX package's host encoder.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from metalhuffman_tpu.core import blocks as jax_blocks
from metalhuffman_tpu.core import delta as jax_delta
from metalhuffman_tpu import native as jax_native
from metalhuffman_tpu_torch import bench, native
from metalhuffman_tpu_torch.models import frame_stream
from metalhuffman_tpu_torch.models.image_codec import ImageCodec
from metalhuffman_tpu_torch.utils import fixtures

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench as jax_bench  # noqa: E402
import bench_torch  # noqa: E402
import chip_smoke  # noqa: E402

TINY = ["--height", "64", "--width", "512", "--frames", "3", "--iters", "2",
        "--variants", "2"]
KEYS = ["metric", "value", "unit", "vs_baseline", "reps", "spread_pct"]


@pytest.mark.parametrize("motion,inner,width", [
    (False, "color", 512),
    (False, "u16", 512),
    (True, "gray", 512),
    (True, "gray", 1024),
    (True, "color", 512),
])
def test_run_temporal_ext_bit_exact(motion, inner, width):
    gbps, reps, spread = bench.run_temporal_ext(
        64, width, 5, 2, variants=2, keyint=3, motion=motion, inner=inner,
        device="cpu")
    assert gbps > 0 and reps == bench.REPS and spread >= 0


def test_run_temporal_plain_bit_exact():
    gbps, reps, spread = bench.run_temporal(64, 512, 5, 2, variants=2,
                                            keyint=3, device="cpu")
    assert gbps > 0 and reps == bench.REPS and spread >= 0


def test_run_single(capsys):
    gbps, reps, spread = bench.run_single(64, 512, "cpu", 2, verbose=True)
    assert gbps > 0 and reps == 3 and spread >= 0
    assert "single-frame [cpu]" in capsys.readouterr().err


@pytest.mark.parametrize("content", ["synthetic", "photo"])
def test_run_encode(content, capsys):
    gbps, reps, spread = bench.run_encode(64, 512, 2, 2, content=content,
                                          device="cpu", verbose=True)
    assert gbps > 0 and reps == 3 and spread >= 0
    err = capsys.readouterr().err
    assert "encode_rows kernel" in err and "encode_stream" in err


@pytest.mark.parametrize("content,shape", [
    ("synthetic", (3, 64, 512)),
    ("photo", (2, 64, 512)),
    ("synthetic", (2, 60, 500)),  # padded blocks at both edges
])
def test_encode_payload_and_stream_match_bench_py(content, shape):
    t, h, w = shape
    if content == "photo":
        frames = jax_bench.photo_frames(h, w, t)
        np.testing.assert_array_equal(frames, fixtures.photo_frames(h, w, t))
    else:
        frames = np.stack([jax_bench.synthetic_frame(h, w, seed=0, phase=i)
                           for i in range(t)])
        np.testing.assert_array_equal(frames, fixtures.synthetic(t, h, w))
    # bench.py:524-531
    blk = np.concatenate([jax_blocks.image_to_blocks(f) for f in frames])
    want = jax_delta.delta_encode_blocks(blk).reshape(-1)
    got = bench.encode_payload(frames)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    host, ref = native.encode_symbols(got), jax_native.encode_symbols(want)
    for field in ("widths", "code_bytes", "block_offsets"):
        a, b = getattr(host, field), getattr(ref, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def _wrong(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x.view(-1)[0] ^= 1
    return x


def test_run_single_wrong_decode_exits_1(monkeypatch, capsys):
    step = ImageCodec.decode_step
    monkeypatch.setattr(ImageCodec, "decode_step",
                        lambda self, prep: _wrong(step(self, prep)))
    with pytest.raises(ValueError, match="^decode mismatch$"):
        bench.run_single(64, 512, "cpu", 2)
    assert bench_torch.main(["--mode", "single", *TINY, "--device",
                             "cpu"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "FATAL: decode mismatch" in out.err


def test_run_encode_wrong_row_merge_exits_1(monkeypatch, capsys):
    merge = native.merge_rows

    def wrong(rows, bits):
        code, offsets, total = merge(rows, bits)
        code = code.copy()
        code[0] ^= 1
        return code, offsets, total

    monkeypatch.setattr(native, "merge_rows", wrong)
    with pytest.raises(ValueError, match=re.escape("encode_rows + merge_rows differs from the host encoder")):
        bench.run_encode(64, 512, 2, 2, device="cpu")
    assert bench_torch.main(["--mode", "encode", *TINY, "--device",
                             "cpu"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "FATAL: encode_rows + merge_rows differs from the host encoder" in out.err


def test_run_encode_wrong_stream_exits_1(monkeypatch, capsys):
    from metalhuffman_tpu_torch.ops import encode_cuda

    enc = encode_cuda.encode_stream

    def wrong(symbols, table):
        stream, offsets, total = enc(symbols, table)
        return _wrong(stream), offsets, total

    monkeypatch.setattr(encode_cuda, "encode_stream", wrong)
    with pytest.raises(ValueError, match=re.escape("encode_stream differs from the host encoder")):
        bench.run_encode(64, 512, 2, 2, device="cpu")
    assert bench_torch.main(["--mode", "encode", *TINY, "--device",
                             "cpu"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "FATAL: encode_stream differs from the host encoder" in out.err


@pytest.mark.parametrize("mode", ["video", "temporal"])
def test_main_wrong_decode_exits_1(mode, monkeypatch, capsys):
    step = frame_stream.decode_shared_step
    monkeypatch.setattr(frame_stream, "decode_shared_step",
                        lambda *a, **k: _wrong(step(*a, **k)))
    assert bench_torch.main(["--mode", mode, *TINY, "--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "FATAL: " in out.err and "mismatch" in out.err


def _child(tmp_path, body: str) -> list:
    """A child command that appends one line to ``tries`` (so a test counts
    its starts), then runs ``body``."""
    tries = tmp_path / "tries"
    code = (f"import os, sys, time\nopen({str(tries)!r}, 'a').write("
            "os.environ.get('MHT_BENCH_CHILD', '-') + '\\n')\n" + body)
    return [sys.executable, "-c", code]


def _tries(tmp_path) -> list:
    return (tmp_path / "tries").read_text().split()


def test_supervise_passes_the_last_line_on(tmp_path, capsys):
    cmd = _child(tmp_path, "print('noise'); print('{\"value\": 1}')")
    assert bench_torch.supervise(cmd) == 0
    assert capsys.readouterr().out == '{"value": 1}\n'
    assert _tries(tmp_path) == ["1"]  # the child is marked


def test_supervise_does_not_retry_a_failed_child(tmp_path, capsys):
    cmd = _child(tmp_path, "print('{}'); sys.exit(1)")
    assert bench_torch.supervise(cmd) == 1
    out = capsys.readouterr()
    assert out.out == "" and "failed (rc=1); not retried" in out.err
    assert _tries(tmp_path) == ["1"]


def test_supervise_retries_a_timeout_once(tmp_path, capsys):
    cmd = _child(tmp_path, "time.sleep(60)")
    assert bench_torch.supervise(cmd, timeout=1.5) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert out.err.count("timed out") == 2 and "giving up" in out.err
    assert _tries(tmp_path) == ["1", "1"]


@pytest.fixture(scope="module")
def blocked_env(tmp_path_factory):
    """An environment whose Python processes, the supervisor's child too,
    cannot import ``jax`` or the JAX package (a ``sitecustomize`` on the
    path marks them missing)."""
    site = tmp_path_factory.mktemp("blocked")
    (site / "sitecustomize.py").write_text(
        "import sys\nsys.modules['jax'] = None\n"
        "sys.modules['metalhuffman_tpu'] = None\n")
    env = {k: v for k, v in os.environ.items() if k != "MHT_BENCH_CHILD"}
    env["OMP_NUM_THREADS"] = "1"  # the runs go all at once
    env["PYTHONPATH"] = os.pathsep.join(
        [str(site)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


#: bench_torch.py's runs at tiny geometry on the CPU -> the metric
MODES = {
    "video": (["--mode", "video"], "decode_throughput"),
    "video delta2d photo": (["--mode", "video", "--precoder", "delta2d",
                             "--content", "photo"], "decode_throughput"),
    "single": (["--mode", "single"], "decode_throughput"),
    "encode": (["--mode", "encode"], "encode_throughput"),
    "temporal": (["--mode", "temporal"], "temporal_decode_throughput"),
    "temporal mc color": (["--mode", "temporal", "--motion", "--inner",
                           "color"], "temporal_mc_color_decode_throughput"),
    "temporal u16": (["--mode", "temporal", "--inner", "u16"],
                     "temporal_u16_decode_throughput"),
}


@pytest.fixture(scope="module")
def mode_runs(blocked_env):
    """Every run of ``MODES`` as ``python bench_torch.py ... --device cpu``
    with JAX blocked, all at once -> (rc, stdout, stderr) by label."""
    procs = {label: subprocess.Popen(
        [sys.executable, str(ROOT / "bench_torch.py"), *args, *TINY, "-v",
         "--device", "cpu"], cwd=ROOT, env=blocked_env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for label, (args, _) in MODES.items()}
    try:
        runs = {label: p.communicate(timeout=120)
                for label, p in procs.items()}
        return {label: (procs[label].returncode, *runs[label])
                for label in procs}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.parametrize("label", MODES)
def test_bench_torch_prints_one_line_without_jax(label, mode_runs):
    rc, out, err = mode_runs[label]
    assert rc == 0, err
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == KEYS
    assert line["metric"] == MODES[label][1] and line["unit"] == "GB/s"
    assert line["value"] > 0 and line["reps"] >= 3
    assert line["vs_baseline"] == pytest.approx(line["value"] / 0.094,
                                                abs=0.01)
    # -v: the launch counts; the plain versions launch nothing
    counts = [ln for ln in err.splitlines() if ln.startswith("launches ")]
    assert len(counts) == 1
    assert json.loads(counts[0][len("launches "):]) == {
        "decode_images": 0, "decode_blocks": 0, "encode_stream": 0,
        "encode_rows": 0, "temporal_fold": 0}


def _options(help_text: str) -> set:
    return set(re.findall(r"(?<![\w-])(--?[a-z][a-z-]*)", help_text))


def test_help_options_are_bench_pys(blocked_env):
    ref = subprocess.run([sys.executable, str(ROOT / "bench.py"), "--help"],
                         cwd=ROOT, env=dict(os.environ, MHT_BENCH_CHILD="1"),
                         capture_output=True, text=True, timeout=120)
    assert ref.returncode == 0, ref.stderr
    ours = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"),
                           "--help"], cwd=ROOT, env=blocked_env,
                          capture_output=True, text=True, timeout=60)
    assert ours.returncode == 0, ours.stderr
    assert _options(ref.stdout) >= {"--mode", "--trace", "--backend", "-v"}
    assert _options(ours.stdout) == (
        _options(ref.stdout) - {"--backend"}) | {"--device"}


def test_bad_argument_is_refused_by_the_supervisor():
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"),
                           "--mode", "stream"], cwd=ROOT, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "invalid choice: 'stream'" in proc.stderr


def test_metric_names_are_bench_pys():
    ap = bench_torch.parser()
    for args, metric in [(["--mode", "temporal", "--motion"],
                          "temporal_mc_decode_throughput"),
                         (["--mode", "temporal", "--inner", "color"],
                          "temporal_color_decode_throughput"),
                         (["--mode", "single"], "decode_throughput")]:
        assert bench_torch.metric_name(ap.parse_args(args)) == metric


def test_trace_on_cpu(tmp_path, capsys):
    where = tmp_path / "trace"
    assert bench_torch.main(["--mode", "single", "--height", "64", "--width",
                             "512", "--iters", "1", "--device", "cpu",
                             "--trace", str(where)]) == 0
    out = capsys.readouterr()
    assert f"trace written to {where}" in out.err
    assert json.loads(out.out)["metric"] == "decode_throughput"
    counts = chip_smoke.trace_events(where / "trace.json")
    assert counts["host"] > 0 and counts["kernels"] == 0


def test_default_device_fails_without_cuda():
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"),
                           "--mode", "single", "--height", "64", "--width",
                           "512"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "not compiled with CUDA" in proc.stderr
    assert "not retried" in proc.stderr


def test_chip_smoke_phase_l_runs_every_mode():
    ap = bench_torch.parser()
    for label, (args, metric, path) in chip_smoke.L_RUNS.items():
        parsed = ap.parse_args(args)
        assert bench_torch.metric_name(parsed) == metric, label
        assert set(path) <= set(chip_smoke.KERNELS)
        assert ((parsed.mode == "encode")
                == (set(path) == {"encode_rows", "encode_stream"}))
    assert len(chip_smoke.L_RUNS) == 9
    assert {chip_smoke.L_RUNS[k][0][1] for k in chip_smoke.L_RUNS} == {
        "video", "single", "encode", "temporal"}
    src = (ROOT / "chip_smoke.py").read_text()
    main = src[src.index("def main("):]
    assert main.index("phase_k(device)") < main.index("phase_l(device, card)")
    assert 'print("phase L " + json.dumps(' in main


def test_chip_smoke_phase_l_refuses_a_run_without_its_kernel(monkeypatch):
    # on the CPU the plain versions run: the line is right, no kernel
    # launched, so the launch check refuses the run
    with pytest.raises(chip_smoke.PhaseError,
                       match="phase L single: launches .* the path's"):
        chip_smoke.run_bench("single", "cpu", "cpu", TINY)
