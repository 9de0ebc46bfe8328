"""Whole runs on the CPU at tiny sizes: the result line, the refusal without
a card, the import guard, files found by name, the control, and the faults
the comparison has to catch."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import control, guard, harness

CELLS = ["bridge8.batch", "bridge8.range", "mc8.batch"]
SEED = 2**31 + 99
CPU = torch.device("cpu")


def run(bench, tiny_cell, workload, trace=False, seconds=0.3, **kw):
    cell, config, mix = tiny_cell(workload)
    return harness.run_cell(bench, cell, config, mix, SEED, seconds, trace,
                            CPU, time.perf_counter(), **kw)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(bench, tiny_cell, workload, trace):
    out = run(bench, tiny_cell, workload, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert "value" in c and len(c) == 2
    cell = tiny_cell(workload)[0]
    if trace:
        # no device operation runs on the CPU: no device metric is read
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["metrics"] == {}
    else:
        names = {m["name"] for m in harness.cell_metrics(bench, cell,
                                                         "end_to_end")}
        assert set(out["metrics"]) == names
        for m in out["metrics"].values():
            assert m["value"] > 0 and set(m) == {"value", "unit"}
    json.dumps(out)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "bridge8.batch", "--seed", str(SEED), "--seconds",
                        "1", "--trace", "0"], cwd=harness.REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_import_guard():
    assert guard.forbidden(["metalhuffman_tpu_torch",
                            "metalhuffman_tpu_torch.ops.decode_cuda",
                            "numpy", "torch._C", "jaxtyping"]) == []
    assert guard.forbidden(["jax.numpy", "numpy"]) == ["jax"]
    assert guard.forbidden(["metalhuffman_tpu.models", "flax"]) == [
        "flax", "metalhuffman_tpu"]
    assert guard.forbidden() == []


def test_guard_fails_a_run(monkeypatch, capsys):
    # a run that has loaded jax prints no result and exits non-zero
    from benchmark import run as run_mod

    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell",
                        lambda *a, **k: {"correct": True, "checks": {}})
    rc = run_mod.main(["--workload", "bridge8.batch", "--seed", "1",
                       "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err


def test_new_files_found_by_name(tmp_path, bench):
    """A new configuration, mix and metric are files and entries; no file
    the benchmark has is edited."""
    root = tmp_path / "benchmark"
    for d in ("configs", "traffic", "metrics"):
        (root / d).mkdir(parents=True)
    (root / "configs" / "new-cfg.json").write_text(
        json.dumps({"name": "new-cfg", "height": 8}))
    (root / "traffic" / "new_mix.json").write_text(
        json.dumps({"kind": "range", "clip_frames": 4}))
    (root / "metrics" / "new.metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "new-cfg", "source": "x",
                           "file": "benchmark/configs/new-cfg.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": "new.cell", "config": "new-cfg",
                             "traffic": "new_mix", "chips": 1, "why": "x"})
    new["per_layer"].append({"name": "new.metric", "unit": "%",
                             "better": "higher", "source": "device_trace",
                             "layer": "device", "moves": "setup_s",
                             "workloads": ["new.cell"]})
    cell, config, mix = harness.find_cell(new, "new.cell", tmp_path)
    assert config["height"] == 8 and mix["clip_frames"] == 4
    names = [m["name"] for m in harness.cell_metrics(new, cell, "per_layer")]
    assert names == ["new.metric"]
    assert harness.reader("new.metric", tmp_path)(None) == 42.0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(bench, tiny_cell, workload):
    out = run(bench, tiny_cell, workload, subject=control)
    assert out["correct"] is False
    assert out["checks"]["wrong_bytes"]["value"] > 0


# -- faults planted in the port, under the window --------------------------


def _zeros(decode):
    """The decode leaves its answer as allocated: the state unchanged."""
    def f(*a, **k):
        out = decode(*a, **k)
        return torch.zeros_like(out)
    return f


def _half(decode):
    """Half of the batch left out: the second half of the frames is never
    decoded."""
    def f(*a, **k):
        out = decode(*a, **k).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return f


def _flip(decode):
    """One byte of the answer altered where it is produced."""
    def f(*a, **k):
        out = decode(*a, **k).clone()
        out.view(-1)[out.numel() // 3] ^= 1
        return out
    return f


def _fold_unchanged(fold):
    """The fold returns the residuals it was given."""
    return lambda planes, *a, **k: planes


FAULTS = {
    "decode_unchanged": ("frame_stream", "decode_shared_step", _zeros),
    "decode_half": ("frame_stream", "decode_shared_step", _half),
    "decode_flip": ("frame_stream", "decode_shared_step", _flip),
    "kernel_flip": ("decode_cuda", "decode_images", _flip),
    "fold_unchanged": ("temporal", "fold_planes", _fold_unchanged),
    "fold_flip": ("temporal", "fold_planes", _flip),
    "range_half": ("frame_stream", "decode_range_parsed", None),
}


def _plant(monkeypatch, name):
    from metalhuffman_tpu_torch.models import frame_stream, temporal
    from metalhuffman_tpu_torch.ops import decode_cuda

    mods = {"frame_stream": frame_stream, "temporal": temporal,
            "decode_cuda": decode_cuda}
    mod, attr, wrap = FAULTS[name]
    orig = getattr(mods[mod], attr)
    if name == "range_half":
        def wrap(decode):
            def f(parsed, a, b, *args, **k):
                return decode(parsed, a, a + (b - a + 1) // 2, *args, **k)
            return f
    monkeypatch.setattr(mods[mod], attr, wrap(orig))


@pytest.mark.parametrize("workload,fault", [
    ("bridge8.batch", "decode_unchanged"), ("bridge8.batch", "decode_half"),
    ("bridge8.batch", "decode_flip"), ("bridge8.batch", "kernel_flip"),
    ("mc8.batch", "fold_unchanged"), ("mc8.batch", "decode_half"),
    ("mc8.batch", "fold_flip"), ("mc8.batch", "kernel_flip"),
    ("bridge8.range", "kernel_flip"), ("bridge8.range", "range_half"),
    ("bridge8.range", "decode_unchanged")])
def test_fault_is_not_correct(bench, tiny_cell, monkeypatch, workload, fault):
    _plant(monkeypatch, fault)
    out = run(bench, tiny_cell, workload)
    assert out["correct"] is False
    assert out["failed"] > 0


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(bench, card, workload):
    """Each cell at its own size, a short window, on the card."""
    cell, config, mix = harness.find_cell(bench, workload)
    out = harness.run_cell(bench, cell, config, mix, SEED, 2.0, False, card,
                           time.perf_counter())
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
