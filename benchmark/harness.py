"""One run of one cell: set-up, the measured window, the comparison, the
metrics and the result line.

The cell names its configuration and its traffic mix in ``BENCHMARK.json``;
the configuration's file, the mix's file (``traffic/<mix>.json``) and each
metric's reader (``metrics/<metric>.py``) are found by those names, so a new
cell, mix or metric is a new file and an entry, with no file edited.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import clips, loops, system, trace as trace_mod
from .reference import plain

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
#: answers kept for the comparison besides the last: staged calls, requests
SAMPLES = {"staged": 8, "range": 16}
#: the longest window a ``--trace 1`` run records: the trace of a window
#: takes about twice the window to read
TRACE_WINDOW_S = 10.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def smi() -> str:
    """One ``nvidia-smi`` reading of every card (its name, power limit and
    draw, clocks, temperature), or why there is none."""
    query = "name,power.limit,power.draw,clocks.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"no nvidia-smi reading ({e.__class__.__name__})"
    return "; ".join(out.stdout.strip().splitlines())


# -- finding a cell's files by name --------------------------------------------


def load_benchmark(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def find_cell(bench: dict, workload: str, repo: Path = REPO):
    """-> (cell, configuration, mix) of the workload named ``workload``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((repo / entry["file"]).read_text())
    mix = json.loads((repo / HERE.name / "traffic" /
                      f"{cell['traffic']}.json").read_text())
    return cell, config, mix


def cell_metrics(bench: dict, cell: dict, section: str) -> list[dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") the cell
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(name: str, repo: Path = REPO):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = repo / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the run --------------------------------------------------------------------


@dataclass
class Run:
    """What a metric's reader is given."""

    config: dict
    mix: dict
    setup_s: float = 0.0
    window: loops.Window = field(default_factory=loops.Window)
    #: staged: one shape dict a rotation (``system.Staged.shape``)
    shapes: list = field(default_factory=list)
    trace: trace_mod.Trace | None = None

    @property
    def kind(self) -> str:
        return self.mix["kind"]


def _sync(device):
    import torch

    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _set_up_staged(subject, run: Run, clip, pan, device):
    """Stage every rotation, warm each up, and hold as many answers at once
    as the window keeps, so the window allocates nothing new -> (the calls,
    each rotation's frame order)."""
    orders = loops.rotation_orders(run.mix)
    t0 = time.perf_counter()
    staged = [subject.stage(run.config, clip[o], o, pan, device)
              for o in orders]
    log(f"set-up: {len(staged)} rotations encoded and staged in "
        f"{time.perf_counter() - t0:.3f} s")
    run.shapes = [s.shape for s in staged]
    held = [staged[i % len(staged)].call()
            for i in range(SAMPLES["staged"] + 2 + len(staged))]
    _sync(device)()
    del held
    return [s.call for s in staged], orders


def _set_up_range(subject, run: Run, clip, device):
    """Store the clip and warm every request size up -> (the decode, the
    warm-up requests that failed)."""
    t0 = time.perf_counter()
    decode, nbytes = subject.ranged(run.config, clip, device)
    lo, hi = run.mix["frames"]
    t = run.mix["clip_frames"]
    failed = 0
    for a, b in [(0, k) for k in range(lo, hi + 1)] + [(t - hi, t)]:
        try:
            decode(a, b)
        except (RuntimeError, ValueError) as e:
            failed += 1
            log(f"set-up: request [{a}, {b}) failed: {e!r}")
    log(f"set-up: container of {nbytes} bytes encoded and each request "
        f"size warmed in {time.perf_counter() - t0:.3f} s")
    return decode, failed


def run_cell(bench: dict, cell: dict, config: dict, mix: dict, seed: int,
             seconds: float, trace: bool, device, t_start: float,
             subject=system) -> dict:
    """Set up, measure for ``seconds``, compare and read the metrics ->
    the result line's object (``checks`` last). ``t_start`` is the
    process's start on ``time.perf_counter``'s clock. ``subject`` is what
    the window drives: the port (:mod:`.system`), or what stands in its
    place (``control.py``), with the same ``build``, ``launches``,
    ``stage`` and ``ranged``."""
    import torch

    run = Run(config, mix)
    staged = mix["kind"] == "staged"
    if mix["kind"] not in ("staged", "range"):
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    on_card = device.type == "cuda"
    if trace:
        seconds = min(seconds, TRACE_WINDOW_S)
    if on_card:
        log(f"card: {torch.cuda.get_device_name(device)}, "
            f"{torch.cuda.device_count()} visible; torch {torch.__version__}"
            f", CUDA {torch.version.cuda}")
        log(f"set-up: kernels and host codec built or loaded in "
            f"{subject.build():.3f} s")
    t0 = time.perf_counter()
    h, w = config["height"], config["width"]
    clip, pan = clips.clip(config["content"], h, w, mix["clip_frames"], seed)
    log(f"set-up: clip {clip.shape[0]}x{h}x{w}, pan {pan} px a frame, in "
        f"{time.perf_counter() - t0:.3f} s")
    sync = _sync(device)
    points = loops.sample_points(seed, SAMPLES[mix["kind"]])
    warm_failed = 0
    if staged:
        calls, orders = _set_up_staged(subject, run, clip, pan, device)
    else:
        decode, warm_failed = _set_up_range(subject, run, clip, device)
    sync()
    launches0 = subject.launches()
    log(f"before the window: {smi()}")
    rec = trace_mod.recorder(trace)
    with rec:
        if staged:
            win = loops.run_staged(calls, seconds, points, sync, rec.span)
        else:
            win = loops.run_range(decode, loops.range_requests(mix, seed),
                                  seconds, points, rec.span)
    run.window = win
    run.setup_s = win.start - t_start
    log(f"after the window: {smi()}")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    launched = {k: v - launches0.get(k, 0)
                for k, v in subject.launches().items()}
    attempted = sum(win.calls) if staged else len(win.calls)
    log(f"window: {win.seconds:.6f} s, {attempted} "
        f"{'calls' if staged else 'requests'}, {win.failed} failed, "
        f"launches {launched}")
    for e in win.errors[:3]:
        log(f"window error: {e}")
    if trace:
        t0 = time.perf_counter()
        run.trace = rec.read()
        log(f"trace read in {time.perf_counter() - t0:.3f} s: "
            + ("no window span" if run.trace is None else
               f"{len(run.trace.device)} device operations, "
               f"{len(run.trace.host)} host operations"))
    # the comparison, once the window has closed, the peak has been read
    # and the program's state is gone
    if staged:
        kept = [(v, out.cpu().numpy()) for v, out in win.kept.values()]
        win.kept.clear()
        del calls
        if on_card:
            torch.cuda.empty_cache()
        pairs = [(out, plain.staged_answer(config["codec"], clip[orders[v]],
                                           orders[v], pan))
                 for v, out in kept]
    else:
        pairs = [(out, plain.range_answer(clip, a, b))
                 for (a, b), out in win.kept.values()]
        win.kept.clear()
    checks = compare(pairs, win.failed + warm_failed)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell, section):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif section == "end_to_end":
            raise RuntimeError(f"{cell['name']} reports no {m['name']}")
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else device.type),
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": all(c["ok"] for c in checks.values()),
           "attempted": attempted,
           "failed": (checks["failed_calls"]["value"]
                      + checks["wrong_answers"]["value"]),
           "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {kk: vv for kk, vv in c.items() if kk != "ok"}
                     for k, c in checks.items()}
    return out


def compare(pairs, failed: int) -> dict:
    """Each (answer, reference) pair compared byte for byte -> the checks,
    each a number with its limit: wrong bytes and wrong answers at most 0,
    failed calls at most 0, answers compared at least 1."""
    wrong_bytes = wrong_answers = 0
    for got, want in pairs:
        got = np.asarray(got)
        bad = (want.size if got.shape != want.shape
               else int(np.count_nonzero(got != want)))
        wrong_bytes += bad
        wrong_answers += bad > 0
    checks = {"wrong_bytes": (wrong_bytes, "at_most", 0),
              "wrong_answers": (wrong_answers, "at_most", 0),
              "failed_calls": (failed, "at_most", 0),
              "answers_compared": (len(pairs), "at_least", 1)}
    return {k: {"value": v, op: lim,
                "ok": v <= lim if op == "at_most" else v >= lim}
            for k, (v, op, lim) in checks.items()}
