"""BENCHMARK.json within the limits its format sets (names, units, sizes,
bounds, the metrics every cell reports), and every file it names found where
the harness looks for it."""

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level(bench):
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len((harness.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_text(bench):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])


def test_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert TEXT.match(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    configs = {c["name"] for c in bench["configs"]}
    used = set()
    for cell in bench["workloads"]:
        used.add(cell["config"])
        e2e = [m["name"] for m in harness.cell_metrics(bench, cell,
                                                        "end_to_end")]
        layer = harness.cell_metrics(bench, cell, "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, cell["name"]
        for m in layer:
            assert m["moves"] in e2e, (cell["name"], m["name"])
    assert used == configs
    pairs = [(c["config"], c["traffic"]) for c in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("group", ["configs", "workloads", "metrics"])
def test_files_found_by_name(bench, group):
    if group == "configs":
        for c in bench["configs"]:
            cfg = json.loads((harness.REPO / c["file"]).read_text())
            assert c["file"].startswith("benchmark/configs/")
            assert cfg["name"] == c["name"] and "assumed" in cfg
    elif group == "workloads":
        for w in bench["workloads"]:
            cell, config, mix = harness.find_cell(bench, w["name"])
            assert mix["kind"] in ("staged", "range")
    else:
        for m in bench["end_to_end"] + bench["per_layer"]:
            assert callable(harness.reader(m["name"]))
