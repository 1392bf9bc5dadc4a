"""BENCHMARK.json against the benchmark's contract, and the harness finding every piece of a
cell by its name, also pieces added as files of their own."""

from __future__ import annotations

import json
import math
import re
import shutil

import pytest

from cgbench import spec
from cgbench.harness import Run

BENCH = spec.load_benchmark()
LINE = re.compile(r"[^\n\t]{1,200}")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cgbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(LINE.fullmatch(word) for word in BENCH["command"])
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert word.startswith("cgbench/") or "/" not in word
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]] + WORKLOADS
                         + [m["name"] for m in METRICS]
                         + [w["traffic"] for w in BENCH["workloads"]]
                         + [k for c in BENCH["configs"] for k in c["reduced"]])
def test_names_use_the_allowed_characters(name):
    assert spec.NAME.fullmatch(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if metric in BENCH["end_to_end"] else {"layer", "moves"}
    assert set(metric) - {"workloads"} == keys
    assert spec.UNIT.fullmatch(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert LINE.fullmatch(metric["layer"])
    assert set(metric.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    assert spec.reader_path(metric["name"]).is_file()


def test_names_are_unique_and_layers_consistent():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    by_module = {}
    for m in BENCH["per_layer"]:
        by_module.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(layers) == 1 for layers in by_module.values())


def test_bounds_and_run_seconds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    seconds = BENCH["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, run_seconds + 60 each, 180 s a cell to
    # compile, 1200 s spare
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 180 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert LINE.fullmatch(entry["source"]) and LINE.fullmatch(entry["why"])
    assert entry["source"].startswith("https://")
    assert entry["file"] == f"cgbench/configs/{entry['name']}.json"
    assert len(entry["reduced"]) <= 16
    with open(spec.ROOT / entry["file"]) as f:
        config = json.load(f)
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_workload_resolves_by_name(workload):
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["name"] == f"{entry['config']}.{entry['traffic']}"
    assert entry["chips"] in (1, 4) and LINE.fullmatch(entry["why"])
    cell = spec.cell(workload)
    assert cell.config["name"] == entry["config"]
    assert cell.traffic["name"] == entry["traffic"]
    assert cell.chips == max(1, cell.traffic["ranks"])
    assert cell.problem_file.is_file()
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]))


def _run(cell, **kw):
    fields = dict(cell=cell, kind="NVIDIA H100 80GB HBM3", itemsize=8, points=[64],
                  setup_s=1.5, operator_build_s=0.1, first_solve_s=0.2,
                  times_ms=[10.0] * 4, total_s=0.04, iterations=[20] * 4, traces=[])
    fields.update(kw)
    return Run(**fields)


def test_pieces_added_as_files_are_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new files of a copy
    of the benchmark, with entries in its BENCHMARK.json, make a cell that the unchanged
    harness resolves and reads."""
    root = tmp_path / "cgbench"
    shutil.copytree(spec.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    config = json.loads(spec.config_path("lap5-20000-f64").read_text())
    config.update(name="lap5-10000-f64", grid_size=10000, unknowns=10 ** 8)
    spec.config_path("lap5-10000-f64", root).write_text(json.dumps(config))
    traffic = json.loads(spec.traffic_path("cg-const-recompute").read_text())
    traffic.update(name="cg-const-classic", loop="classic")
    spec.traffic_path("cg-const-classic", root).write_text(json.dumps(traffic))
    spec.metric_path("host_share_pct", root).write_text(
        '"""host_share_pct: a test\'s metric."""\n\n\ndef read(run):\n'
        '    return 100.0 * run.setup_s / (run.setup_s + run.total_s)\n')
    bench = json.loads(json.dumps(BENCH))
    name = "lap5-10000-f64.cg-const-classic"
    bench["configs"].append({"name": "lap5-10000-f64", "source": config["source"],
                             "file": "cgbench/configs/lap5-10000-f64.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": name, "config": "lap5-10000-f64",
                               "traffic": "cg-const-classic", "chips": 1, "why": "a test"})
    bench["end_to_end"][1]["workloads"].append(name)
    bench["per_layer"].append({"name": "host_share_pct", "unit": "%", "better": "lower",
                               "source": "host_clock", "layer": "a test", "moves": "setup_s",
                               "workloads": [name]})
    cell = spec.cell(name, bench, root)
    assert cell.config["grid_size"] == 10000 and cell.traffic["loop"] == "classic"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "solve_ms"]
    assert "host_share_pct" in [m["name"] for m in cell.per_layer]
    assert spec.reader("host_share_pct", root)(_run(cell)) == pytest.approx(
        100 * 1.5 / 1.54)
    assert spec.reader("solve_ms", root)(_run(cell)) == pytest.approx(10.0)
    # a metric of several ranks with no reader of its own reads by its base metric's
    assert spec.reader_path("host_share_pct.ranks", root) == spec.metric_path(
        "host_share_pct", root)
    assert spec.reader("host_share_pct.ranks", root)(_run(cell)) == pytest.approx(
        100 * 1.5 / 1.54)
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
             if p.is_file() and p.relative_to(root) in before}
    assert after == before  # no file that was there changed


def test_readers_of_a_run_without_a_trace_return_nothing():
    cell = spec.cell(WORKLOADS[0])
    run = _run(cell)
    for m in BENCH["per_layer"]:
        value = spec.reader(m["name"])(run)
        assert value is None or (m["source"] != "device_trace" and math.isfinite(value))
