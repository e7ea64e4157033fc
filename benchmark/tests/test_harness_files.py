"""Every configuration, workload and metric of BENCHMARK.json resolves from
its own file, and a file added to a copy is found with no edit."""

import json
import os
import re
import shutil

import pytest

from benchmark import check, harness

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_resolves(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    path = harness.find(harness.BENCH_DIR, "configs", conf["name"])
    assert os.path.relpath(path, harness.ROOT) == conf["file"]
    data = harness.load_json(path)
    assert data["name"] == conf["name"]
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    assert len(conf["source"]) <= 200 and len(conf["why"]) <= 200
    for key in conf["reduced"]:
        assert key in data["simulation"] or key in data["physical"]


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] in (1, 4)
    assert len(cell["why"]) <= 200
    wl = harness.load_json(harness.find(harness.BENCH_DIR, "workloads",
                                        cell["name"]))
    assert wl["name"] == cell["name"]
    assert wl["config"] == cell["config"]
    assert wl["traffic"] == cell["traffic"]
    harness.find(harness.BENCH_DIR, "configs", wl["config"])
    driver = harness.load_module(harness.BENCH_DIR, "drivers", wl["driver"])
    assert callable(driver.run)
    assert set(wl["limits"]) == set(check.NAMES)
    assert wl["limits"]["rerun_gap"] == 0 and wl["limits"]["flags"] == 0


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_resolves(metric):
    mod = harness.load_module(harness.BENCH_DIR, "metrics", metric["name"])
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        metric["layer"], metric["unit"], metric["source"], metric["moves"])
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    assert callable(mod.read)


def test_end_to_end_metrics():
    names = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(names) == {"particle_steps_per_s", "setup_s"}
    assert names["setup_s"]["bound"] <= 0.25
    for m in names.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"


def test_names_are_unique_and_well_formed():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[kind]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)


def test_readers_return_nothing_without_a_trace():
    r = dict(steps=1000, syncs=62, rollbacks=0, launches=63, window_s=1.0,
             trace=None, least_s=None, bound_by=None, peaks=None)
    for m in SPEC["per_layer"]:
        v = harness.load_module(harness.BENCH_DIR, "metrics",
                                m["name"]).read(r)
        assert (v is None) == (m["source"] == "device_trace")


def test_added_workload_is_found_without_edit(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    wl = harness.load_json(str(bench / "workloads" /
                               "channel-dp0.01.developed.json"))
    wl.update(name="channel-dp0.01.other", warm_interval=0.1)
    (bench / "workloads" / "channel-dp0.01.other.json").write_text(
        json.dumps(wl))
    found = harness.load_json(harness.find(str(bench), "workloads",
                                           "channel-dp0.01.other"))
    assert found["warm_interval"] == 0.1
    assert harness.find(str(bench), "configs", found["config"])
    spec = dict(SPEC, workloads=SPEC["workloads"] + [dict(
        name="channel-dp0.01.other", config="channel-dp0.01",
        traffic="developed", chips=1, why="test")])
    assert harness.cell_entry(spec, "channel-dp0.01.other")["chips"] == 1
    assert harness.metrics_of(spec, "per_layer", "channel-dp0.01.other") \
        == SPEC["per_layer"]


def test_peaks_table():
    peaks = harness.load_json(os.path.join(harness.BENCH_DIR, "peaks.json"))
    h100 = peaks["NVIDIA H100 80GB HBM3"]
    assert h100["ops_per_s"] == 67e12 and h100["bytes_per_s"] == 3.35e12
