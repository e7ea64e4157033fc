"""The benchmark's CPU tests. Tests marked ``cuda`` need a CUDA card and
skip without one; the card is looked for inside the ``card`` fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's cells run on the card")
    return torch.device("cuda", 0)


TINY = "tiny.developed"


def make_tiny_bench(dest):
    """A copy of the benchmark's data under ``dest`` with one more cell:
    the tiny box of ``data/tiny.json`` under the traffic of
    ``channel-dp0.01.developed``, its limits included. Returns
    (bench_dir, spec)."""
    import json
    import shutil
    from benchmark import harness
    bench = os.path.join(str(dest), "benchmark")
    for sub in ("configs", "workloads", "drivers", "metrics"):
        shutil.copytree(os.path.join(harness.BENCH_DIR, sub),
                        os.path.join(bench, sub))
    shutil.copy(os.path.join(harness.BENCH_DIR, "peaks.json"), bench)
    here = os.path.dirname(os.path.abspath(__file__))
    shutil.copy(os.path.join(here, "data", "tiny.json"),
                os.path.join(bench, "configs", "tiny.json"))
    wl = harness.load_json(os.path.join(
        bench, "workloads", "channel-dp0.01.developed.json"))
    wl.update(name=TINY, config="tiny", output_interval=0.01,
              warm_interval=0.005)
    wl["check"]["sampled_from"] = 2
    with open(os.path.join(bench, "workloads", TINY + ".json"), "w") as f:
        json.dump(wl, f)
    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    spec["workloads"].append(dict(name=TINY, config="tiny",
                                  traffic="developed", chips=1, why="test"))
    return bench, spec


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    return make_tiny_bench(tmp_path_factory.mktemp("bench"))
