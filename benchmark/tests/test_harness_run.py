"""A whole run of the harness on the CPU, past its look for a card: a
sound run is correct, and a run with the timed path broken underneath is
not, for each fault the cells can have; so is the lower-precision
control. A box of the channel's physics at a CPU size stands in for the
cells; the limits are ``channel-dp0.01.developed``'s."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import check, control, harness


class Broken:
    """The engine with ``fault(state_in, result) -> result`` applied to
    every output of ``run_interval``."""

    def __init__(self, engine, fault):
        self._engine, self._fault = engine, fault

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def run_interval(self, state, lay, geom, interval, **kw):
        res = self._engine.run_interval(state, lay, geom, interval, **kw)
        return self._fault(state, lay, geom, res)


def unchanged(state, lay, geom, res):
    """A step that returns its state unchanged."""
    return res._replace(state=state, cands=lay, geom=geom)


def half_left_out(state, lay, geom, res):
    """Half of the particles left out: every other one keeps its input."""
    n = state.x.numel()
    odd = torch.arange(n) % 2 == 1
    return res._replace(state=type(state)(*(
        torch.where(odd, a, b) for a, b in zip(state, res.state))))


def speed_altered(state, lay, geom, res):
    """One answer altered where it is produced: a particle's speed."""
    vx = res.state.vx.clone()
    vx[len(vx) // 4] += 0.05
    return res._replace(state=res.state._replace(vx=vx))


def shear_altered(state, lay, geom, res):
    """One answer altered where it is produced: the wall shear."""
    return res._replace(tau_bottom=res.tau_bottom * 1.01)


def _run(tiny_bench, engine_wrap=None, traced=False, seed=2 ** 31 + 5):
    bench, spec = tiny_bench
    return harness.run_cell(spec, "tiny.developed", seed, 0.02, traced,
                            "cpu", time.perf_counter(), bench_dir=bench,
                            engine_wrap=engine_wrap, log=lambda s: None)


def test_sound_run_is_correct(tiny_bench):
    out = _run(tiny_bench)
    assert out["correct"], out["checks"]
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"particle_steps_per_s", "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out["checks"]) == list(check.NAMES)
    json.dumps(out)


def test_traced_run_reports_per_layer_metrics(tiny_bench):
    out = _run(tiny_bench, traced=True)
    assert out["correct"]
    # no device to trace on the CPU: the device readers find nothing
    assert set(out["metrics"]) == {"host_syncs_per_kstep",
                                   "rollbacks_per_kstep",
                                   "wrapper_calls_per_kstep"}


@pytest.mark.parametrize("fault", [unchanged, half_left_out, speed_altered,
                                   shear_altered], ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(tiny_bench, fault):
    out = _run(tiny_bench, engine_wrap=lambda e: Broken(e, fault))
    assert not out["correct"]
    assert out["failed"] >= 1


def test_control_is_not_correct(tiny_bench):
    bench, _ = tiny_bench
    limits = harness.load_json(harness.find(
        harness.BENCH_DIR, "workloads", "channel-dp0.01.developed"))["limits"]
    summary, rows = control.readings("tiny.developed", [2 ** 31 + 6],
                                     [2 ** 31 + 7, 2 ** 31 + 8], 0.02, "cpu",
                                     bench_dir=bench)
    assert check.verdict(summary["program"], limits)[1]
    for r in rows:
        if r["control"]:
            assert not check.verdict(r["gaps"], limits)[1], r["gaps"]


def _cli(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "channel-dp0.01.developed", "--seed", "3", "--seconds", "1"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_cli_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _cli(harness.ROOT)
    assert r.returncode != 0 and r.stdout == ""


def test_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _cli(str(tmp_path))
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card(card):
    """A short run of the smaller cell through the command line: correct,
    with both end-to-end metrics."""
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "channel-dp0.01.developed", "--seed", str(2 ** 31 + 9),
         "--seconds", "3", "--trace", "0"], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"particle_steps_per_s", "setup_s"}
