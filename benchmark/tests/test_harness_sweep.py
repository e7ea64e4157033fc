"""The sweep driver (``drivers/sweep.py``) through the whole harness on the
CPU: two lanes of the tiny box (``data/tiny-sweep.json``) under the
traffic of ``sweep8-dp0.01.developed``, its limits included. A sound run
is correct and counts its lanes in the program's lane loop; a run with
the lanes' engine broken underneath is not; the control readings run on
it."""

import json
import os
import shutil
import time

import pytest

from benchmark import check, control, harness
from test_harness_run import Broken, unchanged

CELL = "tiny-sweep.developed"
SWEEP = "sweep8-dp0.01.developed"


@pytest.fixture(scope="module")
def sweep_bench(tiny_bench):
    bench, spec = tiny_bench
    here = os.path.dirname(os.path.abspath(__file__))
    shutil.copy(os.path.join(here, "data", "tiny-sweep.json"),
                os.path.join(bench, "configs", "tiny-sweep.json"))
    wl = harness.load_json(os.path.join(bench, "workloads", SWEEP + ".json"))
    wl.update(name=CELL, config="tiny-sweep", output_interval=0.01,
              warm_interval=0.005)
    wl["check"]["sampled_from"] = 4
    with open(os.path.join(bench, "workloads", CELL + ".json"), "w") as f:
        json.dump(wl, f)
    spec = dict(spec, workloads=spec["workloads"] + [dict(
        name=CELL, config="tiny-sweep", traffic="developed", chips=1,
        why="test")])
    return bench, spec


def _run(sweep_bench, engine_wrap=None, traced=False, seed=2 ** 31 + 11,
         seconds=0.5):
    bench, spec = sweep_bench
    return harness.run_cell(spec, CELL, seed, seconds, traced, "cpu",
                            time.perf_counter(), bench_dir=bench,
                            engine_wrap=engine_wrap, log=lambda s: None)


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_sound_sweep_is_correct(sweep_bench, traced):
    """Whole lanes of two intervals, correct; traced, the accepted
    counters are read. The window's lanes went through the program's lane
    loop: its counts, reset at the window's start, hold the window's whole
    lanes and the lane loop's own host time (the check runs no lane)."""
    from sph_poiseuille_flow_torch.parallel import sweep
    out = _run(sweep_bench, traced=traced)
    assert out["correct"], out["checks"]
    assert out["attempted"] % 2 == 0 and out["attempted"] >= 2
    assert list(out["checks"]) == list(check.NAMES)
    counts = sweep.SWEEP_COUNTS
    assert counts["points"] == out["attempted"] == 2 * counts["lanes"]
    assert counts["open_s"] > 0.0 and counts["point_s"] > 0.0
    if traced:
        assert set(out["metrics"]) == {
            "host_syncs_per_kstep", "rollbacks_per_kstep",
            "wrapper_calls_per_kstep"}
    else:
        assert set(out["metrics"]) == {"particle_steps_per_s", "setup_s"}
    json.dumps(out)


def test_sampled_lane_is_the_checked_lane(sweep_bench):
    """The check runs the sampled interval's lane: its reference channel
    and its engine carry that lane's mu, and the window's intervals name
    their lanes in order."""
    bench, _ = sweep_bench
    conf = harness.load_json(os.path.join(bench, "configs",
                                          "tiny-sweep.json"))
    wl = harness.load_json(os.path.join(bench, "workloads", CELL + ".json"))
    driver = harness.load_module(bench, "drivers", "sweep")
    mus = conf["lanes"]["mu"]
    seen = set()
    # the draws: interval 1 (lane 0) and interval 3 (lane 1)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2):
        run = driver.run(conf, wl, seed, 2.0, False, "cpu",
                         time.perf_counter())
        lanes = [iv["lane"] for iv in run.intervals]
        assert lanes == [i // 2 % len(mus) for i in range(len(lanes))]
        assert len(run.points) == len(lanes) + 1
        k = lanes[run.sampled - 1]
        assert run.ch.mu == mus[k] == run.engine._mu
        seen.add(k)
    assert seen == {0, 1}


def test_broken_lane_engine_is_not_correct(sweep_bench):
    out = _run(sweep_bench, engine_wrap=lambda e: Broken(e, unchanged))
    assert not out["correct"]
    assert out["failed"] >= 1


def test_control_readings_run_on_the_sweep(sweep_bench):
    bench, _ = sweep_bench
    limits = harness.load_json(harness.find(
        harness.BENCH_DIR, "workloads", SWEEP))["limits"]
    summary, rows = control.readings(CELL, [2 ** 31 + 12], [2 ** 31 + 13],
                                     0.02, "cpu", bench_dir=bench)
    assert check.verdict(summary["program"], limits)[1]
    assert not check.verdict(summary["control"], limits)[1]
    assert [r["control"] for r in rows] == [False, True]
