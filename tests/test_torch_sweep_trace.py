"""The fused sweep's lane loop as the benchmark drives it
(``parallel/sweep._run_lane_seq``) on the CPU, on the tiny box of
tests/test_torch_sweep.py: an ``on_interval`` hook leaves every lane bit
for bit as it is without one and as a single run of the lane's config;
the hook sees each output interval once, with the state the interval
began from; ``SWEEP_COUNTS`` counts lanes, output points and steps; the
benchmark's reference channel at a lane's mu has ``make_workloads``' g;
and ``--profile`` captures a sweep interval by interval."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference.sph import Channel
from sph_poiseuille_flow_torch import run as cli
from sph_poiseuille_flow_torch.config import derive_config
from sph_poiseuille_flow_torch.models.poiseuille import build_scene
from sph_poiseuille_flow_torch.parallel import sweep
from sph_poiseuille_flow_torch.stepper import initial_state, make_engine

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MUS = (0.1, 0.8)    # acoustic and viscous dt: the lanes' steps differ
FIELDS = ("x", "y", "vx", "vy", "rho", "p", "drho_dt", "fx", "fy", "fpx",
          "fpy", "vol", "b11", "b12", "b21", "b22")
PHYS = dict(DL=1.0, DH=0.5, dp=0.05, rho0=1.0, mu=0.1, U_bulk=0.666667,
            c_f=15.0)


def _cfg(**kw):
    return derive_config(**dict(dict(PHYS, end_time=0.04,
                                      output_interval=0.02, sort_interval=100,
                                      restart_from_file=False,
                                      engine="pallas"), **kw))


def _quiet(_):
    pass


def _fields(state):
    return {n: getattr(state, n).numpy() for n in FIELDS}


def _lanes(cfg, on_interval=None):
    """Both lanes through ``_run_lane_seq`` on one engine from one init:
    [(final fields, steps)] and the init (state, layout, geometry)."""
    scene = build_scene(cfg)
    eng = make_engine(cfg, scene, "cpu")
    s0, lay0, geom0, ovf = eng.init(initial_state(cfg, scene, "cpu"))
    assert not bool(ovf)
    gs, mus = sweep.make_workloads(cfg, MUS)
    out = []
    for k in range(len(MUS)):
        st, steps, _, _ = sweep._run_lane_seq(
            cfg, eng, scene, s0, lay0, geom0, gs[k], mus[k], _quiet,
            lane_k=k, on_interval=on_interval)
        out.append((_fields(st), steps))
    return out, (s0, lay0, geom0)


def _single(cfg):
    """The lane's config run alone on a fresh engine: (fields, steps)."""
    scene = build_scene(cfg)
    eng = make_engine(cfg, scene, "cpu")
    state, lay, geom, _ = eng.init(initial_state(cfg, scene, "cpu"))
    f = np.dtype(cfg.dtype).type
    t, steps = 0.0, 0
    while t < cfg.end_time - 1e-9:
        target = min(t + cfg.output_interval, cfg.end_time)
        res = eng.run_interval(state, lay, geom, f(target - t))
        state, lay, geom = res.state, res.cands, res.geom
        steps += res.n_steps
        t = target
    return _fields(state), steps


@pytest.fixture(scope="module")
def lanes():
    cfg = _cfg()
    calls = []
    sweep.reset_sweep_counts()
    hooked, init = _lanes(cfg, lambda k, prev, res: calls.append(
        (k, prev, res)))
    counts = dict(sweep.SWEEP_COUNTS)
    plain, _ = _lanes(cfg)
    gs, mus = sweep.make_workloads(cfg, MUS)
    singles = [_single(sweep._lane_cfg(cfg, g, mu)) for g, mu in zip(gs, mus)]
    return dict(hooked=hooked, plain=plain, singles=singles, calls=calls,
                init=init, counts=counts)


@pytest.mark.parametrize("k", range(len(MUS)))
def test_hooked_lane_equals_plain_lane_and_single_run(lanes, k):
    (got, steps), (plain, plain_steps) = lanes["hooked"][k], lanes["plain"][k]
    ref, ref_steps = lanes["singles"][k]
    assert steps == plain_steps == ref_steps
    for n in FIELDS:
        np.testing.assert_array_equal(got[n], plain[n], err_msg=n)
        np.testing.assert_array_equal(got[n], ref[n], err_msg=n)


def test_hook_sees_each_interval_once(lanes):
    """Two output intervals a lane, in order: the first from the init,
    the second from the first's result; the results' steps are the lane's."""
    calls = lanes["calls"]
    assert [k for k, _, _ in calls] == [0, 0, 1, 1]
    assert lanes["hooked"][0][1] != lanes["hooked"][1][1]
    for k in range(len(MUS)):
        (_, p0, r0), (_, p1, r1) = calls[2 * k:2 * k + 2]
        assert all(a is b for a, b in zip(p0, lanes["init"]))
        assert p1[0] is r0.state and p1[1] is r0.cands and p1[2] is r0.geom
        assert r0.n_steps + r1.n_steps == lanes["hooked"][k][1]
        np.testing.assert_array_equal(r1.state.x.numpy(),
                                      lanes["hooked"][k][0]["x"])


def test_sweep_counts_count_lanes_points_and_steps(lanes):
    c = lanes["counts"]
    assert (c["lanes"], c["points"]) == (2, 4)
    assert c["lane_steps"] == sum(s for _, s in lanes["hooked"])
    assert c["open_s"] > 0.0 and c["point_s"] > 0.0
    sweep.reset_sweep_counts()
    assert all(v == 0 for v in sweep.SWEEP_COUNTS.values())


@pytest.mark.parametrize("mu", [0.05, 0.075, 0.1, 0.125, 0.15, 0.2, 0.25,
                                0.3])
def test_lane_reference_g_matches_make_workloads(mu):
    """The benchmark's sweep cell checks a lane against the reference
    channel at the lane's mu: its g is the program's lane g to rounding."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "sweep8-dp0.01.json")) as f:
        phys = json.load(f)["physical"]
    cfg = derive_config(**{k: float(v) for k, v in phys.items()},
                        end_time=1.0, output_interval=0.5, sort_interval=100,
                        restart_from_file=False)
    gs, _ = sweep.make_workloads(cfg, [mu])
    g_ref = Channel.from_physics(dict(phys, mu=mu)).g
    assert abs(g_ref - gs[0]) <= 1e-14 * abs(gs[0])


@pytest.mark.parametrize("intervals", [1, 2])
def test_profile_covers_the_sweep(tmp_path, capsys, intervals):
    """``--profile`` with ``--sweep-mus``: one ``sph_interval`` row of the
    summary per lane interval."""
    ini = tmp_path / "sweep.ini"
    ini.write_text(
        "[physical]\n" + "".join(f"{k} = {v}\n" for k, v in PHYS.items())
        + f"[simulation]\nend_time = {0.02 * intervals}\n"
        "output_interval = 0.02\nsort_interval = 100\n"
        "restart_from_file = 0\n")
    cli.main(["--config", str(ini), "--device", "cpu", "--base-dir",
              str(tmp_path / "out"), "--sweep-mus", "0.1,0.25", "--profile",
              str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    summary = json.loads((tmp_path / "prof" / "summary.json").read_text())
    assert len(summary["intervals"]) == 2 * intervals
    assert out.count(" output point t=") == 2 * intervals
