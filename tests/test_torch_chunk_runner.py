"""The fused engine's chunk path on persistent buffers
(``fused_cell.ChunkRunner``, ``fused_cell.BufferedChunkRun``) against the
stateless path it replaces (``chunk_buffers`` off: ``ChunkRun`` through
``fused_chunk_call``, the group loop's stacked read), on the CPU, where
the runner fills its ping-pong sets from the plain twins. Every case holds
the engine's ``IntervalResult`` bit for bit to the stateless engine's:

* ``plain``: a window of several sub-chunk groups of several sub-chunks;
* ``rollback``: the predictor off and a small skin, so every group runs
  to a genuine crossing and ends on a rolled-back sub-chunk (the kept
  set's aux cores then feed the rebuild and the next group's carry);
* ``split``: the interval re-run in step-bounded calls (``max_steps=1``,
  resumed with the clock and ``sub_len0``), as the benchmark's check does;
* ``two_intervals``: two intervals in a row reuse one set of buffers
  (``CHUNK_BUFFERS``: one set built, one run per sub-chunk);
* ``slab``: a one-slab ``ShardedPallasEngine`` with ghost rows runs its
  chunk on the extended slab, a key with buffers of its own.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sph_poiseuille_flow_torch.config import SPHConfig
from sph_poiseuille_flow_torch.models.poiseuille import build_scene
from sph_poiseuille_flow_torch.ops import fused_cell as fc
from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
from sph_poiseuille_flow_torch.parallel import (ShardedPallasEngine,
                                                make_mesh)
from sph_poiseuille_flow_torch.stepper import (PallasCellEngine, State,
                                               initial_state)

from test_config import default_cfg

torch.set_num_threads(1)


def _cfg(**kw):
    base = dict(DL=1.0, DH=0.5, dp=0.05, end_time=0.5, output_interval=0.25,
                engine="pallas", neighbor_skin=0.75 * 0.05, rebuild_every=16,
                cell_capacity=18)
    base.update(kw)
    return SPHConfig(**dataclasses.asdict(default_cfg(**base)))


def _moving(cfg, scene):
    """The channel's profile and a seeded transverse noise: particles
    change cells within a few steps."""
    nf = scene.n_fluid
    rng = np.random.default_rng(3)
    y = np.asarray(scene.y[:nf], np.float64)
    vx = np.zeros(scene.n_total, np.float32)
    vy = np.zeros(scene.n_total, np.float32)
    vx[:nf] = 6.0 * cfg.U_bulk * y * (cfg.DH - y) / cfg.DH ** 2
    vy[:nf] = rng.normal(0, 2.0, nf)
    return initial_state(cfg, scene, "cpu")._replace(
        vx=torch.tensor(vx), vy=torch.tensor(vy))


def _same(r1, r2):
    assert r2.n_steps == r1.n_steps > 0
    assert (r2.n_rollbacks, r2.n_syncs, r2.sub_len, r2.skin_guard) == (
        r1.n_rollbacks, r1.n_syncs, r1.sub_len, r1.skin_guard)
    assert (r2.t_local, r2.t_comp) == (r1.t_local, r1.t_comp)
    for name in State._fields:
        assert torch.equal(getattr(r2.state, name),
                           getattr(r1.state, name)), name
    for name in ("tau_bottom", "tau_top", "v_max", "n_pairs", "overflow"):
        assert torch.equal(getattr(r2, name), getattr(r1, name)), name


def _split(eng, start, interval):
    """The interval in calls bounded at one step (the benchmark's
    ``check.rerun``): the last call's result."""
    s, lay, geom = start
    t_loc = t_cmp = np.float32(0.0)
    sub_len, calls = None, 0
    while True:
        kw = {} if sub_len is None else {"sub_len0": sub_len}
        r = eng.run_interval(s, lay, geom, interval, max_steps=1,
                             t_local0=t_loc, t_comp0=t_cmp, **kw)
        calls += 1
        s, lay, geom = r.state, r.cands, r.geom
        t_loc, t_cmp, sub_len = r.t_local, r.t_comp, r.sub_len
        if t_loc >= interval or r.n_steps == 0:
            assert calls >= 3
            return r


def _engines(case):
    """(make an engine, its start state, the window, how many intervals)."""
    if case == "rollback":
        cfg = _cfg(neighbor_skin=0.12 * 0.05, rebuild_every=16)
        scene = build_scene(cfg)
        return (lambda: PallasCellEngine(cfg, scene, "cpu"),
                _moving(cfg, scene), 0.006, 1)
    if case == "slab":
        cfg = _cfg(DH=2.0)
        scene = build_scene(cfg)
        return (lambda: ShardedPallasEngine(cfg, scene,
                                            make_mesh(1, device="cpu"),
                                            ghost=4),
                initial_state(cfg, scene, "cpu"), 0.02, 1)
    cfg = _cfg()
    scene = build_scene(cfg)
    return (lambda: PallasCellEngine(cfg, scene, "cpu"),
            _moving(cfg, scene), 0.04, 2 if case == "two_intervals" else 1)


@pytest.mark.parametrize("case", ["plain", "rollback", "split",
                                  "two_intervals", "slab"])
def test_buffered_chunks_match_stateless(case, monkeypatch):
    # groups of 16 steps in sub-chunks of at most 4: kept sets swap
    # within a group
    monkeypatch.setenv("SPH_SUB_STEPS", "4")
    if case == "rollback":
        monkeypatch.setenv("SPH_DRIFT_PREDICTOR", "0")
    make, s0, window, n_iv = _engines(case)
    interval = np.float32(window)
    ref, eng = make(), make()
    ref.chunk_buffers = False
    assert eng.chunk_buffers
    s_ref = s_eng = eng.init(s0)[:3]
    fcc.reset_launch_counts()
    syncs = 0
    for _ in range(n_iv):
        if case == "split":
            want, got = _split(ref, s_ref, interval), _split(eng, s_eng,
                                                             interval)
        else:
            want = ref.run_interval(*s_ref, interval)
            got = eng.run_interval(*s_eng, interval)
            syncs += got.n_syncs
        _same(want, got)
        s_ref = (want.state, want.cands, want.geom)
        s_eng = (got.state, got.cands, got.geom)
    built = fcc.CHUNK_BUFFERS["sets_built"]
    keys = list(eng._chunks._bufs)
    assert built == len(keys) == 1
    assert fcc.CHUNK_BUFFERS["runs"] > 0
    if case == "rollback":
        assert got.n_rollbacks > 0
    if case == "two_intervals":
        # one run per sub-chunk, each read by the interval's one sync
        assert fcc.CHUNK_BUFFERS["runs"] == syncs
    halo, plain = keys[0][:2]
    if case == "slab":
        # the extended slab: rows_loc + 2 ghost rows, padded to its plan
        nyp_e = fc.plan(eng.slab_spec)[3]
        assert plain[0] == nyp_e > fc.plan(eng.spec)[3]
        assert halo == (nyp_e + 2, eng.spec.K, eng.spec.nx + 2)
    else:
        assert plain == (fc.plan(eng.spec)[3], eng.spec.K, eng.spec.nx)
    assert not any(fcc.LAUNCHES.values())     # the CPU launches no kernel
