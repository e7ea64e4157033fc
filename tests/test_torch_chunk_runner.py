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

With the chunk buffers the rebuilds between groups run on persistent
layout sets (``fused_cell.RebuildRunner``, ``BufferedRebuild``), which
the plain twin (``_do_rebuild``) fills on the CPU. Their cases hold the
returned layout too, bit for bit, count the groups
(``REBUILD_BUFFERS``), hold that nothing returned aliases a set, and
that the card's wrapper refuses what it cannot serve.
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


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_layout(want, got):
    """Every tensor of two ``FusedLayout``s equal bit for bit."""
    for name, a in want._asdict().items():
        if torch.is_tensor(a):
            b = getattr(got, name)
            assert b.dtype == a.dtype and b.shape == a.shape, name
            assert torch.equal(_bits(a), _bits(b)), name


def _counted(eng):
    """Count ``eng``'s ``_do_rebuild`` calls (one a group)."""
    calls, plain = [0], eng._do_rebuild

    def counted(*a):
        calls[0] += 1
        return plain(*a)

    eng._do_rebuild = counted
    return calls


def _set_storage(eng):
    """The data pointers of the engine's layout sets' allocations."""
    return {b.mem.untyped_storage().data_ptr()
            for b in eng._rebuilds._bufs.values()}


def _tensors(r):
    out = dict(r.state._asdict(), geom=r.geom, overflow=r.overflow)
    out.update({f"cands.{k}": v for k, v in r.cands._asdict().items()
                if torch.is_tensor(v) and k != "shear_tbt"})
    return out


@pytest.mark.parametrize("case", ["plain", "rollback", "split",
                                  "two_intervals", "no_alias", "counter"])
def test_layout_sets_match_stateless(case, monkeypatch):
    """The engine's rebuilds on persistent layout sets against the
    stateless path (``chunk_buffers`` off: ``_do_rebuild`` and the torch
    pair count and overflow): the whole ``IntervalResult``, its layout
    included, bit for bit, one rebuild a group. ``no_alias``: what an
    interval returned (state, layout, pair count) is the caller's, left
    as it was by two later intervals, and no layout returned lies in a
    set; ``counter``: one key's sets serve every interval and a lane
    switch (another g, mu on the same engine), one run a group."""
    monkeypatch.setenv("SPH_SUB_STEPS", "4")
    if case == "rollback":
        monkeypatch.setenv("SPH_DRIFT_PREDICTOR", "0")
    make, s0, window, _ = _engines("rollback" if case == "rollback"
                                   else "plain")
    n_iv = {"two_intervals": 2, "no_alias": 3, "counter": 3}.get(case, 1)
    interval = np.float32(window)
    ref, eng = make(), make()
    ref.chunk_buffers = False
    groups = _counted(ref)
    s_ref = s_eng = eng.init(s0)[:3]
    fcc.reset_launch_counts()
    results = []
    for i in range(n_iv):
        kw = {}
        if case == "counter" and i == 2:
            kw = dict(g=2.0 * eng.cfg.gravity_g, mu=0.5 * eng.cfg.mu)
        if case == "split":
            want, got = _split(ref, s_ref, interval), _split(eng, s_eng,
                                                             interval)
        else:
            want = ref.run_interval(*s_ref, interval, **kw)
            got = eng.run_interval(*s_eng, interval, **kw)
        _same(want, got)
        _same_layout(want.cands, got.cands)
        assert got.geom.dtype == want.geom.dtype == torch.int32
        results.append((got, {k: v.clone() for k, v in
                              _tensors(got).items()}))
        s_ref = (want.state, want.cands, want.geom)
        s_eng = (got.state, got.cands, got.geom)
    rb = fcc.REBUILD_BUFFERS
    assert rb["sets_built"] == len(eng._rebuilds._bufs) == 1
    assert rb["runs"] == groups[0] > 0
    if case == "rollback":
        assert got.n_rollbacks > 0
    sets = _set_storage(eng)
    for got, snap in results:
        assert got.cands.pidx.untyped_storage().data_ptr() not in sets
        for k, v in _tensors(got).items():
            assert torch.equal(_bits(v), _bits(snap[k])), k
    assert not any(fcc.LAUNCHES.values())     # the CPU launches no kernel


@pytest.mark.parametrize("what", ["device", "dtype", "shape", "card"])
def test_rebuild_wrapper_refuses(what):
    """The rebuild's wrapper (``RebuildBuffers.launch``) checks device,
    dtype and shape of what it reads and runs on a CUDA card only: each
    wrong input raises, and so do right inputs on the CPU, whose layout
    sets the plain twin fills. Nothing falls back."""
    cfg = _cfg()
    scene = build_scene(cfg)
    eng = PallasCellEngine(cfg, scene, "cpu")
    s, lay, _, _ = eng.init(initial_state(cfg, scene, "cpu"))
    cores = eng._scatter_all(lay, s)
    bufs = fcc.RebuildBuffers(eng.spec, fc.plan(eng.spec)[0],
                              cores["xH"].shape, cores["drP"].shape,
                              torch.float32, torch.device("cpu"))
    args = dict(pidx0=lay.pidx, hidx0=lay.hidx, xs=cores["xH"],
                ys=cores["yH"], drs=cores["drP"], vxs=cores["vxH"],
                vys=cores["vyH"], cnt=None, stat=eng._layout_statics(),
                src_halo=True, first=True)
    match = {"device": "expected a tensor on cpu",
             "dtype": "expected torch.int64",
             "shape": "expected shape",
             "card": "runs on a CUDA card"}[what]
    if what == "device":
        args["vxs"] = torch.empty(cores["vxH"].shape, device="meta")
    elif what == "dtype":
        args["hidx0"] = lay.hidx.to(torch.int32)
    elif what == "shape":
        args["drs"] = cores["xH"]
    with pytest.raises(ValueError, match=match):
        bufs.launch(0, **args)
    assert not any(fcc.LAUNCHES.values())
