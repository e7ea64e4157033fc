"""The fused engine's interval path on persistent buffers, on the CPU,
where the runners fill their sets from the plain twins.

* ``test_buffered_chunks_match_stateless``: scripted calls of a sub-chunk
  group's runner (``fused_cell.ChunkRunner.group`` ->
  ``BufferedChunkRun``), each held bit for bit to the stateless
  primitives from the state the call began in: ``fused_chunk_call``
  for the scratch set's cores and (t, t_comp, steps), the drift bounds
  (``pair_drift_bounds``; the mesh's ``_drift_bounds`` on a slab) for
  (bx, by).
* ``test_layout_sets_match_stateless``: the rebuilds on persistent
  layout sets (``fused_cell.RebuildRunner`` -> ``BufferedRebuild``)
  held to ``_do_rebuild`` through the alternation of the two sets, with
  the exact pair count and the interval's overflow flag.
* ``test_interval_path``: whole intervals: split dispatch against one
  call, the counters (``CHUNK_BUFFERS``: one run a host sync;
  ``REBUILD_BUFFERS``: one run a group; one key's sets built once), what
  an interval returned left alone by later ones, forced rollbacks.
* ``test_rebuild_wrapper_refuses``: the card's wrapper refuses what it
  cannot serve.
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

WINDOW = np.float32(0.04)


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


def _engine(rollback=False):
    """(engine, its start: state, layout, pair count, the window). With
    ``rollback`` a small skin, which the tests run with the predictor off,
    so every group runs to a genuine crossing."""
    if rollback:
        cfg = _cfg(neighbor_skin=0.12 * 0.05)
        scene = build_scene(cfg)
        eng = PallasCellEngine(cfg, scene, "cpu")
        return eng, eng.init(_moving(cfg, scene))[:3], np.float32(0.006)
    cfg = _cfg()
    scene = build_scene(cfg)
    eng = PallasCellEngine(cfg, scene, "cpu")
    return eng, eng.init(_moving(cfg, scene))[:3], WINDOW


def _scalars(cfg):
    return (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0, cfg.transport_coeff,
            cfg.gravity_g, cfg.mu, cfg.wall_visc_factor)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _equal(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a), _bits(b)))


def _snap(d):
    return {k: v.clone() for k, v in d.items()}


def _same_cores(want: dict, got: dict):
    for k, v in want.items():
        assert _equal(v, got[k]), k


# ---- the runner against fused_chunk_call and the drift bounds ----


def _want(run, n_sub, t, tc, bounds):
    """What a call of ``run`` must give from its kept state: the
    stateless chunk's cores (``cnt`` per slot summed to its rows, as
    ``fused_chunk_call`` returns it) and (bx, by, t, t_comp, steps)."""
    c = _snap(run.state())
    st, aux, steps, t2, tc2 = fc.fused_chunk_call(
        run.spec, run.lay, c["xH"], c["yH"], c["vxH"], c["vyH"], c["drP"],
        t, tc, run.interval, n_sub, *run.scalars)
    zero = torch.zeros((), dtype=t2.dtype)
    bx, by = (zero, zero) if bounds is None else bounds(st["xP"], st["yP"])
    cores = dict(st, **aux)
    return cores, [float(bx), float(by), float(t2), float(tc2), int(steps)]


def _script(run, calls, bounds, t=np.float32(0.0), tc=np.float32(0.0)):
    """Run ``calls`` ((n_sub, keep) each) on ``run``, each held to
    ``_want`` from the state it began in; a call not kept (a rollback)
    must leave the kept state whole. Returns the clock reached and each
    call's (bx, by)."""
    got_bounds = []
    for n_sub, keep in calls:
        want, vals = _want(run, n_sub, t, tc, bounds)
        kept = _snap(run.state())
        *got, steps, syncs = run(n_sub, t, tc)
        assert [float(v) for v in got] + [steps] == vals
        assert syncs == 1 and steps > 0
        new = dict(run.new, cnt=fc._cnt_rows(run.spec, run.new["cnt"]))
        _same_cores(want, new)
        assert run.new["cnt"].shape == run.new["drP"].shape   # per slot
        got_bounds.append(got[:2])
        if keep:
            run.keep()
            assert run.state() is run.new
            t, tc = np.float32(got[2]), np.float32(got[3])
        else:
            _same_cores(kept, run.state())
    return t, tc, got_bounds


def _rebuilt_group(eng, lay, cores, run):
    """Rebuild from ``run``'s kept state onto a layout set: (the set's
    layout, the next group's carry, the set's key)."""
    sets = eng._rebuilds.interval(eng.spec, cores, eng._layout_statics(),
                                  eng._shear, eng._do_rebuild)
    st = run.state()
    new_lay, carry, key = sets(lay, st, True)
    return new_lay, dict(carry, **{k: st[k] for k in fc._AUX}), key


@pytest.mark.parametrize("case", ["plain", "rollback", "no_drift", "slab",
                                  "lay_key"])
def test_buffered_chunks_match_stateless(case):
    """``plain``: a chain of kept calls; ``rollback``: a call not kept,
    then one from the kept state, whose aux cores stay whole; ``no_drift``:
    no drift references, bounds 0; ``slab``: a one-slab mesh with ghost
    rows, the chunk on its extended slab (its own key), the bounds held
    to the mesh's ``_drift_bounds`` over the interior rows and the carry's
    pair count back through ``_carry_slab``; ``lay_key``: a second group
    bound to a rebuilt layout set through its key, on the same buffers."""
    fcc.reset_launch_counts()
    if case == "slab":
        cfg = _cfg(DH=2.0)
        scene = build_scene(cfg)
        eng = ShardedPallasEngine(cfg, scene, make_mesh(1, device="cpu"),
                                  ghost=4)
        s, lay, _ = eng.init(initial_state(cfg, scene, "cpu"))[:3]
        sts, _, statics, refx, refy = eng._entry(s, lay)
        stat_h = eng._stat_h({k: [x[k] for x in statics]
                              for k in ("isf", "mass", "wvx", "wvy")})
        occl = [eng._occl(x)
                for x in eng._ext([x["x"] for x in sts], fc._BIG_X)]
        isf = [x["isf"] for x in statics]
        drift = fc.DriftRef(refx[0].contiguous(), refy[0].contiguous(),
                            isf[0].contiguous(), False, eng.ghost)
        run = eng._chunk_run(sts[0], stat_h[0], occl[0], np.float32(0.02),
                             _scalars(cfg), drift)
        assert torch.equal(eng._carry_slab(run.state())["cnt"],
                           sts[0]["cnt"])

        def bounds(x, y):
            return eng._drift_bounds([dict(x=eng._ip(x), y=eng._ip(y))],
                                     refx, refy, isf)

        _script(run, [(4, True), (3, False), (2, True)], bounds)
        nyp_e = fc.plan(eng.slab_spec)[3]
        assert run.state()["drP"].shape[0] == nyp_e > fc.plan(eng.spec)[3]
        slab = eng._carry_slab(run.state())
        assert torch.equal(slab["cnt"], eng._ip(fc._cnt_rows(
            eng.slab_spec, run.state()["cnt"]).reshape(-1, eng.spec.nx)))
    else:
        eng, (s, lay, _), window = _engine()
        spec = eng.spec
        cores = eng._scatter_all(lay, s)
        drift = (None if case == "no_drift"
                 else fc.DriftRef(lay.refx_p, lay.refy_p, lay.isf_c))
        run = eng._chunks.group(spec, lay, cores, window,
                                _scalars(eng.cfg), drift)
        assert run.state() is cores
        bounds = (None if case == "no_drift" else
                  lambda x, y: fc.pair_drift_bounds(spec, lay, x, y))
        calls = {"plain": [(4, True), (4, True), (3, True), (1, True)],
                 "rollback": [(4, True), (4, False), (2, True)],
                 "no_drift": [(4, True), (2, True)],
                 "lay_key": [(4, True)]}[case]
        t, tc, got = _script(run, calls, bounds)
        if case == "no_drift":
            assert all(b == [0.0, 0.0] for b in got)
        else:
            assert any(b[0] > 0.0 or b[1] > 0.0 for b in got)
        if case == "lay_key":
            lay2, carry, key = _rebuilt_group(eng, lay, cores, run)
            for _ in range(2):
                run2 = eng._chunks.group(
                    spec, lay2, carry, window, _scalars(eng.cfg),
                    fc.DriftRef(lay2.refx_p, lay2.refy_p, lay2.isf_c),
                    lay_key=key)
                _script(run2, [(3, True), (2, False), (1, True)],
                        lambda x, y: fc.pair_drift_bounds(spec, lay2, x, y),
                        t, tc)
    assert fcc.CHUNK_BUFFERS["sets_built"] == len(eng._chunks._bufs) == 1
    assert not any(fcc.LAUNCHES.values())     # the CPU launches no kernel


# ---- the rebuild on layout sets against _do_rebuild ----


def _crowd(st, lay, n, kept: bool, spec):
    """``st`` with particles 0 .. n-1 moved to the centre of a cell in the
    middle of the channel: in the plain position cores of a kept state,
    else in the carry's halo'd ones."""
    x, y = ("xP", "yP") if kept else ("xH", "yH")
    idx = (lay.pidx if kept else lay.hidx)[:n]
    out = dict(st, **{x: st[x].clone(), y: st[y].clone()})
    out[x].view(-1)[idx] = (spec.nx // 2 + 0.5) * spec.cell_x
    out[y].view(-1)[idx] = spec.y0 + (spec.ny // 2 + 0.5) * spec.cell_y
    return out


def _rebuild_step(eng, sets, lay, st, kept: bool, overflow_before: bool):
    """One ``BufferedRebuild`` call held to ``_do_rebuild``: the layout
    and carry bit for bit, twice the kept pair count exactly, the overflow
    OR'd since the interval's first call. Returns (layout, carry, set)."""
    ref_st = st if kept else dict(st, xP=st["xH"][1:-1, :, 1:-1],
                                  yP=st["yH"][1:-1, :, 1:-1])
    ref_lay, ref_carry = eng._do_rebuild(lay, ref_st)
    want2 = 2.0 * float(torch.sum(st["cnt"])) if kept else 0.0
    got_lay, got_carry, (bufs, i) = sets(lay, st, kept)
    assert got_lay is sets.layouts[i] and got_carry is sets.carries[i]
    for name, a in ref_lay._asdict().items():
        if torch.is_tensor(a) and name != "shear_tbt":
            assert _equal(a, getattr(got_lay, name)), name
    _same_cores(ref_carry, got_carry)
    assert int(bufs.pairs2) == want2
    assert bool(bufs.overflow_any) == (overflow_before
                                       or bool(ref_lay.overflow))
    return got_lay, got_carry, i


@pytest.mark.parametrize("case", ["plain", "rollback", "overflow"])
def test_layout_sets_match_stateless(case):
    """``plain``: a rebuild from a kept state, then one from the set's
    layout and its carry (nothing kept: no pairs), then one more: the
    sets take turns and a call leaves the other set's layout whole;
    ``rollback``: a group that ends on a call not kept rebuilds from the
    last kept call's state; ``overflow``: a cell crowded past K sets the
    flag, a later clean rebuild keeps it, and the next interval's first
    rebuild starts it afresh on the same sets."""
    fcc.reset_launch_counts()
    eng, (s, lay, _), window = _engine()
    spec = eng.spec
    cores = eng._scatter_all(lay, s)
    run = eng._chunks.group(spec, lay, cores, window, _scalars(eng.cfg),
                            fc.DriftRef(lay.refx_p, lay.refy_p, lay.isf_c))
    run(4, np.float32(0.0), np.float32(0.0))
    run.keep()
    if case == "rollback":
        kept = _snap(run.state())
        run(4, np.float32(0.0), np.float32(0.0))
        _same_cores(kept, run.state())

    def interval():
        return eng._rebuilds.interval(spec, cores, eng._layout_statics(),
                                      eng._shear, eng._do_rebuild)

    sets = interval()
    if case == "overflow":
        st = _crowd(run.state(), lay, spec.K + 2, True, spec)
        lay1, carry1, i1 = _rebuild_step(eng, sets, lay, st, True, False)
        assert bool(sets.bufs.overflow_any)
        # a clean rebuild from the crowded layout keeps the interval's flag
        aux = {k: cores[k] for k in fc._AUX}
        _rebuild_step(eng, sets, lay1, dict(carry1, **aux), False, True)
        sets2 = interval()
        assert sets2.bufs is sets.bufs and sets2.first
        _rebuild_step(eng, sets2, lay, run.state(), True, False)
        assert not bool(sets2.bufs.overflow_any)
        npairs, ovf = sets2.totals(torch.zeros((), dtype=torch.bool))
        assert not bool(ovf)
        assert int(npairs) == int(torch.round(torch.sum(run.state()["cnt"])))
    else:
        lay1, carry1, i1 = _rebuild_step(eng, sets, lay, run.state(), True,
                                         False)
        snap1 = {k: v.clone() for k, v in lay1._asdict().items()
                 if torch.is_tensor(v) and k != "shear_tbt"}
        aux = {k: run.state()[k] for k in fc._AUX}
        lay2, carry2, i2 = _rebuild_step(eng, sets, lay1,
                                         dict(carry1, **aux), False, False)
        assert i2 != i1
        for k, v in snap1.items():
            assert _equal(v, getattr(lay1, k)), k
        _, _, i3 = _rebuild_step(eng, sets, lay2, dict(carry2, **aux),
                                 False, False)
        assert i3 == i1
        npairs, _ = sets.totals(torch.zeros((), dtype=torch.bool))
        assert int(npairs) == 0         # the last rebuild kept no call
    assert fcc.REBUILD_BUFFERS["sets_built"] == len(eng._rebuilds._bufs) == 1
    assert not any(fcc.LAUNCHES.values())


# ---- whole intervals ----


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
    for name, a in r1.cands._asdict().items():
        if torch.is_tensor(a) and name != "shear_tbt":
            assert _equal(a, getattr(r2.cands, name)), name


def _split(eng, start, interval):
    """The interval in calls bounded at one step (the benchmark's
    ``check.rerun``): the last call's result, with the calls' steps,
    rollbacks and host syncs summed."""
    s, lay, geom = start
    t_loc = t_cmp = np.float32(0.0)
    sub_len, calls, steps, rolls, syncs = None, 0, 0, 0, 0
    while True:
        kw = {} if sub_len is None else {"sub_len0": sub_len}
        r = eng.run_interval(s, lay, geom, interval, max_steps=1,
                             t_local0=t_loc, t_comp0=t_cmp, **kw)
        calls += 1
        steps += r.n_steps
        rolls += r.n_rollbacks
        syncs += r.n_syncs
        s, lay, geom = r.state, r.cands, r.geom
        t_loc, t_cmp, sub_len = r.t_local, r.t_comp, r.sub_len
        if t_loc >= interval or r.n_steps == 0:
            assert calls >= 3
            return r._replace(n_steps=steps, n_rollbacks=rolls,
                              n_syncs=syncs)


def _count_groups(eng):
    """Count ``eng``'s sub-chunk groups and its plain rebuilds (the CPU's
    fill of a layout set), each in a one-element list."""
    groups, plains = [0], [0]
    group, plain = eng._run_group, eng._do_rebuild

    def counted_group(*a):
        groups[0] += 1
        return group(*a)

    def counted_plain(*a):
        plains[0] += 1
        return plain(*a)

    eng._run_group, eng._do_rebuild = counted_group, counted_plain
    return groups, plains


def _tensors(r):
    out = dict(r.state._asdict(), geom=r.geom, overflow=r.overflow)
    out.update({f"cands.{k}": v for k, v in r.cands._asdict().items()
                if torch.is_tensor(v) and k != "shear_tbt"})
    return out


@pytest.mark.parametrize("case", ["split", "two_intervals", "no_alias",
                                  "counter", "rollback"])
def test_interval_path(case, monkeypatch):
    """``split``: the interval in one-group calls equals one call, bit for
    bit; ``two_intervals``: one key's chunk buffers and layout sets serve
    both, one chunk run a host sync; ``no_alias``: what an interval
    returned (state, layout, pair count) is the caller's, left as it was
    by two later intervals, and no layout returned lies in a set;
    ``counter``: a lane switch (another g, mu on the same engine) builds
    nothing new, one rebuild run a group; ``rollback``: the predictor off
    and a small skin roll sub-chunks back with no flag."""
    # groups of 16 steps in sub-chunks of at most 4: kept sets swap
    # within a group
    monkeypatch.setenv("SPH_SUB_STEPS", "4")
    if case == "rollback":
        monkeypatch.setenv("SPH_DRIFT_PREDICTOR", "0")
    eng, start, window = _engine(rollback=case == "rollback")
    fcc.reset_launch_counts()
    groups, plains = _count_groups(eng)
    if case == "split":
        once = eng.run_interval(*start, window)
        split = _split(eng, start, window)
        _same(once, split)
        results = [once, split]
    else:
        n_iv = {"two_intervals": 2, "no_alias": 3, "counter": 3}.get(case, 1)
        results, snaps, s = [], [], start
        for i in range(n_iv):
            kw = {}
            if case == "counter" and i == 2:
                kw = dict(g=2.0 * eng.cfg.gravity_g, mu=0.5 * eng.cfg.mu)
            r = eng.run_interval(*s, window, **kw)
            assert r.n_steps > 0 and r.geom.dtype == torch.int32
            results.append(r)
            snaps.append(_snap(_tensors(r)))
            s = (r.state, r.cands, r.geom)
        sets = {b.mem.untyped_storage().data_ptr()
                for b in eng._rebuilds._bufs.values()}
        for r, snap in zip(results, snaps):
            assert r.cands.pidx.untyped_storage().data_ptr() not in sets
            _same_cores(snap, _tensors(r))
    assert fcc.REBUILD_BUFFERS["runs"] == groups[0] == plains[0] > 0
    # one chunk run a host sync of the interval loop
    assert fcc.CHUNK_BUFFERS["runs"] == sum(r.n_syncs for r in results)
    assert fcc.CHUNK_BUFFERS["sets_built"] == len(eng._chunks._bufs) == 1
    assert fcc.REBUILD_BUFFERS["sets_built"] == len(eng._rebuilds._bufs) == 1
    if case == "rollback":
        assert results[0].n_rollbacks > 0 and not results[0].skin_guard
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
