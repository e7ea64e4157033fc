"""The port's multi-device decomposition (``parallel/sharding.py``,
``parallel/virtual.py``) on in-process CPU slabs, held to the port's own
single-device engines (plain twins on the CPU):

* ``ShardedPallasEngine``'s slab-local chunk loop against the
  single-device ``PallasCellEngine`` bit for bit on the tall channel of
  tests/test_parallel.py:268 (DH=2, dp=0.05, K=18, rebuild_every 8) over
  0.02 s: steps, pairs, rollbacks, every ``State`` field and tau, at one
  device (ghost 0 and 4), two and four (bands from the neighbor slabs)
  and eight (slabs of two rows, bands from a gather of every slab), as
  tests/test_parallel.py:287-336 holds the JAX package's;
* the rollback with the predictor off (SPH_DRIFT_PREDICTOR=0, as
  tests/test_parallel.py:338): from rest its 0.02 s window trips no drift
  budget, so the state starts with the channel's profile and a seeded
  transverse noise, which makes the sub-chunks of a 0.006 s window roll
  back and particles change cells and slabs at the re-bins;
* the step-log path (``step_log_every > 0``) on two slabs, rows included;
* a slab's cache kernels take the whole domain's lanes per anchor;
* ``ShardedEngine`` and ``ShardedCellEngine`` against ``Engine`` and
  ``CellEngine`` (with the same padded grid) over 0.05 s of
  tests/test_parallel.py:22's channel, bit for bit in the state;
* the uneven row split refused, ``ensure_devices`` and ``make_mesh``;
* ``ShardedEngine`` and ``ShardedCellEngine`` against the JAX package's
  (the last test).

tests/test_torch_sharding_jax.py holds the two-slab fused engine against
the JAX package."""

import dataclasses

import numpy as np
import pytest
import torch

from sph_poiseuille_flow_tpu.models.poiseuille import (
    build_scene as jbuild_scene)
from sph_poiseuille_flow_tpu.parallel import ShardedCellEngine as JSCell
from sph_poiseuille_flow_tpu.parallel import ShardedEngine as JSGather
from sph_poiseuille_flow_tpu.parallel import make_mesh as jmake_mesh
from sph_poiseuille_flow_tpu.stepper import initial_state as jinitial_state
from sph_poiseuille_flow_torch.config import SPHConfig
from sph_poiseuille_flow_torch.models.poiseuille import build_scene
from sph_poiseuille_flow_torch.ops import fused_cell as fc
from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
from sph_poiseuille_flow_torch.parallel import (
    AXIS, ShardedCellEngine, ShardedEngine, ShardedPallasEngine,
    ensure_devices, make_mesh)
from sph_poiseuille_flow_torch.stepper import (CellEngine, Engine,
                                               PallasCellEngine, State,
                                               initial_state)

from test_config import default_cfg

torch.set_num_threads(1)


def tall_cfg(**kw):
    """tests/test_parallel.py's ``_tall_pallas_cfg``: ~16 cell rows, so 2
    and 4 slabs keep rows_loc >= the 4-row ghost depth while 8 slabs take
    their bands from a gather."""
    base = dict(DL=1.0, DH=2.0, dp=0.05, end_time=0.2, output_interval=0.1,
                engine="pallas", neighbor_skin=0.75 * 0.05, rebuild_every=8,
                cell_capacity=18)
    base.update(kw)
    return SPHConfig(**dataclasses.asdict(default_cfg(**base)))


def quick_cfg(**kw):
    """tests/test_parallel.py's ``_quick_cfg`` (200 fluid particles)."""
    return SPHConfig(**dataclasses.asdict(default_cfg(
        DL=1.0, DH=0.5, dp=0.05, end_time=0.2, output_interval=0.1, **kw)))


def cpu_mesh(n):
    return make_mesh(n, device="cpu")


def assert_same_interval(r1, r2, tau_rel=0.0):
    """Steps, pairs, rollbacks and every state field equal; tau equal, or
    within ``tau_rel`` where its sum over pairs adds in another order."""
    assert r2.n_steps == r1.n_steps > 0
    assert int(r2.n_pairs) == int(r1.n_pairs) > 0
    assert r2.n_rollbacks == r1.n_rollbacks
    for name in State._fields:
        assert torch.equal(getattr(r2.state, name),
                           getattr(r1.state, name)), name
    for wall in ("tau_bottom", "tau_top"):
        assert float(getattr(r2, wall)) == pytest.approx(
            float(getattr(r1, wall)), rel=tau_rel, abs=0.0), wall
    assert not bool(r2.overflow) and not r2.skin_guard


def run(engine, s0, interval):
    s, lay, geom, ovf = engine.init(s0)
    assert not bool(ovf)
    return engine.run_interval(s, lay, geom, np.float32(interval))


@pytest.fixture(scope="module")
def tall():
    cfg = tall_cfg()
    scene = build_scene(cfg)
    s0 = initial_state(cfg, scene, "cpu")
    return cfg, scene, s0, run(PallasCellEngine(cfg, scene, "cpu"), s0, 0.02)


@pytest.mark.parametrize("n_dev,ghost", [(1, None), (1, 4), (2, None),
                                         (4, None), (8, None)])
def test_sharded_fused_matches_single_fused(tall, n_dev, ghost):
    """(1, None) resolves to ghost 0: the single-device interval loop on a
    one-device mesh. (1, 4) runs the chunk on the extended slab; 2 and 4
    slabs the step kernel on each extended slab; 8 slabs of two rows take
    their bands from a gather. The window spans three sub-chunk groups,
    so two slab-local re-bins are on the compared path."""
    cfg, scene, s0, r1 = tall
    eng = ShardedPallasEngine(cfg, scene, cpu_mesh(n_dev), ghost=ghost)
    assert eng.ghost == (ghost if ghost is not None
                         else (4 if n_dev > 1 else 0))
    assert eng._gather_mode == (n_dev == 8)
    assert eng.rows_loc * n_dev == eng.nyp_pad >= eng._nyp
    assert_same_interval(r1, run(eng, s0, 0.02))


def _rollback_start():
    """A small skin and a moving state (the channel's profile and a
    seeded transverse noise): with the predictor off, sub-chunks roll
    back."""
    cfg = tall_cfg(neighbor_skin=0.12 * 0.05, rebuild_every=16)
    scene = build_scene(cfg)
    nf = scene.n_fluid
    rng = np.random.default_rng(3)
    y = np.asarray(scene.y[:nf], np.float64)
    vx = np.zeros(scene.n_total, np.float32)
    vy = np.zeros(scene.n_total, np.float32)
    vx[:nf] = 6.0 * cfg.U_bulk * y * (cfg.DH - y) / cfg.DH ** 2
    vy[:nf] = rng.normal(0, 2.0, nf)
    s0 = initial_state(cfg, scene, "cpu")._replace(
        vx=torch.tensor(vx), vy=torch.tensor(vy))
    return cfg, scene, s0


def test_sharded_fused_rollback_matches_single(monkeypatch):
    """Rollback with backoff under the slab decomposition: the predictor
    off, a small skin, a moving state; the same rollbacks and the same
    trajectory as one device."""
    monkeypatch.setenv("SPH_DRIFT_PREDICTOR", "0")
    cfg, scene, s0 = _rollback_start()
    r1 = run(PallasCellEngine(cfg, scene, "cpu"), s0, 0.006)
    r2 = run(ShardedPallasEngine(cfg, scene, cpu_mesh(2)), s0, 0.006)
    assert r1.n_rollbacks > 0
    assert r2.skin_guard == r1.skin_guard
    assert_same_interval(r1, r2)


def test_one_slab_rollback_matches_single(monkeypatch):
    """The chunk on one extended slab (one device, ghost 4) under the
    same forced rollbacks: a group whose first sub-chunk rolls back keeps
    nothing and re-bins from its carry, and the trajectory is one
    device's; the slab loop takes one host sync more, its jump flag."""
    monkeypatch.setenv("SPH_DRIFT_PREDICTOR", "0")
    cfg, scene, s0 = _rollback_start()
    r1 = run(PallasCellEngine(cfg, scene, "cpu"), s0, 0.006)
    r2 = run(ShardedPallasEngine(cfg, scene, cpu_mesh(1), ghost=4), s0,
             0.006)
    assert r1.n_rollbacks > 0
    assert r2.n_syncs == r1.n_syncs + 1
    assert_same_interval(r1, r2)


def test_sharded_fused_step_log_matches_single():
    """The per-step path (init and every step through the slabs) against
    the single-device per-step path: state and log rows bit-equal."""
    cfg = tall_cfg(step_log_every=5)
    scene = build_scene(cfg)
    s0 = initial_state(cfg, scene, "cpu")
    r1 = run(PallasCellEngine(cfg, scene, "cpu"), s0, 0.02)
    r2 = run(ShardedPallasEngine(cfg, scene, cpu_mesh(2)), s0, 0.02)
    assert_same_interval(r1, r2)
    assert r2.step_log_n == r1.step_log_n > 0
    np.testing.assert_array_equal(r2.step_log, r1.step_log)


def test_slab_cache_kernels_take_the_whole_domain_lanes(monkeypatch):
    """The cache form's per-anchor sums add in an order set by its lanes
    per anchor (``fused_cell_cuda.cache_groups``, picked from the anchor
    slots). A slab of the validated dp=0.01 channel would pick other lanes
    than the whole domain; it takes the whole domain's (the engine hands
    ``cache_slots`` to every step kernel call), so ``--mesh N`` under
    "auto" gives one device's bits on the card as well (chip_smoke.py
    phase 7 (ii))."""
    cfg = SPHConfig(**dataclasses.asdict(default_cfg(
        DL=3.0, DH=1.0, dp=0.01, end_time=0.3, output_interval=0.1,
        neighbor_skin=0.3 * 0.01, rebuild_every=128, cell_capacity=14,
        lane_pack_nx=100)))
    scene = build_scene(cfg)
    for n in (2, 4):
        eng = ShardedPallasEngine(cfg, scene, cpu_mesh(n))
        whole = fcc._shear_const(eng.spec, fc.plan(eng.spec)[0])
        slab = fcc._const(eng.slab_spec, fc.plan(eng.slab_spec)[0], 1.0,
                          0.0, 0.0, 0.0, 0.0, cache_slots=eng.cache_slots)
        assert slab.nyp == eng.rows_loc + 8 < whole.nyp
        assert (slab.cg0, slab.cg) == (whole.cg0, whole.cg)
        assert fcc.cache_groups(slab.nyp * slab.K * slab.nx) != (
            whole.cg0, whole.cg)

    seen = []
    step = fc.fused_step_cores

    def spy(*args, **kw):
        seen.append(kw.get("cache_slots"))
        return step(*args, **kw)

    monkeypatch.setattr(fc, "fused_step_cores", spy)
    cfg = quick_cfg()
    eng = ShardedPallasEngine(cfg, build_scene(cfg), cpu_mesh(2))
    eng.init(initial_state(cfg, eng.scene, "cpu"))
    assert seen == [eng.cache_slots] * 2
    assert eng.cache_slots == fc.plan(eng.spec)[3] * eng.spec.K * eng.spec.nx


@pytest.fixture(scope="module")
def quick():
    cfg = quick_cfg()
    scene = build_scene(cfg)
    return cfg, scene, initial_state(cfg, scene, "cpu")


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_gather_matches_single(quick, n_dev):
    """Each block's rows add the same terms in the same order as the
    whole set's, so the state is bit-equal; the wall shear sums the
    blocks' sums, another order of float32 additions: 1e-6 relative (a
    few ulp; tests/test_parallel.py:178 allows 1e-3 between the JAX
    package's engines)."""
    cfg, scene, s0 = quick
    assert scene.n_fluid % n_dev == 0
    r1 = run(Engine(cfg, scene, "cpu"), s0, 0.05)
    r2 = run(ShardedEngine(cfg, scene, cpu_mesh(n_dev)), s0, 0.05)
    assert_same_interval(r1, r2, tau_rel=1e-6)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_cellgrid_matches_single(quick, n_dev):
    """The y-slab cell engine against ``CellEngine`` on the same padded
    grid (``s_multiple``): the slabs' pair blocks and their one-row bands
    give every slot the single engine's views, so the state is bit-equal;
    tau sums the slabs' sums (1e-6 relative, as the gather engine's)."""
    cfg, scene, s0 = quick
    single = CellEngine(cfg, scene, "cpu", s_multiple=n_dev)
    sharded = ShardedCellEngine(cfg, scene, cpu_mesh(n_dev))
    assert sharded.spec == single.spec
    assert (single.spec.ny * single.spec.nx) % n_dev == 0
    assert_same_interval(run(single, s0, 0.05), run(sharded, s0, 0.05),
                         tau_rel=1e-6)


def test_sharded_rejects_uneven_split(quick):
    cfg, scene, _ = quick
    with pytest.raises(ValueError, match="divide evenly"):
        ShardedEngine(cfg, scene, cpu_mesh(3))   # 200 rows over 3


def test_ensure_devices_cpu(monkeypatch):
    monkeypatch.delenv("SPH_DRYRUN_REAL_DEVICES", raising=False)
    assert ensure_devices(3, "cpu") == [torch.device("cpu")] * 3
    mesh = make_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.virtual and AXIS == "shard"
    assert make_mesh(2, devices=mesh.devices).size == 2
    with pytest.raises(ValueError, match="requested 5 devices"):
        make_mesh(5, devices=mesh.devices)


def test_ensure_devices_asserts_real_cards(monkeypatch):
    """SPH_DRYRUN_REAL_DEVICES asserts N real cards: never a CPU or a
    shared-card mesh in their place (a one-device mesh asserts
    nothing)."""
    monkeypatch.setenv("SPH_DRYRUN_REAL_DEVICES", "1")
    with pytest.raises(RuntimeError, match="SPH_DRYRUN_REAL_DEVICES"):
        ensure_devices(2, "cpu")
    assert ensure_devices(1, "cpu") == [torch.device("cpu")]


def test_cuda_mesh_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ensure_devices(2, "cuda")


@pytest.mark.parametrize("kind", ["gather", "cellgrid"])
def test_sharded_per_step_engines_match_jax(kind):
    """Against the JAX package's ``ShardedEngine`` and
    ``ShardedCellEngine`` on ``make_mesh(8)`` (the eight virtual CPU
    devices tests/conftest.py sets up), tests/test_parallel.py:154-208's
    tolerances: the same steps, vx within 1e-4, positions within 1e-5,
    tau within 1e-3."""
    cfg = default_cfg(DL=1.0, DH=0.5, dp=0.05, end_time=0.2,
                      output_interval=0.1)
    scene = jbuild_scene(cfg)
    jcls, tcls = ((JSGather, ShardedEngine) if kind == "gather"
                  else (JSCell, ShardedCellEngine))
    jeng = jcls(cfg, scene, jmake_mesh(8))
    js, jl, jg, jov = jeng.init(jinitial_state(cfg, scene))
    jr = jeng.run_interval(js, jl, jg, 0.05)
    pcfg = SPHConfig(**dataclasses.asdict(cfg))
    teng = tcls(pcfg, scene, make_mesh(8, device="cpu"))
    assert teng.spec.ny == jeng.spec.ny and teng.spec.nx == jeng.spec.nx
    ts, tl, tg, tov = teng.init(initial_state(pcfg, scene, "cpu"))
    assert not bool(jov) and not bool(tov)
    tr = teng.run_interval(ts, tl, tg, np.float32(0.05))
    assert tr.n_steps == int(jr.n_steps) > 0
    nf = scene.n_fluid
    np.testing.assert_allclose(tr.state.vx[:nf].numpy(),
                               np.asarray(jr.state.vx[:nf]),
                               rtol=1e-4, atol=1e-6)
    for name in ("x", "y"):
        np.testing.assert_allclose(getattr(tr.state, name)[:nf].numpy(),
                                   np.asarray(getattr(jr.state, name)[:nf]),
                                   rtol=1e-5, atol=1e-6)
    for wall in ("tau_bottom", "tau_top"):
        assert float(getattr(tr, wall)) == pytest.approx(
            float(getattr(jr, wall)), rel=1e-3, abs=1e-6)
