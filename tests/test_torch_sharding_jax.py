"""The port's two-slab fused engine against the JAX package, from the same
numpy state: the port's ``ShardedPallasEngine`` (plain twins on CPU slabs)
  against the JAX package's single-device ``PallasCellEngine`` (Pallas
  kernels in interpret mode) over a window of four steps on the jittered
  tiny box of tests/test_pallas.py:22-39 with a skin and rebuild_every 8
  (row groups of one row, forced as tests/test_torch_fused.py's
  ``tiny_case`` forces two, so the interpreted kernels trace in a third
  of the time; seven plan rows padded to eight, slabs of four). Tolerance: tests/test_torch_fused.py's for
  its chunk, 2e-4 of each field's scale (``p``: times p0) and the pair
  count within one pair. The JAX package's own sharded fused engine is
  not run here: it is the slow part of tests/test_parallel.py.
  tests/test_torch_sharding.py holds the per-step sharded engines against
  the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sph_poiseuille_flow_tpu.models.poiseuille import build_scene
from sph_poiseuille_flow_tpu.stepper import PallasCellEngine as JPallas
from sph_poiseuille_flow_tpu.stepper import initial_state as jinitial_state
from sph_poiseuille_flow_torch import interop
from sph_poiseuille_flow_torch.config import SPHConfig
from sph_poiseuille_flow_torch.parallel import ShardedPallasEngine, make_mesh
from sph_poiseuille_flow_torch.stepper import State, initial_state

from test_config import default_cfg
from test_torch_engine import jittered

torch.set_num_threads(1)

TOL_CHUNK = 2e-4


@pytest.fixture(scope="module")
def fused_runs():
    cfg = default_cfg(DL=1.0, DH=0.5, dp=0.05, end_time=0.5,
                      output_interval=0.25, engine="pallas",
                      neighbor_skin=0.75 * 0.05, rebuild_every=8,
                      cell_capacity=18, plan_r=1)
    scene = build_scene(cfg)
    arrays = jittered(cfg, scene)
    jeng = JPallas(cfg, scene)
    js, jl, jg, _ = jeng.init(jinitial_state(cfg, scene)._replace(
        **{k: jnp.asarray(v) for k, v in arrays.items()}))
    jr = jeng.run_interval(js, jl, jg, np.float32(0.004))
    pcfg = SPHConfig(**dataclasses.asdict(cfg))
    teng = ShardedPallasEngine(pcfg, scene, make_mesh(2, device="cpu"))
    ts, tl, tg, tov = teng.init(interop.state_from_numpy(
        arrays, base=initial_state(pcfg, scene, "cpu")))
    assert not bool(tov)
    tr = teng.run_interval(ts, tl, tg, np.float32(0.004))
    return cfg, teng, jr, tr


def test_two_slab_fused_runs_the_slab_path(fused_runs):
    _, teng, jr, tr = fused_runs
    assert teng.n_dev == 2 and teng.ghost == 4 and not teng._gather_mode
    assert teng.rows_loc == 4 and teng.nyp_pad == teng._nyp + 1 == 8
    assert tr.n_steps == int(jr.n_steps) == 4
    assert abs(int(tr.n_pairs) - int(jr.n_pairs)) <= 1
    assert not bool(tr.overflow) and not tr.skin_guard


@pytest.mark.parametrize("name", State._fields)
def test_two_slab_fused_matches_jax_single(fused_runs, name):
    cfg, _, jr, tr = fused_runs
    got = getattr(tr.state, name).numpy().astype(np.float64)
    ref = np.asarray(getattr(jr.state, name), np.float64)
    bound = TOL_CHUNK * (cfg.p0 if name == "p"
                         else max(1.0, np.max(np.abs(ref))))
    err = np.max(np.abs(got - ref))
    assert err <= bound, f"{name}: max abs error {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("wall", ["tau_bottom", "tau_top"])
def test_two_slab_fused_wall_shear_matches_jax(fused_runs, wall):
    _, _, jr, tr = fused_runs
    assert float(getattr(tr, wall)) == pytest.approx(
        float(getattr(jr, wall)), rel=1e-3, abs=1e-6)
