"""The developed-state generator: deterministic per seed, the same
particles for every seed, and a state the port's fused layout holds
without overflow at both cells' scales (one rebuild on the CPU)."""

import pytest
import torch

from benchmark import harness, traffic
from benchmark.drivers.developed import port_config
from benchmark.reference.sph import Channel


def _params(cell):
    wl = harness.load_json(harness.find(harness.BENCH_DIR, "workloads", cell))
    conf = harness.load_json(harness.find(harness.BENCH_DIR, "configs",
                                          wl["config"]))
    return conf, wl


def test_same_seed_same_state_other_seed_other_jitter():
    conf, wl = _params("channel-dp0.01.developed")
    ch = Channel.from_physics(conf["physical"])
    a = traffic.developed_state(ch, wl["state"], 2 ** 31 + 7, "cpu")
    b = traffic.developed_state(ch, wl["state"], 2 ** 31 + 7, "cpu")
    c = traffic.developed_state(ch, wl["state"], 2 ** 31 + 8, "cpu")
    for k in ("x", "y", "vx", "vy", "rho", "drho_dt", "mass"):
        assert torch.equal(a[k], b[k]), k
    nf = a["n_fluid"]
    assert nf == c["n_fluid"] == 30000
    assert not torch.equal(a["x"][:nf], c["x"][:nf])
    assert torch.equal(a["x"][nf:], c["x"][nf:])      # walls do not move
    amp = wl["state"]["jitter_dp"] * ch.dp
    lattice = ch.lattice()[0]
    assert float((a["x"][:nf] - lattice[:nf]).abs().max()) <= amp
    assert torch.allclose(a["vx"][:nf], ch.analytic_u(a["y"][:nf]))


@pytest.mark.parametrize("cell", ["channel-dp0.01.developed",
                                  "channel-dp0.005.developed"])
def test_state_builds_a_layout_without_overflow(cell):
    from sph_poiseuille_flow_torch import build_scene, make_engine
    conf, wl = _params(cell)
    cfg = port_config(conf, wl)
    engine = make_engine(cfg, build_scene(cfg), "cpu")
    ch = Channel.from_physics(conf["physical"])
    for seed in (1, 2 ** 31 + 3):
        inp = traffic.developed_state(ch, wl["state"], seed, "cpu")
        lay = engine._rebuild(inp["x"].float(), inp["y"].float())
        assert not bool(lay.overflow)
        assert int(lay.occ.max()) <= cfg.cell_capacity
