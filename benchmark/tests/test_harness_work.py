"""The roofline's count: from the particle state alone, the same under
two grid layouts of the port, and its pairs equal a brute-force count."""

import numpy as np
import torch

from benchmark import harness, traffic, work
from benchmark.drivers.developed import port_config
from benchmark.reference.sph import Channel


def _tiny(tiny_bench):
    bench, _ = tiny_bench
    wl = harness.load_json(harness.find(bench, "workloads", "tiny.developed"))
    conf = harness.load_json(harness.find(bench, "configs", "tiny"))
    return conf, wl


def _brute(x, y, nf, DL, h):
    ff = fw = 0
    for a in range(nf):
        for b in range(x.size):
            if b == a or (b < nf and b < a):
                continue
            dx = x[a] - x[b]
            dx -= DL * np.round(dx / DL)
            r2 = dx * dx + (y[a] - y[b]) ** 2
            if 1e-24 < r2 < (2 * h) ** 2:
                ff += b < nf
                fw += b >= nf
    return ff, fw


def test_pairs_match_brute_force(tiny_bench):
    conf, wl = _tiny(tiny_bench)
    ch = Channel.from_physics(conf["physical"])
    inp = traffic.developed_state(ch, wl["state"], 11, "cpu")
    x, y = inp["x"].float(), inp["y"].float()
    got = work.pairs_within(x, y, inp["n_fluid"], ch.DL, ch.h)
    assert got == _brute(x.double().numpy(), y.double().numpy(),
                         inp["n_fluid"], ch.DL, ch.h)


def test_same_state_same_work_under_two_layouts(tiny_bench):
    """The port's grid under K = 14, 4 lane-packed columns and under
    K = 20 with the auto column pick holds the same state; the count
    reads only the state, so both give the same operations and bytes."""
    from sph_poiseuille_flow_torch import build_scene, make_engine
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    conf, wl = _tiny(tiny_bench)
    ch = Channel.from_physics(conf["physical"])
    inp = traffic.developed_state(ch, wl["state"], 12, "cpu")
    counts, specs = [], []
    for k, nx in ((14, 4), (20, 0)):
        c = dict(conf, knobs=dict(conf["knobs"], cell_capacity=k,
                                  lane_pack_nx=nx))
        cfg = port_config(c, wl)
        eng = make_engine(cfg, build_scene(cfg), "cpu")
        lay = eng._rebuild(inp["x"].float(), inp["y"].float())
        specs.append((eng.spec.K, eng.spec.nx, tuple(lay.occ.shape)))
        # the state the layout holds, back in particle order
        x, y = fc.take_p(lay, lay.refx_p), fc.take_p(lay, lay.refy_p)
        assert torch.equal(y, inp["y"].float())
        ff, fw = work.pairs_within(x, y, inp["n_fluid"], ch.DL, ch.h)
        counts.append(work.step_work(ff, fw, inp["n_fluid"],
                                     inp["x"].numel()))
    assert specs[0] != specs[1]
    assert counts[0] == counts[1]


def test_least_time_is_the_larger_bound():
    ops, nbytes = work.step_work(300000, 6000, 30000, 32400)
    assert ops == (600000 + 6000) * work.PAIR_OPS + 30000 * work.PARTICLE_OPS
    assert nbytes == 4 * (6 * 32400 + 16 * 30000)
    s, by = work.least_seconds(ops, nbytes, 67e12, 3.35e12)
    assert by == "operations" and s == ops / 67e12
    t, by = work.window_least_seconds([(300000, 6000)] * 3, [10, 10],
                                      30000, 32400, 67e12, 3.35e12)
    assert by == "operations"
    assert abs(t - 2 * (10 * ops + 6000 * work.SHEAR_PAIR_OPS) / 67e12) \
        < 1e-15
