"""``--mesh N`` through the port's command line with ``--device cpu``
(in-process CPU slabs, plain twins): the engine each resolved name picks,
the ``mesh:`` log line, a run bit-equal to the one without ``--mesh``, and
the refusal of split dispatch under a mesh.

tests/data/quick.ini's full 1.5 s takes about a minute per run with the
fused engine's plain twins on one CPU core (84 s without ``--mesh``), so
the fused runs here stop at 0.04 s (undeveloped, exit code 1, the flags
clean: the simulation raises on overflow, on an unrecoverable drift trip
and on non-finite velocities); the whole 1.5 s with exit code 0 runs on
the row-sharded gather engine, which takes seconds."""

import contextlib
import io

import numpy as np
import pytest
import torch

from sph_poiseuille_flow_torch import run as cli

torch.set_num_threads(1)

QUICK = "tests/data/quick.ini"
SHORT = ["--set", "simulation.end_time=0.04", "--set",
         "simulation.output_interval=0.02"]


def _run(tmp_path, name, flags, config=QUICK):
    base = tmp_path / name
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", config, "--device", "cpu",
                       "--base-dir", str(base)] + flags)
    return rc, buf.getvalue(), np.load(base / "restart.npz")


@pytest.fixture(scope="module")
def short_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    return {name: _run(d, name, flags + SHORT) for name, flags in (
        ("single", []), ("mesh1", ["--mesh", "1"]),
        ("mesh2", ["--mesh", "2"]))}


@pytest.mark.parametrize("name", ["mesh1", "mesh2"])
def test_mesh_run_equals_single(short_runs, name):
    """The two-slab chunk loop and the one-device mesh (ghost 0, the
    single-device loop) reproduce the run without --mesh bit for bit: the
    restart file of the last output point, every field."""
    rc, out, got = short_runs[name]
    _, _, ref = short_runs["single"]
    n = name[-1]
    assert (f"mesh: {n} devices ("
            + ("virtual: 2 slabs on cpu" if n == "2" else "cpu")
            + "), engine=pallas (y-slab sharded)") in out
    assert out.count("output point:") == 2 and "L2 relative error" in out
    assert rc == 1          # 0.04 s is undeveloped: the verdict fails
    for k in ref.files:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_mesh2_gather_quick_ini_passes(tmp_path):
    """The whole of quick.ini on two neighbor-row blocks: exit code 0."""
    rc, out, _ = _run(tmp_path, "gather", ["--mesh", "2", "--engine",
                                           "gather"])
    assert "mesh: 2 devices (virtual: 2 slabs on cpu), engine=gather " \
           "(row-sharded)" in out
    assert "validation PASSED" in out and rc == 0
    assert out.count("output point:") == 3


@pytest.mark.parametrize("flags,engine", [
    (["--dtype", "float64"], "engine=cellgrid (y-slab sharded)"),
    (["--engine", "gather"], "engine=gather (row-sharded)")])
def test_mesh_resolves_engines(tmp_path, flags, engine):
    """float64 "auto" takes the y-slab cell engine, --engine gather the
    row-sharded gather engine."""
    rc, out, st = _run(tmp_path, "e", ["--mesh", "2"] + flags + [
        "--set", "simulation.end_time=0.01", "--set",
        "simulation.output_interval=0.01"])
    assert engine in out and rc == 1
    assert np.all(np.isfinite(st["vx"]))


def test_mesh_refuses_split_dispatch(tmp_path):
    with pytest.raises(RuntimeError, match="run without --mesh"):
        _run(tmp_path, "msd", ["--mesh", "2", "--max-steps-per-dispatch",
                               "4"] + SHORT)
