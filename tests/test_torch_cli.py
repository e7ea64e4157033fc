"""The port's command line end to end on a tiny ini with ``--device cpu``,
its five ``SPH_*_OVERRIDE`` environment variables, ``--profile``, the
kernel-form flags and ``--step-log-every``, the (g, mu) sweep flags, and
the rule that the package never imports jax (``--mesh``:
test_torch_mesh_cli.py)."""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sph_poiseuille_flow_torch import run as cli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_INI = ("[physical]\nDL = 1.0\nDH = 0.5\ndp = 0.05\nrho0 = 1.0\n"
            "mu = 0.4\nU_bulk = 0.666667\nc_f = 15.0\n"
            "[simulation]\nend_time = 0.1\noutput_interval = 0.05\n"
            "sort_interval = 100\nrestart_from_file = 0\n")


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One CLI run whose config and every output path come from the five
    override variables (no --config flag)."""
    d = tmp_path_factory.mktemp("cli")
    (d / "tiny.ini").write_text(TINY_INI)
    env = dict(SPH_CONFIG_OVERRIDE=str(d / "tiny.ini"),
               SPH_RESTART_PATH_OVERRIDE=str(d / "o" / "restart.npz"),
               SPH_RESULT_PNG_OVERRIDE=str(d / "o" / "r.png"),
               SPH_PROFILE_PNG_OVERRIDE=str(d / "o" / "p.png"),
               SPH_POSTPROCESS_MAT_OVERRIDE=str(d / "o" / "post.npz"))
    mp = pytest.MonkeyPatch()
    for k, v in env.items():
        mp.setenv(k, v)
    try:
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--device", "cpu", "--base-dir", str(d / "base"),
                           "--set", "physical.mu=0.4"])
    finally:
        mp.undo()
    return rc, buf.getvalue(), d


def test_cli_end_to_end_on_cpu(cli_run):
    rc, out, d = cli_run
    assert "L2 relative error" in out, out
    assert "throughput" in out and "host syncs" in out
    # a 0.1 s run is undeveloped: the verdict is FAILED, exit code 1
    assert "validation FAILED" in out and rc == 1
    assert out.count("output point:") == 2


@pytest.mark.parametrize("var,name", [
    ("SPH_RESTART_PATH_OVERRIDE", "restart.npz"),
    ("SPH_POSTPROCESS_MAT_OVERRIDE", "post.npz"),
    ("SPH_RESULT_PNG_OVERRIDE", "r.png"),
    ("SPH_PROFILE_PNG_OVERRIDE", "p.png"),
])
def test_output_overrides(cli_run, var, name):
    _, out, d = cli_run
    if name.endswith(".png") and importlib.util.find_spec(
            "matplotlib") is None:
        assert "figures skipped" in out
        return
    assert (d / "o" / name).exists(), var
    assert not (d / "base" / name).exists()


def test_config_override_was_read(cli_run):
    """SPH_CONFIG_OVERRIDE named the tiny ini: 200 fluid particles."""
    _, out, _ = cli_run
    assert "particles: fluid=200, wall=160, total=360" in out


def test_restart_file_loads_in_the_jax_package(cli_run):
    from sph_poiseuille_flow_tpu.config import derive_config
    from sph_poiseuille_flow_tpu.utils.checkpoint import load_restart
    _, _, d = cli_run
    cfg = derive_config(DL=1.0, DH=0.5, dp=0.05, rho0=1.0, mu=0.4,
                        U_bulk=0.666667, c_f=15.0, end_time=0.1,
                        output_interval=0.05, sort_interval=100,
                        restart_from_file=False)
    payload, reason = load_restart(str(d / "o" / "restart.npz"),
                                   cfg.signature, 360)
    assert reason == "ok"
    assert payload["t"] == pytest.approx(0.1)
    assert np.all(np.isfinite(payload["vx"]))


def test_restart_resumes_in_the_port(cli_run, monkeypatch, capsys):
    """restart_from_file=1 with the same signature: the run resumes from
    the file the first run wrote (through interop.state_from_numpy) at
    t=end_time, so no interval runs and the verdict is recomputed."""
    _, _, d = cli_run
    ini = d / "resume.ini"
    ini.write_text(TINY_INI.replace("restart_from_file = 0",
                                    "restart_from_file = 1"))
    monkeypatch.setenv("SPH_RESTART_PATH_OVERRIDE",
                       str(d / "o" / "restart.npz"))
    rc = cli.main(["--config", str(ini), "--device", "cpu", "--base-dir",
                   str(d / "resume"), "--set", "physical.mu=0.4"])
    out = capsys.readouterr().out
    assert "Restart: resuming from t=0.100000" in out
    assert "output point:" not in out and "L2 relative error" in out
    assert rc == 1


def test_postprocess_only(cli_run, capsys):
    _, _, d = cli_run
    rc = cli.main(["--postprocess-only", str(d / "o" / "post.npz")])
    assert "L2 relative error" in capsys.readouterr().out
    assert rc == 1


SWEEP_INI = TINY_INI.replace("end_time = 0.1\noutput_interval = 0.05",
                             "end_time = 0.04\noutput_interval = 0.02")
WORKLOAD = re.compile(r"workload (\d): mu=([\d.]+) L2=\d+\.\d{3}% "
                      r"(PASS|FAIL)$")


def _sweep_cli(tmp_path, capsys, name, flags):
    ini = tmp_path / "sweep.ini"
    ini.write_text(SWEEP_INI)
    rc = cli.main(["--config", str(ini), "--device", "cpu", "--base-dir",
                   str(tmp_path / name), "--sweep-mus", "0.1,0.25"] + flags)
    out = capsys.readouterr().out
    return rc, out, [ln for ln in out.splitlines() if WORKLOAD.match(ln)]


def test_sweep_mus_prints_each_workload(tmp_path, capsys):
    """--sweep-mus on the fused engine's plain twins: one workload line per
    lane, the summed throughput line, each lane's restart, and exit 1 since
    the 0.04 s lanes are undeveloped (every lane must pass for exit 0)."""
    rc, out, lines = _sweep_cli(tmp_path, capsys, "fused",
                                ["--sweep-lane-chunk", "1"])
    assert [WORKLOAD.match(ln).group(1, 2) for ln in lines] == [
        ("0", "0.1"), ("1", "0.25")], out
    assert all(ln.endswith("FAIL") for ln in lines) and rc == 1
    assert re.search(r"^throughput: \d\.\d{3}e[+-]\d+ particle-steps/sec "
                     r"\(sum over lanes\)$", out, re.M), out
    assert "inapplicable on the fused sweep path" in out
    for k in range(2):
        assert (tmp_path / "fused" / f"restart_lane{k}.npz").exists()


def test_sweep_lane_chunk_gives_the_same_lanes(tmp_path, capsys):
    """--engine cellgrid: lanes one at a time give the workload lines of
    one chunk of every lane."""
    rc1, _, chunked = _sweep_cli(tmp_path, capsys, "c1",
                                 ["--engine", "cellgrid",
                                  "--sweep-lane-chunk", "1"])
    rc2, _, whole = _sweep_cli(tmp_path, capsys, "c2",
                               ["--engine", "cellgrid"])
    assert len(chunked) == 2 and chunked == whole and rc1 == rc2 == 1


@pytest.mark.parametrize("flags,want", [
    ([], ("full", 16)),
    (["--geom-cache", "none"], ("none", 0)),
    (["--geom-cache", "ring"], ("ring", 16)),
    (["--geom-cache", "partial", "--geom-kcut", "5"], ("partial", 5)),
    (["--fused-rows", "1"], ("rows", 0)),
])
def test_form_flags_reach_the_engine(tmp_path, monkeypatch, flags, want):
    """--geom-cache, --geom-kcut and --fused-rows pick the form the engine
    runs (on the tiny ini, "auto" is the full cache)."""
    from sph_poiseuille_flow_torch import simulation
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    seen = {}

    def fake_run(self):
        seen["form"] = fc.chunk_form(self.engine.spec, torch.float32)
        return dict(particle_steps_per_sec=0.0, step=0, tau_history=[],
                    host_syncs=0, passed=True)

    monkeypatch.setattr(simulation.Simulation, "run", fake_run)
    ini = tmp_path / "tiny.ini"
    ini.write_text(TINY_INI)
    assert cli.main(["--config", str(ini), "--device", "cpu",
                     "--base-dir", str(tmp_path)] + flags) == 0
    assert seen["form"] == want


def test_step_log_flag_prints_rows(tmp_path, capsys):
    ini = tmp_path / "tiny.ini"
    ini.write_text(TINY_INI.replace("end_time = 0.1", "end_time = 0.004")
                   .replace("output_interval = 0.05",
                            "output_interval = 0.002"))
    cli.main(["--config", str(ini), "--device", "cpu", "--base-dir",
              str(tmp_path), "--step-log-every", "1"])
    out = capsys.readouterr().out
    steps = [int(m) for m in re.findall(r"^step=(\d+), t=", out, re.M)]
    assert steps == list(range(1, len(steps) + 1)) and len(steps) > 2


def test_profile_writes_trace_and_summary(tmp_path, capsys):
    """--profile DIR captures the run with torch.profiler: a chrome trace
    and a per-interval summary. On the CPU there is no device activity, so
    the busy share is reported as not measured rather than as 0."""
    ini = tmp_path / "tiny.ini"
    ini.write_text(TINY_INI.replace("end_time = 0.1", "end_time = 0.004")
                   .replace("output_interval = 0.05",
                            "output_interval = 0.002"))
    cli.main(["--config", str(ini), "--device", "cpu", "--base-dir",
              str(tmp_path), "--profile", str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    summary = json.loads((tmp_path / "prof" / "summary.json").read_text())
    assert len(summary["intervals"]) == out.count("output point:") == 2
    assert all(r["wall_us"] > 0 and r["busy_us"] is None
               for r in summary["intervals"])
    assert summary["steady"]["n_intervals"] == 1
    assert "device busy not measured" in out


def test_profile_union_of_device_spans():
    """The busy time is the union of overlapping device spans inside each
    interval, clipped to it; user ranges on the device timeline are not
    device work."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from sph_poiseuille_flow_torch.utils import profile as prof

    def ev(name, a, b, dev):
        return NS(name=name, time_range=NS(start=a, end=b), device_type=dev,
                  is_user_annotation=False)

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [ev(prof.INTERVAL, 0, 100, cpu), ev(prof.INTERVAL, 200, 300, cpu),
              ev(prof.INTERVAL, 0, 300, cuda),
              ev("k1", -10, 30, cuda), ev("k2", 20, 50, cuda),
              ev("k1", 210, 260, cuda), ev("k2", 290, 320, cuda)]
    s = prof.summarize(events)
    assert [r["busy_us"] for r in s["intervals"]] == [50, 60]
    assert s["intervals"][0]["device_us_by_name"] == {"k1": 30, "k2": 30}
    assert s["steady"]["busy_share"] == pytest.approx(0.6)
    assert s["steady"]["device_us_by_name"] == {"k1": 50, "k2": 10}


def test_device_cuda_without_a_card_raises(tmp_path):
    """--device cuda never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks its absence")
    ini = tmp_path / "tiny.ini"
    ini.write_text(TINY_INI)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", str(ini), "--base-dir", str(tmp_path)])


def test_import_leaves_no_jax():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, sph_poiseuille_flow_torch, "
         "sph_poiseuille_flow_torch.run, sph_poiseuille_flow_torch.interop;"
         "print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('jax', 'jaxlib', "
         "'sph_poiseuille_flow_tpu')))"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_resume_matches_uninterrupted(tmp_path):
    """tests/test_checkpoint.py:67-116 in the port: tests/data/quick.ini
    run 0.04 s straight against 0.02 s + restart + 0.02 s, with output
    points every 0.02 s (~19 steps each; the plain twins take ~50 ms a
    step here). The final states agree closely; bitwise equality is not
    expected, because the resumed run re-derives Vol and B from the
    restart state at init."""
    import dataclasses
    from types import SimpleNamespace

    from sph_poiseuille_flow_torch.config import load_config
    from sph_poiseuille_flow_torch.simulation import (Simulation,
                                                      SimulationPaths)
    from sph_poiseuille_flow_torch.utils import checkpoint

    def paths(tag):
        d = tmp_path / tag
        return SimulationPaths(
            restart=str(d / "restart.npz"), result_png=str(d / "r.png"),
            profile_evolution_png=str(d / "p.png"),
            postprocess_npz=str(d / "post.npz"))

    def quiet(_):
        pass

    cfg_full = load_config(os.path.join(ROOT, "tests", "data", "quick.ini"),
                           ini_overrides={"simulation": {
                               "end_time": 0.04, "output_interval": 0.02}})
    sim_full = Simulation(cfg_full, paths("full"), log=quiet, device="cpu")
    res_full = sim_full.run()

    cfg_half = dataclasses.replace(cfg_full, end_time=0.02)
    p2 = paths("resumed")
    sim_half = Simulation(cfg_half, p2, log=quiet, device="cpu")
    sim_half.run()

    # the signature includes end_time: re-save the half run's restart
    # under the full config's signature
    n_total = sim_half.scene.n_total
    payload, reason = checkpoint.load_restart(p2.restart, cfg_half.signature,
                                              n_total)
    assert payload is not None, reason
    assert payload["t"] == pytest.approx(0.02)
    cfg_resume = dataclasses.replace(cfg_full, restart_from_file=True)
    checkpoint.save_restart(p2.restart, cfg_resume.signature,
                            SimpleNamespace(**payload), payload["t"],
                            payload["step"])
    logs = []
    sim_resume = Simulation(cfg_resume, p2, log=logs.append, device="cpu")
    res_resumed = sim_resume.run()
    assert "Restart: resuming from t=0.020000, step=" in "\n".join(logs)
    assert sum(ln.startswith("output point:") for ln in logs) == 1

    assert res_resumed["t"] == pytest.approx(0.04)
    assert res_resumed["step"] == res_full["step"]
    nf = sim_full.scene.n_fluid
    u_full = res_full["final_state"].vx[:nf].numpy()
    u_res = res_resumed["final_state"].vx[:nf].numpy()
    scale = np.abs(u_full).max()
    assert scale > 0
    assert np.abs(u_full - u_res).max() < 0.02 * scale
    assert res_resumed["L2_error"] == pytest.approx(res_full["L2_error"],
                                                    abs=0.01)

