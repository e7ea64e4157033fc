"""``bench_torch.py``, the port's benchmark, on the CPU: its protocol at a
tiny size (one warm and one timed interval of 0.002 s at dp=0.025, the
plain PyTorch twins of the kernels), the JSON line's keys, and that it
imports nothing of JAX."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_bench():
    return bench_torch.measure(0.025, n_timed_intervals=1, interval=0.002,
                               n_warm=1, device="cpu")


def test_measure_keys_and_values(tiny_bench):
    out = tiny_bench
    assert set(out) == {"metric", "value", "unit", "vs_baseline",
                        "mean_value", "mean_vs_baseline", "intervals"}
    assert out["metric"] == "particle_steps_per_sec_dp0.025"
    assert out["unit"] == "particle-steps/sec"
    assert out["value"] > 0 and out["mean_value"] > 0
    assert out["intervals"] == [out["value"]] == [out["mean_value"]]
    assert out["vs_baseline"] == pytest.approx(
        out["value"] / bench_torch.REF_BASELINE_PSPS[0.025], abs=1e-3)
    json.dumps(out)


def test_measure_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.measure(0.025, n_timed_intervals=1, interval=0.002,
                            n_warm=0)


def test_bench_imports_no_jax():
    """A tiny measure in a fresh interpreter leaves no module of JAX or of
    the JAX package loaded."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, bench_torch;"
         "bench_torch.measure(0.025, 1, 0.002, 0, 'cpu');"
         "print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('jax', 'jaxlib', "
         "'sph_poiseuille_flow_tpu')))"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
