"""What the harness's chip path and the reference load, compared by
whole top-level names: neither JAX nor the JAX package, and the
reference nothing of the port."""

import ast
import os
import subprocess
import sys

from benchmark import harness

JAX = {"jax", "jaxlib", "flax", "sph_poiseuille_flow_tpu"}
PORT = "sph_poiseuille_flow_torch"


def _loaded(code: str) -> set:
    """Top-level names of ``sys.modules`` after ``code`` runs in a fresh
    interpreter at the checkout's root."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def _top_names(path: str) -> set:
    tree = ast.parse(open(path, encoding="utf-8").read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(*subdirs):
    for sub in subdirs:
        base = os.path.join(harness.BENCH_DIR, sub)
        for f in sorted(os.listdir(base)):
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_chip_path_loads_neither_jax_nor_the_jax_package():
    names = _loaded(
        "from benchmark import harness, check, control, trace, work\n"
        "import torch\n"
        "for kind in ('drivers', 'metrics'):\n"
        "    import os\n"
        "    for f in os.listdir(os.path.join(harness.BENCH_DIR, kind)):\n"
        "        if f.endswith('.py'):\n"
        "            harness.load_module(harness.BENCH_DIR, kind, f[:-3])\n"
        "import sph_poiseuille_flow_torch\n"
        "from sph_poiseuille_flow_torch.ops import fused_cell_cuda\n")
    assert PORT in names
    assert not names & JAX


def test_harness_sources_import_no_jax():
    for path in _sources(".", "drivers", "metrics", "reference"):
        assert not _top_names(path) & JAX, path


def test_reference_loads_nothing_of_the_port():
    names = _loaded("from benchmark.reference import sph\n"
                    "from benchmark import traffic, work\n")
    assert not names & (JAX | {PORT})
    for path in _sources("reference"):
        assert not _top_names(path) & (JAX | {PORT}), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, PORT + "_extra", sys)
    assert "jaxtyping_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
