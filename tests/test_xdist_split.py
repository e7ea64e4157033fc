"""The scheduler of the repo's root conftest.py: under ``--dist loadfile``
the tests of a file in ``SPLIT_FILES`` are work units of their own and
start first, while every other file stays one unit on one worker."""

import re
from pathlib import Path

pytest_plugins = "pytester"

SUITE_CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"


def test_split_files_spread_over_workers(pytester):
    pytester.makeconftest(f"""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "suite_conftest", {str(SUITE_CONFTEST)!r})
        suite = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(suite)

        def pytest_configure(config):
            config.pluginmanager.register(suite)
    """)
    tests = pytester.mkdir("tests")
    body = "import time\n\ndef test_a():\n    time.sleep(1)\n\n" \
           "def test_b():\n    time.sleep(1)\n"
    (tests / "test_parallel.py").write_text(body)
    (tests / "test_other.py").write_text(body)
    result = pytester.runpytest_subprocess(
        "-p", "no:cacheprovider", "-p", "xdist", "-n", "2",
        "--dist", "loadfile", "-v", "tests")
    result.assert_outcomes(passed=4)
    started = re.findall(r"^(tests/\S+) *$", result.stdout.str(), re.M)
    assert set(started[:2]) == {"tests/test_parallel.py::test_a",
                                "tests/test_parallel.py::test_b"}, started
    worker = {m[2]: m[1] for m in re.finditer(
        r"\[(gw\d)\] \[[ \d%]+\] PASSED (tests/\S+)", result.stdout.str())}
    assert len(worker) == 4, result.stdout.str()
    assert (worker["tests/test_parallel.py::test_a"]
            != worker["tests/test_parallel.py::test_b"])
    assert (worker["tests/test_other.py::test_a"]
            == worker["tests/test_other.py::test_b"])
