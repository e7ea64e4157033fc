"""The per-test time limit of the repo's root conftest.py: a test whose
setup, call or teardown runs past the limit fails with a message naming it
and the limit, and the run goes on."""

from pathlib import Path

pytest_plugins = "pytester"

SUITE_CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"


def test_time_limit_fails_the_test_and_the_run_goes_on(pytester):
    # The inner run is a process of its own, so its alarms leave this
    # test's alone; it loads the suite's hooks with a limit of 1 s.
    pytester.makeconftest(f"""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "suite_conftest", {str(SUITE_CONFTEST)!r})
        suite = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(suite)
        suite.TIME_LIMIT_S = 1

        def pytest_configure(config):
            config.pluginmanager.register(suite)
    """)
    pytester.makepyfile(test_inner="""
        import time

        import pytest

        @pytest.fixture
        def slow_fixture():
            time.sleep(30)

        @pytest.fixture
        def slow_teardown():
            yield
            time.sleep(30)

        def test_sleeps_past_its_limit():
            time.sleep(30)

        def test_setup_sleeps_past_its_limit(slow_fixture):
            pass

        def test_teardown_sleeps_past_its_limit(slow_teardown):
            pass

        def test_after_them():
            pass
    """)
    result = pytester.runpytest_subprocess("-p", "no:cacheprovider")
    result.assert_outcomes(passed=2, failed=1, errors=2)
    result.stdout.fnmatch_lines_random([
        "*test_inner.py::test_sleeps_past_its_limit exceeded its time limit "
        "of 1 s in call*",
        "*test_inner.py::test_setup_sleeps_past_its_limit exceeded its time "
        "limit of 1 s in setup*",
        "*test_inner.py::test_teardown_sleeps_past_its_limit exceeded its "
        "time limit of 1 s in teardown*",
        "*1 failed, 2 passed, 2 errors*",
    ])
