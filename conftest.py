"""Suite-wide pytest hooks, loaded for every run under this directory.

* A time limit on each test's setup, call and teardown, so a hang fails its
  own test instead of eating the whole run's clock. SIGALRM fails the test
  as soon as Python code runs again; a hang inside native code (an XLA
  compile) never returns to Python, so faulthandler then dumps every
  thread's stack and ends the process a minute later.
* Under ``--dist loadfile`` the tests of a few long files are work units of
  their own, so pytest-xdist spreads them over its workers instead of
  running each such file on one, and they are handed out before the other
  files, so that the many short files fill the end of the run.

Nothing here imports jax: tests/conftest.py sets up its platform first.
"""

import contextlib
import faulthandler
import os
import signal
import sys

import pytest

TIME_LIMIT_S = 600

# Files whose tests, run one after another on one worker, outlast the
# suite's run. Measured under the tier-1 command (-n 6 on 8 cores), in test
# seconds per file: test_parallel.py 1,553, test_pallas.py 1,335,
# test_split_dispatch.py 477; no other file over 135, no test over ~320.
SPLIT_FILES = frozenset({
    "tests/test_parallel.py",
    "tests/test_pallas.py",
    "tests/test_split_dispatch.py",
})

_STDERR_FD = pytest.StashKey[int]()


def pytest_configure(config):
    # faulthandler writes to a file descriptor: copy stderr's while output
    # capture is off, or the dump would land in the capture's temp file.
    config.stash[_STDERR_FD] = os.dup(sys.__stderr__.fileno())


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR_FD])


@contextlib.contextmanager
def _time_limit(item, when):
    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} exceeded its time limit of "
                    f"{TIME_LIMIT_S} s in {when}", pytrace=False)

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT_S)
    faulthandler.dump_traceback_later(TIME_LIMIT_S + 60, exit=True,
                                      file=item.config.stash[_STDERR_FD])
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _time_limit(item, "teardown"):
        return (yield)


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SplitLongFiles(LoadFileScheduling):
        def _split_scope(self, nodeid):
            path = super()._split_scope(nodeid)
            return nodeid if path in SPLIT_FILES else path

        def _assign_work_unit(self, node):
            # The queue comes sorted by tests per unit, which puts the
            # one-test units last; move the next one to the front.
            for scope in self.workqueue:
                if "::" in scope:
                    self.workqueue.move_to_end(scope, last=False)
                    break
            super()._assign_work_unit(node)

    return SplitLongFiles(config, log)
