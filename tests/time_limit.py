"""A time limit for every test, loaded by the repo-root conftest.py.

Each phase of a test (setup, call, teardown) may take DEFAULT_SECONDS;
``@pytest.mark.time_limit(seconds)`` (registered in pytest.ini) gives one
test a limit of its own, with the reason in a comment beside it.

On expiry SIGALRM fails the test in the main thread: the failure names
the test and carries every thread's stack, dumped by faulthandler, and
the worker goes on to the next test.  The failure is a BaseException, so
an ``except Exception`` in the code under test does not swallow it.  A
compile that the test left running on a thread of its own (the JAX
package's cachefix runs every XLA compile on one) keeps running; so that
it cannot hold the process at exit, a process in which a limit expired
ends with ``os._exit`` once pytest has written its reports.  If the main
thread does not come back to Python within GRACE_SECONDS of the expiry
(a native call that never returns), faulthandler dumps the stacks to the
terminal and ends the process; pytest-xdist then reports the test as
crashed and starts a new worker.
"""

import faulthandler
import os
import signal
import sys
import tempfile
import threading
from contextlib import contextmanager

import pytest

DEFAULT_SECONDS = 300.0
GRACE_SECONDS = 60.0


def pytest_configure(config):
    config.pluginmanager.register(TimeLimit(config), "time_limit_state")


def _stacks():
    with tempfile.TemporaryFile("w+") as f:
        faulthandler.dump_traceback(f, all_threads=True)
        f.seek(0)
        return f.read()


class TimeLimit:
    def __init__(self, config):
        # stderr as it was before pytest captured it
        capman = config.pluginmanager.getplugin("capturemanager")
        err = getattr(getattr(capman, "_global_capturing", None), "err", None)
        self.terminal_fd = getattr(err, "targetfd_save", 2)
        self.expired = False
        self.exitstatus = 1

    @contextmanager
    def limited(self, item):
        mark = item.get_closest_marker("time_limit")
        seconds = DEFAULT_SECONDS if mark is None else float(mark.args[0])
        faulthandler.dump_traceback_later(seconds + GRACE_SECONDS, exit=True,
                                          file=self.terminal_fd)
        on_main = threading.current_thread() is threading.main_thread()
        if on_main:
            def expire(signum, frame):
                self.expired = True
                pytest.fail(f"{item.nodeid} ran past its time limit of "
                            f"{seconds:g} s. The stack of every thread:\n"
                            f"{_stacks()}", pytrace=False)

            old = signal.signal(signal.SIGALRM, expire)
            signal.setitimer(signal.ITIMER_REAL, seconds)
        try:
            yield
        finally:
            if on_main:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, old)
            faulthandler.cancel_dump_traceback_later()

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_setup(self, item):
        with self.limited(item):
            return (yield)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_call(self, item):
        with self.limited(item):
            return (yield)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_teardown(self, item):
        with self.limited(item):
            return (yield)

    def pytest_sessionfinish(self, exitstatus):
        self.exitstatus = int(exitstatus)

    @pytest.hookimpl(trylast=True)
    def pytest_unconfigure(self):
        stray = [t for t in threading.enumerate()
                 if t is not threading.main_thread() and not t.daemon]
        if self.expired and stray:
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(self.exitstatus)
