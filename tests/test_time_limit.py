"""The per-test time limit (tests/time_limit.py) on small inner test
files, each run by a pytest of its own in a subprocess, so that the
failures they provoke stay out of this run; and the marks that the
repo-root conftest.py gives tests by node id."""

import importlib.util
import os
import re
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
INI = os.path.join(REPO, "pytest.ini")

INNER = '''
import threading
import time

import pytest

import time_limit

time_limit.DEFAULT_SECONDS = 2.5


@pytest.mark.time_limit(2)
def test_sleeps_past_its_limit():
    time.sleep(60)


def test_runs_after_an_expiry():
    pass


@pytest.mark.time_limit(2)
def test_waits_on_a_stuck_thread():
    done = threading.Event()

    def work():
        time.sleep(600)
        done.set()

    threading.Thread(target=work).start()
    done.wait()


@pytest.fixture
def hanging_fixture():
    time.sleep(60)


@pytest.mark.time_limit(2)
def test_with_a_hanging_fixture(hanging_fixture):
    pass


def test_under_its_limit():
    time.sleep(1)


@pytest.mark.time_limit(10)
def test_marked_over_the_default():
    time.sleep(3)


def test_past_the_default():
    time.sleep(3)
'''

BLOCKED = '''
import signal
import time

import pytest

import time_limit

time_limit.GRACE_SECONDS = 1.0


@pytest.mark.time_limit(1)
def test_blocks_the_alarm():
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(60)
'''


def run_inner(tmp_path, source):
    """pytest on `source` with the repo's pytest.ini and the plugin ->
    (process, seconds, {test name: its failure or error text, or None})."""
    (tmp_path / "test_inner.py").write_text(source)
    xml = tmp_path / "inner.xml"
    env = dict(os.environ, PYTHONPATH=TESTS)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-c", INI, "--rootdir", str(tmp_path),
         "-p", "time_limit", "-p", "no:cacheprovider", "-q",
         f"--junitxml={xml}", str(tmp_path / "test_inner.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    seconds = time.monotonic() - t0
    cases = {}
    if xml.exists():
        for case in ET.parse(xml).iter("testcase"):
            bad = case.find("failure")
            if bad is None:
                bad = case.find("error")
            cases[case.get("name")] = None if bad is None else bad.text
    return proc, seconds, cases


@pytest.fixture(scope="module")
def inner(tmp_path_factory):
    """The inner run, its default limit set to 2.5 s."""
    return run_inner(tmp_path_factory.mktemp("inner"), INNER)


def test_expiry_fails_with_name_and_stacks(inner):
    proc, _, cases = inner
    text = cases["test_sleeps_past_its_limit"]
    assert text is not None
    assert ("test_inner.py::test_sleeps_past_its_limit ran past its time "
            "limit of 2 s") in text
    assert "Current thread" in text
    assert re.search(r'test_inner.py", line \d+ in test_sleeps_past_its_limit',
                     text)
    assert proc.returncode == 1


def test_next_test_runs_after_an_expiry(inner):
    _, _, cases = inner
    assert "test_runs_after_an_expiry" in cases
    assert cases["test_runs_after_an_expiry"] is None


def test_stuck_thread_neither_holds_the_test_nor_the_exit(inner):
    """The test's own thread sleeps 600 s: the test fails at its limit,
    the tests after it run, and the process still ends."""
    _, seconds, cases = inner
    text = cases["test_waits_on_a_stuck_thread"]
    assert text is not None and "ran past its time limit of 2 s" in text
    assert "in test_waits_on_a_stuck_thread" in text
    assert cases["test_under_its_limit"] is None
    assert seconds < 60


def test_fixture_setup_has_the_limit_too(inner):
    _, _, cases = inner
    text = cases["test_with_a_hanging_fixture"]
    assert text is not None and "ran past its time limit of 2 s" in text
    assert "in hanging_fixture" in text


def test_marker_sets_the_limit_over_the_default(inner):
    """With the default at 2.5 s, 1 s passes, an unmarked 3 s test
    fails, and a marked 3 s test with a limit of 10 s passes."""
    _, _, cases = inner
    assert cases["test_under_its_limit"] is None
    assert cases["test_marked_over_the_default"] is None
    text = cases["test_past_the_default"]
    assert text is not None and "ran past its time limit of 2.5 s" in text


def test_alarm_that_cannot_land_ends_the_process(tmp_path):
    """A main thread that never takes the alarm (here it blocks SIGALRM,
    as a native call that never returns would keep it) is ended by
    faulthandler GRACE_SECONDS later, with the stacks on stderr."""
    proc, seconds, _ = run_inner(tmp_path, BLOCKED)
    assert proc.returncode == 1
    assert "Timeout (0:00:02)!" in proc.stderr
    assert "in test_blocks_the_alarm" in proc.stderr
    assert seconds < 60


def _root_conftest():
    spec = importlib.util.spec_from_file_location(
        "root_conftest", os.path.join(REPO, "conftest.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ROOT = _root_conftest()
MARKED = sorted(set(ROOT.SLOW) | set(ROOT.LIMITS))


@pytest.fixture(scope="module")
def collected():
    """The node ids that the repo's pytest collects from the files of
    MARKED under `-m slow` and under `-m "not slow"`."""
    files = sorted({nodeid.split("::")[0] for nodeid in MARKED})

    def ids(expression):
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "--collect-only", "-q",
             "-p", "no:cacheprovider", "-m", expression, *files],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return {line for line in proc.stdout.splitlines() if "::" in line}

    return ids("slow"), ids("not slow")


@pytest.mark.parametrize("nodeid", MARKED)
def test_root_conftest_marks_a_collected_test(nodeid, collected):
    """Each node id of the root conftest's tables names a test that is
    collected, and is `slow` exactly when SLOW lists it: a renamed test
    would otherwise lose its mark unseen."""
    slow, default = collected
    assert nodeid in slow | default
    assert (nodeid in slow) == (nodeid in ROOT.SLOW)
