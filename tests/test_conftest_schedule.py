"""The xdist scheduler hook of the repository's root conftest.py, driven with
fake workers.

No xdist session runs here: each case feeds a collection to the scheduler the
hook returns, completes the tests it hands out one at a time, and reads the
order in which files were sent to the workers. The priority a worker gives
itself is read in a child process, which may lower its own but not raise it.
"""

import collections
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import pytest

pytest.importorskip("xdist")
from xdist.scheduler import LoadFileScheduling  # noqa: E402

# Loaded by its path: more than one directory has a module named `conftest`.
ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "root_conftest", ROOT / "conftest.py")
conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(conftest)

# Light files with more tests than any heavy one, so that xdist's own queue
# (most tests first) would send the heavy files last.
LIGHT_FILES = {f"tests/test_light{i}.py": 9 + i for i in range(6)}
SLOWEST = conftest.HEAVY[0]
SLOWEST_FILE = SLOWEST.split("::")[0]
# The heavy files as the suite has them: the slowest test last of four.
HEAVY_TESTS = (
    [f"{SLOWEST_FILE}::test_{j}" for j in range(3)] + [SLOWEST]
    + [f"tests/test_pallas_gibbs.py::test_{j}" for j in range(5)]
    + [f"tests/test_parity_extra.py::test_{j}" for j in range(8)])


class FakeNode:
    """Stands in for xdist's WorkerController: records the units (files, or
    a test of its own) it is sent."""

    def __init__(self, name, collection, sent, scope_of):
        self.name = name
        self.scope_of = scope_of
        self.gateway = types.SimpleNamespace(id=name)
        self.collection = collection
        self.sent = sent
        self.shutting_down = False

    def send_runtest_some(self, indices):
        scopes = {self.scope_of(self.collection[i]) for i in indices}
        assert len(scopes) == 1
        self.sent.append((self.name, scopes.pop()))

    def shutdown(self):
        self.shutting_down = True


def fake_config(dist, n_workers):
    values = {"dist": dist, "tx": [f"{n_workers}*popen"]}
    return types.SimpleNamespace(
        getvalue=values.__getitem__,
        option=types.SimpleNamespace(loadscopereorder=True))


def make_collection(files):
    return [f"{path}::test_{j}" for path, n in files.items() for j in range(n)]


def run_schedule(sched, collection, n_workers):
    """Run a whole session on `sched`; return the workers told at the start
    that nothing follows, the (worker, file) sends in order and the test ids
    completed, in order."""
    sent = []
    nodes = [FakeNode(f"gw{k}", collection, sent, sched._split_scope)
             for k in range(n_workers)]
    for node in nodes:
        sched.add_node(node)
    for node in nodes:
        sched.add_node_collection(node, collection)
    sched.schedule()
    shut_at_start = [n.name for n in nodes if n.shutting_down]
    done = []
    for _ in range(len(collection) + 1):
        if not sched.has_pending:
            break
        for node in nodes:
            pending = [nid for unit in sched.assigned_work[node].values()
                       for nid, finished in unit.items() if not finished]
            if pending:
                done.append(pending[0])
                sched.mark_test_complete(node, collection.index(pending[0]))
    assert not sched.has_pending, "tests left that no worker will run"
    return shut_at_start, sent, done


def hook_scheduler(n_workers):
    sched = conftest.pytest_xdist_make_scheduler(
        fake_config("loadfile", n_workers), None)
    assert isinstance(sched, LoadFileScheduling)
    return sched


@pytest.mark.parametrize("unit", conftest.HEAVY)
def test_heavy_units_exist(unit):
    # A renamed file or test would drop out of the list without a word.
    path, _, test = unit.partition("::")
    source = ROOT / path
    assert source.is_file()
    assert not test or f"def {test}(" in source.read_text()


@pytest.mark.parametrize("n_workers", [1, 3, 6])
def test_heavy_units_first_and_every_test_run_once(n_workers):
    collection = make_collection(LIGHT_FILES) + HEAVY_TESTS
    shut_at_start, sent, done = run_schedule(
        hook_scheduler(n_workers), collection, n_workers)
    # The listed units go first, each to its own worker, in list order.
    first = min(n_workers, len(conftest.HEAVY))
    assert sent[:first] == [(f"gw{k}", conftest.HEAVY[k])
                            for k in range(first)]
    assert [s for _, s in sent if s in conftest.HEAVY] == list(conftest.HEAVY)
    # The other files keep xdist's own order.
    _, stock, _ = run_schedule(LoadFileScheduling(
        fake_config("loadfile", n_workers), None), collection, n_workers)
    assert [s for _, s in sent if s in LIGHT_FILES] == [
        s for _, s in stock if s in LIGHT_FILES]
    # No unit is lost or sent twice, and every test runs once.
    counts = collections.Counter(scope for _, scope in sent)
    assert counts == collections.Counter(set(LIGHT_FILES) | set(conftest.HEAVY))
    assert sorted(done) == sorted(collection)
    # With other workers to take the rest, the slowest test's worker gets
    # nothing else and is told at the start that nothing follows, so the
    # test need not wait for another file to be queued.
    if n_workers > 1:
        assert shut_at_start == ["gw0"]
        assert [scope for w, scope in sent if w == "gw0"] == [SLOWEST]
    else:
        assert shut_at_start == []


def test_without_heavy_files_order_is_xdists_own():
    collection = make_collection(LIGHT_FILES)
    _, sent, done = run_schedule(hook_scheduler(4), collection, 4)
    _, stock_sent, stock_done = run_schedule(
        LoadFileScheduling(fake_config("loadfile", 4), None), collection, 4)
    assert sent == stock_sent
    assert done == stock_done


@pytest.mark.parametrize("dist", ["load", "loadscope", "loadgroup",
                                  "worksteal", "each", "no"])
def test_other_dist_modes_keep_xdists_default(dist):
    assert conftest.pytest_xdist_make_scheduler(
        fake_config(dist, 6), None) is None


# Reports the nice values of its threads (one started before any change)
# after each setup: outside xdist, in a worker before HEAVY[0], and before
# another test.
LOWER_PRIORITY_CHILD = textwrap.dedent("""
    import importlib.util, json, os, sys, threading, types
    spec = importlib.util.spec_from_file_location("root_conftest", sys.argv[1])
    conftest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conftest)
    start = os.getpriority(os.PRIO_PROCESS, 0)
    conftest.NICE = min(19, start + 5)
    done = threading.Event()
    threading.Thread(target=done.wait).start()

    def nice(nodeid):
        conftest.pytest_runtest_setup(types.SimpleNamespace(nodeid=nodeid))
        return sorted({os.getpriority(os.PRIO_PROCESS, int(tid))
                       for tid in os.listdir("/proc/self/task")})

    seen = [nice("tests/test_light0.py::test_0")]
    os.environ["PYTEST_XDIST_WORKER"] = "gw0"
    seen += [nice(conftest.HEAVY[0]), nice("tests/test_light0.py::test_0")]
    done.set()
    print(json.dumps([start, conftest.NICE, seen]))
""")


def test_workers_but_the_slowests_lower_their_priority():
    env = {k: v for k, v in os.environ.items() if k != "PYTEST_XDIST_WORKER"}
    out = subprocess.run(
        [sys.executable, "-c", LOWER_PRIORITY_CHILD, str(ROOT / "conftest.py")],
        env=env, capture_output=True, text=True, check=True).stdout
    start, nice, seen = json.loads(out)
    assert nice > start
    assert seen == [[start], [start], [nice]]
