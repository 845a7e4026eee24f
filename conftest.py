"""Test-session settings shared by every test directory of the repository.

Under `pytest-xdist --dist loadfile` the slowest tests start first, and the
workers running other tests give the slowest one the CPU when both want it.
"""

import os

import pytest

# Units of work that run for minutes on the CPU, longest first: a file, or
# one test sent apart from the rest of its file. xdist's loadfile queue starts
# the files with the most tests first, which put these last; started first,
# each on its own worker, they no longer set the suite's wall time by their
# late start. Seconds from one run with six workers.
HEAVY = (
    # 1,064 s (825-1,328 s in other runs); last of its file, so apart it
    # starts at once instead of after the other three
    "tests/test_gibbs.py::test_gibbs_blocked_sweep_unbiased_vs_exact",
    "tests/test_pallas_gibbs.py",  # 651 s, 313 s of it one test
    "tests/test_parity_extra.py",  # 592 s, 276 s of it one test
    "tests/test_gibbs.py",  # 246 s: the other three tests
)
NICE = 10  # of a worker running other tests than HEAVY[0]


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """With `--dist loadfile`, hand out HEAVY before any other file; the
    worker of the first takes nothing else."""
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class HeavyFirstScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return nodeid if nodeid in HEAVY else super()._split_scope(nodeid)

        def _assign_work_unit(self, node):
            for scope in reversed(HEAVY):
                if scope in self.workqueue:
                    self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

        def _reschedule(self, node):
            # The first unit outlasts the rest of the suite, so a file
            # queued behind it would wait to the end. Where other workers
            # take the rest, its worker is told at once that nothing
            # follows: a worker starts a test only when it knows the next
            # one or that there is none.
            if HEAVY[0] not in self.assigned_work[node] or len(
                    self.nodes) == 1:
                super()._reschedule(node)
            elif not node.shutting_down:
                node.shutdown()

    return HeavyFirstScheduling(config, log)


def pytest_runtest_setup(item):
    """An xdist worker about to run any test but HEAVY[0] lowers its own
    priority to NICE, once: HEAVY[0] alone sets the suite's length, and
    beside five busy workers of equal priority it got 1.3 of the ~2.2
    cores it uses when it has them."""
    if (item.nodeid != HEAVY[0] and os.environ.get("PYTEST_XDIST_WORKER")
            and os.getpriority(os.PRIO_PROCESS, 0) < NICE):
        lower_priority()


def lower_priority():
    """Set every thread of this process to at least nice NICE; threads it
    starts later take the value from the thread that starts them."""
    for tid in os.listdir("/proc/self/task"):
        tid = int(tid)
        try:
            os.setpriority(os.PRIO_PROCESS, tid,
                           max(NICE, os.getpriority(os.PRIO_PROCESS, tid)))
        except ProcessLookupError:  # the thread has ended since the listing
            pass
