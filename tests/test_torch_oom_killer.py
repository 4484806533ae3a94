"""Memory monitor and OOM worker-killing on the port's cluster runtime,
through the JAX package's scenarios with their own inputs and
assertions: tests/test_oom_killer.py (14).

Reference parity: src/ray/common/memory_monitor.h:52 (threshold
sampling), src/ray/raylet/worker_killing_policy.h:34 and the two
shipped policies — policy choice is asserted at the unit level (each
unit scenario runs the port's ``core/oom.py`` and the JAX package's on
the same candidates and asserts both answers), then the kill→retry
path end to end on a one-node cluster per scenario, as in the JAX file.
Functions are defined inside the tests, so they travel by value. Every
get carries a timeout.
"""

import os
import time

import pytest

import ray_tpu_torch as ray
from ray_tpu.core import oom as jax_oom
from ray_tpu_torch.core import oom
from ray_tpu_torch.core.api import _global_runtime

MODULES = [pytest.param(oom, id="torch"), pytest.param(jax_oom, id="jax")]


# ---------------------------------------------------------------------------
# threshold semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", MODULES)
def test_threshold_fraction_only(m):
    snap = m.MemorySnapshot(96, 100)
    assert m.is_above_threshold(snap, 0.95, -1)
    assert not m.is_above_threshold(m.MemorySnapshot(94, 100), 0.95, -1)


@pytest.mark.parametrize("m", MODULES)
def test_threshold_min_free_is_anded(m):
    """min_memory_free_bytes relaxes the fraction on big hosts: BOTH
    conditions must hold (reference: memory_monitor.cc)."""
    snap = m.MemorySnapshot(96, 100)
    assert not m.is_above_threshold(snap, 0.95, 2)  # free=4 >= 2 floor
    assert m.is_above_threshold(snap, 0.95, 10)  # free=4 < 10


@pytest.mark.parametrize("m", MODULES)
def test_threshold_empty_snapshot_safe(m):
    assert not m.is_above_threshold(m.MemorySnapshot(0, 0), 0.95, -1)


# ---------------------------------------------------------------------------
# policy choice (reference: worker_killing_policy_*_test.cc shapes)
# ---------------------------------------------------------------------------

def _c(m, name, owner, retriable, t):
    return m.KillCandidate(name, owner, retriable, t)


@pytest.mark.parametrize("m", MODULES)
def test_fifo_kills_earliest_retriable(m):
    v, retry = m.select_worker_to_kill(
        [_c(m, "late", "a", True, 10.0), _c(m, "early", "a", True, 1.0)],
        m.RETRIABLE_FIFO)
    assert v.worker == "early" and retry


@pytest.mark.parametrize("m", MODULES)
def test_fifo_prefers_retriable_over_older_nonretriable(m):
    v, _ = m.select_worker_to_kill(
        [_c(m, "old-actor", "a", False, 1.0),
         _c(m, "young-task", "b", True, 9.0)],
        m.RETRIABLE_FIFO)
    assert v.worker == "young-task"


@pytest.mark.parametrize("m", MODULES)
def test_lifo_kills_newest_retriable(m):
    v, retry = m.select_worker_to_kill(
        [_c(m, "late", "a", True, 10.0), _c(m, "early", "a", True, 1.0)],
        m.RETRIABLE_LIFO)
    assert v.worker == "late" and retry


@pytest.mark.parametrize("m", MODULES)
def test_group_by_owner_picks_largest_retriable_group_lifo_victim(m):
    cands = [
        _c(m, "a1", "ownerA", True, 1.0), _c(m, "a2", "ownerA", True, 5.0),
        _c(m, "a3", "ownerA", True, 3.0),
        _c(m, "b1", "ownerB", True, 0.5),
        _c(m, "actor", "x", False, 0.1),
    ]
    v, retry = m.select_worker_to_kill(cands, m.GROUP_BY_OWNER)
    # largest retriable group is ownerA (3 members); LIFO inside → a2
    assert v.worker == "a2"
    assert retry, "group still has members: task should be retried"


@pytest.mark.parametrize("m", MODULES)
def test_group_by_owner_last_member_not_retried(m):
    """Killing a retriable group's LAST member returns should_retry=False
    (reference: should_retry = size>1 && retriable)."""
    v, retry = m.select_worker_to_kill(
        [_c(m, "only", "ownerA", True, 2.0)], m.GROUP_BY_OWNER)
    assert v.worker == "only" and not retry


@pytest.mark.parametrize("m", MODULES)
def test_group_by_owner_nonretriable_share_one_group(m):
    """Non-retriable work all lands in ONE group regardless of owner; a
    retriable group is preferred over it even when smaller."""
    cands = [
        _c(m, "n1", "o1", False, 1.0), _c(m, "n2", "o2", False, 2.0),
        _c(m, "n3", "o3", False, 3.0),
        _c(m, "r1", "o4", True, 9.0),
    ]
    v, _ = m.select_worker_to_kill(cands, m.GROUP_BY_OWNER)
    assert v.worker == "r1"


@pytest.mark.parametrize("m", MODULES)
def test_group_by_owner_ties_break_to_newest_group(m):
    cands = [
        _c(m, "oldg", "A", True, 1.0),
        _c(m, "newg", "B", True, 8.0),
    ]
    v, retry = m.select_worker_to_kill(cands, m.GROUP_BY_OWNER)
    assert v.worker == "newg" and not retry


@pytest.mark.parametrize("m", MODULES)
def test_empty_candidates(m):
    assert m.select_worker_to_kill([], m.GROUP_BY_OWNER) == (None, False)


# ---------------------------------------------------------------------------
# end to end: pressure → kill → retry
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_memory():
    os.environ["RAY_TPU_TEST_MEMORY_TOTAL_BYTES"] = str(100)
    os.environ["RAY_TPU_TEST_MEMORY_USED_BYTES"] = str(0)
    yield
    os.environ.pop("RAY_TPU_TEST_MEMORY_TOTAL_BYTES", None)
    os.environ.pop("RAY_TPU_TEST_MEMORY_USED_BYTES", None)


def test_oom_kill_retries_task_end_to_end(fake_memory, tmp_path):
    """A worker running under memory pressure is killed by the nodelet's
    monitor and its (retriable) task is resubmitted and completes."""
    ray.init(num_cpus=2)
    try:
        started = str(tmp_path / "started")

        @ray.remote(num_cpus=1, max_retries=2)
        def hog():
            if not os.path.exists(started):
                open(started, "w").close()
                time.sleep(60)  # parked until the OOM killer takes us
                return "survived"
            return "retried"

        ref = hog.remote()
        deadline = time.monotonic() + 30
        while not os.path.exists(started) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert os.path.exists(started), "task never started"
        nodelet = _global_runtime()._booted[1]
        # drive the node over the 95% threshold; the in-process nodelet's
        # reap loop samples the (faked) snapshot every 250ms
        os.environ["RAY_TPU_TEST_MEMORY_USED_BYTES"] = str(99)
        deadline = time.monotonic() + 15
        while nodelet._oom_kills == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        os.environ["RAY_TPU_TEST_MEMORY_USED_BYTES"] = str(0)
        assert nodelet._oom_kills >= 1, "monitor never killed under pressure"
        assert ray.get(ref, timeout=60) == "retried"
    finally:
        ray.shutdown()


def test_no_kill_below_threshold(fake_memory):
    """Sanity: with usage below threshold nothing is ever killed."""
    ray.init(num_cpus=2)
    try:
        @ray.remote(num_cpus=1)
        def f(x):
            return x * 2

        assert ray.get([f.remote(i) for i in range(10)],
                       timeout=60) == [i * 2 for i in range(10)]
        assert _global_runtime()._booted[1]._oom_kills == 0
    finally:
        ray.shutdown()


def test_oom_snapshot_reads_proc():
    """The real (non-faked) sampler returns sane /proc numbers."""
    snap = oom.take_snapshot([os.getpid()])
    assert snap.total_bytes > 0
    assert 0 < snap.used_bytes <= snap.total_bytes
    assert snap.process_rss[os.getpid()] > 0
