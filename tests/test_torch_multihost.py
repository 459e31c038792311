"""The port's multihost helpers against ``ccvm_tpu/parallel/multihost.py``
(CPU).

``run_resilient`` is run on the same items and the same failing work
function by both packages: the same results, the same failures map (the
same exception types and messages), the same calls to ``on_failure`` and the
same order of attempts.  ``local_shard_bounds``, ``process_index`` and
``is_coordinator`` are held against the JAX ones on one process, and on a
pretended process group of four (the JAX side's process count and index
patched, the port's ``torch.distributed`` state patched alike).
``initialize`` is held to the JAX helper's rules on one process (nothing
configured: a single-process run; a bad explicit configuration: it
raises); tests/test_torch_mesh.py and tests/test_torch_multihost_run.py
run it in worlds of several processes.
"""

from __future__ import annotations

import jax
import pytest
import torch.distributed as dist

from ccvm_tpu.parallel import multihost as jmultihost
from ccvm_tpu_torch import parallel
from ccvm_tpu_torch.parallel import multihost


def _flaky(log, fail_until):
    """A work function that records each attempt and raises for an item
    until its ``fail_until[item]``-th attempt (never succeeding for -1)."""
    attempts = {}

    def fn(item):
        attempts[item] = attempts.get(item, 0) + 1
        log.append((item, attempts[item]))
        limit = fail_until.get(item, 0)
        if limit == -1 or attempts[item] <= limit:
            raise RuntimeError(f"{item} failed on attempt {attempts[item]}")
        return item * 10

    return fn


def _run(module, items, fail_until, **kwargs):
    log, seen = [], []
    on_failure = kwargs.pop("on_failure", None)

    def record(item, exc, attempt):
        seen.append((item, str(exc), attempt))
        return on_failure(item, exc, attempt) if on_failure else None

    results, failures = module.run_resilient(items, _flaky(log, fail_until),
                                             on_failure=record, **kwargs)
    return results, {i: (type(e), str(e)) for i, e in failures.items()}, log, seen


@pytest.mark.parametrize("max_attempts", [1, 2, 3, 4])
@pytest.mark.parametrize("fail_until", [{}, {2: 1}, {2: 2, 4: 1}, {1: -1, 3: 2},
                                        {0: -1, 1: -1, 2: -1, 3: -1, 4: -1}])
def test_run_resilient_equals_jax(fail_until, max_attempts):
    items = [0, 1, 2, 3, 4]
    ours = _run(multihost, items, fail_until, max_attempts=max_attempts)
    theirs = _run(jmultihost, items, fail_until, max_attempts=max_attempts)
    assert ours == theirs
    results, failures, _, _ = ours
    assert set(results) | set(failures) == set(range(len(items)))
    for i in failures:
        assert fail_until[i] == -1 or fail_until[i] >= max_attempts


def test_on_failure_false_cancels_the_retries_as_jax_does():
    """An ``on_failure`` that returns False lands the item in the failures
    map at once; one that returns None keeps retrying."""
    items = [0, 1, 2]
    fail_until = {0: -1, 1: 1, 2: -1}

    def cancel_zero(item, exc, attempt):
        return False if item == 0 else None

    ours = _run(multihost, items, fail_until, max_attempts=3, on_failure=cancel_zero)
    theirs = _run(jmultihost, items, fail_until, max_attempts=3, on_failure=cancel_zero)
    assert ours == theirs
    results, failures, log, _ = ours
    assert results == {1: 10}
    assert sorted(failures) == [0, 2]
    assert log.count((0, 1)) == 1 and (0, 2) not in log
    assert (2, 3) in log and (2, 4) not in log


def test_package_exports_the_three_helpers():
    assert parallel.run_resilient is multihost.run_resilient
    assert parallel.local_shard_bounds is multihost.local_shard_bounds
    assert parallel.is_coordinator is multihost.is_coordinator
    assert parallel.initialize is multihost.initialize
    assert parallel.global_batch_mesh is multihost.global_batch_mesh
    assert parallel.process_allgather is multihost.process_allgather


@pytest.mark.parametrize("total", [0, 1, 7, 50, 301])
def test_one_process_owns_everything(total):
    assert not dist.is_initialized()
    assert multihost.local_shard_bounds(total) == jmultihost.local_shard_bounds(total) \
        == (0, total)
    assert multihost.process_index() == 0 == jax.process_index()
    assert multihost.is_coordinator() is True is jmultihost.is_coordinator()


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
@pytest.mark.parametrize("total", [0, 3, 7, 50])
def test_shard_bounds_of_a_process_group_equal_jax_s(monkeypatch, rank, total):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    assert multihost.local_shard_bounds(total) == jmultihost.local_shard_bounds(total)
    assert multihost.process_index() == rank
    assert multihost.is_coordinator() == jmultihost.is_coordinator() == (rank == 0)


def test_initialize_without_a_configuration_is_a_single_process_run(monkeypatch):
    """No coordinator and no torchrun environment: no group to join, as the
    JAX helper logs and carries on (ccvm_tpu/parallel/multihost.py:65-67)."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    multihost.initialize()
    multihost.initialize(device="cpu")
    assert not dist.is_initialized()
    assert multihost.process_index() == 0 and multihost.local_shard_bounds(3) == (0, 3)


@pytest.mark.parametrize("config,match", [
    (dict(num_processes=2, process_id=2, device="cpu"), "process 2 is not one of 2"),
    (dict(coordinator_address="localhost:1", num_processes=1, process_id=0,
          device="cuda"), "has no card"),
], ids=["rank out of range", "cuda without a card"])
def test_initialize_raises_under_an_explicit_bad_configuration(monkeypatch, config, match):
    """A configured run that cannot start raises, as the JAX helper does
    (:57-64): going on alone would compute 1/N of the sweep."""
    monkeypatch.setattr("torch.cuda.device_count", lambda: 0)
    with pytest.raises(RuntimeError, match=match):
        multihost.initialize(**config)
    assert not dist.is_initialized()


def test_a_mesh_over_every_card_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        multihost.global_batch_mesh()
