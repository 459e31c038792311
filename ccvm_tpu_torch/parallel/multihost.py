"""Multi-process helpers: the single-process part of
``ccvm_tpu/parallel/multihost.py``, under the same names.

``run_resilient`` is the JAX package's failure-tolerant work loop, line for
line (plain Python).  ``process_index``, ``is_coordinator`` and
``local_shard_bounds`` read ``torch.distributed``'s rank and world size when
a process group is initialised, and rank 0 of 1 otherwise.  Starting a
multi-process run (``initialize``) and a mesh over every card
(``global_batch_mesh``) wait for ROADMAP queue 1 item 13.
"""

from __future__ import annotations

import logging

import torch.distributed as dist

from ccvm_tpu_torch.solvers.base import not_ported

logger = logging.getLogger(__name__)


def _rank_and_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Not ported: a multi-process run (``ccvm_tpu/parallel/multihost.py:21-67``)."""
    raise not_ported("multihost.initialize", "queue 1 item 13")


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return _rank_and_world()[0]


def is_coordinator() -> bool:
    """True on the process that should write metadata/plots (process 0)."""
    return process_index() == 0


def global_batch_mesh():
    """Not ported: a "batch" mesh over every card (``multihost.py:75-79``)."""
    raise not_ported("multihost.global_batch_mesh", "queue 1 item 13")


def local_shard_bounds(total: int) -> tuple[int, int]:
    """[start, end) rows of a length-``total`` globally sharded axis owned by
    this process — for host-side work distribution (e.g. which instance
    files this process loads in a multi-process benchmark sweep)."""
    rank, world = _rank_and_world()
    per = -(-total // world)
    start = min(per * rank, total)
    return start, min(start + per, total)


def run_resilient(items, fn, *, max_attempts=3, on_failure=None):
    """Failure-tolerant work loop for benchmark sweeps
    (``ccvm_tpu/parallel/multihost.py:91-134``).

    Runs ``fn(item)`` for every work item; an item whose attempt raises is
    re-queued at the back (up to ``max_attempts`` attempts each) so one bad
    solve — a transient device error, an out-of-memory on an oversized
    stacked batch, a build failure for an odd shape — doesn't abort a
    multi-hour sweep.

    Scope: this recovers *per-item* failures within a live process; a lost
    process is recovered by restarting it and resuming from
    :mod:`ccvm_tpu_torch.checkpoint`, not by re-queuing.

    Args:
        items: iterable of hashable-by-index work items.
        fn: ``fn(item) -> result``; exceptions mark the attempt failed.
        max_attempts: attempts per item before it lands in ``failures``.
        on_failure: optional ``on_failure(item, exc, attempt)`` callback.
            Returning ``False`` cancels further attempts for that item —
            use it to classify deterministic failures (a shape-dependent
            build error, an out-of-memory at a fixed batch) whose retries
            would burn the tail of the sweep on guaranteed re-failures.

    Returns:
        (results, failures): ``results[i]`` is ``fn(items[i])`` for items that
        succeeded; ``failures[i]`` is the last exception for items that
        exhausted their attempts.  Indices refer to the input order.
    """
    queue = [(i, item, 1) for i, item in enumerate(items)]
    results, failures = {}, {}
    while queue:
        idx, item, attempt = queue.pop(0)
        try:
            results[idx] = fn(item)
        except Exception as exc:  # noqa: BLE001 — any solve failure re-queues
            retry = True
            if on_failure is not None and on_failure(item, exc, attempt) is False:
                retry = False
            logger.warning(
                "work item %d failed (attempt %d/%d%s): %s",
                idx, attempt, max_attempts,
                "" if retry else ", cancelled by on_failure", exc,
            )
            if retry and attempt < max_attempts:
                queue.append((idx, item, attempt + 1))
            else:
                failures[idx] = exc
    return results, failures
