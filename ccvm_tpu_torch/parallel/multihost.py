"""Multi-process runtime helpers (the twin of
``ccvm_tpu/parallel/multihost.py``, on ``torch.distributed``).

Multi-process scaling is: :func:`initialize` once per process (from its
arguments or from torchrun's environment), a global mesh over every rank
(:func:`global_batch_mesh`), batch or instance axes sharded over it, and the
small final gathers over NCCL (cards) or gloo (CPU).  Process 0 writes
Solution / Metadata artifacts.  ``run_resilient`` is the JAX package's
failure-tolerant work loop, line for line (plain Python).
"""

from __future__ import annotations

import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# How long a rank waits for the others (to join, and at each collective).
_TIMEOUT = datetime.timedelta(seconds=300)


def _rank_and_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(coordinator_address=None, num_processes=None, process_id=None, *,
               device="cuda"):
    """Join the process group (idempotent; the twin of
    ``ccvm_tpu/parallel/multihost.py:22-67``).

    With ``coordinator_address`` ("host:port", or a ``tcp://`` or
    ``file://`` URL) or ``num_processes`` it joins the group they describe as
    ``process_id``; else, under torchrun, the one
    its environment describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, ``LOCAL_RANK``).  ``device`` "cuda" takes NCCL and the
    card ``LOCAL_RANK`` (``torch.cuda.set_device``; a rank without a card
    raises), "cpu" gloo.  A configured run that fails raises: going on as one
    process would compute 1/N of the sweep.  With nothing configured it logs
    and returns, a single-process run (tests, one-card benches) with no
    group to join."""
    if dist.is_initialized():
        return
    explicit = coordinator_address is not None or num_processes is not None
    from_env = all(k in os.environ for k in _ENV)
    if not (explicit or from_env):
        logger.info("torch.distributed not initialized (no coordinator and no "
                    "torchrun environment); single-process run")
        return
    if device not in ("cuda", "cpu"):
        raise ValueError(f'device must be "cuda" or "cpu", got {device!r}')
    try:
        if explicit:
            world = int(1 if num_processes is None else num_processes)
            rank = int(0 if process_id is None else process_id)
            if not 0 <= rank < world:
                raise ValueError(f"process {rank} is not one of {world}")
            local = int(os.environ.get("LOCAL_RANK", rank))
            address = coordinator_address or "localhost:29500"
            if "://" not in address:
                address = f"tcp://{address}"
            init = dict(init_method=address, world_size=world, rank=rank)
        else:
            local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
            init = dict(init_method="env://")
        if device == "cuda":
            cards = torch.cuda.device_count()
            if local >= cards:
                raise RuntimeError(
                    f"local rank {local} has no card ({cards} on this host): NCCL "
                    "takes one card a rank")
            torch.cuda.set_device(local)
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                timeout=_TIMEOUT, **init)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            "torch.distributed.init_process_group failed for the configured "
            f"multi-process run (coordinator={coordinator_address!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r}): {e}"
        ) from e
    logger.info("torch.distributed initialized: process %d/%d (%s)",
                dist.get_rank(), dist.get_world_size(), dist.get_backend())


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return _rank_and_world()[0]


def is_coordinator() -> bool:
    """True on the process that should write metadata/plots (process 0)."""
    return process_index() == 0


def global_batch_mesh():
    """1-D "batch" mesh over every rank of the process group (all hosts)."""
    from ccvm_tpu_torch.parallel.mesh import make_batch_mesh

    return make_batch_mesh()


def process_allgather(x, tiled=False):
    """Every process's ``x`` (a scalar, an array or a tensor), as a host
    array (``jax.experimental.multihost_utils.process_allgather``): stacked
    on a new leading axis, or with ``tiled`` concatenated along the first.
    One process gives its own ``x`` so shaped.  NCCL gathers on the card,
    gloo on the CPU."""
    t = torch.as_tensor(np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x))
    if t.ndim == 0 and tiled:
        raise ValueError("a tiled gather takes an array of at least one axis")
    _, world = _rank_and_world()
    if world == 1:
        parts = [t]
    else:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
        t = t.to(device).contiguous()
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
    out = torch.cat(parts) if tiled else torch.stack(parts)
    return out.cpu().numpy()


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
