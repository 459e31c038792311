"""Profiling and observability hooks (the counterpart of
``ccvm_tpu/profiling.py``).

The reference's only instrumentation is ``time.time()`` spans divided by the
batch size (``dl_solver.py:851,929-933``).  The same ``solve_time`` /
``pp_time`` semantics stay on the Solution object, and this module adds:

* :func:`trace` — a context manager around ``torch.profiler`` (host
  activity, and the card's kernels and copies when a card is present) that
  writes a Chrome-format trace which Perfetto and TensorBoard open;
* :func:`annotate` — named regions in that trace (and NVTX ranges on the
  card);
* :class:`Timer` — a wall-clock span that waits for the result's device;
* :func:`solve_rate` — iterations/s and trajectory-iterations/s/chip
  counters from a finished Solution.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a profiler trace of everything inside the ``with`` block and
    write it to ``log_dir`` as ``<pid>.<time_ns>.pt.trace.json``.

    Usage::

        with ccvm_tpu_torch.profiling.trace("ccvm-trace") as prof:
            solution = solver(instance, seed=0)

    The context yields the ``torch.profiler.profile`` (its
    ``key_averages()``, ``events()``).  ``create_perfetto_link`` is kept for
    the JAX signature: the trace file is written either way, and no link is
    made (open the file in Perfetto's UI or TensorBoard).
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        logger.info("Wrote torch profiler trace to %s", path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline
    (``torch.profiler.record_function``), and an NVTX range when a card is
    present."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def _synchronize(out):
    """Wait for every card that holds a tensor of ``out`` (a tensor or a
    nested tuple or list of them)."""
    if isinstance(out, (tuple, list)):
        for x in out:
            _synchronize(x)
    elif isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


class Timer:
    """Wall-clock span with the reference's per-batch normalization semantics.

    ``Timer(batch_size)(fn, *args)`` returns ``(result, per_batch_seconds)``,
    matching how the reference divides solve_time by batch size
    (``dl_solver.py:929-933``); the span ends when the result's card has
    finished.
    """

    def __init__(self, batch_size: int = 1):
        self.batch_size = batch_size
        self.elapsed = 0.0

    def __call__(self, fn, *args, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        _synchronize(out)
        self.elapsed = time.perf_counter() - start
        return out, self.elapsed / self.batch_size


def solve_rate(solution, num_chips: int = 1) -> dict:
    """Throughput counters for a finished Solution.

    Returns a dict with:
      * ``iterations_per_sec`` — SDE steps per wall second,
      * ``trajectory_iterations_per_sec`` — steps x batch per wall second,
      * ``trajectory_iterations_per_sec_per_chip`` — the BASELINE.json metric.

    ``solution.solve_time`` is per-batch-normalized (reference semantics), so
    the raw wall time is ``solve_time * batch_size``.
    """
    wall = solution.solve_time * solution.batch_size
    if wall <= 0:
        return {
            "iterations_per_sec": float("inf"),
            "trajectory_iterations_per_sec": float("inf"),
            "trajectory_iterations_per_sec_per_chip": float("inf"),
        }
    it_rate = solution.iterations / wall
    traj_rate = it_rate * solution.batch_size
    return {
        "iterations_per_sec": it_rate,
        "trajectory_iterations_per_sec": traj_rate,
        "trajectory_iterations_per_sec_per_chip": traj_rate / max(num_chips, 1),
    }
