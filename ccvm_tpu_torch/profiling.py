"""Profiling and observability hooks (the counterpart of
``ccvm_tpu/profiling.py``).

The reference's only instrumentation is ``time.time()`` spans divided by the
batch size (``dl_solver.py:851,929-933``).  The same ``solve_time`` /
``pp_time`` semantics stay on the Solution object, and this module adds:

* :func:`trace` — a context manager around ``torch.profiler`` (host
  activity, and the card's kernels and copies when a card is present) that
  writes a Chrome-format trace which Perfetto and TensorBoard open;
* :class:`annotate` — the program's one span primitive: a named region in
  that trace (and an NVTX range on the card), with :func:`count` for the
  counters of the innermost open span;
* :func:`spans` — the records of the spans that ran while tracing was on.

Tracing is on exactly while a ``torch.profiler`` profile runs (:func:`trace`,
or any other).  Off, a span makes one boolean check (besides its NVTX range
on a card) and a counter one; neither records anything.  On, a span also
opens ``torch.profiler.record_function(name)``, so it appears on the
trace's timeline beside the device's kernels and copies, and appends one
:class:`Span` record to an in-process ring of :data:`STORE_SIZE` records.
Spans nest on a per-thread stack.  No span or counter synchronises the
device or reads a device value.

The program opens these spans (``ccvm.call`` and ``ccvm.load`` are roots;
``ccvm.scale`` is one too, except under ``sweep_solve(scale=True)``):

* ``ccvm.call``: a façade's ``__call__``; ``parallel.sweep_solve``;
* ``ccvm.sync``: an explicit wait for the card (the façades' under
  ``timing="sync"``; the sweep's for its solve and its refinement);
* ``ccvm.postprocess``: the refinement;
* ``ccvm.readout``: ``compute_energy_readout64``; ``stacked_readout64``;
* ``ccvm.statistics``: ``Solution``'s best objective and gap fractions;
* ``ccvm.load``: ``ProblemInstance.load_instance``;
* ``ccvm.parse``: ``parse_instance_file``;
* ``ccvm.scale``: ``ProblemInstance.scale_coefs``;

and counts ``host_syncs`` (each point where the host waits for device
results: an explicit synchronise, a device-to-host copy, a Python number
or bool of a device tensor; counted on "cpu" at the same points) and
``rows64`` (rows the readout recomputes in float64).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger(__name__)

STORE_SIZE = 262_144
"""Records the span store keeps; the oldest go first."""

_store = collections.deque(maxlen=STORE_SIZE)
_local = threading.local()
_call_ids = itertools.count(1)
_nvtx = None  # whether a card is present, read at the first span


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


@dataclass(eq=False, slots=True)
class Span:
    """One span that ran while tracing was on.

    ``start`` and ``end`` are ``time.perf_counter()`` seconds (``end`` None
    while it is open); ``cpu_s`` the thread CPU seconds
    (``time.thread_time()``) it took; ``parent`` the span it ran in (None
    for a root); ``call`` an id shared by every span under one root;
    ``counts`` what :func:`count` added while it was the innermost open
    span."""

    name: str
    start: float
    parent: Span | None
    call: int
    end: float | None = None
    cpu_s: float = 0.0
    counts: dict = field(default_factory=dict)


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class annotate:
    """A named region of the program: ``with annotate(name):``, or
    ``@annotate(name)`` on a function.

    On a card it is an NVTX range.  While a ``torch.profiler`` profile runs
    it is also a ``torch.profiler.record_function`` region and a
    :class:`Span` record in :func:`spans`."""

    __slots__ = ("name", "_span", "_cpu0", "_region")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _nvtx
        if _nvtx is None:
            _nvtx = torch.cuda.is_available()
        if _nvtx:
            torch.cuda.nvtx.range_push(self.name)
        if not _autograd_profiler._is_profiler_enabled:
            self._span = None
            return self
        stack = _stack()
        parent = stack[-1] if stack else None
        self._region = _autograd_profiler.record_function(self.name)
        self._region.__enter__()
        span = Span(self.name, time.perf_counter(), parent,
                    parent.call if parent is not None else next(_call_ids))
        self._cpu0 = time.thread_time()
        stack.append(span)
        _store.append(span)
        self._span = span
        return self

    def __exit__(self, *exc):
        span = self._span
        if span is not None:
            span.cpu_s = time.thread_time() - self._cpu0
            span.end = time.perf_counter()
            _stack().pop()
            self._region.__exit__(*exc)
        if _nvtx:
            torch.cuda.nvtx.range_pop()

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)

        return spanned


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` of the innermost open span (nothing
    when tracing is off or no span is open)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def spans() -> list:
    """The stored :class:`Span` records, oldest first: the latest
    :data:`STORE_SIZE` spans that ran while tracing was on."""
    return list(_store)
