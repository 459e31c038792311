"""The measured window and its arithmetic.

Calls run back to back from the window's start; the last call is the one
that starts before ``seconds`` have passed, and the window closes when it
returns, so every call in it is whole.  The rate is all the work of the
window over all its time; the tail is over the walls of all its calls.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class CallRecord:
    index: int
    size: int
    start: float
    wall: float
    work: float = 0.0  # trajectory-iterations
    instances: int = 1
    batch: int = 0
    pp_s: float = 0.0  # the refinement's wall, as the Solutions report it
    failed: bool = False


@dataclass
class Window:
    start: float
    end: float
    calls: list = field(default_factory=list)

    @property
    def seconds(self):
        return self.end - self.start

    @property
    def done(self):
        return [c for c in self.calls if not c.failed]


def run(calls, execute, seconds, clock=time.perf_counter):
    """Run ``execute(call)`` (which returns a CallRecord's extra fields as a
    dict, or raises) on ``calls`` in order until one starts at or after
    ``seconds``; returns the Window."""
    start = clock()
    window = Window(start, start)
    for call in calls:
        t0 = clock()
        if t0 - start >= seconds:
            break
        try:
            extra = execute(call)
            failed = False
        except Exception as e:  # a failed call is counted, and the run goes on
            import traceback

            traceback.print_exception(e)
            extra, failed = {}, True
        t1 = clock()
        window.calls.append(CallRecord(index=call.index, size=call.size, start=t0,
                                       wall=t1 - t0, failed=failed, **extra))
        window.end = t1
    else:
        raise RuntimeError("the plan ran out of calls before the window closed")
    return window


def rate(window):
    """Work completed per second over the whole window."""
    return sum(c.work for c in window.done) / window.seconds


def percentile(values, q):
    """The q-th percentile, linear between the closest ranks."""
    return float(np.percentile(np.asarray(values, np.float64), q))
