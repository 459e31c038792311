"""Streaming statistics over plain iterables (a copy of
``ccvm_tpu/ccvmplotlib/utils/utilities.py``).

Same call surface as the reference's iterator helpers
(``ccvm_simulators/ccvmplotlib/utils/utilities.py``) but implemented as a
single Welford accumulation pass — numerically stable for long streams,
and both statistics come from one shared routine instead of two
near-duplicate loops.
"""

from __future__ import annotations


def running_moments(iterable):
    """One pass of Welford's algorithm.

    Returns ``(count, mean, m2)`` where ``m2`` is the sum of squared
    deviations from the running mean; population variance is ``m2 / count``.
    """
    count = 0
    mean = 0.0
    m2 = 0.0
    for x in iterable:
        count += 1
        delta = x - mean
        mean += delta / count
        m2 += delta * (x - mean)
    return count, mean, m2


def imean(iterator) -> float:
    """Mean of an iterator's elements."""
    count, mean, _ = running_moments(iterator)
    return mean if count else 0.0 / 0.0


def ivariance(iterator) -> float:
    """Population variance of an iterator's elements."""
    count, _, m2 = running_moments(iterator)
    return m2 / count
