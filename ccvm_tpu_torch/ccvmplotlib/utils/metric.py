"""Metric base class for the plotting library (a copy of
``ccvm_tpu/ccvmplotlib/utils/metric.py``).

Same call surface as the reference's
(``ccvm_simulators/ccvmplotlib/utils/metric.py``): subclasses implement
``calc`` and inherit the nested-result aggregation helpers, which here share
one flattening generator and the Welford accumulator from
:mod:`ccvm_tpu_torch.ccvmplotlib.utils.utilities`.
"""

from __future__ import annotations

import numpy

from ccvm_tpu_torch.ccvmplotlib.utils.mixins import StrDictMixIn
from ccvm_tpu_torch.ccvmplotlib.utils.utilities import running_moments


def _flat_values(results, key):
    """Yield ``element[key]`` across the nested results list."""
    for result in results:
        for element in result:
            yield element[key]


class Metric(StrDictMixIn):
    """Parent Metric class: inherit all other metrics from this class."""

    def __init__(self, goal: str = "minimize"):
        self.goal = goal

    def calc(self, results, best_known_energies, **kwargs):
        """Placeholder: calculate the metric value."""

    @staticmethod
    def overall_mean(results, key) -> float:
        """Overall average of the quantity corresponding to ``key``."""
        _, mean, _ = running_moments(_flat_values(results, key))
        return mean

    @staticmethod
    def overall_variance(results, key) -> float:
        """Population variance of the quantity corresponding to ``key``."""
        count, _, m2 = running_moments(_flat_values(results, key))
        return m2 / count

    @staticmethod
    def num_solutions_per_result(results) -> int:
        """Number of solutions per result; all results must agree."""
        lengths = {len(result) for result in results}
        if not lengths:
            return 0
        if len(lengths) > 1:
            raise ValueError("Number of solutions not the same for all results")
        return lengths.pop()

    @staticmethod
    def fill_in_value(value: float, failure_fill_in_value: float) -> float:
        """Replace a non-finite value with the fill-in value."""
        return value if numpy.isfinite(value) else failure_fill_in_value
