"""Time-to-solution (TTS) metric with Beta-posterior bootstrap (a copy of
``ccvm_tpu/ccvmplotlib/utils/sampleTTSmetric.py``).

Statistical contract shared with the reference
(``ccvm_simulators/ccvmplotlib/utils/sampleTTSmetric.py:123-214``):

  * R99 = ln(1 - confidence) / ln(1 - p), clamped to >= 1 (1 at p = 1,
    infinite at p = 0);
  * per-problem success probabilities get a Beta(0.5, 0.5)-prior posterior
    (alpha = 0.5 + successes, beta = 0.5 + failures);
  * the bootstrap resamples problems with replacement, draws one posterior
    probability per resampled problem, and records a percentile of the
    resulting R99 sample per bootstrap round;
  * TTS = mean(R99 percentile over rounds) x mean machine time.

The implementation is original: one vectorised ``(rounds, problems)``
resampling core (:meth:`_bootstrap_r99`) feeds every entry point — the
per-element Python loops of the reference are gone, and a single set of
draws serves all requested percentiles.  Seeded runs are deterministic for
a given ``numpy`` ``RandomState`` seed (the JAX package's copy is pinned
by ``tests/unit/ccvmplotlib/test_sample_tts_metric.py``, and
``tests/test_torch_metadata_plot.py`` holds this one equal to it).
"""

from __future__ import annotations

import sys
from typing import Union

import numpy
from scipy.stats import beta as beta_distribution

from ccvm_tpu_torch.ccvmplotlib.utils.metric import Metric

_PRIOR = 0.5  # Jeffreys Beta(0.5, 0.5) prior on the success probability


class SampleTTSMetric(Metric):
    """Time to solution (TTS) metric."""

    def __init__(
        self,
        tau_attribute: str,
        percentile: float = 50.0,
        confidence: float = 0.99,
        num_bootstraps: int = 100,
        failure_fill_in_value: float = sys.float_info.max,
        tolerance: float = 1e-5,
        seed: int = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if not 0 < confidence < 1:
            raise ValueError("confidence must be between 0 and 1")
        self.name = "tts"
        self.tau_attribute = tau_attribute
        self.percentile = percentile
        self.confidence = confidence
        self.num_bootstraps = num_bootstraps
        self.failure_fill_in_value = failure_fill_in_value
        self.tolerance = tolerance
        self._rng = numpy.random.RandomState(seed)

    # ------------------------------------------------------------------
    # R99 core
    # ------------------------------------------------------------------

    def _log_miss(self) -> float:
        """ln(1 - confidence); the R99 numerator."""
        return float(numpy.log1p(-self.confidence))

    def calc_R99(self, success_probability: float) -> float:
        """Independent runs needed to see the best known energy at least
        once with the configured confidence; clamped to >= 1."""
        if not 0 < self.confidence < 1:
            raise ValueError("confidence must be between 0 and 1")
        if success_probability <= 0.0:
            return numpy.inf
        if success_probability >= 1.0:
            return 1.0
        raw = self._log_miss() / numpy.log1p(-success_probability)
        return raw if raw > 1.0 else 1.0

    def _bootstrap_r99(self, success_probabilities, num_repeats: int):
        """All bootstrap rounds at once: a ``(num_bootstraps, n)`` matrix of
        clamped R99 values drawn from the Beta posteriors of resampled
        problems.  Every percentile statistic reads off this one matrix."""
        p = numpy.asarray(success_probabilities, dtype=float)
        n = p.size
        alphas = _PRIOR + p * num_repeats
        betas = _PRIOR + (1.0 - p) * num_repeats

        picks = self._rng.randint(0, n, size=(self.num_bootstraps, n))
        quantiles = self._rng.uniform(size=(self.num_bootstraps, n))
        drawn = beta_distribution.ppf(quantiles, alphas[picks], betas[picks])

        with numpy.errstate(divide="ignore", invalid="ignore"):
            r99 = self._log_miss() / numpy.log1p(-drawn)
        r99 = numpy.where(drawn <= 0.0, numpy.inf, r99)
        r99 = numpy.where(drawn >= 1.0, 1.0, r99)
        return numpy.maximum(r99, 1.0)

    def calc_R99_distribution(
        self, success_probabilities, num_repeats: int
    ) -> numpy.ndarray:
        """One R99 percentile per bootstrap round (shape
        ``(num_bootstraps,)``)."""
        matrix = self._bootstrap_r99(success_probabilities, num_repeats)
        return numpy.percentile(matrix, self.percentile, axis=1)

    def calc_R99_quartile_means(
        self, success_probabilities, num_repeats: int, percentiles=(25, 50, 75)
    ) -> dict:
        """Mean (over rounds) of several R99 percentiles from ONE set of
        bootstrap draws."""
        matrix = self._bootstrap_r99(success_probabilities, num_repeats)
        per_round = numpy.percentile(matrix, list(percentiles), axis=1)
        return {
            pct: float(per_round[k].mean())
            for k, pct in enumerate(percentiles)
        }

    # ------------------------------------------------------------------
    # Success probabilities
    # ------------------------------------------------------------------

    def calc_success_probability(
        self, solutions: Union[list, dict], best_known_energy: float
    ) -> float:
        """Fraction of solutions at or below best_known_energy + tolerance."""
        threshold = best_known_energy + self.tolerance
        hits = sum(1 for s in solutions if s["best_energy"] < threshold)
        return hits / float(len(solutions))

    def calc_success_probabilities(self, results, best_known_energies):
        """Success probability for each problem."""
        return numpy.fromiter(
            (
                self.calc_success_probability(result, energy)
                for result, energy in zip(results, best_known_energies)
            ),
            dtype=float,
            count=len(results),
        )

    # ------------------------------------------------------------------
    # TTS
    # ------------------------------------------------------------------

    def calc(self, results, best_known_energies, **kwargs):
        """Mean and std of the sample TTS at the configured percentile.

        Returns the fill-in value pair when fewer than ``percentile``% of the
        problems were ever solved (the percentile of R99 would be infinite).
        """
        probabilities = self.calc_success_probabilities(
            results, best_known_energies
        )

        solved_fraction = float((probabilities > 0).mean())
        if solved_fraction < self.percentile / 100.0:
            mean_tts = std_tts = numpy.inf
        else:
            r99 = self.calc_R99_distribution(
                probabilities, self.num_solutions_per_result(results)
            )
            mean_r99, var_r99 = r99.mean(), r99.var()
            count, mean_tau, m2 = _tau_moments(results, self.tau_attribute)
            var_tau = m2 / count
            mean_tts = mean_r99 * mean_tau
            # Var(R * tau) for independent R, tau
            std_tts = numpy.sqrt(
                var_r99 * var_tau
                + mean_r99**2 * var_tau
                + mean_tau**2 * var_r99
            )

        if self.failure_fill_in_value is not None:
            mean_tts = self.fill_in_value(mean_tts, self.failure_fill_in_value)
            std_tts = self.fill_in_value(std_tts, self.failure_fill_in_value)

        return mean_tts, std_tts


def _tau_moments(results, key):
    """Welford moments of the machine-time attribute across all solutions."""
    from ccvm_tpu_torch.ccvmplotlib.utils.utilities import running_moments

    return running_moments(
        element[key] for result in results for element in result
    )
