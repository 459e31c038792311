"""BoxQP metadata -> plotting data (a copy of
``ccvm_tpu/ccvmplotlib/problem_metadata/boxqp_metadata.py``).

Produces the same plotting-table contract as the reference
(``ccvm_simulators/ccvmplotlib/problem_metadata/boxqp_metadata.py``): a
DataFrame indexed by problem size with (gap-level, percentile) MultiIndex
columns where each TTS cell is ``metric_value x mean(bootstrapped R99
percentile)`` and is ``inf`` whenever fewer than percentile% of the size's
instances were ever solved at that gap.

The implementation is original: ingest uses ``pandas.json_normalize`` (the
reference hand-flattens each record from a ``json_stream`` reader), plot
data is built size-by-size with a single vectorized Beta-posterior bootstrap
per (size, gap) shared across all three percentiles (the reference runs a
fresh 100-iteration bootstrap loop per percentile), and success
probabilities are one ``groupby().mean()``.
"""

from __future__ import annotations

import json

import numpy as np
import pandas as pd

from ccvm_tpu_torch.ccvmplotlib.problem_metadata.problem_metadata import (
    ProblemMetadata,
    ProblemType,
)
from ccvm_tpu_torch.ccvmplotlib.utils.sampleTTSmetric import SampleTTSMetric

_PERF_PREFIX = "solution_performance."
_QUARTILES = (25, 50, 75)


class BoxQPMetadata(ProblemMetadata):
    """BoxQP problem-specific metadata -> TTS/ETS/success-prob plot data."""

    def __init__(self, problem: ProblemType) -> None:
        super().__init__(problem)
        self._df: pd.DataFrame = pd.DataFrame()
        self._gaps: list[str] = []
        self._batch_size: int = 0

    @property
    def _sizes(self) -> list[int]:
        return sorted(int(s) for s in self._df["problem_size"].unique())

    def ingest_metadata(self, metadata_filepath: str) -> None:
        """Load a metadata JSON file into a flat DataFrame.

        The per-result ``solution_performance`` dict is flattened into one
        column per gap level; every other key stays a column of its own.
        """
        with open(metadata_filepath, "r") as f:
            payload = json.load(f)

        records = payload["result_metadata"]
        if not records:
            raise ValueError(f"{metadata_filepath} contains no results")
        first_perf = records[0].get("solution_performance")
        if not isinstance(first_perf, dict):
            raise KeyError(
                "result_metadata entries must carry a solution_performance dict"
            )
        self._gaps = list(first_perf.keys())

        df = pd.json_normalize(records)
        df.columns = [
            c[len(_PERF_PREFIX):] if c.startswith(_PERF_PREFIX) else c
            for c in df.columns
        ]
        missing = {"problem_size", "batch_size", *self._gaps} - set(df.columns)
        if missing:
            raise KeyError(f"metadata missing required fields: {sorted(missing)}")
        self._df = df
        self._batch_size = int(df["batch_size"].iloc[0])

    def _columns(self) -> pd.MultiIndex:
        return pd.MultiIndex.from_product(
            [self._gaps, [str(q) for q in _QUARTILES] + ["success_prob"]],
            names=["Optimality Type", "Percentile"],
        )

    def generate_plot_data(self, metric_func) -> pd.DataFrame:
        """TTS (or ETS) per (size, gap, quartile).

        One bootstrap sample of Beta-posterior success probabilities is drawn
        per (size, gap) and all three R99 quartiles are read off the same
        draws; the reference's statistic (mean over bootstraps of the
        per-bootstrap R99 percentile, scaled by the machine metric) is
        unchanged.
        """
        sampler = SampleTTSMetric(
            tau_attribute="time", seed=1, num_bootstraps=100
        )
        rows: dict[int, dict] = {}
        for size, group in self._df.groupby("problem_size", sort=True):
            size = int(size)
            tau = metric_func(dataframe=group, problem_size=size)
            cells: dict[tuple, float] = {}
            for gap in self._gaps:
                p = group[gap].to_numpy(dtype=float)
                ever_solved = float((p > 0).mean())
                quartile_means = sampler.calc_R99_quartile_means(
                    p, self._batch_size, _QUARTILES
                )
                for q in _QUARTILES:
                    if ever_solved < q / 100.0:
                        cells[(gap, str(q))] = np.inf
                    else:
                        cells[(gap, str(q))] = tau * quartile_means[q]
                cells[(gap, "success_prob")] = np.nan
            rows[size] = cells

        table = pd.DataFrame.from_dict(rows, orient="index")
        table = table.reindex(columns=self._columns())
        table.index.name = "Problem Size (N)"
        return table

    def generate_success_prob_plot_data(self) -> pd.DataFrame:
        """Mean success probability per (size, gap)."""
        means = self._df.groupby("problem_size", sort=True)[self._gaps].mean()
        table = pd.DataFrame(
            index=means.index.astype(int), columns=self._columns()
        )
        for gap in self._gaps:
            table[(gap, "success_prob")] = means[gap].to_numpy(dtype=float)
        table.index.name = "Problem Size (N)"
        return table
