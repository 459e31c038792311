"""Plotting library for CCVM solver results (a copy of
``ccvm_tpu/ccvmplotlib/ccvmplotlib.py``).

API parity with ``ccvm_simulators/ccvmplotlib/ccvmplotlib.py`` (same public
entry points, same metadata-JSON-in / (fig, ax)-out contract: ``plot_TTS`` /
``plot_ETS`` draw a median line with an inter-quartile band per gap level on
a log axis; ``plot_success_prob`` draws mean success per gap level), with an
original implementation: the quartile renderer works off vectorized slices
of the plotting table rather than per-column loops over the MultiIndex, and
the TTS axis window is derived from the median matrix in one pass.
"""

from __future__ import annotations

import matplotlib
import matplotlib.pyplot as plt
import numpy as np

from ccvm_tpu_torch.ccvmplotlib.problem_metadata import ProblemMetadataFactory

TTS_UPPER_LIMIT = 1e20  # Roughly the age of the universe in seconds.
_TTS_WINDOW_DECADES = 6  # Cap the visible band this many decades above best.
PERC_GAP_LABEL_MAP = {
    "optimal": r"0.1% gap",
    "one_percent": r"1% gap",
    "two_percent": r"2% gap",
    "three_percent": r"3% gap",
    "four_percent": r"4% gap",
    "five_percent": r"5% gap",
    "ten_percent": r"10% gap",
}


def _load_plot_table(metadata_filepath, problem, metric_func=None):
    """metadata JSON -> plotting DataFrame via the problem-metadata layer."""
    meta = ProblemMetadataFactory.create_problem_metadata(problem)
    meta.ingest_metadata(metadata_filepath)
    if metric_func is None:
        return meta.generate_success_prob_plot_data()
    return meta.generate_plot_data(metric_func=metric_func)


def _gap_palette(gaps):
    """One rainbow color per gap level."""
    cmap = matplotlib.colormaps["rainbow"]
    if len(gaps) == 1:
        return {gaps[0]: cmap(0.0)}
    return {g: cmap(k / (len(gaps) - 1)) for k, g in enumerate(gaps)}


def _quartile_slices(table):
    """(sizes, gaps, q25, q50, q75) as plain numpy from the plotting table."""
    sizes = np.asarray(table.index)
    gaps = list(table.columns.levels[0])
    per_q = {
        q: table.loc[:, (slice(None), q)].droplevel(1, axis=1)[gaps]
        .to_numpy(dtype=float)
        for q in ("25", "50", "75")
    }
    return sizes, gaps, per_q["25"], per_q["50"], per_q["75"]


class ccvmplotlib:
    """A generic plotting library for problems solved by CCVM solvers."""

    @staticmethod
    def _render_quartile_bands(table, fig=None, ax=None):
        """Median line + inter-quartile band per gap level."""
        if fig is None or ax is None:
            fig, ax = plt.subplots()
        sizes, gaps, lo, mid, hi = _quartile_slices(table)
        palette = _gap_palette(gaps)
        for k, gap in enumerate(gaps):
            color = palette[gap]
            ax.fill_between(sizes, lo[:, k], hi[:, k], color=color, alpha=0.25)
            ax.plot(
                sizes, mid[:, k],
                marker="s", linewidth=3.0, color=color,
                label=PERC_GAP_LABEL_MAP.get(gap, gap),
            )
        # Legend keys for the statistics themselves.
        ax.plot([], [], marker="s", linewidth=3.0, color="black",
                label="(median)")
        ax.fill_between([], [], alpha=0.25, label="(IQR)")
        return fig, ax

    @staticmethod
    def plot_TTS(metadata_filepath, problem, machine_time_func, fig=None,
                 ax=None):
        """Plot Time-To-Solution vs problem size.

        Raises:
            ValueError: when every median TTS exceeds the plottable limit
                (nothing was ever solved).
        """
        table = _load_plot_table(metadata_filepath, problem, machine_time_func)
        fig, ax = ccvmplotlib._render_quartile_bands(table, fig, ax)

        _, _, _, medians, _ = _quartile_slices(table)
        best = np.nanmin(medians)
        if not best < TTS_UPPER_LIMIT:
            raise ValueError(
                "TTS values are too large to plot. Please check the result"
                f" data. Minimum TTS median value: {best}"
            )
        # Window: one decade of margin around the medians, capped at
        # _TTS_WINDOW_DECADES decades above the best median so a few
        # unsolved-at-this-gap infinities cannot flatten the whole plot.
        worst_shown = min(np.nanmax(medians[np.isfinite(medians)]),
                          best * 10.0 ** _TTS_WINDOW_DECADES)
        ax.set_yscale("log")
        ax.set_ylim(
            10.0 ** (np.floor(np.log10(best)) - 1),
            10.0 ** (np.ceil(np.log10(worst_shown)) + 1),
        )
        ax.set_xticks(table.index)
        return fig, ax

    @staticmethod
    def plot_ETS(metadata_filepath, problem, machine_energy_func, fig=None,
                 ax=None):
        """Plot Energy-To-Solution vs problem size."""
        table = _load_plot_table(metadata_filepath, problem,
                                 machine_energy_func)
        fig, ax = ccvmplotlib._render_quartile_bands(table, fig, ax)
        ax.set_yscale("log")
        ax.set_xticks(table.index)
        return fig, ax

    @staticmethod
    def plot_success_prob(metadata_filepath, problem, fig=None, ax=None):
        """Plot mean success probability vs problem size.

        Raises:
            ValueError: when all success probabilities are zero.
        """
        table = _load_plot_table(metadata_filepath, problem)
        if fig is None or ax is None:
            fig, ax = plt.subplots()

        sizes = np.asarray(table.index)
        gaps = list(table.columns.levels[0])
        probs = (
            table.loc[:, (slice(None), "success_prob")]
            .droplevel(1, axis=1)[gaps]
            .to_numpy(dtype=float)
        )
        if not (np.nanmax(probs) > 0.0):
            raise ValueError(
                "Success Probability values are all 0.0. Please check the"
                " result data."
            )
        palette = _gap_palette(gaps)
        for k, gap in enumerate(gaps):
            ax.plot(
                sizes, probs[:, k], marker="s", color=palette[gap],
                label=PERC_GAP_LABEL_MAP.get(gap, gap),
            )
        ax.set_yscale("log")
        ax.set_xticks(sizes)
        return fig, ax

    # ----- default styling (same look knobs the reference exposes) -----

    @staticmethod
    def set_default_figsize(fig) -> None:
        fig.set_size_inches(8.0, 7.0)

    @staticmethod
    def set_default_xlabel(ax, xlabel: str) -> None:
        ax.set_xlabel(xlabel=xlabel, fontdict={"family": "serif", "size": 36})

    @staticmethod
    def set_default_ylabel(ax, ylabel: str) -> None:
        ax.set_ylabel(ylabel=ylabel, fontdict={"family": "serif", "size": 36})

    @staticmethod
    def set_default_ticks(ax) -> None:
        ax.tick_params(axis="both", labelsize=32)

    @staticmethod
    def set_default_legend(ax) -> None:
        """Order legend entries: gap levels first, then the statistic keys."""
        handles, labels = ax.get_legend_handles_labels()
        preferred = list(PERC_GAP_LABEL_MAP.values()) + ["(median)", "(IQR)"]
        order = [labels.index(lbl) for lbl in preferred if lbl in labels]
        ax.legend(
            [handles[i] for i in order],
            [labels[i] for i in order],
            loc="best", ncol=2,
        )

    @staticmethod
    def set_default_grid(ax) -> None:
        ax.grid(visible=True, which="major", axis="both", color="#666666",
                linestyle="--")

    @staticmethod
    def _apply_default_styling(fig, ax, ylabel: str) -> None:
        ccvmplotlib.set_default_figsize(fig)
        ccvmplotlib.set_default_xlabel(ax, "Problem Size, $N$")
        ccvmplotlib.set_default_ylabel(ax, ylabel)
        ccvmplotlib.set_default_ticks(ax)
        ccvmplotlib.set_default_legend(ax)
        ccvmplotlib.set_default_grid(ax)
        fig.tight_layout()

    @staticmethod
    def apply_default_tts_styling(fig, ax) -> None:
        ccvmplotlib._apply_default_styling(fig, ax, "TTS (seconds)")

    @staticmethod
    def apply_default_ets_styling(fig, ax) -> None:
        ccvmplotlib._apply_default_styling(fig, ax, "ETS (joules)")

    @staticmethod
    def apply_default_succ_prob_styling(fig, ax) -> None:
        ccvmplotlib._apply_default_styling(fig, ax, "Success Probability")
