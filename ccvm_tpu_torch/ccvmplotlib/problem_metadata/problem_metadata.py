"""Problem metadata base types (parity with
``ccvm_simulators/ccvmplotlib/problem_metadata/problem_metadata.py``; a copy
of ``ccvm_tpu/ccvmplotlib/problem_metadata/problem_metadata.py``)."""

from abc import ABC, abstractmethod
from enum import Enum

import pandas as pd  # noqa: F401  (part of the public interface contract)


class ProblemType(Enum):
    """Problem type ENUM class."""

    BoxQP = "BoxQP"


class TTSType(Enum):
    """Time-To-Solution type: CPU time (physical) or optic device time
    (wallclock)."""

    wallclock = "wallclock"
    physical = "physical"


class ProblemMetadata(ABC):
    """Abstract class for the problem metadata."""

    def __init__(self, problem: ProblemType) -> None:
        self.__problem = problem

    @property
    def problem(self) -> ProblemType:
        return self.__problem

    @abstractmethod
    def ingest_metadata(self) -> None:
        """Convert a metadata file into a pandas.DataFrame."""

    @abstractmethod
    def generate_plot_data(self):
        """Generate data for plotting."""

    @abstractmethod
    def generate_success_prob_plot_data(self):
        """Generate success-probability plot data."""
