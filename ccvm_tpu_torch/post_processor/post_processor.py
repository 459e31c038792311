"""Post-processor interface (API-parity port of
``ccvm_simulators/post_processor/post_processor.py`` by way of
``ccvm_tpu/post_processor/post_processor.py``)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from enum import Enum

import numpy as np
import torch


class MethodType(str, Enum):
    BFGS = "bfgs"
    LBFGS = "lbfgs"
    Adam = "adam"
    ASGD = "asgd"
    GradDescent = "grad-descent"


def require_array(name, x):
    """Raise TypeError when ``x`` is neither a tensor nor an ndarray,
    mirroring the reference's "parameter ... must be a tensor" guards (e.g.
    ``grad_descent.py:48-55``)."""
    if not isinstance(x, (np.ndarray, torch.Tensor)):
        raise TypeError(f"parameter {name} must be a tensor")
    return x


class PostProcessor(ABC):
    """Post-processor interface; concrete classes refine solver output with a
    few steps of box-projected optimization on the relaxed objective."""

    @abstractmethod
    def postprocess(self):
        """Refine a batch of candidate solutions."""
