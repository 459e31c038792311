"""Post-processor interface (API-parity port of
``ccvm_simulators/post_processor/post_processor.py`` by way of
``ccvm_tpu/post_processor/post_processor.py``)."""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from enum import Enum

import numpy as np
import torch

from ccvm_tpu_torch import profiling


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


def as_float32(c, q_matrix, v_vector):
    """The three inputs as float32 tensors on ``c``'s device, after the
    type guards."""
    c = torch.as_tensor(require_array("c", c), dtype=torch.float32)
    return c, *(torch.as_tensor(require_array(name, x), dtype=torch.float32,
                                device=c.device)
                for name, x in (("q_matrix", q_matrix), ("v_vector", v_vector)))


class PostProcessor(ABC):
    """Post-processor interface; concrete classes refine solver output with a
    few steps of box-projected optimization on the relaxed objective."""

    @abstractmethod
    def postprocess(self):
        """Refine a batch of candidate solutions."""

    @staticmethod
    def elapsed(start_time, result):
        """Seconds since ``start_time`` once ``result`` is computed (the card
        is synchronised first)."""
        profiling.count("host_syncs")
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
        return time.time() - start_time

    def func_post(self, c, *args):
        """Scalar objective 0.5 cQc + Vc as numpy (reference ``:22-36``)."""
        q_matrix = np.asarray(args[0])
        v_vector = np.asarray(args[1])
        energy1 = np.einsum("i, ij, j", c, q_matrix, c)
        energy2 = np.einsum("i, i", c, v_vector)
        return 0.5 * energy1 + energy2

    def func_post_jac(self, c, *args):
        """Jacobian Qc + V as numpy (reference ``:38-57``)."""
        q_matrix = np.asarray(args[0])
        v_vector = np.asarray(args[1])
        return np.einsum("ij,j->i", q_matrix, c) + v_vector
