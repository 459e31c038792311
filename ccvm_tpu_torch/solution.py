"""Solution dataclass (API-parity port of ``ccvm_simulators/solution.py``).

Gap statistics are computed in one vectorized NumPy reduction.
``save_tensor_to_file`` writes ``.npy`` via NumPy, as the JAX package does
(same method name and semantics as the reference's ``.pt`` writer).
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

from ccvm_tpu_torch import profiling

_GAP_THRESHOLDS = {
    "optimal": 0.1,
    "one_percent": 1,
    "two_percent": 2,
    "three_percent": 3,
    "four_percent": 4,
    "five_percent": 5,
    "ten_percent": 10,
}


def _is_array(x):
    return isinstance(x, (np.ndarray, torch.Tensor))


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        profiling.count("host_syncs")
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class Solution:
    """The solution of one solve (reference ``solution.py:6-63``).

    Attributes:
        solution_performance (dict): fraction of batch solutions within each
            gap threshold {0.1, 1, 2, 3, 4, 5, 10}% of the optimal value.
        best_objective_value (float): max(-objective_values).
    """

    problem_size: int
    batch_size: int
    instance_name: str
    iterations: int
    objective_values: object = field(repr=False)
    solve_time: float
    pp_time: float
    optimal_value: float
    best_value: float
    num_frac_values: int
    solution_vector: list
    variables: dict = field(repr=False)
    evolution_file: str = None
    device: str = field(default="cuda", repr=False)
    solution_performance: dict = None
    best_objective_value: float = None

    @profiling.annotate("ccvm.statistics")
    def __post_init__(self):
        """Compute best objective and gap statistics (reference ``:65-85``)
        from one host copy of the objective values."""
        obj_np = _to_numpy(self.objective_values)
        self.best_objective_value = float(np.max(-obj_np))
        self.get_solution_stats(obj_np)

    def get_solution_stats(self, _obj_np=None):
        """Fractions of solutions within each optimality gap
        (reference ``:87-146``): gap = (optimal - obj) * 100 / |obj|."""
        objective_values = -(
            _to_numpy(self.objective_values) if _obj_np is None else _obj_np
        )
        gap = (self.optimal_value - objective_values) * 100 / np.abs(objective_values)
        n = objective_values.shape[0]
        self.solution_performance = {
            name: round(float(np.sum(gap <= thr)) / n, 4)
            for name, thr in _GAP_THRESHOLDS.items()
        }

    def get_metadata_dict(self) -> dict:
        """Metadata dict excluding array fields (repr=False), mirroring
        reference ``:148-157``."""
        out = {}
        for k, f in self.__dataclass_fields__.items():
            if not f.repr:
                continue
            v = getattr(self, k)
            if _is_array(v):
                v = _to_numpy(v).tolist()
            out[k] = v
        return out

    def save_tensor_to_file(self, tensor_name, file_dir=".", file_name=None):
        """Save an array from ``variables`` to ``<file_dir>/<file_name>.npy``
        (reference ``:159-200`` saves torch ``.pt``)."""
        keys = self.variables.keys()
        try:
            if file_dir != "." and not os.path.isdir(file_dir):
                os.makedirs(file_dir)
                print("The folder to store doesn't exist yet. Creating: ", file_dir)
        except Exception as e:
            raise Exception(f"Failed to create the folder path: {e}")

        if tensor_name not in keys:
            raise Exception(
                f"Cannot find the {tensor_name} in the variables dictionary."
            )
        elif not file_name:
            file_name = tensor_name

        tensor_value = self.variables[tensor_name]
        if _is_array(tensor_value):
            np.save(f"{file_dir}/{file_name}.npy", _to_numpy(tensor_value))
            print("Successfully saved the tensor!")
        else:
            raise Exception(
                f"A tensor object cannot be obtained by the given tensor_name: {tensor_name}"
            )

    def asdict(self):
        return asdict(self)
