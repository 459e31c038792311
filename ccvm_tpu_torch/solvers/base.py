"""Solver base class for the PyTorch/CUDA CCVM port.

API-parity port of ``ccvm_simulators/solvers/ccvm_solver.py`` by way of
``ccvm_tpu/solvers/base.py``: the public surface (``parameter_key``,
``get_scaling_factor``, ``machine_time``, ``machine_energy``, the method
selector) is preserved so reference user code ports 1:1.  The device string
decides the compute path: "cuda" launches the hand-written kernels, "cpu"
runs their plain PyTorch versions; nothing falls back from one to the other.

The machine-model callables take any dataframe-like object with
``.columns`` and ``df[col].values`` (pandas is not needed to run a solve).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.runtime import resolve_device


def not_ported(feature, item):
    """The error a feature not ported yet raises, naming its ROADMAP item."""
    return NotImplementedError(
        f"{feature} is not ported to ccvm_tpu_torch yet (ROADMAP.md, {item})"
    )


class MachineType:
    """The type of machine we are simulating (``ccvm_solver.py:15-22``)."""

    CPU = "cpu"
    GPU = "gpu"
    FPGA = "fpga"
    DL_CCVM = "dl-ccvm"
    MF_CCVM = "mf-ccvm"


class CCVMSolver(ABC):
    """The base class for all solvers (``ccvm_solver.py:25``).

    Args:
        device (str): "cuda" or "cpu"; "cuda" raises when no card is present.
        timing (str): "sync" (default) synchronises the card right after the
            SDE integration so ``solve_time`` measures it alone. "async" lets
            the solve and the readout run with the readout's single
            device-to-host copy as the only sync; ``solve_time`` then covers
            the full pipeline minus ``pp_time``.
    """

    def __init__(self, device, timing="sync"):
        self.torch_device = resolve_device(device)
        if timing not in ("sync", "async"):
            raise ValueError(
                f'timing must be "sync" or "async", got {timing!r}'
            )
        self.device = device
        self.timing = timing
        self._is_tuned = False
        self._scaling_multiplier = None
        self._parameter_key = None
        self._default_cpu_machine_parameters = {
            "cpu_power": {20: 4.93, 30: 5.19, 40: 5.0, 50: 5.01, 60: 5.0, 70: 5.22}
        }
        self._default_cuda_machine_parameters = {
            "gpu_power": {
                20: 28.93,
                30: 29.8,
                40: 31.09,
                50: 31.29,
                60: 31.49,
                70: 32.28,
            }
        }
        self.calculate_grads = None
        self.change_variables = None
        self.fit_to_constraints = None

    ##################################
    # Properties                     #
    ##################################
    @property
    def is_tuned(self):
        """bool: True if the current parameters were set by tune()."""
        return self._is_tuned

    @property
    def parameter_key(self):
        """The parameters used by the solver when solving the problem."""
        return self._parameter_key

    ##################################
    # Abstract methods               #
    ##################################

    @abstractmethod
    def tune(self):
        """Determine the best solver parameters over a set of instances."""

    @abstractmethod
    def _solve(self):
        """Solve a problem instance (Adam-filtered when given Adam
        hyperparameters)."""

    @abstractmethod
    def _calculate_drift_boxqp(self, **kwargs):
        """Drift part of the CCVM for the boxqp problem."""

    @abstractmethod
    def _calculate_grads_boxqp(self, **kwargs):
        """Gradients of the variables for the boxqp problem."""

    @abstractmethod
    def _change_variables_boxqp(self, **kwargs):
        """Change of variables on the boxqp problem."""

    @abstractmethod
    def _fit_to_constraints_boxqp(self, **kwargs):
        """Fit the variables to the constraints for the boxqp problem."""

    ##################################
    # Implemented methods            #
    ##################################

    def get_scaling_factor(self, q_matrix):
        """Default problem-scaling value: sqrt(sum |Q|) * solver multiplier
        (``ccvm_solver.py:134-150``)."""
        return common.scaling_factor(q_matrix, self._scaling_multiplier)

    def _method_selector(self, problem_category):
        """Bind problem-category-specific methods (``ccvm_solver.py:152-170``)."""
        if problem_category.lower() == "boxqp":
            self.calculate_drift = self._calculate_drift_boxqp
            self.calculate_grads = self._calculate_grads_boxqp
            self.change_variables = self._change_variables_boxqp
            self.fit_to_constraints = self._fit_to_constraints_boxqp
        else:
            raise ValueError(
                "The given instance is not a valid problem category."
                f" Given category: {problem_category}"
            )

    ################################
    ### Machine energy functions ###
    ################################

    def _validate_machine_energy_dataframe_columns(self, dataframe):
        """Validate optics-energy dataframe columns (``ccvm_solver.py:176-195``)."""
        required_columns = ["pp_time", "iterations"]
        missing_columns = [
            col for col in required_columns if col not in dataframe.columns
        ]
        if missing_columns:
            raise ValueError(
                f"The given dataframe is missing the following columns: {missing_columns}"
            )

    def _cpu_machine_energy(self, machine_parameters: dict = None):
        """Average energy of simulating on a CPU (``ccvm_solver.py:197-246``)."""
        if machine_parameters is None:
            machine_parameters = self._default_cpu_machine_parameters
        elif "cpu_power" not in machine_parameters.keys():
            raise ValueError(
                "The given machine parameters are not valid. "
                "The dictionary must contain the key 'cpu_power'"
            )

        def _cpu_machine_energy_callable(dataframe, problem_size: int):
            if "solve_time" not in dataframe.columns:
                raise ValueError(
                    "The given dataframe does not contain the column 'solve_time'"
                )
            machine_time = np.mean(dataframe["solve_time"].values)
            machine_power = machine_parameters["cpu_power"][problem_size]
            return machine_power * machine_time

        return _cpu_machine_energy_callable

    def _cuda_machine_energy(self, machine_parameters: dict = None):
        """Average energy of simulating on CUDA GPUs (``ccvm_solver.py:248-299``)."""
        if machine_parameters is None:
            machine_parameters = self._default_cuda_machine_parameters
        elif "gpu_power" not in machine_parameters.keys():
            raise ValueError(
                "The given machine parameters are not valid. "
                "The dictionary must contain the key 'gpu_power'"
            )

        def _cuda_machine_energy_callable(dataframe, problem_size: int):
            if "solve_time" not in dataframe.columns:
                raise ValueError(
                    "The given dataframe does not contain the column 'solve_time'"
                )
            machine_time = np.mean(dataframe["solve_time"].values)
            machine_power = machine_parameters["gpu_power"][problem_size]
            return machine_power * machine_time

        return _cuda_machine_energy_callable

    def machine_energy(self, machine: str, machine_parameters: dict = None):
        """Average energy consumed by the specified hardware
        (``ccvm_solver.py:301-350``)."""
        solver_energy_methods = {
            "cpu": self._cpu_machine_energy,
            "gpu": self._cuda_machine_energy,
            "dl-ccvm": (
                getattr(self, "_optics_machine_energy", None)
                if self.__class__.__name__ == "DLSolver"
                else None
            ),
            "mf-ccvm": (
                getattr(self, "_optics_machine_energy", None)
                if self.__class__.__name__ == "MFSolver"
                else None
            ),
            "fpga": (
                getattr(self, "_fpga_machine_energy", None)
                if self.__class__.__name__ == "LangevinSolver"
                else None
            ),
        }

        if machine not in solver_energy_methods:
            raise ValueError(
                f"The given machine type is not valid. "
                f"The machine type must be one of {', '.join(solver_energy_methods.keys())}"
            )

        energy_method = solver_energy_methods[machine]
        if not energy_method:
            raise ValueError(
                f"Mismatch between the solver and the machine type. "
                f"Provided machine type: {machine}, solver type: {self.__class__.__name__}"
            )
        return energy_method(machine_parameters)

    ##############################
    ### Machine time functions ###
    ##############################

    def _cpu_gpu_machine_time(self, **_):
        """Average simulation wall time on CPU/GPU (``ccvm_solver.py:356-392``)."""

        def _cpu_gpu_machine_time_callable(dataframe, **_):
            if "solve_time" not in dataframe.columns:
                raise ValueError(
                    "The given dataframe does not contain the column 'solve_time'"
                )
            return np.mean(dataframe["solve_time"].values)

        return _cpu_gpu_machine_time_callable

    def machine_time(self, machine: str, machine_parameters: dict = None):
        """Average time spent by the specified hardware
        (``ccvm_solver.py:394-444``)."""
        solver_time_methods = {
            "cpu": self._cpu_gpu_machine_time,
            "gpu": self._cpu_gpu_machine_time,
            "dl-ccvm": (
                getattr(self, "_optics_machine_time", None)
                if self.__class__.__name__ == "DLSolver"
                else None
            ),
            "mf-ccvm": (
                getattr(self, "_optics_machine_time", None)
                if self.__class__.__name__ == "MFSolver"
                else None
            ),
            "fpga": (
                getattr(self, "_fpga_machine_time", None)
                if self.__class__.__name__ == "LangevinSolver"
                else None
            ),
        }

        if machine not in solver_time_methods:
            raise ValueError(
                f"The given machine type is not valid. "
                f"The machine type must be one of {', '.join(solver_time_methods.keys())}"
            )

        time_method = solver_time_methods[machine]
        if not time_method:
            raise ValueError(
                f"Mismatch between the solver and the machine type. "
                f"Provided machine type: {machine}, solver type: {self.__class__.__name__}"
            )
        return time_method(machine_parameters=machine_parameters)
