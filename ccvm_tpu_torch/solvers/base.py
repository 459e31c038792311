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
import torch

from ccvm_tpu_torch import profiling
from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.native import write_sample_rows
from ccvm_tpu_torch.runtime import resolve_device
from ccvm_tpu_torch.tuning import tune_solver


def check_mesh(mesh):
    """Raise unless ``mesh`` is None or a
    :class:`torch.distributed.device_mesh.DeviceMesh`
    (:func:`ccvm_tpu_torch.parallel.make_mesh`)."""
    from torch.distributed.device_mesh import DeviceMesh

    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed DeviceMesh (make_mesh), got {type(mesh).__name__}"
        )


def per_variable_saturation(S, problem_size, batch_size, device):
    """A façade's S as its solve takes it: a scalar, one value a column (a
    tuple of float32 values, ``dynamics/common.saturation``), or one an
    element (a (batch, n) float32 tensor on ``device``).

    A 1-D S of the problem's size is per column, as the JAX façades'
    ``np.outer(ones(batch), S)`` makes it (``ccvm_tpu/solvers/dl.py:378-383``);
    another size raises their ``ValueError``.  A (batch, n) S whose rows are
    equal is its row (the per-column build); rows that differ are one S an
    element (the per-element build), as the JAX façades' lax path takes a
    (batch, n) S."""
    if np.ndim(S) == 0:
        return float(np.float32(S))
    if np.ndim(S) == 1:
        if np.shape(S)[0] != problem_size:
            raise ValueError("Tensor S size should be equal to problem size.")
        return common.saturation(S)
    if tuple(np.shape(S)) != (batch_size, problem_size):
        raise ValueError(
            f"S must be a scalar, ({problem_size},) or ({batch_size}, "
            f"{problem_size}), got shape {tuple(np.shape(S))}")
    S = common.saturation_tensor(S, device)
    profiling.count("host_syncs")
    if bool((S == S[:1]).all()):
        return common.saturation(S[0])
    return S


def saturation_of(params, device):
    """A parameter tuple's S for the readout's change of variables, as a
    float32 tensor on ``device``: 0-dim, (n,) for one a column, which
    broadcasts over the batch as the JAX façades' (batch, n) S does, or
    (batch, n).  A tensor in every case, so that all divide alike (PyTorch
    multiplies a CUDA tensor by the rounded reciprocal of a Python float
    divisor) and S as a constant vector reads out as the scalar does."""
    return common.saturation_tensor(params.S, device)


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
        mesh (torch.distributed.device_mesh.DeviceMesh, optional): When
            given (:func:`ccvm_tpu_torch.parallel.make_mesh`), trajectory
            batches are sharded over the mesh's "batch" axis (data
            parallelism: each rank runs the whole-solve kernel on its rows,
            then the state is all-gathered), and a "model" axis larger than
            one routes the solve to :mod:`ccvm_tpu_torch.parallel.tp`.  Its
            device type must be the solver's.
        timing (str): "sync" (default) synchronises the card right after the
            SDE integration so ``solve_time`` measures it alone. "async" lets
            the solve and the readout run with the readout's single
            device-to-host copy as the only sync; ``solve_time`` then covers
            the full pipeline minus ``pp_time``.
    """

    def __init__(self, device, mesh=None, timing="sync"):
        self.torch_device = resolve_device(device)
        if timing not in ("sync", "async"):
            raise ValueError(
                f'timing must be "sync" or "async", got {timing!r}'
            )
        check_mesh(mesh)
        if mesh is not None and mesh.device_type != self.torch_device.type:
            raise ValueError(
                f'a "{mesh.device_type}" mesh cannot shard a "{device}" solver'
            )
        self.device = device
        self.mesh = mesh
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

    def _evolution_file(self, instance, evolution_step_size, evolution_file):
        """The evolution file of a sampled solve (``./{name}_evolution.txt``
        by default), checking the step size as the JAX façades do; None
        without sampling."""
        if not evolution_step_size:
            return None
        if evolution_step_size < 1:
            raise ValueError(
                "The evolution step size must be greater than or equal to 1."
            )
        return evolution_file or f"./{instance.name}_evolution.txt"

    @staticmethod
    def _evolution_sample_plan(iterations, evolution_step_size):
        """Number of samples and segment lengths for evolution recording
        (``ccvm_tpu/solvers/base.py:363-386``): a sample after iteration 0,
        after every ``evolution_step_size``-th iteration, and after the last
        if not already aligned (``dl_solver.py:866-873``, ``:557-564``)."""
        num_steps = int(iterations / evolution_step_size)
        num_samples = num_steps + 1
        if iterations % evolution_step_size != 0:
            num_samples += 1
        sample_points = list(range(0, iterations, evolution_step_size))
        if sample_points[-1] != iterations - 1:
            sample_points.append(iterations - 1)
        segments = []
        prev = -1
        for sp in sample_points:
            segments.append(sp - prev)
            prev = sp
        return num_samples, segments

    @staticmethod
    def _device_sample_stack(samples, num_samples):
        """(K, batch, n) segment samples -> (batch, n, num_samples), on the
        samples' device, zero-padded in the trailing dim like the
        reference's buffer (``ccvm_tpu/solvers/base.py:388-404``): only the
        best trajectory's (n, num_samples) slice is read back, when the
        evolution file is written."""
        samples = torch.movedim(samples, 0, -1)
        pad = num_samples - samples.shape[-1]
        if pad:
            samples = torch.nn.functional.pad(samples, (0, pad))
        return samples

    @staticmethod
    def _write_evolution(evolution_file, objval, blocks, append_trailing_tab=True):
        """Write the best trajectory's sample blocks (each (batch, n,
        samples) on the device; the row of the lowest objective value read
        back) to ``evolution_file``, in the reference format
        (``native.write_sample_rows``)."""
        best = int(np.argmax(-np.asarray(objval)))
        with open(evolution_file, "w") as f:
            for block in blocks:
                profiling.count("host_syncs")
                write_sample_rows(f, block[best].cpu().numpy(),
                                  append_trailing_tab=append_trailing_tab)

    def _tp_mesh(self):
        """The mesh when it carries a nontrivial "model" (tensor-parallel)
        axis, else None.  Façades route such solves through
        :mod:`ccvm_tpu_torch.parallel.tp` (Q's rows sharded)."""
        from ccvm_tpu_torch.parallel.mesh import axis_size

        if self.mesh is not None and axis_size(self.mesh, "model") > 1:
            return self.mesh
        return None

    def _sharded(self, run, params):
        """``run(params, batch_size, row_base)`` on this rank's rows of a
        mesh-sharded solve, its every tensor (tuples nest) all-gathered
        along the batch dimension (the second last) over the mesh's "batch"
        axis, so that every rank returns the global arrays; without a mesh,
        ``run`` on the whole batch.  ``row_base`` is the rank's first global
        row, whose draws are those of the single-card solve's rows; a
        per-element (batch, n) S is cut to the rank's rows."""
        if self.mesh is None:
            return run(params, self.batch_size, 0)
        from ccvm_tpu_torch.parallel.mesh import (all_gather, axis_group, axis_index,
                                                  axis_size)

        dp = axis_size(self.mesh, "batch")
        if self.batch_size % dp != 0:
            raise ValueError(
                f"batch_size {self.batch_size} must divide over the batch axis ({dp})"
            )
        batch = self.batch_size // dp
        row_base = axis_index(self.mesh, "batch") * batch
        if isinstance(params.S, torch.Tensor) and params.S.ndim == 2:
            params = params._replace(S=params.S[row_base:row_base + batch])
        group = axis_group(self.mesh, "batch")

        def gather(x):
            if isinstance(x, tuple):
                return tuple(gather(y) for y in x)
            return all_gather(x, group, -2)

        return gather(run(params, batch, row_base))

    def tune(self, instances, post_processor=None, parameter_ranges=None, **kwargs):
        """Grid-search ``parameter_ranges`` on ``instances`` and make the
        winner the solver's ``parameter_key`` (``is_tuned`` then reads
        True); returns it.  See :func:`ccvm_tpu_torch.tuning.tune_solver`
        for the keyword arguments (the reference's tune is a crashing
        placeholder, ``dl_solver.py:327-329``)."""
        best = tune_solver(
            self, instances, parameter_ranges=parameter_ranges,
            post_processor=post_processor, **kwargs,
        )
        self._parameter_key = best
        self._is_tuned = True
        return best

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
