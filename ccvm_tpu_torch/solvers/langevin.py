"""Langevin solver façade (API parity with
``ccvm_simulators/solvers/langevin_solver.py`` and
``ccvm_tpu/solvers/langevin.py``).

``device="cuda"`` launches the whole-solve CUDA kernel
(``csrc/langevin_solve.cu``) for every feature this port carries;
``device="cpu"`` runs its plain PyTorch version.  Features not ported yet
raise ``NotImplementedError`` naming the ROADMAP item that brings them; none
of them takes another path quietly.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics import langevin as dyn
from ccvm_tpu_torch.ops import langevin_kernels, philox
from ccvm_tpu_torch.post_processor.factory import PostProcessorFactory
from ccvm_tpu_torch.solution import Solution
from ccvm_tpu_torch.solvers.algorithms import AdamParameters
from ccvm_tpu_torch.solvers.base import CCVMSolver, not_ported

LANGEVIN_SCALING_MULTIPLIER = 0.05
"""Scaling multiplier used in get_scaling_factor (reference
``langevin_solver.py:12``)."""


def check_langevin_options(mesh, backend, kernel_rng):
    """The constructor options the Langevin-family façades share: a mesh and
    a backend other than "auto" are not ported; ``kernel_rng`` names one of
    the kernel's Wiener transforms."""
    if mesh is not None:
        raise not_ported("mesh-sharded solving", "queue 1 item 13")
    if backend != "auto":
        raise not_ported(
            f"backend={backend!r} (the device decides the path in this port)",
            "queue 1 item 7")
    if kernel_rng not in philox.RNG_NAMES:
        raise ValueError(
            f"kernel_rng must be one of {philox.RNG_NAMES}, got {kernel_rng!r}"
        )


def langevin_readout(solver, instance, c, S, post_processor_object, batch_size):
    """The Langevin family's epilogue (``ccvm_tpu/solvers/langevin.py:360-380``):
    ``(c + S) / (2 S)`` BEFORE post-processing, then the float64-grade
    readout with no change of variables.  Returns
    ``(problem_variables, pp_time, objval)``."""
    problem_variables = common.langevin_change_variables(c, S)
    pp_time = 0.0
    if post_processor_object is not None:
        problem_variables = post_processor_object.postprocess(
            problem_variables, solver.q_matrix, solver.v_vector
        )
        pp_time = post_processor_object.pp_time / batch_size
    return problem_variables, pp_time, instance.compute_energy_readout64(
        problem_variables)


def algorithm_hyperparameters(algorithm_parameters):
    """Adam hyperparameters of ``algorithm_parameters``, or None."""
    if algorithm_parameters is None:
        return None
    if isinstance(algorithm_parameters, AdamParameters):
        return algorithm_parameters.to_hyperparameters()
    raise ValueError(
        f"Solver option type {type(algorithm_parameters)} is not supported."
    )


class LangevinSolver(CCVMSolver):
    """Models typical Langevin dynamics as a system of SDEs
    (reference ``langevin_solver.py:17``).

    ``mesh`` and ``backend`` are kept for signature parity with the JAX
    façade: neither a mesh nor a backend other than "auto" (the device
    decides the path) is ported.  ``kernel_rng`` names the kernel's Wiener
    transform ("popcount32", the default, "popcount16", "popcount" or
    "box_muller").
    """

    def __init__(
        self,
        device,
        problem_category="boxqp",
        batch_size=1000,
        mesh=None,
        backend="auto",
        timing="sync",
        kernel_rng="popcount32",
    ):
        super().__init__(device, timing=timing)
        check_langevin_options(mesh, backend, kernel_rng)
        self.batch_size = batch_size
        self.backend = backend
        self.kernel_rng = kernel_rng
        self._scaling_multiplier = LANGEVIN_SCALING_MULTIPLIER
        self._method_selector(problem_category)
        self._default_fpga_machine_parameters = {
            "fpga_power": {
                20: 17.18,
                30: 18.13,
                40: 18.45,
                50: 19.03,
                60: 19.22,
                70: 19.32,
            },
            "fpga_runtimes": {
                20: 133e-6,
                30: 265e-6,
                40: 327e-6,
                50: 437e-6,
                60: 511e-6,
                70: 662e-6,
            },
        }

    @property
    def parameter_key(self):
        """Per-problem-size solver parameters; keys must be exactly
        {dt, S, iterations, sigma, feedback_scale}
        (reference ``langevin_solver.py:66-114``)."""
        return self._parameter_key

    @parameter_key.setter
    def parameter_key(self, parameters):
        expected_lparameter_key_set = set(
            ["dt", "S", "iterations", "sigma", "feedback_scale"]
        )
        for parameter_key in parameters.values():
            if parameter_key.keys() != expected_lparameter_key_set:
                raise ValueError(
                    "The parameter key is not valid for this solver. Expected keys: "
                    + str(expected_lparameter_key_set)
                    + " Given keys: "
                    + str(parameter_key.keys())
                )
        self._parameter_key = parameters
        self._is_tuned = False

    ##################################
    # Problem-category methods       #
    ##################################

    def _calculate_drift_boxqp(self, c, lower_limit=0, upper_limit=1, S=1):
        """Langevin drift (reference ``langevin_solver.py:117-139``)."""
        return dyn.drift_boxqp(
            torch.as_tensor(c), self.q_matrix, self.v_vector, lower_limit,
            upper_limit, S,
        )

    def _calculate_grads_boxqp(self, c, lower_limit=0, upper_limit=1, S=1):
        """Gradients (identical expression, reference ``:141-166``)."""
        return self._calculate_drift_boxqp(c, lower_limit, upper_limit, S)

    def _change_variables_boxqp(self, problem_variables, lower_limit=0, upper_limit=1, S=1):
        return common.change_variables_boxqp(
            torch.as_tensor(problem_variables), lower_limit, upper_limit, S
        )

    def _fit_to_constraints_boxqp(self, c, lower_clamp, upper_clamp):
        return common.fit_to_constraints_boxqp(
            torch.as_tensor(c), lower_clamp, upper_clamp
        )

    def _validate_fpga_machine_parameters(self, machine_parameters):
        required_keys = ["fpga_power", "fpga_runtimes"]
        missing_keys = [key for key in required_keys if key not in machine_parameters]
        if missing_keys:
            raise ValueError(
                f"Invalid fpga_machine_parameters: Missing required keys - {missing_keys}"
            )

    def tune(self, instances, post_processor=None, parameter_ranges=None, **kwargs):
        """The grid-search tuner arrives with ``tuning.py``."""
        raise not_ported("LangevinSolver.tune", "queue 1 item 10")

    ##################################
    # Machine models                 #
    ##################################

    def _fpga_machine_energy(self, machine_parameters=None):
        """FPGA energy model (reference ``langevin_solver.py:269-303``)."""
        if machine_parameters is None:
            machine_parameters = self._default_fpga_machine_parameters
        else:
            self._validate_fpga_machine_parameters(machine_parameters)

        def _fpga_machine_energy_callable(dataframe, problem_size: int):
            machine_time = machine_parameters["fpga_runtimes"][problem_size]
            machine_power = machine_parameters["fpga_power"][problem_size]
            return machine_power * machine_time

        return _fpga_machine_energy_callable

    def _fpga_machine_time(self, machine_parameters: dict = None):
        """FPGA time model (reference ``langevin_solver.py:305-366``)."""
        if machine_parameters is None:
            machine_parameters = self._default_fpga_machine_parameters
        else:
            self._validate_fpga_machine_parameters(machine_parameters)

        def _fpga_machine_time_callable(dataframe, problem_size: int):
            try:
                postprocessing_time = np.mean(dataframe["pp_time"].values)
            except KeyError as e:
                raise ValueError(
                    f"The given dataframe is missing required column: {e.args[0]}"
                )
            try:
                machine_time = (
                    machine_parameters["fpga_runtimes"][problem_size]
                    + postprocessing_time
                )
            except KeyError:
                raise ValueError(
                    f"The fpga_runtimes dict in given machine_parameters does not"
                    f" have an entry for problem size {problem_size}."
                )
            return machine_time

        return _fpga_machine_time_callable

    ##################################
    # Solve paths                    #
    ##################################

    def _make_params(self, S, dt, sigma, feedback_scale):
        lo, hi = self.solution_bounds
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        return dyn.LangevinParams(
            S=f32(S), dt=f32(dt), sigma=f32(sigma),
            feedback_scale=f32(feedback_scale), lower_limit=f32(lo),
            upper_limit=f32(hi),
        )

    def _solve(self, seed, params, iterations, hp=None):
        """One whole-solve launch on the instance's device (kernel on
        "cuda", plain version on "cpu"); ``hp`` selects the Adam variant."""
        return langevin_kernels.langevin_solve(
            seed, self.q_matrix, self.v_vector, params,
            iterations=iterations, batch_size=self.batch_size,
            rng=self.kernel_rng, hp=hp,
        )

    def __call__(
        self,
        instance,
        post_processor=None,
        evolution_step_size=None,
        evolution_file=None,
        algorithm_parameters=None,
        seed=None,
    ):
        """Solve a problem instance (reference ``langevin_solver.py:563-762``).

        ``seed`` (int) keys the kernel's Philox noise; ``None`` draws one.
        """
        if instance.device != self.device:
            raise ValueError(
                f"The device type of the instance ({instance.device}) and the solver"
                f" ({self.device}) must match."
            )
        if evolution_step_size:
            raise not_ported("Langevin evolution sampling (evolution_step_size)",
                             "queue 1 item 7")

        problem_size = instance.problem_size
        self.q_matrix = instance.q_matrix
        self.v_vector = instance.v_vector
        self.solution_bounds = instance.solution_bounds

        batch_size = self.batch_size

        try:
            dt = self.parameter_key[problem_size]["dt"]
            S = self.parameter_key[problem_size]["S"]
            iterations = self.parameter_key[problem_size]["iterations"]
            sigma = self.parameter_key[problem_size]["sigma"]
            feedback_scale = self.parameter_key[problem_size]["feedback_scale"]
        except KeyError as e:
            raise KeyError(
                f"The parameter '{e.args[0]}' for the given instance size is not defined."
            ) from e
        if not np.isscalar(S):
            raise not_ported("per-variable S on the Langevin solver",
                             "queue 1 item 7")

        # An unknown post-processor raises before the solve is spent.
        post_processor_object = (
            PostProcessorFactory.create_postprocessor(post_processor)
            if post_processor else None
        )
        hp = algorithm_hyperparameters(algorithm_parameters)

        solve_time_start = time.time()

        params = self._make_params(S, dt, sigma, feedback_scale)
        if seed is None:
            seed = np.random.SeedSequence().entropy % (2**31)
        c = self._solve(int(seed), params, iterations, hp=hp)
        if self.timing == "sync" and c.is_cuda:
            torch.cuda.synchronize(c.device)
        # Per-instance normalized solve time (reference :704-708)
        solve_time = (time.time() - solve_time_start) / batch_size

        problem_variables, pp_time, objval = langevin_readout(
            self, instance, c, params.S, post_processor_object, batch_size)

        if self.timing == "async":
            solve_time = (time.time() - solve_time_start) / batch_size - pp_time

        return Solution(
            problem_size=instance.problem_size,
            batch_size=batch_size,
            instance_name=instance.name,
            iterations=iterations,
            objective_values=objval,
            solve_time=solve_time,
            pp_time=pp_time,
            optimal_value=instance.optimal_sol,
            best_value=instance.best_sol,
            num_frac_values=instance.num_frac_values,
            solution_vector=instance.solution_vector,
            variables={"problem_variables": problem_variables},
            device=self.device,
        )
