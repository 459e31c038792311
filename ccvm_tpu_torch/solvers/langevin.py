"""Langevin solver façade (API parity with
``ccvm_simulators/solvers/langevin_solver.py`` and
``ccvm_tpu/solvers/langevin.py``).

``device="cuda"`` launches the whole-solve CUDA kernel
(``csrc/langevin_solve.cu``) for every feature this port carries (evolution
sampling as one segment launch a sample, and a per-variable S, included);
``device="cpu"`` runs its plain PyTorch version.  No feature takes another
path quietly.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ccvm_tpu_torch import profiling
from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics import langevin as dyn
from ccvm_tpu_torch.ops import langevin_kernels, philox
from ccvm_tpu_torch.post_processor.factory import PostProcessorFactory
from ccvm_tpu_torch.runtime import synchronize
from ccvm_tpu_torch.solution import Solution
from ccvm_tpu_torch.solvers.algorithms import AdamParameters
from ccvm_tpu_torch.solvers.base import (CCVMSolver, per_variable_saturation,
                                         saturation_of)

LANGEVIN_SCALING_MULTIPLIER = 0.05
"""Scaling multiplier used in get_scaling_factor (reference
``langevin_solver.py:12``)."""


def check_langevin_options(backend, kernel_rng):
    """The constructor options the Langevin-family façades share: the
    backend is "auto" (the device decides the path, as for ``DLSolver`` and
    ``MFSolver``); ``kernel_rng`` names one of the kernel's Wiener
    transforms."""
    if backend != "auto":
        raise ValueError(
            f'backend must be "auto" (the device decides the path), got {backend!r}'
        )
    if kernel_rng not in philox.RNG_NAMES:
        raise ValueError(
            f"kernel_rng must be one of {philox.RNG_NAMES}, got {kernel_rng!r}"
        )


def langevin_readout(solver, instance, c, params, post_processor_object, batch_size):
    """The Langevin family's epilogue (``ccvm_tpu/solvers/langevin.py:360-380``):
    ``(c + S) / (2 S)`` BEFORE post-processing (one S a column broadcast
    over the batch), then the float64 readout with no change of
    variables.  Returns ``(problem_variables, pp_time, objval)``."""
    problem_variables = common.langevin_change_variables(
        c, saturation_of(params, c.device))
    pp_time = 0.0
    if post_processor_object is not None:
        with profiling.annotate("ccvm.postprocess"):
            problem_variables = post_processor_object.postprocess(
                problem_variables, solver.q_matrix, solver.v_vector
            )
        pp_time = post_processor_object.pp_time / batch_size
    return problem_variables, pp_time, instance.compute_energy_readout64(
        problem_variables)


def langevin_family_call(solver, instance, parameter_names, make_params, solve,
                         post_processor, evolution_step_size, evolution_file,
                         algorithm_parameters, seed):
    """The Langevin-family ``__call__`` after the device check (reference
    ``langevin_solver.py:563-762``, ``pumped_langevin_solver.py:451-658``):
    the parameters named in ``parameter_names`` (S among them, a scalar or
    one a column), ``make_params(values)``, ``solve(seed, params,
    iterations, evolution_step_size, hp)`` (which records ``c_sample``), the
    readout, the evolution file and the ``Solution``."""
    problem_size = instance.problem_size
    solver.q_matrix = instance.q_matrix
    solver.v_vector = instance.v_vector
    solver.solution_bounds = instance.solution_bounds
    batch_size = solver.batch_size
    try:
        values = {k: solver.parameter_key[problem_size][k] for k in parameter_names}
    except KeyError as e:
        raise KeyError(
            f"The parameter '{e.args[0]}' for the given instance size is not defined."
        ) from e
    values["S"] = per_variable_saturation(values["S"], problem_size, batch_size,
                                          solver.torch_device)
    solver.c_sample = None
    evolution_file = solver._evolution_file(instance, evolution_step_size,
                                            evolution_file)
    # An unknown post-processor raises before the solve is spent.
    post_processor_object = (
        PostProcessorFactory.create_postprocessor(post_processor)
        if post_processor else None
    )
    hp = algorithm_hyperparameters(algorithm_parameters)

    solve_time_start = time.time()
    params = make_params(values)
    if seed is None:
        seed = np.random.SeedSequence().entropy % (2**31)
    iterations = values["iterations"]
    c = solve(int(seed), params, iterations, evolution_step_size, hp)
    if solver.timing == "sync":
        synchronize(c)
    # Per-instance normalized solve time (reference :704-708)
    solve_time = (time.time() - solve_time_start) / batch_size

    problem_variables, pp_time, objval = langevin_readout(
        solver, instance, c, params, post_processor_object, batch_size)

    if solver.timing == "async":
        solve_time = (time.time() - solve_time_start) / batch_size - pp_time

    if evolution_step_size:
        solver._write_evolution(evolution_file, objval, (solver.c_sample,))

    solution = Solution(
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
        device=solver.device,
    )
    if evolution_step_size:
        solution.evolution_file = evolution_file
    return solution


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

    ``mesh`` shards the batch (and with a "model" axis the features) as
    the base class says; ``backend`` is kept for signature parity with the
    JAX façade: no backend other than "auto" (the device decides the path)
    is ported.  ``kernel_rng`` names the kernel's Wiener
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
        super().__init__(device, mesh=mesh, timing=timing)
        check_langevin_options(backend, kernel_rng)
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
            S=common.saturation(S), dt=f32(dt), sigma=f32(sigma),
            feedback_scale=f32(feedback_scale), lower_limit=f32(lo),
            upper_limit=f32(hi),
        )

    def _solve(self, seed, params, iterations, evolution_step_size=None, hp=None):
        """The solve on the instance's device (kernel on "cuda", plain
        version on "cpu"): one whole-solve launch, or with
        ``evolution_step_size`` one segment launch a sample, the samples
        kept on the device in ``c_sample``; ``hp`` selects the Adam
        variant.  A mesh shards the batch (:meth:`_sharded`), or with a
        "model" axis runs :func:`ccvm_tpu_torch.parallel.tp.langevin_solve`."""
        kwargs = dict(rng=self.kernel_rng, hp=hp)
        q, v = self.q_matrix, self.v_vector
        if not evolution_step_size:
            tp_mesh = self._tp_mesh()
            if tp_mesh is not None:
                from ccvm_tpu_torch.parallel import tp

                return tp.langevin_solve(tp_mesh, seed, q, v, params,
                                         iterations=iterations,
                                         batch_size=self.batch_size, **kwargs)
            return self._sharded(lambda p, batch, row_base: langevin_kernels.langevin_solve(
                seed, q, v, p, iterations=iterations, batch_size=batch,
                row_base=row_base, **kwargs), params)
        num_samples, segments = self._evolution_sample_plan(iterations,
                                                            evolution_step_size)
        c, samples = self._sharded(
            lambda p, batch, row_base: langevin_kernels.langevin_solve_sampled(
                seed, q, v, p, segments, batch_size=batch, row_base=row_base,
                **kwargs), params)
        self.c_sample = self._device_sample_stack(samples, num_samples)
        return c

    @profiling.annotate("ccvm.call")
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
        ``evolution_step_size`` records ``c_sample`` and writes the best
        trajectory's to ``evolution_file``.
        """
        if instance.device != self.device:
            raise ValueError(
                f"The device type of the instance ({instance.device}) and the solver"
                f" ({self.device}) must match."
            )
        return langevin_family_call(
            self, instance, ("dt", "S", "iterations", "sigma", "feedback_scale"),
            lambda t: self._make_params(t["S"], t["dt"], t["sigma"],
                                        t["feedback_scale"]),
            lambda seed, params, iterations, evolution_step_size, hp: self._solve(
                seed, params, iterations, evolution_step_size=evolution_step_size,
                hp=hp),
            post_processor, evolution_step_size, evolution_file,
            algorithm_parameters, seed)
