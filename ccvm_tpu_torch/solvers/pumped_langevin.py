"""Pumped Langevin solver façade (API parity with
``ccvm_simulators/solvers/pumped_langevin_solver.py`` and
``ccvm_tpu/solvers/pumped_langevin.py``).

``device="cuda"`` launches the whole-solve CUDA kernel
(``csrc/langevin_solve.cu``, pumped specialisation); ``device="cpu"`` runs
its plain PyTorch version.  Features not ported yet raise
``NotImplementedError`` naming the ROADMAP item that brings them.  There is
no machine model of its own: the base class's cpu and gpu models apply, as
in the JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics import pumped_langevin as dyn
from ccvm_tpu_torch.ops import langevin_kernels
from ccvm_tpu_torch.post_processor.factory import PostProcessorFactory
from ccvm_tpu_torch.solution import Solution
from ccvm_tpu_torch.solvers.base import CCVMSolver, not_ported
from ccvm_tpu_torch.solvers.langevin import (algorithm_hyperparameters,
                                             check_langevin_options,
                                             langevin_readout)

PUMPED_LANGEVIN_SCALING_MULTIPLIER = 0.05
"""Reference ``pumped_langevin_solver.py:10``."""


class PumpedLangevinSolver(CCVMSolver):
    """Langevin dynamics extended with a pump/saturation drift term
    (reference ``pumped_langevin_solver.py:18``).  Options as
    :class:`ccvm_tpu_torch.solvers.langevin.LangevinSolver`."""

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
        self._scaling_multiplier = PUMPED_LANGEVIN_SCALING_MULTIPLIER
        self._method_selector(problem_category)

    @property
    def parameter_key(self):
        """Keys must be exactly {pump, dt, S, iterations, sigma,
        feedback_scale} (reference ``:74-93``)."""
        return self._parameter_key

    @parameter_key.setter
    def parameter_key(self, parameters):
        expected_pl_parameter_key_set = set(
            ["pump", "dt", "S", "iterations", "sigma", "feedback_scale"]
        )
        for parameter_key in parameters.values():
            if parameter_key.keys() != expected_pl_parameter_key_set:
                raise ValueError(
                    "The parameter key is not valid for this solver. Expected keys: "
                    + str(expected_pl_parameter_key_set)
                    + " Given keys: "
                    + str(parameter_key.keys())
                )
        self._parameter_key = parameters
        self._is_tuned = False

    ##################################
    # Problem-category methods       #
    ##################################

    def _calculate_drift_boxqp(self, c, p, S, feedback_scale):
        """Pump drift + feedback gradient (reference ``:95-116``)."""
        c = torch.as_tensor(c)
        lo, hi = self.solution_bounds
        g = dyn.grads_boxqp(c, self.q_matrix, self.v_vector, lo, hi, S)
        return (-1 + p - torch.square(c)) * c + feedback_scale * g

    def _calculate_grads_boxqp(self, c, lower_limit=0, upper_limit=1, S=1):
        return dyn.grads_boxqp(
            torch.as_tensor(c), self.q_matrix, self.v_vector, lower_limit,
            upper_limit, S,
        )

    def _change_variables_boxqp(self, problem_variables, lower_limit=0, upper_limit=1, S=1):
        return common.change_variables_boxqp(
            torch.as_tensor(problem_variables), lower_limit, upper_limit, S
        )

    def _fit_to_constraints_boxqp(self, c, lower_clamp, upper_clamp):
        return common.fit_to_constraints_boxqp(
            torch.as_tensor(c), lower_clamp, upper_clamp
        )

    def tune(self, instances, post_processor=None, parameter_ranges=None, **kwargs):
        """The grid-search tuner arrives with ``tuning.py``."""
        raise not_ported("PumpedLangevinSolver.tune", "queue 1 item 10")

    ##################################
    # Solve paths                    #
    ##################################

    def _make_params(self, pump, S, dt, sigma, feedback_scale, iterations):
        lo, hi = self.solution_bounds
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        return dyn.PumpedLangevinParams(
            pump=f32(pump), S=f32(S), dt=f32(dt), sigma=f32(sigma),
            feedback_scale=f32(feedback_scale), lower_limit=f32(lo),
            upper_limit=f32(hi), iterations=f32(iterations),
        )

    def _solve(self, seed, params, iterations, pump_rate_flag, hp=None):
        """One whole-solve launch on the instance's device (kernel on
        "cuda", plain version on "cpu"); ``hp`` selects the Adam variant."""
        return langevin_kernels.pumped_langevin_solve(
            seed, self.q_matrix, self.v_vector, params,
            iterations=iterations, batch_size=self.batch_size,
            pump_rate_flag=pump_rate_flag, rng=self.kernel_rng, hp=hp,
        )

    def __call__(
        self,
        instance,
        post_processor=None,
        pump_rate_flag=True,
        evolution_step_size=None,
        evolution_file=None,
        algorithm_parameters=None,
        seed=None,
    ):
        """Solve an instance (reference ``pumped_langevin_solver.py:451-658``).

        ``seed`` (int) keys the kernel's Philox noise; ``None`` draws one.
        """
        if instance.device != self.device:
            raise ValueError(
                f"The device type of the instance ({instance.device}) and the solver"
                f" ({self.device}) must match."
            )
        if evolution_step_size:
            raise not_ported(
                "pumped-Langevin evolution sampling (evolution_step_size)",
                "queue 1 item 7")

        problem_size = instance.problem_size
        self.q_matrix = instance.q_matrix
        self.v_vector = instance.v_vector
        self.solution_bounds = instance.solution_bounds

        batch_size = self.batch_size

        try:
            pump = self.parameter_key[problem_size]["pump"]
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
            raise not_ported("per-variable S on the pumped-Langevin solver",
                             "queue 1 item 7")

        # An unknown post-processor raises before the solve is spent.
        post_processor_object = (
            PostProcessorFactory.create_postprocessor(post_processor)
            if post_processor else None
        )
        hp = algorithm_hyperparameters(algorithm_parameters)

        solve_time_start = time.time()

        params = self._make_params(pump, S, dt, sigma, feedback_scale, iterations)
        if seed is None:
            seed = np.random.SeedSequence().entropy % (2**31)
        c = self._solve(int(seed), params, iterations, pump_rate_flag, hp=hp)
        if self.timing == "sync" and c.is_cuda:
            torch.cuda.synchronize(c.device)
        solve_time = (time.time() - solve_time_start) / batch_size

        # Calibrate the variable before post-processing (reference :603-619)
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
