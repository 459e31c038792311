"""Pumped Langevin solver façade (API parity with
``ccvm_simulators/solvers/pumped_langevin_solver.py`` and
``ccvm_tpu/solvers/pumped_langevin.py``).

``device="cuda"`` launches the whole-solve CUDA kernel
(``csrc/langevin_solve.cu``, pumped specialisation; evolution sampling as one
segment launch a sample, and a per-variable S, included); ``device="cpu"``
runs its plain PyTorch version.  There is no machine model of its own: the
base class's cpu and gpu models apply, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ccvm_tpu_torch import profiling
from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics import pumped_langevin as dyn
from ccvm_tpu_torch.ops import langevin_kernels
from ccvm_tpu_torch.solvers.base import CCVMSolver
from ccvm_tpu_torch.solvers.langevin import (check_langevin_options,
                                             langevin_family_call)

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
        super().__init__(device, mesh=mesh, timing=timing)
        check_langevin_options(backend, kernel_rng)
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

    ##################################
    # Solve paths                    #
    ##################################

    def _make_params(self, pump, S, dt, sigma, feedback_scale, iterations):
        lo, hi = self.solution_bounds
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        return dyn.PumpedLangevinParams(
            pump=f32(pump), S=common.saturation(S), dt=f32(dt), sigma=f32(sigma),
            feedback_scale=f32(feedback_scale), lower_limit=f32(lo),
            upper_limit=f32(hi), iterations=f32(iterations),
        )

    def _solve(self, seed, params, iterations, pump_rate_flag, evolution_step_size=None,
               hp=None):
        """The solve on the instance's device (kernel on "cuda", plain
        version on "cpu"): one whole-solve launch, or with
        ``evolution_step_size`` one segment launch a sample, the samples
        kept on the device in ``c_sample``; ``hp`` selects the Adam
        variant.  A mesh shards the batch (:meth:`_sharded`), or with a
        "model" axis runs
        :func:`ccvm_tpu_torch.parallel.tp.pumped_langevin_solve`."""
        kwargs = dict(pump_rate_flag=pump_rate_flag, rng=self.kernel_rng, hp=hp)
        q, v = self.q_matrix, self.v_vector
        if not evolution_step_size:
            tp_mesh = self._tp_mesh()
            if tp_mesh is not None:
                from ccvm_tpu_torch.parallel import tp

                return tp.pumped_langevin_solve(tp_mesh, seed, q, v, params,
                                                iterations=iterations,
                                                batch_size=self.batch_size, **kwargs)
            return self._sharded(
                lambda p, batch, row_base: langevin_kernels.pumped_langevin_solve(
                    seed, q, v, p, iterations=iterations, batch_size=batch,
                    row_base=row_base, **kwargs), params)
        num_samples, segments = self._evolution_sample_plan(iterations,
                                                            evolution_step_size)
        c, samples = self._sharded(
            lambda p, batch, row_base: langevin_kernels.pumped_langevin_solve_sampled(
                seed, q, v, p, segments, batch_size=batch, row_base=row_base,
                **kwargs), params)
        self.c_sample = self._device_sample_stack(samples, num_samples)
        return c

    @profiling.annotate("ccvm.call")
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
        ``evolution_step_size`` records ``c_sample`` and writes the best
        trajectory's to ``evolution_file``.
        """
        if instance.device != self.device:
            raise ValueError(
                f"The device type of the instance ({instance.device}) and the solver"
                f" ({self.device}) must match."
            )
        return langevin_family_call(
            self, instance, ("pump", "dt", "S", "iterations", "sigma", "feedback_scale"),
            lambda t: self._make_params(t["pump"], t["S"], t["dt"], t["sigma"],
                                        t["feedback_scale"], t["iterations"]),
            lambda seed, params, iterations, evolution_step_size, hp: self._solve(
                seed, params, iterations, pump_rate_flag,
                evolution_step_size=evolution_step_size, hp=hp),
            post_processor, evolution_step_size, evolution_file,
            algorithm_parameters, seed)
