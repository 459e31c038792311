"""MF-CCVM solver façade (API parity with
``ccvm_simulators/solvers/mf_solver.py`` and ``ccvm_tpu/solvers/mf.py``).

``device="cuda"`` launches the whole-solve CUDA kernel (``csrc/mf_solve.cu``)
for every feature this port carries (evolution sampling as one segment
launch a sample, and a per-variable S, included); ``device="cpu"`` runs its
plain PyTorch version.  No feature takes another path quietly.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ccvm_tpu_torch import profiling
from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics import mf as dyn
from ccvm_tpu_torch.ops import mf_kernels, philox
from ccvm_tpu_torch.post_processor.factory import PostProcessorFactory
from ccvm_tpu_torch.runtime import synchronize
from ccvm_tpu_torch.solution import Solution
from ccvm_tpu_torch.solvers.algorithms import AdamParameters
from ccvm_tpu_torch.solvers.base import CCVMSolver, per_variable_saturation, saturation_of

MF_SCALING_MULTIPLIER = 0.05
"""Reference ``mf_solver.py:12``."""


class MFSolver(CCVMSolver):
    """Measurement-feedback CCVM solver (reference ``mf_solver.py:17``).

    ``mesh`` shards the batch (and with a "model" axis the features) as
    the base class says; ``backend`` is kept for signature parity with the
    JAX façade and accepts only "auto" (the device decides the path).
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
        if backend != "auto":
            raise ValueError(
                f'backend must be "auto" (the device decides the path), got {backend!r}'
            )
        if kernel_rng not in philox.RNG_NAMES:
            raise ValueError(
                f"kernel_rng must be one of {philox.RNG_NAMES}, got {kernel_rng!r}"
            )
        self.batch_size = batch_size
        self.backend = backend
        self.kernel_rng = kernel_rng
        self._default_optics_machine_parameters = {
            "laser_clock": 100e-12,
            "FPGA_clock": 3.33e-9,
            "FPGA_fixed": 34,
            "FPGA_var_fac": 0.1,
            "FPGA_power": {
                20: 15.74,
                30: 16.97,
                40: 18.54,
                50: 20.25,
                60: 22.08,
                70: 24.01,
            },
            "buffer_time": 3.33e-9,
            "laser_power": 1000e-6,
            "postprocessing_power": {
                20: 4.87,
                30: 5.14,
                40: 5.11,
                50: 5.08,
                60: 5.09,
                70: 5.3,
            },
        }
        self._scaling_multiplier = MF_SCALING_MULTIPLIER
        self._method_selector(problem_category)

    @property
    def parameter_key(self):
        """Keys must be exactly {pump, feedback_scale, j, S, dt, iterations}
        (reference ``mf_solver.py:120-139``)."""
        return self._parameter_key

    @parameter_key.setter
    def parameter_key(self, parameters):
        expected_mfparameter_key_set = set(
            ["pump", "feedback_scale", "j", "S", "dt", "iterations"]
        )
        for parameter_key in parameters.values():
            if parameter_key.keys() != expected_mfparameter_key_set:
                raise ValueError(
                    "The parameter key is not valid for this solver. Expected keys: "
                    + str(expected_mfparameter_key_set)
                    + " Given keys: "
                    + str(parameter_key.keys())
                )
        self._parameter_key = parameters
        self._is_tuned = False

    ##################################
    # Problem-category methods       #
    ##################################

    def _calculate_drift_boxqp(
        self, mu, mu_tilde, sigma, pump, j, g, S, fs, lower_limit=0, upper_limit=1
    ):
        """Drift of mu and sigma (reference ``mf_solver.py:141-198``)."""
        return dyn.drift_boxqp(
            torch.as_tensor(mu), torch.as_tensor(mu_tilde), torch.as_tensor(sigma),
            pump, j, g, S, fs, self.q_matrix, self.v_vector,
            lower_limit, upper_limit,
        )

    def _calculate_grads_boxqp(self, mu_tilde, S, fs, lower_limit=0, upper_limit=1):
        return dyn.grads_boxqp(
            torch.as_tensor(mu_tilde), S, fs, self.q_matrix, self.v_vector,
            lower_limit, upper_limit,
        )

    def _change_variables_boxqp(self, problem_variables, lower_limit=0, upper_limit=1, S=1):
        return common.change_variables_boxqp(
            torch.as_tensor(problem_variables), lower_limit, upper_limit, S
        )

    def _fit_to_constraints_boxqp(self, mu_tilde, lower_clamp, upper_clamp):
        return common.fit_to_constraints_boxqp(
            torch.as_tensor(mu_tilde), lower_clamp, upper_clamp
        )

    def _is_valid_optics_machine_parameters(self, machine_parameters):
        required_keys = [
            "laser_clock",
            "FPGA_clock",
            "FPGA_fixed",
            "FPGA_var_fac",
            "FPGA_power",
            "buffer_time",
            "laser_power",
            "postprocessing_power",
        ]
        missing_keys = [key for key in required_keys if key not in machine_parameters]
        if missing_keys:
            raise ValueError(
                f"Invalid optics_machine_parameters: Missing required keys - {missing_keys}"
            )

    ##################################
    # Machine models                 #
    ##################################

    def _roundtrip_time(self, machine_parameters, problem_size):
        """FPGA+optics roundtrip (reference ``mf_solver.py:404-412``)."""
        return (
            (
                machine_parameters["FPGA_fixed"]
                + machine_parameters["FPGA_var_fac"] * float(problem_size)
            )
            * machine_parameters["FPGA_clock"]
            + float(problem_size) * machine_parameters["laser_clock"]
            + machine_parameters["buffer_time"]
        )

    def _optics_machine_energy(self, machine_parameters=None):
        """MF-CCVM optics energy model (reference ``mf_solver.py:348-428``)."""
        if machine_parameters is None:
            machine_parameters = self._default_optics_machine_parameters
        else:
            self._is_valid_optics_machine_parameters(machine_parameters)

        def _optics_machine_energy_callable(dataframe, problem_size: int):
            self._validate_machine_energy_dataframe_columns(dataframe)
            try:
                pump = self.parameter_key[problem_size]["pump"]
                measure_strength = self.parameter_key[problem_size]["j"]
            except KeyError as e:
                raise KeyError(
                    f"The parameter '{e.args[0]}' for the given instance size:"
                    f" {problem_size} is not defined."
                ) from e

            iterations = np.mean(dataframe["iterations"].values)
            postprocessing_time = np.mean(dataframe["pp_time"].values)
            roundtrip_time = self._roundtrip_time(machine_parameters, problem_size)
            optics_power = machine_parameters["FPGA_power"][
                problem_size
            ] + machine_parameters["laser_power"] * (pump + 1 + measure_strength)
            optics_energy = (
                roundtrip_time * optics_power
                - machine_parameters["FPGA_power"][problem_size]
                * machine_parameters["buffer_time"]
            ) * iterations
            postprocessing_energy = (
                machine_parameters["postprocessing_power"][problem_size]
                * postprocessing_time
            )
            return optics_energy + postprocessing_energy

        return _optics_machine_energy_callable

    def _optics_machine_time(self, machine_parameters: dict = None):
        """MF-CCVM optics time model: roundtrip(N) * iterations + pp_time
        (reference ``mf_solver.py:430-491``)."""
        if machine_parameters is None:
            machine_parameters = self._default_optics_machine_parameters
        else:
            self._is_valid_optics_machine_parameters(machine_parameters)

        def _optics_machine_time_callable(dataframe, problem_size: int):
            try:
                iterations = np.mean(dataframe["iterations"].values)
                postprocessing_time = np.mean(dataframe["pp_time"].values)
            except KeyError as e:
                raise KeyError(
                    f"The given dataframe is missing the {e.args[0]} column."
                    " Required columns are: ['iterations', 'pp_time']."
                )
            roundtrip_time = self._roundtrip_time(machine_parameters, problem_size)
            return roundtrip_time * iterations + postprocessing_time

        return _optics_machine_time_callable

    ##################################
    # Solve paths                    #
    ##################################

    def _make_params(self, pump, S, dt, j, feedback_scale, g, iterations):
        lo, hi = self.solution_bounds
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        return dyn.MFParams(
            pump=f32(pump), S=common.saturation(S), dt=f32(dt), j=f32(j),
            feedback_scale=f32(feedback_scale), g=f32(g), lower_limit=f32(lo),
            upper_limit=f32(hi), iterations=f32(iterations),
        )

    def _solve(self, seed, params, iterations, pump_rate_flag, evolution_step_size=None,
               hp=None):
        """The solve on the instance's device (kernel on "cuda", plain
        version on "cpu"): one whole-solve launch, or with
        ``evolution_step_size`` one segment launch a sample, the samples
        kept on the device in ``mu_sample`` / ``sigma_sample``; ``hp``
        selects the Adam variant.  A mesh shards the batch
        (:meth:`_sharded`), or with a "model" axis runs
        :func:`ccvm_tpu_torch.parallel.tp.mf_solve`."""
        kwargs = dict(pump_rate_flag=pump_rate_flag, rng=self.kernel_rng, hp=hp)
        q, v = self.q_matrix, self.v_vector
        if not evolution_step_size:
            tp_mesh = self._tp_mesh()
            if tp_mesh is not None:
                from ccvm_tpu_torch.parallel import tp

                return tp.mf_solve(tp_mesh, seed, q, v, params, iterations=iterations,
                                   batch_size=self.batch_size, **kwargs)
            return self._sharded(lambda p, batch, row_base: mf_kernels.mf_solve(
                seed, q, v, p, iterations=iterations, batch_size=batch,
                row_base=row_base, **kwargs), params)
        num_samples, segments = self._evolution_sample_plan(iterations,
                                                            evolution_step_size)
        (mu, mu_tilde, sigma), (mu_samples, sigma_samples) = self._sharded(
            lambda p, batch, row_base: mf_kernels.mf_solve_sampled(
                seed, q, v, p, segments, batch_size=batch, row_base=row_base,
                **kwargs), params)
        self.mu_sample = self._device_sample_stack(mu_samples, num_samples)
        self.sigma_sample = self._device_sample_stack(sigma_samples, num_samples)
        return mu, mu_tilde, sigma

    @profiling.annotate("ccvm.call")
    def __call__(
        self,
        instance,
        post_processor=None,
        g=0.01,
        pump_rate_flag=True,
        evolution_step_size=None,
        evolution_file=None,
        algorithm_parameters=None,
        seed=None,
    ):
        """Solve an instance (reference ``mf_solver.py:766-989``).

        ``seed`` (int) keys the kernel's Philox noise; ``None`` draws one.
        ``evolution_step_size`` records ``mu_sample`` / ``sigma_sample`` and
        writes the best trajectory's to ``evolution_file``.
        """
        if instance.device != self.device:
            raise ValueError(
                f"The device type of the instance ({instance.device}) and the solver"
                f" ({self.device}) must match."
            )

        problem_size = instance.problem_size
        self.q_matrix = instance.q_matrix
        self.v_vector = instance.v_vector
        self.solution_bounds = instance.solution_bounds

        batch_size = self.batch_size

        try:
            pump = self.parameter_key[problem_size]["pump"]
            dt = self.parameter_key[problem_size]["dt"]
            iterations = self.parameter_key[problem_size]["iterations"]
            j = self.parameter_key[problem_size]["j"]
            feedback_scale = self.parameter_key[problem_size]["feedback_scale"]
            S = self.parameter_key[problem_size]["S"]
        except KeyError as e:
            raise KeyError(
                f"The parameter '{e.args[0]}' for the given instance size is not"
                " defined."
            ) from e
        S = per_variable_saturation(S, problem_size, batch_size, self.torch_device)
        self.mu_sample = None
        self.sigma_sample = None
        evolution_file = self._evolution_file(instance, evolution_step_size,
                                              evolution_file)

        # An unknown post-processor raises before the solve is spent.
        post_processor_object = (
            PostProcessorFactory.create_postprocessor(post_processor)
            if post_processor else None
        )
        if algorithm_parameters is None:
            hp = None
        elif isinstance(algorithm_parameters, AdamParameters):
            hp = algorithm_parameters.to_hyperparameters()
        else:
            raise ValueError(
                f"Solver option type {type(algorithm_parameters)} is not supported."
            )

        solve_time_start = time.time()

        params = self._make_params(pump, S, dt, j, feedback_scale, g, iterations)
        if seed is None:
            seed = np.random.SeedSequence().entropy % (2**31)
        mu, mu_tilde, sigma = self._solve(
            int(seed), params, iterations, pump_rate_flag,
            evolution_step_size=evolution_step_size, hp=hp,
        )
        if self.timing == "sync":
            synchronize(mu_tilde)
        solve_time = (time.time() - solve_time_start) / batch_size

        lo, hi = self.solution_bounds
        # MF post-processes the CHANGED variables and uses the post-processor
        # output directly (reference mf_solver.py:927-948).
        problem_variables = self.change_variables(
            mu_tilde, lo, hi, saturation_of(params, mu_tilde.device))
        if post_processor_object is not None:
            with profiling.annotate("ccvm.postprocess"):
                problem_variables = post_processor_object.postprocess(
                    problem_variables, self.q_matrix, self.v_vector,
                )
            pp_time = post_processor_object.pp_time / batch_size
        else:
            pp_time = 0.0

        # Float64-grade readout: the f32 energy pass runs on the device; only
        # energies and ambiguous rows cross to the host.
        objval = instance.compute_energy_readout64(problem_variables)

        if self.timing == "async":
            solve_time = (time.time() - solve_time_start) / batch_size - pp_time

        if evolution_step_size:
            self._write_evolution(evolution_file, objval,
                                  (self.mu_sample, self.sigma_sample),
                                  append_trailing_tab=False)

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
            variables={
                "problem_variables": problem_variables,
                "mu": mu,
                "sigma": sigma,
            },
            device=self.device,
        )
        if evolution_step_size:
            solution.evolution_file = evolution_file
        return solution
