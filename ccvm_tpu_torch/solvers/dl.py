"""DL-CCVM solver façade (API parity with
``ccvm_simulators/solvers/dl_solver.py`` and ``ccvm_tpu/solvers/dl.py``).

``device="cuda"`` launches the whole-solve CUDA kernel (``csrc/dl_solve.cu``)
for every feature this port carries (evolution sampling as one segment
launch a sample, a per-variable S and the generalised ``pump_ramp`` included);
``device="cpu"`` runs its plain PyTorch version.  No feature takes another
path quietly.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ccvm_tpu_torch import profiling
from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics import dl as dyn
from ccvm_tpu_torch.ops import dl_kernels
from ccvm_tpu_torch.post_processor.factory import PostProcessorFactory
from ccvm_tpu_torch.runtime import synchronize
from ccvm_tpu_torch.solution import Solution
from ccvm_tpu_torch.solvers.algorithms import AdamParameters
from ccvm_tpu_torch.solvers.base import CCVMSolver, per_variable_saturation, saturation_of

DL_SCALING_MULTIPLIER = 0.2
"""Reference ``dl_solver.py:12``."""


class DLSolver(CCVMSolver):
    """Models the delay-line coherent continuous-variable machine (DL-CCVM),
    reference ``dl_solver.py:17``.

    ``mesh`` shards the batch (and with a "model" axis the features) as
    the base class says; ``backend`` is kept for signature parity with the
    JAX façade and accepts only "auto" (the device decides the path).
    """

    def __init__(
        self,
        device,
        problem_category="boxqp",
        batch_size=1000,
        S=1,
        mesh=None,
        backend="auto",
        timing="sync",
        kernel_rng="popcount16",
    ):
        super().__init__(device, mesh=mesh, timing=timing)
        if backend != "auto":
            raise ValueError(
                f'backend must be "auto" (the device decides the path), got {backend!r}'
            )
        if kernel_rng not in dl_kernels.philox.RNG_NAMES:
            raise ValueError(
                f"kernel_rng must be one of {dl_kernels.philox.RNG_NAMES}, got {kernel_rng!r}"
            )
        self.batch_size = batch_size
        self.kernel_rng = kernel_rng
        self.S = S
        self.backend = backend
        self._default_optics_machine_parameters = {
            "laser_power": 1200e-6,
            "modulators_power": 10e-3,
            "squeezing_power": 180e-3,
            "electronics_power": 0.0,
            "amplifiers_power": 222.2e-3,
            "electronics_latency": 1e-9,
            "laser_clock": 10e-12,
            "postprocessing_power": {
                20: 4.96,
                30: 5.1,
                40: 4.95,
                50: 5.26,
                60: 5.11,
                70: 5.09,
            },
        }
        self._scaling_multiplier = DL_SCALING_MULTIPLIER
        self._method_selector(problem_category)

    @property
    def parameter_key(self):
        """Keys must be exactly {pump, dt, iterations, noise_ratio,
        feedback_scale} (reference ``dl_solver.py:96-115``)."""
        return self._parameter_key

    @parameter_key.setter
    def parameter_key(self, parameters):
        expected_dlparameter_key_set = set(
            ["pump", "dt", "iterations", "noise_ratio", "feedback_scale"]
        )
        for parameter_key in parameters.values():
            if parameter_key.keys() != expected_dlparameter_key_set:
                raise ValueError(
                    "The parameter key is not valid for this solver. Expected keys: "
                    + str(expected_dlparameter_key_set)
                    + " Given keys: "
                    + str(parameter_key.keys())
                )
        self._parameter_key = parameters
        self._is_tuned = False

    ##################################
    # Problem-category methods       #
    ##################################

    def _calculate_drift_boxqp(
        self, c, s, pump, rate, feedback_scale=100, lower_limit=0, upper_limit=1, S=1
    ):
        """Two-quadrature drift (reference ``dl_solver.py:117-172``); the
        pump>1 saturation override happens inside, as in the reference."""
        if pump > 1:
            S = np.sqrt(pump - 1)
        return dyn.drift_boxqp(
            torch.as_tensor(c), torch.as_tensor(s), self.q_matrix, self.v_vector,
            pump, rate, feedback_scale, lower_limit, upper_limit, S,
        )

    def _calculate_grads_boxqp(self, c, s, lower_limit=0, upper_limit=1, S=1):
        return dyn.grads_boxqp(
            torch.as_tensor(c), torch.as_tensor(s), self.q_matrix, self.v_vector,
            lower_limit, upper_limit, S,
        )

    def _change_variables_boxqp(self, problem_variables, lower_limit=0, upper_limit=1, S=1):
        return common.change_variables_boxqp(
            torch.as_tensor(problem_variables), lower_limit, upper_limit, S
        )

    def _fit_to_constraints_boxqp(self, c, lower_clamp, upper_clamp):
        return common.fit_to_constraints_boxqp(
            torch.as_tensor(c), lower_clamp, upper_clamp
        )

    def _is_valid_optics_machine_parameters(self, machine_parameters):
        required_keys = [
            "laser_power",
            "modulators_power",
            "squeezing_power",
            "electronics_power",
            "amplifiers_power",
            "electronics_latency",
            "laser_clock",
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

    def _optics_machine_energy(self, machine_parameters=None):
        """DL-CCVM optics energy model (reference ``dl_solver.py:331-406``)."""
        if machine_parameters is None:
            machine_parameters = self._default_optics_machine_parameters
        else:
            self._is_valid_optics_machine_parameters(machine_parameters)

        def _optics_machine_energy_callable(dataframe, problem_size: int):
            self._validate_machine_energy_dataframe_columns(dataframe)
            try:
                pump = self.parameter_key[problem_size]["pump"]
            except KeyError:
                raise KeyError(
                    f"Pump for the given instance size: {problem_size} is not defined."
                )

            T_clock = machine_parameters["laser_clock"]
            P_opt = machine_parameters["laser_power"]
            T_elec = machine_parameters["electronics_latency"]
            P_mod = machine_parameters["modulators_power"]
            P_sq = machine_parameters["squeezing_power"]
            P_elec = machine_parameters["electronics_power"]
            P_opa = machine_parameters["amplifiers_power"]
            postprocessing_time = np.mean(dataframe["pp_time"].values)
            iterations = np.mean(dataframe["iterations"].values)
            size = float(problem_size)
            optics_energy = (
                pump * P_opt * T_elec
                + pump * P_opt * T_clock * size
                + 2 * P_mod * T_clock * size * (size - 1)
                + P_sq * T_elec
                + P_sq * T_clock * size
                + P_elec * T_elec
                + P_elec * T_clock * size
                + P_opa * T_elec * (size - 1)
                + P_opa * T_clock * size * (size - 1)
            ) * iterations
            postprocessing_energy = (
                machine_parameters["postprocessing_power"][problem_size]
                * postprocessing_time
            )
            return optics_energy + postprocessing_energy

        return _optics_machine_energy_callable

    def _optics_machine_time(self, machine_parameters: dict = None):
        """DL-CCVM optics time model: N * laser_clock * iterations + pp_time
        (reference ``dl_solver.py:408-466``)."""
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
                    f"The given dataframe is missing the {e.args[0]} "
                    f"column. Required columns are: ['iterations', 'pp_time']."
                )
            laser_clock = machine_parameters["laser_clock"]
            return float(problem_size) * laser_clock * iterations + postprocessing_time

        return _optics_machine_time_callable

    ##################################
    # Solve paths                    #
    ##################################

    def _make_params(self, pump, S, dt, noise_ratio, feedback_scale, g, iterations,
                     pump_ramp=None):
        """DLParams in float32; ``S`` a scalar or one a column;
        ``pump_ramp`` ``(power, fraction)`` checked as the JAX façade checks
        it (``ccvm_tpu/solvers/dl.py:229-256``), ``(1.0, 1.0)`` normalised
        to the reference's linear ramp (unset fields)."""
        lo, hi = self.solution_bounds
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        ramp_power = ramp_fraction = None
        if pump_ramp is not None:
            power, fraction = pump_ramp
            if not (fraction > 0):
                raise ValueError("pump_ramp fraction must be positive.")
            if not (power > 0):
                raise ValueError("pump_ramp power must be positive.")
            if (power, fraction) != (1.0, 1.0):
                ramp_power, ramp_fraction = f32(power), f32(fraction)
        return dyn.DLParams(
            pump=f32(pump), S=common.saturation(S), dt=f32(dt),
            noise_ratio=f32(noise_ratio), feedback_scale=f32(feedback_scale),
            g=f32(g), lower_limit=f32(lo), upper_limit=f32(hi),
            iterations=f32(iterations), ramp_power=ramp_power,
            ramp_fraction=ramp_fraction,
        )

    def _solve(self, seed, params, iterations, pump_rate_flag, pump_is_gt_one,
               evolution_step_size=None, hp=None):
        """The solve on the instance's device (kernel on "cuda", plain
        version on "cpu"): one whole-solve launch, or with
        ``evolution_step_size`` one segment launch a sample (the JAX
        ``_evolution_sample_plan``), the samples kept on the device in
        ``c_sample`` / ``s_sample``.  ``hp`` selects the Adam variant, which
        works here although the reference's own DL+Adam call site raises
        TypeError (``dl_solver.py:906-923``).  A mesh shards the batch
        (:meth:`_sharded`), or with a "model" axis runs
        :func:`ccvm_tpu_torch.parallel.tp.dl_solve`."""
        kwargs = dict(pump_rate_flag=pump_rate_flag, pump_is_gt_one=pump_is_gt_one,
                      rng=self.kernel_rng, hp=hp)
        q, v = self.q_matrix, self.v_vector
        if not evolution_step_size:
            tp_mesh = self._tp_mesh()
            if tp_mesh is not None:
                from ccvm_tpu_torch.parallel import tp

                return tp.dl_solve(tp_mesh, seed, q, v, params, iterations=iterations,
                                   batch_size=self.batch_size, **kwargs)
            return self._sharded(lambda p, batch, row_base: dl_kernels.dl_solve(
                seed, q, v, p, iterations=iterations, batch_size=batch,
                row_base=row_base, **kwargs), params)
        num_samples, segments = self._evolution_sample_plan(iterations,
                                                            evolution_step_size)
        (c, s), (c_samples, s_samples) = self._sharded(
            lambda p, batch, row_base: dl_kernels.dl_solve_sampled(
                seed, q, v, p, segments, batch_size=batch, row_base=row_base,
                **kwargs), params)
        self.c_sample = self._device_sample_stack(c_samples, num_samples)
        self.s_sample = self._device_sample_stack(s_samples, num_samples)
        return c, s

    @profiling.annotate("ccvm.call")
    def __call__(
        self,
        instance,
        post_processor=None,
        pump_rate_flag=True,
        g=0.05,
        evolution_step_size=None,
        evolution_file=None,
        algorithm_parameters=None,
        seed=None,
        pump_ramp=None,
    ):
        """Solve an instance (reference ``dl_solver.py:771-999``).

        ``seed`` (int) keys the kernel's Philox noise; ``None`` draws one.
        ``pump_ramp``: optional ``(power, fraction)`` generalising the linear
        pump ramp to rate(i) = min((i+1)/(fraction*T), 1)**power, as the JAX
        façade's; ``(1.0, 1.0)`` or ``None`` is the reference schedule.
        ``evolution_step_size`` records ``c_sample`` / ``s_sample`` and
        writes the best trajectory's to ``evolution_file``.
        """
        if instance.device != self.device:
            raise ValueError(
                f"The device type of the instance ({instance.device}) and the solver"
                f" ({self.device}) must match."
            )
        if pump_ramp is not None:
            try:
                pump_ramp = tuple(float(x) for x in pump_ramp)
            except (TypeError, ValueError):
                pump_ramp = ()
            if len(pump_ramp) != 2:
                raise ValueError(
                    f"pump_ramp must be a (power, fraction) pair of numbers, got "
                    f"{pump_ramp!r}.")

        problem_size = instance.problem_size
        self.q_matrix = instance.q_matrix
        self.v_vector = instance.v_vector
        self.solution_bounds = instance.solution_bounds

        batch_size = self.batch_size

        try:
            pump = self.parameter_key[problem_size]["pump"]
            dt = self.parameter_key[problem_size]["dt"]
            iterations = self.parameter_key[problem_size]["iterations"]
            noise_ratio = self.parameter_key[problem_size]["noise_ratio"]
            feedback_scale = self.parameter_key[problem_size]["feedback_scale"]
        except KeyError as e:
            raise KeyError(
                f"The parameter '{e.args[0]}' for the given instance size is not defined."
            ) from e
        S = per_variable_saturation(self.S, problem_size, batch_size,
                                    self.torch_device)
        self.c_sample = None
        self.s_sample = None
        evolution_file = self._evolution_file(instance, evolution_step_size,
                                              evolution_file)

        # An unknown post-processor raises before the solve is spent.
        post_processor_object = (
            PostProcessorFactory.create_postprocessor(post_processor)
            if post_processor else None
        )
        solve_time_start = time.time()

        params = self._make_params(
            pump, S, dt, noise_ratio, feedback_scale, g, iterations,
            pump_ramp=pump_ramp,
        )
        pump_is_gt_one = bool(pump > 1)
        if seed is None:
            seed = np.random.SeedSequence().entropy % (2**31)
        seed = int(seed)

        if algorithm_parameters is None:
            hp = None
        elif isinstance(algorithm_parameters, AdamParameters):
            hp = algorithm_parameters.to_hyperparameters()
        else:
            raise ValueError(
                f"Solver option type {type(algorithm_parameters)} is not supported."
            )
        c, s = self._solve(
            seed, params, iterations, pump_rate_flag, pump_is_gt_one,
            evolution_step_size=evolution_step_size, hp=hp,
        )
        if self.timing == "sync":
            synchronize(c)
        solve_time = (time.time() - solve_time_start) / batch_size

        lo, hi = self.solution_bounds
        S = saturation_of(params, c.device)
        if post_processor_object is not None:
            with profiling.annotate("ccvm.postprocess"):
                problem_variables = post_processor_object.postprocess(
                    self.change_variables(c, lo, hi, S),
                    self.q_matrix,
                    self.v_vector,
                )
            pp_time = post_processor_object.pp_time / batch_size
        else:
            problem_variables = c
            pp_time = 0.0

        # The reference applies change_variables AGAIN to post-processed
        # output (dl_solver.py:941-958); kept for parity.  Float64 readout:
        # the change of variables and every row's float64 energy run on the
        # device; only the energies cross.  With one S a column the box
        # coordinates are materialised first, as the JAX façade does
        # (ccvm_tpu/solvers/dl.py:451-459).
        if np.ndim(params.S) == 0:
            objval = instance.compute_energy_readout64(
                problem_variables, change_vars=("boxqp", lo, hi, params.S),
            )
        else:
            objval = instance.compute_energy_readout64(
                self.change_variables(problem_variables, lo, hi, S))

        if self.timing == "async":
            solve_time = (time.time() - solve_time_start) / batch_size - pp_time

        if evolution_step_size:
            self._write_evolution(evolution_file, objval, (self.c_sample, self.s_sample))

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
                "s": s,
            },
            device=self.device,
        )
        if evolution_step_size:
            solution.evolution_file = evolution_file
        return solution
