"""The port's LangevinSolver and PumpedLangevinSolver façades against the JAX
ones, and their guard rails (CPU).

With ``sigma = 0`` the diffusion is zero on both sides (the JAX façade on
the CPU takes its lax path; the port runs its plain version, whose draws
are scaled by sigma), so the two integrate the same deterministic SDE.
Objective values agree to rtol 1e-4 (float32 round-off over a few hundred
steps), the statistics exactly.
"""

from __future__ import annotations

import os
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import torch

from ccvm_tpu import AdamParameters as JAdamParameters
from ccvm_tpu import LangevinSolver as JLangevinSolver
from ccvm_tpu import ProblemInstance as JProblemInstance
from ccvm_tpu import PumpedLangevinSolver as JPumpedLangevinSolver
from ccvm_tpu_torch import (AdamParameters, LangevinSolver, ProblemInstance,
                            PumpedLangevinSolver)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST020 = os.path.join(REPO, "tests", "data", "test020.in")
PARAMS = {20: {"dt": 0.002, "S": 0.5, "iterations": 300, "sigma": 0.0,
               "feedback_scale": 2.0}}
PUMPED_PARAMS = {20: {"pump": 1.0, "dt": 0.002, "S": 0.5, "iterations": 300,
                      "sigma": 0.0, "feedback_scale": 1.0}}
FAMILIES = {
    "langevin": (JLangevinSolver, LangevinSolver, PARAMS, 0.1),
    "pumped": (JPumpedLangevinSolver, PumpedLangevinSolver, PUMPED_PARAMS, 0.01),
}


# Where a post-processor's result is decided by the float32 round-off of
# its input, the two sides part by more than round-off, so the façades are
# held to what was measured here: (rtol of the objective values and the
# best value, atol of the problem variables); the statistics stay exact.
#   adam: its first step is lr g / (|g| + eps), +-0.01 on a coordinate
#     whose gradient the converged solve left at round-off, with the sign
#     of that round-off (best values 1.0e-5 apart on Langevin-Adam);
#   bfgs: 50 L-BFGS iterations reach the box minimum of the relaxed
#     objective, where the float32 energy is flat to an ulp, and each side
#     stops where its own round-off fails the next step's test, up to
#     sqrt(ulp(f) / lambda_min) ~ 6e-4 apart in x, read at 2 (x - 0.5),
#     where the gradient is not zero (objectives 7.6e-4 apart).
# tests/test_torch_post_processors.py holds both alone at 1e-5 and 1e-4.
ROUND_OFF_DECIDED = {"adam": (1e-4, 2e-2), "bfgs": (2e-3, 2e-3)}


def _solve(solver_cls, instance_cls, params, batch=64, **call):
    solver = solver_cls(device="cpu", batch_size=batch)
    solver.parameter_key = params
    inst = instance_cls(device="cpu", file_path=TEST020, instance_type="test")
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    return solver(inst, seed=3, **call)


@pytest.mark.parametrize("post_processor",
                         [None, "grad-descent", "adam", "asgd", "bfgs", "lbfgs"])
@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_facades_agree_without_diffusion(family, adam, post_processor):
    jcls, tcls, params, alpha = FAMILIES[family]
    jcall = {"post_processor": post_processor}
    tcall = dict(jcall)
    if adam:
        jcall["algorithm_parameters"] = JAdamParameters(alpha=alpha)
        tcall["algorithm_parameters"] = AdamParameters(alpha=alpha)
    sol_j = _solve(jcls, JProblemInstance, params, **jcall)
    sol_t = _solve(tcls, ProblemInstance, params, **tcall)
    rtol, atol = ROUND_OFF_DECIDED.get(post_processor, (None, None))
    np.testing.assert_allclose(np.asarray(sol_t.objective_values),
                               np.asarray(sol_j.objective_values), rtol=rtol or 1e-4)
    assert sol_t.solution_performance == sol_j.solution_performance
    assert sol_t.best_objective_value == pytest.approx(
        sol_j.best_objective_value, rel=rtol or 1e-6)
    # (c + S) / (2S) maps into [0, 1] before the post-processor (BFGS hands
    # back 2 (x - 0.5), in [-1, 1]).
    pv = sol_t.variables["problem_variables"]
    low = -1.0 if post_processor == "bfgs" else 0.0
    assert pv.shape == (64, 20) and low <= pv.min() and pv.max() <= 1.0
    np.testing.assert_allclose(
        pv.numpy(), np.asarray(sol_j.variables["problem_variables"]),
        atol=atol or 1e-4)
    assert (sol_t.pp_time > 0) == (post_processor is not None)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_noise_on_solve_is_seeded(family):
    _, tcls, params, _ = FAMILIES[family]
    noisy = {20: dict(params[20], sigma=0.5, iterations=100)}
    a = _solve(tcls, ProblemInstance, noisy, batch=16)
    b = _solve(tcls, ProblemInstance, noisy, batch=16)
    assert np.array_equal(a.objective_values, b.objective_values)
    assert np.all(np.isfinite(a.objective_values))
    # The noise separates the trajectories (sigma = 0 keeps them equal).
    assert len(set(np.round(a.objective_values, 6))) > 1


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_solution_keeps_the_final_amplitudes(family):
    """``variables["c"]`` is the solve's final state, before the change of
    variables: without a post-processor the problem variables are
    ``(c + S) / (2 S)`` of it exactly; a refinement leaves it as it was."""
    _, tcls, params, _ = FAMILIES[family]
    noisy = {20: dict(params[20], sigma=0.5, iterations=100)}
    sol = _solve(tcls, ProblemInstance, noisy, batch=16)
    c = sol.variables["c"]
    assert set(sol.variables) == {"problem_variables", "c"}
    assert c.shape == (16, 20) and c.dtype == torch.float32
    S = torch.tensor(0.5, dtype=torch.float32)
    assert torch.equal(sol.variables["problem_variables"], (c + S) / (2 * S))
    assert c.abs().max() <= 0.5 and len(set(c.flatten().tolist())) > 2
    refined = _solve(tcls, ProblemInstance, noisy, batch=16, post_processor="grad-descent")
    assert torch.equal(refined.variables["c"], c)


def test_fpga_machine_time_and_energy_match_jax():
    frame = pd.DataFrame({"iterations": [300.0, 500.0], "pp_time": [0.01, 0.03],
                          "solve_time": [0.2, 0.4]})
    j, t = JLangevinSolver(device="cpu"), LangevinSolver(device="cpu")
    j.parameter_key = t.parameter_key = PARAMS
    for machine in ("fpga", "cpu", "gpu"):
        for size in (20, 70):
            assert t.machine_energy(machine)(frame, size) == pytest.approx(
                j.machine_energy(machine)(frame, size), rel=1e-12)
            assert t.machine_time(machine)(dataframe=frame, problem_size=size) == \
                pytest.approx(j.machine_time(machine)(dataframe=frame,
                                                      problem_size=size), rel=1e-12)
    custom = {"fpga_power": {20: 1.0}, "fpga_runtimes": {20: 2e-4}}
    assert t.machine_energy("fpga", custom)(frame, 20) == pytest.approx(
        j.machine_energy("fpga", custom)(frame, 20), rel=1e-12)
    with pytest.raises(ValueError, match="Missing required keys"):
        t.machine_energy("fpga", {"fpga_power": {}})
    with pytest.raises(ValueError, match="missing required column"):
        t.machine_time("fpga")(dataframe=pd.DataFrame({"x": [1.0]}), problem_size=20)
    with pytest.raises(ValueError, match="does not"):
        t.machine_time("fpga", custom)(dataframe=frame, problem_size=30)
    with pytest.raises(ValueError, match="Mismatch"):
        t.machine_energy("mf-ccvm")


def test_pumped_has_only_the_cpu_and_gpu_machine_models():
    frame = pd.DataFrame({"iterations": [300.0], "pp_time": [0.01],
                          "solve_time": [0.2]})
    j, t = JPumpedLangevinSolver(device="cpu"), PumpedLangevinSolver(device="cpu")
    for machine in ("cpu", "gpu"):
        assert t.machine_energy(machine)(frame, 20) == pytest.approx(
            j.machine_energy(machine)(frame, 20), rel=1e-12)
    with pytest.raises(ValueError, match="Mismatch"):
        t.machine_energy("fpga")


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize(
    "call",
    [{"evolution_step_size": 10},
     {"post_processor": "bfgs", "evolution_step_size": 10}],
    ids=["evolution", "post_processor"],
)
def test_features_left_out_raise(tmp_path, family, call):
    """Evolution sampling, with and without a post-processor, now runs on
    the port and matches the JAX façade: objective values to rtol 1e-4
    (BFGS: ROUND_OFF_DECIDED), the c samples to rtol 1e-4 and the evolution
    file (4 decimals) to atol 2e-4."""
    jcls, tcls, params, _ = FAMILIES[family]
    runs = []
    for side, cls, inst_cls in (("jax", jcls, JProblemInstance),
                                ("torch", tcls, ProblemInstance)):
        solver = cls(device="cpu", batch_size=8)
        solver.parameter_key = params
        inst = inst_cls(device="cpu", file_path=TEST020, instance_type="test")
        inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
        runs.append((solver, solver(inst, seed=3, evolution_file=str(tmp_path / side),
                                    **call)))
    (js, sol_j), (ts, sol_t) = runs
    rtol = ROUND_OFF_DECIDED.get(call.get("post_processor"), (1e-4,))[0]
    np.testing.assert_allclose(np.asarray(sol_t.objective_values),
                               np.asarray(sol_j.objective_values), rtol=rtol)
    assert sol_t.solution_performance == sol_j.solution_performance
    np.testing.assert_allclose(ts.c_sample.numpy(), np.asarray(js.c_sample),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.loadtxt(sol_t.evolution_file),
                               np.loadtxt(sol_j.evolution_file), atol=2e-4)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_per_variable_s_mesh_tune_and_backend_raise(family):
    """A 1-D S of the problem's size now runs and matches the JAX façade
    (more in tests/test_torch_per_variable_s.py); a mesh runs now
    (tests/test_torch_mesh.py) and what is not a DeviceMesh raises; a
    backend other than "auto" raises DLSolver's and MFSolver's ValueError; tune runs
    (tests/test_torch_tuning.py) and, as the JAX package's, needs a
    parameter key first."""
    jcls, tcls, params, _ = FAMILIES[family]
    vector_s = {20: dict(params[20], S=np.linspace(0.4, 0.6, 20))}
    sol_j = _solve(jcls, JProblemInstance, vector_s, batch=8)
    sol_t = _solve(tcls, ProblemInstance, vector_s, batch=8)
    np.testing.assert_allclose(np.asarray(sol_t.objective_values),
                               np.asarray(sol_j.objective_values), rtol=1e-4)
    assert sol_t.solution_performance == sol_j.solution_performance
    with pytest.raises(TypeError, match="DeviceMesh"):
        tcls(device="cpu", mesh=object())
    with pytest.raises(ValueError, match="Set solver.parameter_key before tuning"):
        tcls(device="cpu").tune([])
    with pytest.raises(ValueError, match='backend must be "auto"'):
        tcls(device="cpu", backend="pallas")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_parameter_key_and_devices(family):
    _, tcls, params, _ = FAMILIES[family]
    solver = tcls(device="cpu")
    with pytest.raises(ValueError, match="not valid for this solver"):
        solver.parameter_key = {20: {"dt": 0.1}}
    solver.parameter_key = {30: params[20]}
    inst = ProblemInstance(device="cpu", file_path=TEST020)
    with pytest.raises(KeyError, match="not defined"):
        solver(inst)
    for bad in ("tpu", "gpu", "cuda:0"):
        with pytest.raises(ValueError, match="Given device is not available"):
            tcls(device=bad)
    with pytest.raises(ValueError, match="kernel_rng"):
        tcls(device="cpu", kernel_rng="mersenne")
    with pytest.raises(ValueError, match="must match"):
        tcls(device="cpu").__call__(mock.Mock(device="cuda"))
    with pytest.raises(ValueError, match="not supported"):
        _solve(tcls, ProblemInstance, params, batch=8, algorithm_parameters=object())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cuda_raises_without_a_card(monkeypatch, family):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        FAMILIES[family][1](device="cuda")
