"""The port's DLSolver façade against the JAX one, and its guard rails (CPU).

With ``g=0`` the diffusion is zero (``dynamics/dl.py:152``), so both façades
integrate the same deterministic SDE: the JAX lax path against the port's
plain version.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from ccvm_tpu import DLSolver as JDLSolver
from ccvm_tpu import ProblemInstance as JProblemInstance
from ccvm_tpu_torch import AdamParameters, DLSolver, ProblemInstance
from ccvm_tpu_torch.dynamics.dl import DLParams
from ccvm_tpu_torch.ops.dl_kernels import dl_solve_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST020 = os.path.join(REPO, "tests", "data", "test020.in")
PARAMS = {20: {"pump": 8.0, "feedback_scale": 100.0, "noise_ratio": 10.0,
               "dt": 0.001, "iterations": 200}}


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


def _solve(solver_cls, instance_cls, **call):
    solver = solver_cls(device="cpu", batch_size=64)
    solver.parameter_key = PARAMS
    inst = instance_cls(device="cpu", file_path=TEST020, instance_type="test")
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    return solver(inst, g=0.0, seed=3, **call)


@pytest.mark.parametrize("adam", [False, True])
def test_facades_agree_without_diffusion(adam):
    jcall, tcall = {}, {}
    if adam:
        from ccvm_tpu import AdamParameters as JAdamParameters

        jcall["algorithm_parameters"] = JAdamParameters(alpha=0.05)
        tcall["algorithm_parameters"] = AdamParameters(alpha=0.05)
    sol_j = _solve(JDLSolver, JProblemInstance, **jcall)
    sol_t = _solve(DLSolver, ProblemInstance, **tcall)
    np.testing.assert_allclose(np.asarray(sol_t.objective_values),
                               np.asarray(sol_j.objective_values), rtol=1e-4)
    assert sol_t.solution_performance == sol_j.solution_performance
    assert sol_t.best_objective_value == pytest.approx(
        sol_j.best_objective_value, rel=1e-6)
    assert sol_t.variables["problem_variables"].shape == (64, 20)


@pytest.mark.parametrize("post_processor", ["adam", "asgd", "bfgs", "lbfgs"])
@pytest.mark.parametrize("adam", [False, True])
def test_facades_agree_with_each_post_processor(adam, post_processor):
    """The DL façade with each post-processor ported in this slice
    (grad-descent: tests/test_torch_mf_solver.py), at this file's
    tolerances (objective values to rtol 1e-4, the statistics exactly)
    where round-off does not decide the result."""
    jcall, tcall = {"post_processor": post_processor}, {"post_processor": post_processor}
    if adam:
        from ccvm_tpu import AdamParameters as JAdamParameters

        jcall["algorithm_parameters"] = JAdamParameters(alpha=0.05)
        tcall["algorithm_parameters"] = AdamParameters(alpha=0.05)
    sol_j = _solve(JDLSolver, JProblemInstance, **jcall)
    sol_t = _solve(DLSolver, ProblemInstance, **tcall)
    rtol, atol = ROUND_OFF_DECIDED.get(post_processor, (None, None))
    np.testing.assert_allclose(np.asarray(sol_t.objective_values),
                               np.asarray(sol_j.objective_values), rtol=rtol or 1e-4)
    assert sol_t.solution_performance == sol_j.solution_performance
    assert sol_t.best_objective_value == pytest.approx(
        sol_j.best_objective_value, rel=rtol or 1e-6)
    np.testing.assert_allclose(
        sol_t.variables["problem_variables"].numpy(),
        np.asarray(sol_j.variables["problem_variables"]), atol=atol or 1e-4)
    assert sol_t.pp_time > 0


def test_stacked_reference_equals_serial_solves_with_seed_plus_instance():
    rng = np.random.RandomState(5)
    a = rng.randn(2, 10, 10).astype(np.float32)
    q = torch.from_numpy((a + a.transpose(0, 2, 1)) / 2)
    v = torch.from_numpy(rng.randn(2, 10).astype(np.float32))
    p = DLParams(12.0, 1.0, 0.001, 1.0, 200.0, 0.05, 0.0, 1.0, 60.0)
    kw = dict(iterations=60, batch_size=12, pump_rate_flag=True,
              pump_is_gt_one=True)
    c, s = dl_solve_reference(7, q, v, p, **kw)
    for i in range(2):
        ci, si = dl_solve_reference(7 + i, q[i], v[i], p, **kw)
        assert torch.equal(c[i], ci) and torch.equal(s[i], si)


@pytest.mark.parametrize(
    "call",
    [
        {"post_processor": "adam", "evolution_step_size": 10},
        {"evolution_step_size": 10},
        {"pump_ramp": (2.0, 0.5)},
    ],
    ids=["post_processor", "evolution", "pump_ramp"],
)
def test_features_left_out_raise(call):
    """Every post-processor is ported; a post-processed evolution run still
    raises, before the solve is spent."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _solve(DLSolver, ProblemInstance, **call)


@pytest.mark.parametrize("pump_ramp", [2.0, (1.0,), (1.0, 1.0, 1.0), ("a", 1.0)])
def test_malformed_pump_ramp_raises_a_value_error_naming_it(pump_ramp):
    """A pump_ramp that is not a pair of numbers is refused by name (the JAX
    package's unpacking refuses a bare number with a TypeError)."""
    with pytest.raises(ValueError, match="pump_ramp"):
        _solve(DLSolver, ProblemInstance, pump_ramp=pump_ramp)


def test_per_variable_s_and_mesh_raise():
    solver = DLSolver(device="cpu", batch_size=8, S=np.ones(20))
    solver.parameter_key = PARAMS
    inst = ProblemInstance(device="cpu", file_path=TEST020)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solver(inst)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DLSolver(device="cpu", mesh=object())


def test_devices_and_backend():
    for bad in ("tpu", "gpu", "cuda:0"):
        with pytest.raises(ValueError, match="Given device is not available"):
            DLSolver(device=bad)
        with pytest.raises(ValueError, match="Given device is not available"):
            ProblemInstance(device=bad)
    with pytest.raises(ValueError, match="backend"):
        DLSolver(device="cpu", backend="pallas")


def test_cuda_raises_without_a_card(monkeypatch):
    from ccvm_tpu_torch import runtime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.default_device()
    with pytest.raises(RuntimeError, match="cuda"):
        DLSolver(device="cuda")
