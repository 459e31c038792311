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
def test_features_left_out_raise(tmp_path, call):
    """The features PRs 1-3 left out (a post-processed evolution run,
    evolution sampling, a generalised pump ramp) now run on the port and
    match the JAX façade: objective values to rtol 1e-4 (Adam's
    post-processor: ROUND_OFF_DECIDED), samples to rtol 1e-4 and the
    evolution file to atol 2e-4 (it rounds to 4 decimals)."""
    if "evolution_step_size" in call:
        call = dict(call, evolution_file=str(tmp_path / "evolution.txt"))
    sol_j = _solve(JDLSolver, JProblemInstance, **call)
    j_file = call.get("evolution_file") and np.loadtxt(call["evolution_file"])
    sol_t = _solve(DLSolver, ProblemInstance, **call)
    rtol = ROUND_OFF_DECIDED.get(call.get("post_processor"), (1e-4,))[0]
    np.testing.assert_allclose(np.asarray(sol_t.objective_values),
                               np.asarray(sol_j.objective_values), rtol=rtol)
    assert sol_t.solution_performance == sol_j.solution_performance
    if "evolution_step_size" in call:
        assert sol_t.evolution_file == call["evolution_file"]
        np.testing.assert_allclose(np.loadtxt(sol_t.evolution_file), j_file, atol=2e-4)


RAMPS = [(2.0, 0.5), (0.5, 1.0), (1.0, 0.25)]


@pytest.mark.parametrize("pump_ramp", RAMPS)
@pytest.mark.parametrize("adam", [False, True])
def test_pump_ramp_matches_jax(adam, pump_ramp):
    """DL and DL-Adam with a generalised ramp rate(i) =
    min((i+1)/T / fraction, 1)^power, against the JAX façade."""
    jcall, tcall = {"pump_ramp": pump_ramp}, {"pump_ramp": pump_ramp}
    if adam:
        from ccvm_tpu import AdamParameters as JAdamParameters

        jcall["algorithm_parameters"] = JAdamParameters(alpha=0.05)
        tcall["algorithm_parameters"] = AdamParameters(alpha=0.05)
    sol_j = _solve(JDLSolver, JProblemInstance, **jcall)
    sol_t = _solve(DLSolver, ProblemInstance, **tcall)
    np.testing.assert_allclose(np.asarray(sol_t.objective_values),
                               np.asarray(sol_j.objective_values), rtol=1e-4)
    assert sol_t.solution_performance == sol_j.solution_performance


@pytest.mark.parametrize("adam", [False, True])
def test_unit_pump_ramp_is_the_reference_schedule(adam):
    """``(1.0, 1.0)`` normalises to no ramp, as the JAX façade does: the
    same solve as ``None``, bit for bit; another ramp differs."""
    call = {"algorithm_parameters": AdamParameters(alpha=0.05)} if adam else {}
    base = _solve(DLSolver, ProblemInstance, **call).objective_values
    unit = _solve(DLSolver, ProblemInstance, pump_ramp=(1.0, 1.0), **call)
    assert np.array_equal(unit.objective_values, base)
    other = _solve(DLSolver, ProblemInstance, pump_ramp=(2.0, 0.5), **call)
    assert not np.array_equal(other.objective_values, base)


@pytest.mark.parametrize("pump_ramp,message", [
    ((2.0, 0.0), "fraction must be positive"), ((2.0, -1.0), "fraction must be positive"),
    ((0.0, 0.5), "power must be positive"), ((-1.0, 1.0), "power must be positive")])
def test_non_positive_pump_ramp_raises_the_jax_error(pump_ramp, message):
    for solver_cls, instance_cls in ((JDLSolver, JProblemInstance),
                                     (DLSolver, ProblemInstance)):
        with pytest.raises(ValueError, match=message):
            _solve(solver_cls, instance_cls, pump_ramp=pump_ramp)


@pytest.mark.parametrize("pump_ramp", RAMPS + [None])
def test_step_table_holds_the_ramp_bit_for_bit(pump_ramp):
    """The kernel's step table holds fs (0.5 + rate) and pump rate with the
    plain version's ``pump_rate_schedule`` at every step, bit for bit."""
    from ccvm_tpu_torch.dynamics import dl as dyn
    from ccvm_tpu_torch.ops import dl_kernels

    power, fraction = pump_ramp or (None, None)
    params = DLParams(8.0, 1.0, 0.001, 10.0, 200.0, 0.05, 0.0, 1.0, 40.0,
                      ramp_power=power, ramp_fraction=fraction)
    table = dl_kernels._step_table(params, None, 1.0, 40, True, "cpu")
    p = dyn._scalars(params, "cpu")
    for i in range(40):
        rate = dyn.pump_rate_schedule(p, i, True)
        assert torch.equal(table[i, 0], p.feedback_scale * (0.5 + rate))
        assert torch.equal(table[i, 1], p.pump * rate)
    if pump_ramp is not None:
        assert table[39, 1] == 8.0  # the plateau (or the end of the ramp)


@pytest.mark.parametrize("pump_ramp", [2.0, (1.0,), (1.0, 1.0, 1.0), ("a", 1.0)])
def test_malformed_pump_ramp_raises_a_value_error_naming_it(pump_ramp):
    """A pump_ramp that is not a pair of numbers is refused by name (the JAX
    package's unpacking refuses a bare number with a TypeError)."""
    with pytest.raises(ValueError, match="pump_ramp"):
        _solve(DLSolver, ProblemInstance, pump_ramp=pump_ramp)


def test_per_variable_s_and_mesh_raise():
    """A 1-D S of the problem's size now runs (and matches the JAX façade:
    ``tests/test_torch_per_variable_s.py``); another size raises the JAX
    package's ValueError; a mesh runs now (tests/test_torch_mesh.py), and
    what is not a DeviceMesh raises."""
    inst = ProblemInstance(device="cpu", file_path=TEST020)
    jinst = JProblemInstance(device="cpu", file_path=TEST020)
    sols = []
    for solver_cls, inst_ in ((JDLSolver, jinst), (DLSolver, inst)):
        solver = solver_cls(device="cpu", batch_size=8, S=np.ones(20))
        solver.parameter_key = PARAMS
        sols.append(solver(inst_, g=0.0, seed=1))
    np.testing.assert_allclose(np.asarray(sols[1].objective_values),
                               np.asarray(sols[0].objective_values), rtol=1e-4)
    solver = DLSolver(device="cpu", batch_size=8, S=np.ones(21))
    solver.parameter_key = PARAMS
    with pytest.raises(ValueError, match="Tensor S size"):
        solver(inst)
    with pytest.raises(TypeError, match="DeviceMesh"):
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
