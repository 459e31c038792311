"""The port's MFSolver façade against the JAX one, its guard rails, and the
DL façade with grad-descent (CPU).

MF's noise enters through the measured field, not through ``g``, so the
façades are compared with the noise off on both sides: the JAX lax path with
``common.normal`` patched to zeros, the port's plain version with
``noise_scale=0``.  Objective values agree to rtol 1e-4 (float32 round-off
over a few hundred steps), and the statistics exactly.
"""

from __future__ import annotations

import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ccvm_tpu import AdamParameters as JAdamParameters
from ccvm_tpu import DLSolver as JDLSolver
from ccvm_tpu import MFSolver as JMFSolver
from ccvm_tpu import ProblemInstance as JProblemInstance
from ccvm_tpu.dynamics import common as jcommon
from ccvm_tpu_torch import AdamParameters, DLSolver, MFSolver, ProblemInstance
from ccvm_tpu_torch.ops import mf_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST020 = os.path.join(REPO, "tests", "data", "test020.in")
PARAMS = {20: {"pump": 0.5, "feedback_scale": 4000.0, "j": 5.0, "S": 20.0,
               "dt": 0.0025, "iterations": 300}}
DL_PARAMS = {20: {"pump": 8.0, "feedback_scale": 100.0, "noise_ratio": 10.0,
                  "dt": 0.001, "iterations": 200}}
# No post-processor, and each of the five (tests/test_torch_post_processors.py
# holds each alone against the JAX package).
POST_PROCESSORS = [None, "grad-descent", "adam", "asgd", "bfgs", "lbfgs"]
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


@pytest.fixture
def noise_off(monkeypatch):
    """No noise on either side.  The JAX solve is jitted, so its trace cache
    is cleared around the patch: a trace with zero noise must not serve (or
    be served by) a solve elsewhere in the process."""
    monkeypatch.setattr(jcommon, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    for name in ("mf_solve", "mf_solve_sampled"):
        monkeypatch.setattr(mf_kernels, name,
                            functools.partial(getattr(mf_kernels, name), noise_scale=0.0))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _solve(solver_cls, instance_cls, params=PARAMS, batch=64, **call):
    solver = solver_cls(device="cpu", batch_size=batch)
    solver.parameter_key = params
    inst = instance_cls(device="cpu", file_path=TEST020, instance_type="test")
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    return solver(inst, seed=3, **call)


def _agree(sol_t, sol_j, post_processor=None):
    rtol, _ = ROUND_OFF_DECIDED.get(post_processor, (None, None))
    np.testing.assert_allclose(np.asarray(sol_t.objective_values),
                               np.asarray(sol_j.objective_values), rtol=rtol or 1e-4)
    assert sol_t.solution_performance == sol_j.solution_performance
    assert sol_t.best_objective_value == pytest.approx(
        sol_j.best_objective_value, rel=rtol or 1e-6)


@pytest.mark.parametrize("post_processor", POST_PROCESSORS)
@pytest.mark.parametrize("adam", [False, True])
def test_mf_facades_agree_without_noise(noise_off, post_processor, adam):
    jcall = {"post_processor": post_processor}
    tcall = dict(jcall)
    if adam:
        jcall["algorithm_parameters"] = JAdamParameters(alpha=0.05)
        tcall["algorithm_parameters"] = AdamParameters(alpha=0.05)
    sol_j = _solve(JMFSolver, JProblemInstance, **jcall)
    sol_t = _solve(MFSolver, ProblemInstance, **tcall)
    _agree(sol_t, sol_j, post_processor)
    pv = sol_t.variables["problem_variables"]
    # BFGS hands back 2 (x - 0.5), in [-1, 1].
    low = -1.0 if post_processor == "bfgs" else 0.0
    assert pv.shape == (64, 20) and low <= pv.min() and pv.max() <= 1.0
    np.testing.assert_allclose(
        pv.numpy(), np.asarray(sol_j.variables["problem_variables"]),
        atol=ROUND_OFF_DECIDED.get(post_processor, (None, 1e-4))[1])
    np.testing.assert_allclose(sol_t.variables["mu"].numpy(),
                               np.asarray(sol_j.variables["mu"]), atol=1e-3)
    assert (sol_t.pp_time > 0) == (post_processor is not None)


@pytest.mark.parametrize("adam", [False, True])
def test_dl_facade_with_grad_descent_agrees_without_diffusion(adam):
    jcall, tcall = {}, {}
    if adam:
        jcall["algorithm_parameters"] = JAdamParameters(alpha=0.05)
        tcall["algorithm_parameters"] = AdamParameters(alpha=0.05)
    sol_j = _solve(JDLSolver, JProblemInstance, DL_PARAMS, g=0.0,
                   post_processor="grad-descent", **jcall)
    sol_t = _solve(DLSolver, ProblemInstance, DL_PARAMS, g=0.0,
                   post_processor="grad-descent", **tcall)
    _agree(sol_t, sol_j)
    assert sol_t.pp_time > 0


def test_mf_noise_on_solve_is_seeded():
    a = _solve(MFSolver, ProblemInstance, batch=16)
    b = _solve(MFSolver, ProblemInstance, batch=16)
    assert np.array_equal(a.objective_values, b.objective_values)
    assert np.all(np.isfinite(a.objective_values))


def test_machine_time_and_energy_match_jax():
    frame = pd.DataFrame({"iterations": [300.0, 500.0], "pp_time": [0.01, 0.03],
                          "solve_time": [0.2, 0.4]})
    j, t = JMFSolver(device="cpu"), MFSolver(device="cpu")
    j.parameter_key = t.parameter_key = PARAMS
    for machine in ("mf-ccvm", "cpu", "gpu"):
        assert t.machine_energy(machine)(frame, 20) == pytest.approx(
            j.machine_energy(machine)(frame, 20), rel=1e-12)
        assert t.machine_time(machine)(dataframe=frame, problem_size=20) == \
            pytest.approx(j.machine_time(machine)(dataframe=frame, problem_size=20),
                          rel=1e-12)
    custom = dict(t._default_optics_machine_parameters, laser_power=2e-3)
    assert t.machine_energy("mf-ccvm", custom)(frame, 20) == pytest.approx(
        j.machine_energy("mf-ccvm", custom)(frame, 20), rel=1e-12)
    with pytest.raises(ValueError, match="Missing required keys"):
        t.machine_energy("mf-ccvm", {"laser_clock": 1e-10})
    with pytest.raises(ValueError, match="Mismatch"):
        t.machine_energy("dl-ccvm")


@pytest.mark.parametrize(
    "call",
    [{"evolution_step_size": 10},
     {"post_processor": "bfgs", "evolution_step_size": 10}],
    ids=["evolution", "post_processor"],
)
def test_features_left_out_raise(noise_off, tmp_path, call):
    """Evolution sampling, with and without a post-processor, now runs on
    the port and matches the JAX façade: objective values to rtol 1e-4
    (BFGS: ROUND_OFF_DECIDED), the mu and sigma samples to rtol 1e-4 and
    the evolution file (4 decimals, no trailing tab) to atol 2e-4."""
    sols = []
    for side, cls, inst_cls in (("jax", JMFSolver, JProblemInstance),
                                ("torch", MFSolver, ProblemInstance)):
        solver = cls(device="cpu", batch_size=8)
        solver.parameter_key = PARAMS
        inst = inst_cls(device="cpu", file_path=TEST020, instance_type="test")
        inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
        sol = solver(inst, seed=3, evolution_file=str(tmp_path / side), **call)
        sols.append((solver, sol))
    (js, sol_j), (ts, sol_t) = sols
    _agree(sol_t, sol_j, call.get("post_processor"))
    for name in ("mu_sample", "sigma_sample"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.loadtxt(sol_t.evolution_file),
                               np.loadtxt(sol_j.evolution_file), atol=2e-4)


def test_per_variable_s_mesh_and_tune_raise(noise_off):
    """A 1-D S of the problem's size now runs and matches the JAX façade
    (more in tests/test_torch_per_variable_s.py); a mesh runs now
    (tests/test_torch_mesh.py) and what is not a DeviceMesh raises; tune
    runs (tests/test_torch_tuning.py) and, as
    the JAX package's, needs a parameter key first."""
    params = {20: dict(PARAMS[20], S=np.linspace(15.0, 25.0, 20))}
    sol_j = _solve(JMFSolver, JProblemInstance, params, batch=8)
    sol_t = _solve(MFSolver, ProblemInstance, params, batch=8)
    _agree(sol_t, sol_j)
    with pytest.raises(TypeError, match="DeviceMesh"):
        MFSolver(device="cpu", mesh=object())
    with pytest.raises(ValueError, match="Set solver.parameter_key before tuning"):
        MFSolver(device="cpu").tune([])


def test_parameter_key_and_devices():
    solver = MFSolver(device="cpu")
    with pytest.raises(ValueError, match="not valid for this solver"):
        solver.parameter_key = {20: {"pump": 0.0}}
    solver.parameter_key = {30: PARAMS[20]}
    inst = ProblemInstance(device="cpu", file_path=TEST020)
    with pytest.raises(KeyError, match="not defined"):
        solver(inst)
    for bad in ("tpu", "gpu", "cuda:0"):
        with pytest.raises(ValueError, match="Given device is not available"):
            MFSolver(device=bad)
    with pytest.raises(ValueError, match="backend"):
        MFSolver(device="cpu", backend="pallas")
    with pytest.raises(ValueError, match="kernel_rng"):
        MFSolver(device="cpu", kernel_rng="mersenne")
    with pytest.raises(ValueError, match="must match"):
        MFSolver(device="cpu").__call__(mock.Mock(device="cuda"))


def test_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        MFSolver(device="cuda")
