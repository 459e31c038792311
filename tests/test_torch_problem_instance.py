"""The port's BoxQP problem layer against the JAX package's (CPU)."""

from __future__ import annotations

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvm_tpu.problem_classes.boxqp import problem_instance as jpi
from ccvm_tpu.solution import Solution as JSolution
from ccvm_tpu.solvers.dl import DLSolver as JDLSolver
from ccvm_tpu_torch import interop
from ccvm_tpu_torch.problem_classes.boxqp import problem_instance as tpi
from ccvm_tpu_torch.solution import Solution as TSolution
from ccvm_tpu_torch.solvers.dl import DLSolver as TDLSolver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(REPO, "tests", "data", "*.in"))) + [
    sorted(glob.glob(os.path.join(d, "*.in")))[0]
    for d in sorted(glob.glob(os.path.join(REPO, "examples",
                                           "benchmarking_instances", "Size*")))
]


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_parse_scale_and_energy_match(path):
    q_j, v_j, sol_j, meta_j = jpi.parse_instance_file(path)
    q_t, v_t, sol_t, meta_t = tpi.parse_instance_file(path)
    assert q_t.dtype == np.float64 and v_t.dtype == np.float64
    np.testing.assert_array_equal(q_t, q_j)
    np.testing.assert_array_equal(v_t, v_j)
    assert meta_t == meta_j and sol_t == sol_j

    ij = jpi.ProblemInstance(device="cpu", file_path=path)
    it = tpi.ProblemInstance(device="cpu", file_path=path)
    sf_j = JDLSolver(device="cpu").get_scaling_factor(ij.q_matrix)
    sf_t = TDLSolver(device="cpu").get_scaling_factor(it.q_matrix)
    np.testing.assert_allclose(float(sf_t), float(sf_j), rtol=1e-6)
    ij.scale_coefs(sf_j)
    it.scale_coefs(sf_t)
    assert it.scaled_by == pytest.approx(ij.scaled_by, rel=1e-6)

    n = meta_j["problem_size"]
    confs = np.random.RandomState(n).rand(32, n).astype(np.float32)
    e_t = it.compute_energy(torch.from_numpy(confs)).numpy()
    e_j = np.asarray(ij.compute_energy(jnp.asarray(confs)))
    # rtol 1e-5 relative to the row's absolute-value energy
    # 0.5|x||Q||x| + |V||x|: float32 rounding scales with it, and a row whose
    # terms cancel has a small energy but the same absolute rounding.
    scale = np.asarray(tpi._energy(
        torch.from_numpy(np.abs(confs)), torch.abs(it.q_matrix), torch.abs(it.v_vector),
        abs(float(np.float32(it.scaled_by)))))
    assert np.all(np.abs(e_t - e_j) <= 1e-5 * scale)


def _readout_pair(path):
    """The JAX instance after scaling and the port's built from its arrays."""
    ij = jpi.ProblemInstance(device="cpu", file_path=path)
    ij.scale_coefs(JDLSolver(device="cpu").get_scaling_factor(ij.q_matrix))
    _, _, sol, meta = tpi.parse_instance_file(path)
    it = interop.instance_from_numpy(
        ij._q64, ij._v64, meta, ij.scaled_by, ij.solution_bounds, "cpu",
        q_matrix=np.asarray(ij.q_matrix), v_vector=np.asarray(ij.v_vector),
        solution_vector=sol,
    )
    return ij, it


@pytest.mark.parametrize(
    "path",
    [os.path.join(REPO, "tests", "data", "test020.in"),
     os.path.join(REPO, "examples", "benchmarking_instances", "Size70",
                  "tuningH070-100-0.in")],
    ids=os.path.basename,
)
def test_readout64_with_change_vars_matches(path):
    ij, it = _readout_pair(path)
    n = ij.problem_size
    rng = np.random.RandomState(7)
    # Amplitudes in [-S, S] with a cluster near the optimum's corners so
    # some rows sit near the gap thresholds.
    pv = rng.uniform(-1.0, 1.0, (512, n)).astype(np.float32)
    pv[:64] = np.sign(pv[:64]).astype(np.float32)
    cv = ("boxqp", 0.0, 1.0, 1.0)
    e_j = ij.compute_energy_readout64(jnp.asarray(pv), change_vars=cv)
    e_t = it.compute_energy_readout64(torch.from_numpy(pv), change_vars=cv)

    # Which rows the JAX package re-evaluates in float64 (the port now
    # evaluates every row in float64).
    confs = 0.5 * pv / np.float32(1.0) * np.float32(1.0) + np.float32(0.5)
    raw_j = np.asarray(jpi._energy_and_bound_kernel(
        jnp.asarray(confs), ij.q_matrix, ij.v_vector, jnp.float32(ij.scaled_by)
    ), np.float64)
    near_j = jpi.ambiguous_readout_rows(raw_j[0], ij.optimal_sol, n,
                                        abs_e=raw_j[1])
    assert near_j.sum() >= 32
    np.testing.assert_allclose(e_t[near_j], e_j[near_j], rtol=1e-12)
    # Rows the JAX package keeps in float32: within 1e-5 of the row's
    # absolute-value energy (see test_parse_scale_and_energy_match).
    scale = raw_j[1]
    assert np.all(np.abs(e_t - e_j)[~near_j] <= 1e-5 * scale[~near_j])

    kw = dict(problem_size=n, batch_size=pv.shape[0], instance_name="x",
              iterations=1, solve_time=0.0, pp_time=0.0,
              optimal_value=ij.optimal_sol, best_value=ij.best_sol,
              num_frac_values=ij.num_frac_values, solution_vector=[],
              variables={})
    sol_j = JSolution(objective_values=e_j, **kw)
    sol_t = TSolution(objective_values=e_t, **kw)
    assert sol_t.solution_performance == sol_j.solution_performance
    assert sol_t.best_objective_value == pytest.approx(
        sol_j.best_objective_value, rel=1e-12)


def test_fused_langevin_change_vars_matches_mapping_first():
    """``change_vars=("langevin", lo, hi, S)`` maps ``(c + S) / (2S)`` inside
    the readout: the same energies and statistics as mapping first and
    reading out after (``tests/unit/test_readout_fusion.py:54``)."""
    from ccvm_tpu.dynamics.common import langevin_change_variables as jmap
    from ccvm_tpu_torch.dynamics.common import langevin_change_variables

    path = os.path.join(REPO, "examples", "benchmarking_instances", "Size70",
                        "tuningH070-100-0.in")
    _, it = _readout_pair(path)
    rng = np.random.RandomState(11)
    S = np.float32(0.5)
    c = rng.uniform(-S, S, (512, it.problem_size)).astype(np.float32)
    # Rows near the recorded solution's corner sit near the gap thresholds.
    corner = (2 * np.asarray(it.solution_vector, np.float32) - 1) * S
    c[:64] = np.clip(corner + rng.normal(0, 0.005, (64, it.problem_size)), -S, S)
    c_t = torch.from_numpy(c)
    torch.testing.assert_close(
        tpi._apply_cv(c_t, "langevin", torch.tensor(0.0), torch.tensor(1.0),
                      torch.tensor(S)),
        langevin_change_variables(c_t, torch.tensor(S)), rtol=0, atol=0)
    np.testing.assert_array_equal(langevin_change_variables(c_t, float(S)).numpy(),
                                  np.asarray(jmap(jnp.asarray(c), S)))
    fused = it.compute_energy_readout64(c_t, change_vars=("langevin", 0.0, 1.0, S))
    mapped = it.compute_energy_readout64(langevin_change_variables(c_t, float(S)))
    np.testing.assert_array_equal(fused, mapped)
    kw = dict(problem_size=it.problem_size, batch_size=512, instance_name="x",
              iterations=1, solve_time=0.0, pp_time=0.0,
              optimal_value=it.optimal_sol, best_value=it.best_sol,
              num_frac_values=it.num_frac_values, solution_vector=[],
              variables={})
    perf = TSolution(objective_values=fused, **kw).solution_performance
    assert perf == TSolution(objective_values=mapped, **kw).solution_performance
    assert perf["one_percent"] > 0  # the rows near the corner
    with pytest.raises(ValueError, match="unknown change-of-variables"):
        it.compute_energy_readout64(c_t, change_vars=("mf", 0.0, 1.0, S))


@pytest.mark.parametrize("trailing_tab", [True, False])
def test_write_sample_rows_matches(trailing_tab):
    import io

    from ccvm_tpu.native import write_sample_rows as jwrite
    from ccvm_tpu_torch.native import write_sample_rows as twrite

    sample = np.random.RandomState(2).randn(3, 5)
    out_j, out_t = io.StringIO(), io.StringIO()
    jwrite(out_j, sample, append_trailing_tab=trailing_tab)
    twrite(out_t, sample, append_trailing_tab=trailing_tab)
    assert out_t.getvalue() == out_j.getvalue()
