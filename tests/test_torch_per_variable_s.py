"""A per-variable S on the port's four façades against the JAX ones, and
its carrying across from the JAX package (CPU).

A 1-D S of the problem's size is one value a column, as the JAX façades'
``np.outer(ones(batch), S)`` makes it.  The noise is off on both sides as in
``tests/test_torch_evolution.py``; objective values agree to rtol 1e-4 and
the statistics exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ccvm_tpu import DLSolver as JDLSolver
from ccvm_tpu.dynamics import dl as jdl
from ccvm_tpu_torch import interop
from ccvm_tpu_torch.ops import dl_kernels
from test_torch_evolution import FAMILIES, TEST020, noise_off, solve_pair  # noqa: F401

# S drawn from a seed in [0.5 S, 1.5 S] around each family's scalar S.
_DRAW = np.random.RandomState(20)
S_VECTORS = {
    "dl": (1.0 * _DRAW.uniform(0.5, 1.5, 20)).astype(np.float32),
    "mf": (20.0 * _DRAW.uniform(0.5, 1.5, 20)).astype(np.float32),
    "langevin": (0.5 * _DRAW.uniform(0.5, 1.5, 20)).astype(np.float32),
    "pumped": (0.5 * _DRAW.uniform(0.5, 1.5, 20)).astype(np.float32),
}


def _with_s(family, S):
    """(solver kwargs, parameter key) of a family with this S: DL takes S in
    its constructor, the others in the parameter key."""
    pkey = FAMILIES[family][2]
    if family == "dl":
        return {"S": S}, pkey
    return {}, {20: dict(pkey[20], S=S)}


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_per_variable_s_matches_jax(noise_off, tmp_path, family, adam):  # noqa: F811
    kwargs, pkey = _with_s(family, S_VECTORS[family])
    pair = solve_pair(family, tmp_path, adam=adam, solver_kwargs=kwargs, params=pkey,
                      post_processor="grad-descent")
    (_, jsol), (_, tsol) = pair
    np.testing.assert_allclose(np.asarray(tsol.objective_values),
                               np.asarray(jsol.objective_values), rtol=1e-4)
    assert tsol.solution_performance == jsol.solution_performance
    np.testing.assert_allclose(tsol.variables["problem_variables"].numpy(),
                               np.asarray(jsol.variables["problem_variables"]),
                               atol=1e-4)


@pytest.mark.parametrize("adam", [False, True])
def test_dl_per_variable_s_enters_the_drift_below_pump_one(tmp_path, adam):
    """At pump 0.9 the drift's S_d is S itself, so each column's S scales
    its x and its feedback (at pump > 1, S_d = sqrt(pump - 1) and S enters
    only the clamp and the change of variables)."""
    kwargs, _ = _with_s("dl", S_VECTORS["dl"])
    pkey = {20: dict(FAMILIES["dl"][2][20], pump=0.9)}
    pair = solve_pair("dl", tmp_path, adam=adam, solver_kwargs=kwargs, params=pkey)
    (_, jsol), (_, tsol) = pair
    np.testing.assert_allclose(np.asarray(tsol.objective_values),
                               np.asarray(jsol.objective_values), rtol=1e-4)
    assert tsol.solution_performance == jsol.solution_performance


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_per_variable_s_with_evolution_sampling(noise_off, tmp_path, family):  # noqa: F811
    kwargs, pkey = _with_s(family, S_VECTORS[family])
    pair = solve_pair(family, tmp_path, solver_kwargs=kwargs, params=pkey,
                      evolution_step_size=100)
    (jsolver, jsol), (tsolver, tsol) = pair
    np.testing.assert_allclose(np.asarray(tsol.objective_values),
                               np.asarray(jsol.objective_values), rtol=1e-4)
    for name in FAMILIES[family][5]:
        np.testing.assert_allclose(getattr(tsolver, name).numpy(),
                                   np.asarray(getattr(jsolver, name)),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_wrong_length_s_raises_the_jax_error(family):
    from ccvm_tpu import ProblemInstance as JProblemInstance
    from ccvm_tpu_torch import ProblemInstance

    kwargs, pkey = _with_s(family, np.ones(19, np.float32))
    for cls, inst_cls in zip(FAMILIES[family][:2], (JProblemInstance, ProblemInstance)):
        solver = cls(device="cpu", batch_size=8, **kwargs)
        solver.parameter_key = pkey
        inst = inst_cls(device="cpu", file_path=TEST020, instance_type="test")
        with pytest.raises(ValueError, match="Tensor S size should be equal to "
                                             "problem size."):
            solver(inst, seed=1, **FAMILIES[family][3])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_two_dimensional_s(noise_off, tmp_path, family):  # noqa: F811
    """A (batch, n) S with equal rows is its row; rows that differ are one S
    an element and give the JAX façade's objective values and statistics
    (tests/test_torch_per_element_s.py holds the rest of that build)."""
    from ccvm_tpu_torch import ProblemInstance

    S = S_VECTORS[family]
    tcls, base = FAMILIES[family][1], FAMILIES[family][3]
    inst = ProblemInstance(device="cpu", file_path=TEST020, instance_type="test")
    results = []
    for value in (S, np.outer(np.ones(8, np.float32), S)):
        kwargs, pkey = _with_s(family, value)
        solver = tcls(device="cpu", batch_size=8, **kwargs)
        solver.parameter_key = pkey
        results.append(solver(inst, seed=1, **base).objective_values)
    assert np.array_equal(results[0], results[1])
    rows = np.outer(np.linspace(1.0, 1.5, 8, dtype=np.float32), S)
    kwargs, pkey = _with_s(family, rows)
    (_, jsol), (_, tsol) = solve_pair(family, tmp_path, batch=8, solver_kwargs=kwargs,
                                      params=pkey)
    np.testing.assert_allclose(np.asarray(tsol.objective_values),
                               np.asarray(jsol.objective_values), rtol=1e-4)
    assert tsol.solution_performance == jsol.solution_performance


def test_interop_carries_a_ramp_and_a_vector_s():
    """A JAX ``DLParams`` made by its façade with a ramp and a 1-D S (its S
    the (batch, n) outer product) becomes the port's, whose plain solve
    gives the JAX lax solve's result (noise off: g = 0)."""
    rng = np.random.RandomState(4)
    a = rng.randn(20, 20).astype(np.float32)
    q, v = (a + a.T) / 4, rng.randn(20).astype(np.float32)
    jsolver = JDLSolver(device="cpu", batch_size=16)
    jsolver.solution_bounds = (0.0, 1.0)
    S = S_VECTORS["dl"]
    jp = jsolver._make_params(0.9, np.outer(np.ones(16, np.float32), S), 0.001, 3.0,
                              100.0, 0.0, 150, pump_ramp=(2.0, 0.5))
    tp = interop.dl_params_from_numpy(*jp)
    assert tp.S == tuple(S.tolist())
    assert (tp.ramp_power, tp.ramp_fraction) == (2.0, 0.5)
    import jax

    kw = dict(iterations=150, batch_size=16, pump_rate_flag=True, pump_is_gt_one=False)
    for hp in (None, interop.adam_from_numpy(0.05, 0.9, 0.999, False)):
        jhp = None if hp is None else jdl.AdamHyperparameters(*hp)
        jc, js = jdl.solve(jax.random.PRNGKey(0), q, v, jp, hp=jhp, **kw)
        tc, ts = dl_kernels.dl_solve_reference(0, torch.from_numpy(q),
                                               torch.from_numpy(v), tp, hp=hp,
                                               noise_scale=0.0, **kw)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    rows = np.outer(np.arange(1, 17, dtype=np.float32), S)
    carried = interop.dl_params_from_numpy(*jp._replace(S=rows))
    assert isinstance(carried.S, torch.Tensor) and np.array_equal(carried.S.numpy(), rows)
