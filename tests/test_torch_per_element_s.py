"""A (batch, n) S whose rows differ, one S an element, on the port against
the JAX package (CPU).

The JAX façades take such an S on their lax path and broadcast it over the
instances of a sweep.  The port's façades, its sweep and its interop carry
it as a float32 tensor to the per-element builds of its kernels, whose
plain versions run here.  The S is drawn from a seed:
``np.outer(linspace(1, 1.5, batch), S_row)`` times a per-element factor in
[0.9, 1.1], around each family's per-variable S.  The noise is off on both
sides as in ``tests/test_torch_per_variable_s.py``: objective values agree
to rtol 1e-4, the statistics exactly, the states to atol 1e-5 and rtol 1e-6
(a few float32 ulps of MF's mu, near 100 here; the refinements' outputs to
atol 1e-4).  Inside the port, with the noise on,
segments and stacked instances equal the whole solve and serial solves bit
for bit.
"""

from __future__ import annotations

import logging

import jax
import numpy as np
import pytest
import torch

from ccvm_tpu import ProblemInstance as JProblemInstance
from ccvm_tpu import tuning as jtuning
from ccvm_tpu.dynamics import dl as jdl
from ccvm_tpu.dynamics import langevin as jlgv
from ccvm_tpu.dynamics import mf as jmf
from ccvm_tpu.dynamics import pumped_langevin as jplgv
from ccvm_tpu.parallel import sweep_solve as jax_sweep_solve
from ccvm_tpu.solvers import LangevinSolver as JLangevinSolver
from ccvm_tpu_torch import LangevinSolver, ProblemInstance, interop, tuning
from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.ops import build, dl_kernels, langevin_kernels, mf_kernels
from ccvm_tpu_torch.parallel import sweep_solve
from ccvm_tpu_torch.solvers.base import per_variable_saturation
from test_torch_evolution import (FAMILIES, TEST020, assert_samples_agree,  # noqa: F401
                                  noise_off, solve_pair)
from test_torch_per_variable_s import S_VECTORS, _with_s
from test_torch_sweep import CLASSES, N, PARAMS, _agree, _instances, _noise_off
from test_torch_sweep import files, mf_noise_off  # noqa: F401
from test_torch_tuning import GRID, _scaled, _scores, _solver

BATCH = 16


def element_s(row, batch=BATCH, seed=14):
    """A (batch, n) S whose rows differ: each row a multiple of ``row`` in
    [1, 1.5], times a factor in [0.9, 1.1] an element, drawn from ``seed``."""
    draw = np.random.RandomState(seed)
    scale = np.outer(np.linspace(1.0, 1.5, batch), np.asarray(row, np.float64))
    return (scale * draw.uniform(0.9, 1.1, scale.shape)).astype(np.float32)


def _objectives_agree(pair):
    (_, jsol), (_, tsol) = pair
    np.testing.assert_allclose(np.asarray(tsol.objective_values),
                               np.asarray(jsol.objective_values), rtol=1e-4)
    assert tsol.solution_performance == jsol.solution_performance


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_per_element_s_matches_jax(noise_off, tmp_path, family, adam):  # noqa: F811
    """Each façade, plain and Adam, with grad-descent (DL at pump 8, where
    S enters the final clamp and the change of variables)."""
    kwargs, pkey = _with_s(family, element_s(S_VECTORS[family]))
    pair = solve_pair(family, tmp_path, adam=adam, batch=BATCH, solver_kwargs=kwargs,
                      params=pkey, post_processor="grad-descent")
    _objectives_agree(pair)
    (_, jsol), (_, tsol) = pair
    np.testing.assert_allclose(tsol.variables["problem_variables"].numpy(),
                               np.asarray(jsol.variables["problem_variables"]),
                               atol=1e-4)


@pytest.mark.parametrize("adam", [False, True])
def test_dl_per_element_s_enters_the_drift_below_pump_one(tmp_path, adam):
    """At pump 0.9 the drift's S_d is S_ij itself: each element's S scales
    its x, its feedback and its V term."""
    kwargs, _ = _with_s("dl", element_s(S_VECTORS["dl"]))
    pkey = {20: dict(FAMILIES["dl"][2][20], pump=0.9)}
    _objectives_agree(solve_pair("dl", tmp_path, adam=adam, batch=BATCH,
                                 solver_kwargs=kwargs, params=pkey))


def test_dl_per_element_s_with_pump_ramp(tmp_path):
    """DL's generalised pump ramp with a (batch, n) S, below pump 1 (S in
    the drift)."""
    kwargs, _ = _with_s("dl", element_s(S_VECTORS["dl"]))
    pkey = {20: dict(FAMILIES["dl"][2][20], pump=0.9)}
    _objectives_agree(solve_pair("dl", tmp_path, batch=BATCH, solver_kwargs=kwargs,
                                 params=pkey, pump_ramp=(2.0, 0.5)))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_per_element_s_with_evolution_sampling(noise_off, tmp_path, family):  # noqa: F811
    """Evolution sampling (the segment launches) with a (batch, n) S: the
    samples, the evolution file and the objective values."""
    kwargs, pkey = _with_s(family, element_s(S_VECTORS[family]))
    pair = solve_pair(family, tmp_path, batch=BATCH, solver_kwargs=kwargs, params=pkey,
                      evolution_step_size=100)
    assert_samples_agree(family, pair, tmp_path)
    _objectives_agree(pair)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_sweep_with_per_element_s_matches_jax(request, files, name):  # noqa: F811
    """``sweep_solve`` with one (batch, n) S for every instance, against
    the JAX sweep, which broadcasts it over the instance axis."""
    if name == "mf":
        request.getfixturevalue("mf_noise_off")
    params, call = _noise_off(name)
    S = element_s(np.full(N, PARAMS[name].get("S", 1.0), np.float32), seed=15)
    solvers = []
    for cls, extra in zip(CLASSES[name], ({"backend": "lax"}, {})):
        if name == "dl":
            solver = cls(device="cpu", batch_size=BATCH, S=S, **extra)
            solver.parameter_key = {N: dict(PARAMS[name], **params)}
        else:
            solver = cls(device="cpu", batch_size=BATCH, **extra)
            solver.parameter_key = {N: dict(PARAMS[name], S=S, **params)}
        solvers.append(solver)
    theirs = jax_sweep_solve(solvers[0], _instances(files, JProblemInstance), seed=11,
                             post_processor="grad-descent", **call)
    ours = sweep_solve(solvers[1], _instances(files), seed=11,
                       post_processor="grad-descent", **call)
    _agree(ours, theirs, "grad-descent")


def test_tuner_with_per_element_s_matches_jax(tmp_path, caplog):
    """The tuner scores each candidate with one sweep, whose (batch, n) S
    (the tuning batch's) it passes through: noise off (sigma 0), every
    candidate's score and the winner equal the JAX tuner's."""
    caplog.set_level(logging.INFO)
    S = element_s(np.full(N, 0.5, np.float32), seed=16)
    winners = []
    for cls, inst_cls in ((JLangevinSolver, JProblemInstance),
                          (LangevinSolver, ProblemInstance)):
        solver = _solver(cls, sigma=0.0, S=S)
        insts = _scaled(tmp_path, (1, 2), solver, inst_cls,
                        prefix=f"{cls.__module__.split('.')[0]}_")
        winners.append(solver.tune(insts, parameter_ranges=GRID, tuning_batch_size=BATCH,
                                   seed=7, post_processor="grad-descent"))
    (jwin,), (twin,) = (list(w.values()) for w in winners)
    assert set(jwin) == set(twin)
    assert all(np.array_equal(jwin[k], twin[k]) for k in jwin)
    assert np.array_equal(twin["S"], S)
    theirs = _scores(caplog, jtuning.logger.name)
    ours = _scores(caplog, tuning.logger.name)
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs, strict=True):
        assert a[:2] == b[:2]
        assert a[2] == pytest.approx(b[2], rel=1e-6)


# The plain version of each kernel and the JAX dynamics: (JAX module, port
# wrapper, interop of the parameters, JAX _make_params arguments but S,
# solve flags).
_PLAIN = {
    "dl": (jdl, dl_kernels.dl_solve, interop.dl_params_from_numpy,
           (8.0, 0.001, 10.0, 100.0, 0.0, 150), dict(pump_rate_flag=True,
                                                     pump_is_gt_one=True)),
    "dl pump 0.9": (jdl, dl_kernels.dl_solve, interop.dl_params_from_numpy,
                    (0.9, 0.001, 3.0, 100.0, 0.0, 150),
                    dict(pump_rate_flag=True, pump_is_gt_one=False)),
    "mf": (jmf, mf_kernels.mf_solve, interop.mf_params_from_numpy,
           (0.5, 0.0025, 5.0, 4000.0, 0.01, 150), dict(pump_rate_flag=True)),
    "langevin": (jlgv, langevin_kernels.langevin_solve,
                 interop.langevin_params_from_numpy, (0.002, 0.0, 2.0), {}),
    "pumped": (jplgv, langevin_kernels.pumped_langevin_solve,
               interop.pumped_langevin_params_from_numpy, (1.0, 0.002, 0.0, 1.0, 150),
               dict(pump_rate_flag=True)),
}


def _problem(n=20):
    rng = np.random.RandomState(4)
    a = rng.randn(n, n).astype(np.float32)
    return (a + a.T) / 4, rng.randn(n).astype(np.float32)


def _jax_params(case, S):
    """A JAX parameter tuple of ``case`` made by its façade, with S."""
    family = case.split()[0]
    solver = FAMILIES[family][0](device="cpu", batch_size=BATCH)
    solver.solution_bounds = (0.0, 1.0)
    args = _PLAIN[case][3]
    if family in ("dl", "mf", "pumped"):
        return solver._make_params(args[0], S, *args[1:])
    return solver._make_params(S, *args)


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("case", sorted(_PLAIN))
def test_plain_versions_match_jax_dynamics(noise_off, case, adam):  # noqa: F811
    """Each kernel's plain version on a (batch, n) S, its parameters carried
    over from the JAX ones by ``interop``, against the JAX lax solve with
    the same inputs (noise off)."""
    jmod, solve, carry, _, flags = _PLAIN[case]
    family = case.split()[0]
    q, v = _problem()
    S = element_s(S_VECTORS[family])
    jp = _jax_params(case, S)
    tp = carry(*jp)
    assert isinstance(tp.S, torch.Tensor) and tuple(tp.S.shape) == (BATCH, 20)
    hp = interop.adam_from_numpy(0.05, 0.9, 0.999, False) if adam else None
    jhp = None if hp is None else jmod.AdamHyperparameters(*hp)
    kw = dict(iterations=150, batch_size=BATCH, **flags)
    want = jmod.solve(jax.random.PRNGKey(0), q, v, jp, hp=jhp, **kw)
    got = solve(0, torch.from_numpy(q), torch.from_numpy(v), tp, hp=hp, noise_scale=0.0,
                rng="popcount16" if family == "dl" else "popcount32", **kw)
    want, got = (x if isinstance(x, tuple) else (x,) for x in (want, got))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-5)


# Each family's plain solve with the noise on: (whole, segment, sampled
# wrapper, flags, Adam's state names).
_SEGMENTS = {
    "dl": (dl_kernels.dl_solve, dl_kernels.dl_solve_sampled,
           dict(pump_rate_flag=True, pump_is_gt_one=False, rng="popcount16")),
    "mf": (mf_kernels.mf_solve, mf_kernels.mf_solve_sampled,
           dict(pump_rate_flag=True, rng="popcount32")),
    "langevin": (langevin_kernels.langevin_solve, langevin_kernels.langevin_solve_sampled,
                 dict(rng="popcount32")),
    "pumped": (langevin_kernels.pumped_langevin_solve,
               langevin_kernels.pumped_langevin_solve_sampled,
               dict(pump_rate_flag=True, rng="popcount32")),
}


def _port_params(family, S, iterations):
    case = "dl pump 0.9" if family == "dl" else family
    params = _PLAIN[case][2](*_jax_params(case, np.ones((BATCH, 20), np.float32)))
    params = params._replace(S=common.saturation(S))
    if family == "langevin":
        return params._replace(sigma=0.5)
    if family == "pumped":
        return params._replace(sigma=0.5, iterations=float(iterations))
    if family == "dl":
        return params._replace(g=0.05, iterations=float(iterations))
    return params._replace(iterations=float(iterations))


def _flat(out):
    return [y for x in out for y in _flat(x)] if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("family", sorted(_SEGMENTS))
def test_segments_and_stacked_instances_equal_whole_solves(family):
    """Noise on: a solve cut into segments ends where the whole solve ends,
    and each instance of a stacked (I, n, n) solve, every one with the same
    (batch, n) S, equals its serial solve with seed + i, bit for bit."""
    whole, sampled, flags = _SEGMENTS[family]
    q, v = _problem()
    p = _port_params(family, element_s(S_VECTORS[family]), 120)
    q, v = torch.from_numpy(q), torch.from_numpy(v)
    kw = dict(flags, batch_size=BATCH)
    want = whole(5, q, v, p, iterations=120, **kw)
    got, _ = sampled(5, q, v, p, [1, 40, 40, 39], **kw)
    assert all(torch.equal(a, b) for a, b in zip(_flat(got), _flat(want)))
    q2, v2 = torch.stack([q, q.flip(0).flip(1)]), torch.stack([v, v.flip(0)])
    stacked = _flat(whole(5, q2, v2, p, iterations=60, **kw))
    for i in range(2):
        serial = _flat(whole(5 + i, q2[i], v2[i], p, iterations=60, **kw))
        assert all(torch.equal(a[i], b) for a, b in zip(stacked, serial))


# Each wrapper's array of S for its kernel: (columns function, its launch
# rule's rows and NP at N=20, the derived array's plain value, padding).
def _derived(family, S, span):
    if family == "mf":
        return torch.ones_like(S) / S
    if family == "dl":
        return span / S
    return span / (2 * S)


@pytest.mark.parametrize("family", ["dl", "mf", "langevin"])
def test_per_element_arrays_for_the_kernels(family):
    """The per-element build's array (csrc/*.cu CCVM_ELEM): S and its
    derived array by the plain version's float32 operations, padded to the
    launch's whole blocks and NP columns (S 1 there); with equal rows each
    row equals the per-column build's columns, so the two builds read the
    same values."""
    n, batch = 20, 37
    S = torch.from_numpy(element_s(S_VECTORS["mf" if family == "mf" else "dl"], batch))
    p = _port_params(family, S[:BATCH], 10)._replace(S=S)
    span = torch.tensor(float(p.upper_limit)) - float(p.lower_limit)
    if family == "dl":
        shape = build.dl_launch_shape(n, False, True, 2)
        arr = dl_kernels._columns(p, "cpu", shape.rows, shape.np, 3)
        assert arr.shape[0] == 2 + 3
    elif family == "mf":
        shape = build.mf_launch_shape(n, False, True)
        arr = mf_kernels._columns(p, "cpu", shape.rows, shape.np)
    else:
        shape = build.langevin_launch_shape(n, False, True)
        arr = langevin_kernels._columns(p, "cpu", shape.rows, shape.np)
    padded = -(-batch // shape.rows) * shape.rows
    assert tuple(arr.shape[1:]) == (padded, shape.np) and padded > batch
    assert torch.equal(arr[0, :batch, :n], S)
    assert torch.equal(arr[1, :batch, :n], _derived(family, S, span))
    assert bool((arr[0, batch:] == 1).all()) and bool((arr[0, :, n:] == 1).all())
    equal = p._replace(S=S[:1].expand(batch, n).contiguous())
    col = p._replace(S=common.saturation(S[0]))
    if family == "dl":
        rows = dl_kernels._columns(equal, "cpu", shape.rows, shape.np, 1)
        cols = dl_kernels._columns(col, "cpu", shape.rows, shape.np, 1)
        assert torch.equal(cols[2], 0.25 * cols[1])  # the kernel's 0.25 span/S_ij
    else:
        module = mf_kernels if family == "mf" else langevin_kernels
        rows = module._columns(equal, "cpu", shape.rows, shape.np)
        cols = module._columns(col, "cpu", shape.rows, shape.np)
    for k in range(2):
        assert torch.equal(rows[k, :batch, :n], cols[k].expand(batch, n))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_wrong_batch_of_s_raises(family):
    """A (batch, n) S is checked against the launch's batch."""
    whole, _, flags = _SEGMENTS[family]
    q, v = (torch.from_numpy(x) for x in _problem())
    p = _port_params(family, element_s(S_VECTORS[family]), 10)
    with pytest.raises(ValueError, match="one an element"):
        whole(0, q, v, p, iterations=10, batch_size=BATCH + 1, **flags)


def test_per_variable_saturation_keeps_rows_that_differ():
    """Rows that differ are one S an element, a float32 tensor on the
    solve's device; equal rows are their row (the per-column build)."""
    S = element_s(S_VECTORS["dl"])
    got = per_variable_saturation(S, 20, BATCH, torch.device("cpu"))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), S)
    equal = np.outer(np.ones(BATCH, np.float32), S_VECTORS["dl"])
    assert per_variable_saturation(equal, 20, BATCH, "cpu") == \
        tuple(S_VECTORS["dl"].tolist())
    with pytest.raises(ValueError, match="S must be a scalar"):
        per_variable_saturation(S[:-1], 20, BATCH, "cpu")
