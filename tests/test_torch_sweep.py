"""The port's instance sweep against the JAX package's and against its own
serial solves (CPU).

Instances follow ``tests/unit/test_sweep.py`` (four random N=8 instances,
batch 16, 60 steps), each file's optimum set to its best box vertex so that
the gap statistics are not all zero.  Against the JAX sweep (its lax path)
the noise is off on both sides: DL with ``g=0``, the Langevin family with
``sigma=0``, MF with the JAX draws patched to zeros and the port's plain
version at ``noise_scale=0``.  Objective values agree to rtol 1e-4 (float32
round-off), the statistics exactly.  Against the port's serial façade
solves, noise on, the sweep equals them bit for bit: the plain versions
draw stacked instance i's noise as a solve with seed + i, and the
refinement cores compute instance i's rows as a one-instance call does.
"""

from __future__ import annotations

import functools
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvm_tpu import AdamParameters as JAdamParameters
from ccvm_tpu.dynamics import common as jcommon
from ccvm_tpu.parallel import sweep_solve as jax_sweep_solve
from ccvm_tpu.problem_classes.boxqp import ProblemInstance as JProblemInstance
from ccvm_tpu.solvers import DLSolver as JDLSolver
from ccvm_tpu.solvers import LangevinSolver as JLangevinSolver
from ccvm_tpu.solvers import MFSolver as JMFSolver
from ccvm_tpu.solvers import PumpedLangevinSolver as JPumpedLangevinSolver
from ccvm_tpu_torch import (AdamParameters, DLSolver, LangevinSolver, MFSolver,
                            ProblemInstance, PumpedLangevinSolver, Solution)
from ccvm_tpu_torch.ops import lbfgs as tlbfgs
from ccvm_tpu_torch.ops import mf_kernels
from ccvm_tpu_torch.parallel import sweep_solve

N = 8
ITERS = 60
BATCH = 16
PARAMS = {
    "langevin": {"dt": 0.02, "S": 0.5, "iterations": ITERS, "sigma": 0.5,
                 "feedback_scale": 1.0},
    "pumped": {"pump": 2.0, "dt": 0.02, "S": 0.5, "iterations": ITERS,
               "sigma": 0.5, "feedback_scale": 1.0},
    "dl": {"pump": 2.0, "feedback_scale": 10, "dt": 0.01, "iterations": ITERS,
           "noise_ratio": 10},
    "mf": {"pump": 0.0, "feedback_scale": 50, "j": 5.0, "S": 2.0, "dt": 0.01,
           "iterations": ITERS},
}
CLASSES = {"langevin": (JLangevinSolver, LangevinSolver),
           "pumped": (JPumpedLangevinSolver, PumpedLangevinSolver),
           "dl": (JDLSolver, DLSolver), "mf": (JMFSolver, MFSolver)}
# As tests/test_torch_langevin_solver.py holds the façades: where round-off
# of the input decides a post-processor's result, (rtol of the objective
# values and the best value, atol of the problem variables).
ROUND_OFF_DECIDED = {"adam": (1e-4, 2e-2), "bfgs": (2e-3, 2e-3)}


def _write_instance(path, rng, n=N):
    """A random BoxQP instance file in the reference .in format, its
    optimum the best vertex of the box (of the maximisation the file
    states)."""
    a = rng.randn(n, n)
    q = np.round((a + a.T) / 2, 6)
    v = np.round(rng.randn(n), 6)
    vertices = np.array(list(itertools.product((0.0, 1.0), repeat=n)))
    best = (0.5 * np.einsum("ki,ij,kj->k", vertices, q, vertices) + vertices @ v).max()
    lines = [f"{n}\t{best:.6f}\t{best:.6f}\t90.0\t0.1\t0.1\t0\t0\n"]
    lines.append("\t".join(f"{x:.6f}" for x in v) + "\n")
    for row in q:
        lines.append("\t".join(f"{x:.6f}" for x in row) + "\n")
    path.write_text("".join(lines))
    return str(path)


@pytest.fixture
def files(tmp_path):
    rng = np.random.RandomState(0)
    return [_write_instance(tmp_path / f"i{k}.in", rng) for k in range(4)]


def _instances(files, cls=ProblemInstance, device="cpu"):
    return [cls(instance_type="test", file_path=f, device=device) for f in files]


def _solver(name, jax_side=False, **params):
    jcls, tcls = CLASSES[name]
    s = jcls(device="cpu", batch_size=BATCH, backend="lax") if jax_side else \
        tcls(device="cpu", batch_size=BATCH)
    s.parameter_key = {N: dict(PARAMS[name], **params)}
    return s


@pytest.fixture
def mf_noise_off(monkeypatch):
    """The MF noise off on both sides (tests/test_torch_mf_solver.py)."""
    monkeypatch.setattr(jcommon, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(mf_kernels, "mf_solve",
                        functools.partial(mf_kernels.mf_solve, noise_scale=0.0))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _noise_off(name):
    """(parameter overrides, sweep keywords) that switch the noise off."""
    if name == "dl":
        return {}, {"g": 0.0}
    if name == "mf":
        return {}, {}
    return {"sigma": 0.0}, {}


def _agree(ours, theirs, post_processor=None):
    rtol, atol = ROUND_OFF_DECIDED.get(post_processor, (1e-4, 1e-4))
    for a, b in zip(ours, theirs, strict=True):
        np.testing.assert_allclose(np.asarray(a.objective_values),
                                   np.asarray(b.objective_values), rtol=rtol)
        assert a.solution_performance == b.solution_performance
        assert a.best_objective_value == pytest.approx(b.best_objective_value,
                                                       rel=rtol if post_processor else 1e-6)
        np.testing.assert_allclose(a.variables["problem_variables"].numpy(),
                                   np.asarray(b.variables["problem_variables"]),
                                   atol=atol)
        assert a.instance_name == b.instance_name
        assert (a.pp_time > 0) == (post_processor is not None)


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_sweep_matches_jax_without_noise(request, files, name, adam):
    if name == "mf":
        request.getfixturevalue("mf_noise_off")
    params, call = _noise_off(name)
    jcall, tcall = dict(call), dict(call)
    if adam:
        jcall["algorithm_parameters"] = JAdamParameters(alpha=0.05)
        tcall["algorithm_parameters"] = AdamParameters(alpha=0.05)
    theirs = jax_sweep_solve(_solver(name, True, **params),
                             _instances(files, JProblemInstance), seed=11, **jcall)
    ours = sweep_solve(_solver(name, **params), _instances(files), seed=11, **tcall)
    _agree(ours, theirs)
    if name == "dl":
        np.testing.assert_allclose(ours[0].variables["s"].numpy(),
                                   np.asarray(theirs[0].variables["s"]), atol=1e-4)
    if name == "mf":
        for key in ("mu", "sigma"):
            np.testing.assert_allclose(ours[0].variables[key].numpy(),
                                       np.asarray(theirs[0].variables[key]), atol=1e-3)


@pytest.mark.parametrize("post_processor", ["grad-descent", "adam", "asgd", "bfgs",
                                            "lbfgs"])
def test_each_post_processor_matches_jax(files, post_processor):
    theirs = jax_sweep_solve(_solver("langevin", True, sigma=0.0),
                             _instances(files, JProblemInstance), seed=5,
                             post_processor=post_processor)
    ours = sweep_solve(_solver("langevin", sigma=0.0), _instances(files), seed=5,
                       post_processor=post_processor)
    _agree(ours, theirs, post_processor)


def _equal_to_serial(solver, instances, seed, **call):
    swept = sweep_solve(solver, instances, seed=seed, **call)
    for i, inst in enumerate(instances):
        serial = solver(inst, seed=seed + i, **call)
        assert swept[i].variables.keys() == serial.variables.keys()
        for key, value in serial.variables.items():
            assert torch.equal(swept[i].variables[key], value), key
        np.testing.assert_array_equal(swept[i].objective_values, serial.objective_values)
        assert swept[i].solution_performance == serial.solution_performance
    return swept


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_sweep_instance_equals_serial_solve_with_noise(files, name):
    swept = _equal_to_serial(_solver(name), _instances(files), 11)
    # The noise separates the trajectories.
    rows = swept[0].variables["s" if name == "dl" else "problem_variables"]
    assert not torch.equal(rows[0], rows[1])


@pytest.mark.parametrize("post_processor", [None, "adam", "asgd", "bfgs", "lbfgs"])
def test_every_post_processor_equals_serial(files, post_processor):
    _equal_to_serial(_solver("langevin"), _instances(files), 3,
                     post_processor=post_processor)


def test_adam_sweep_equals_serial(files):
    _equal_to_serial(_solver("pumped"), _instances(files), 4,
                     algorithm_parameters=AdamParameters(alpha=0.05, beta2=1.0))


def test_sweep_readout_statistics_match_host64(files):
    """The stacked float64 readout (on the device) yields the host's
    float64 path's statistics for every instance in the stack, and every
    row's energy to float64 round-off of its absolute-value energy."""
    instances = _instances(files)
    swept = sweep_solve(_solver("langevin"), instances, seed=2)
    for inst, sol in zip(instances, swept, strict=True):
        x = sol.variables["problem_variables"]
        e_ref = inst.compute_energy_host64(x)
        xa = np.abs(x.double().numpy())
        scale = 0.5 * np.sum(xa * (xa @ np.abs(inst._q64)), -1) + xa @ np.abs(inst._v64)
        assert np.all(np.abs(sol.objective_values - e_ref) <= 1e-12 * scale)
        ref = Solution(
            problem_size=sol.problem_size, batch_size=sol.batch_size,
            instance_name=sol.instance_name, iterations=sol.iterations,
            objective_values=e_ref, solve_time=0.0, pp_time=0.0,
            optimal_value=inst.optimal_sol, best_value=inst.best_sol,
            num_frac_values=0, solution_vector=None, variables={},
        )
        assert sol.solution_performance == ref.solution_performance
        assert sol.best_objective_value == pytest.approx(ref.best_objective_value,
                                                         rel=1e-12, abs=0)
        assert any(v > 0 for v in sol.solution_performance.values())


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("kwargs", [dict(max_iter=50), dict(first_step_scale=0.001,
                                                            max_iter=1)])
def test_lbfgs_over_an_instance_axis_equals_per_instance_calls(symmetric, kwargs):
    rng = np.random.RandomState(7)
    a = rng.uniform(-1, 1, (3, 10, 10)).astype(np.float32)
    q = (a + a.transpose(0, 2, 1)) / 2 if symmetric else a
    q = torch.from_numpy(q - 5.0 * np.eye(10, dtype=np.float32))
    v = torch.from_numpy(rng.uniform(-1, 0, (3, 10)).astype(np.float32))
    c = torch.from_numpy(rng.uniform(0, 1, (3, 24, 10)).astype(np.float32))
    stacked = tlbfgs.lbfgs_box_batch(c, q, v[:, None, :], **kwargs)
    for i in range(3):
        assert torch.equal(stacked[i], tlbfgs.lbfgs_box_batch(c[i], q[i], v[i], **kwargs))


def test_rejects_mixed_sizes_devices_and_unknown_post_processor(files, tmp_path):
    solver = _solver("langevin")
    other = ProblemInstance(instance_type="test", device="cpu", file_path=_write_instance(
        tmp_path / "big.in", np.random.RandomState(9), n=9))
    with pytest.raises(ValueError, match="share one problem size"):
        sweep_solve(solver, _instances(files) + [other])
    moved = _instances(files)
    moved[2].device = "cuda"
    with pytest.raises(ValueError, match="must match"):
        sweep_solve(solver, moved)
    with pytest.raises(ValueError, match="does not know"):
        sweep_solve(solver, _instances(files), post_processor="newton")
    with pytest.raises(ValueError, match="No instances"):
        sweep_solve(solver, [])
    solver.parameter_key = {N + 1: dict(PARAMS["langevin"])}
    with pytest.raises(KeyError, match="problem size 8"):
        sweep_solve(solver, _instances(files))


def test_mesh_raises_naming_its_roadmap_item(files):
    """A mesh runs now (tests/test_torch_mesh.py shards a sweep over two
    ranks); what is not a DeviceMesh is refused before anything is solved."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        sweep_solve(_solver("dl"), _instances(files), mesh=object())


def test_scale_applies_the_solvers_scaling(files):
    solver = _solver("mf")
    instances, by_hand = _instances(files), _instances(files)
    for inst in by_hand:
        inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    swept = sweep_solve(solver, instances, seed=1, scale=True)
    for inst, ref in zip(instances, by_hand, strict=True):
        assert torch.equal(inst.q_matrix, ref.q_matrix) and inst.scaled_by == ref.scaled_by
    np.testing.assert_array_equal(swept[1].objective_values,
                                  sweep_solve(solver, by_hand, seed=1)[1].objective_values)


def test_solve_time_is_the_sweep_wall_over_every_trajectory(files):
    solver = _solver("langevin")
    swept = sweep_solve(solver, _instances(files), seed=0, post_processor="grad-descent")
    assert len({s.solve_time for s in swept}) == 1 and swept[0].solve_time > 0
    assert len({s.pp_time for s in swept}) == 1 and swept[0].pp_time > 0
    assert all(s.batch_size == BATCH and s.iterations == ITERS for s in swept)


@pytest.mark.parametrize("timing", ["async", "sync"])
def test_solve_clock_waits_for_the_solve_before_the_refinement(monkeypatch, files,
                                                                timing):
    """Under either timing the solve's output (after the change of
    variables) is waited for before the solve clock stops and the
    refinement starts, so ``pp_time`` holds the refinement alone.  The
    kernel is made an asynchronous launch that takes SLOW seconds on a
    stand-in clock that moves only then: the patched wrapper returns at
    once, and the first wait on the device moves the clock by SLOW, as a
    synchronise waits for a queued kernel."""
    from ccvm_tpu_torch.ops import langevin_kernels
    from ccvm_tpu_torch.parallel import sweep as sweep_mod

    slow = 0.5
    clock = [1000.0]
    events, pending = [], []
    launch = langevin_kernels.langevin_solve

    def queued(*args, **kwargs):
        events.append("launch")
        pending.append(slow)
        return launch(*args, **kwargs)

    def synchronize(x):
        events.append("wait")
        if pending:
            clock[0] += pending.pop()

    refine = sweep_mod._refine

    def recorded_refine(*args):
        events.append("refine")
        return refine(*args)

    monkeypatch.setattr(langevin_kernels, "langevin_solve", queued)
    monkeypatch.setattr(sweep_mod, "_synchronize", synchronize)
    monkeypatch.setattr(sweep_mod, "_refine", recorded_refine)
    monkeypatch.setattr(sweep_mod, "time", types.SimpleNamespace(time=lambda: clock[0]))
    solver = LangevinSolver(device="cpu", batch_size=BATCH, timing=timing)
    solver.parameter_key = {N: dict(PARAMS["langevin"])}
    swept = sweep_solve(solver, _instances(files), seed=0, post_processor="grad-descent")
    assert events == ["launch", "wait", "refine", "wait"]
    trajectories = len(files) * BATCH
    assert swept[0].solve_time * trajectories == pytest.approx(slow)
    assert swept[0].pp_time == 0.0


def test_cuda_without_a_card_raises(monkeypatch, files):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        LangevinSolver(device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        _instances(files, device="cuda")
