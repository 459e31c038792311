"""The port's grid-search ``tune`` (``ccvm_tpu_torch/tuning.py``): the JAX
package's tuning tests (``tests/unit/test_tuning.py``) on the port, and the
port against the JAX package with the noise off (``sigma=0``: the same
winner, each candidate's score fractions equal and its best objective to
rtol 1e-6), on the CPU.
"""

from __future__ import annotations

import itertools
import logging

import numpy as np
import pytest

from ccvm_tpu import tuning as jtuning
from ccvm_tpu.problem_classes.boxqp import ProblemInstance as JProblemInstance
from ccvm_tpu.solvers import LangevinSolver as JLangevinSolver
from ccvm_tpu_torch import (AdamParameters, DLSolver, LangevinSolver, MFSolver,
                            ProblemInstance, PumpedLangevinSolver, tuning)
from ccvm_tpu_torch.parallel import sweep as sweep_mod

N = 8
BASE = {"dt": 0.02, "S": 0.5, "iterations": 50, "sigma": 0.5, "feedback_scale": 1.0}


def _write(tmp_path, seed, name):
    """A random instance file, its optimum the best vertex of the box."""
    rng = np.random.RandomState(seed)
    a = rng.randn(N, N)
    q = np.round((a + a.T) / 2, 6)
    v = np.round(rng.randn(N), 6)
    x = np.array(list(itertools.product((0.0, 1.0), repeat=N)))
    best = (0.5 * np.einsum("ki,ij,kj->k", x, q, x) + x @ v).max()
    lines = [f"{N}\t{best:.6f}\t{best:.6f}\t90.0\t0.1\t0.1\t0\t0\n"]
    lines.append("\t".join(f"{x:.6f}" for x in v) + "\n")
    for row in q:
        lines.append("\t".join(f"{x:.6f}" for x in row) + "\n")
    path = tmp_path / name
    path.write_text("".join(lines))
    return str(path)


def _make_instance(tmp_path, seed, name, cls=ProblemInstance):
    return cls(instance_type="tuning", file_path=_write(tmp_path, seed, name),
               device="cpu")


@pytest.fixture
def instance(tmp_path):
    return _make_instance(tmp_path, 0, "t.in")


def _solver(cls=LangevinSolver, **params):
    s = cls(device="cpu", batch_size=32, **({"backend": "lax"} if cls is JLangevinSolver
                                            else {}))
    s.parameter_key = {N: dict(BASE, **params)}
    return s


def _scaled(tmp_path, seeds, solver, cls=ProblemInstance, prefix="i"):
    insts = [_make_instance(tmp_path, s, f"{prefix}{s}.in", cls) for s in seeds]
    for inst in insts:
        inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    return insts


def test_tune_picks_a_candidate_and_sets_is_tuned(instance):
    solver = _solver()
    assert not solver.is_tuned
    best = solver.tune(
        [instance],
        parameter_ranges={"dt": [0.005, 0.02], "sigma": [0.1, 0.5]},
        tuning_batch_size=16,
        seed=0,
    )
    assert solver.is_tuned
    assert best[N]["dt"] in (0.005, 0.02)
    assert best[N]["sigma"] in (0.1, 0.5)
    # non-tuned keys keep their base values
    assert best[N]["iterations"] == 50
    assert solver.parameter_key == best


def test_tune_restores_batch_size(instance):
    solver = _solver()
    solver.tune([instance], parameter_ranges={"dt": [0.02]}, tuning_batch_size=8)
    assert solver.batch_size == 32


@pytest.mark.parametrize("cls", [DLSolver, MFSolver, LangevinSolver,
                                 PumpedLangevinSolver])
def test_tune_requires_base_parameter_key(instance, cls):
    with pytest.raises(ValueError, match="Set solver.parameter_key before tuning"):
        cls(device="cpu", batch_size=8).tune([instance], parameter_ranges={"dt": [0.01]})


def test_tune_unknown_size_raises(instance):
    solver = _solver()
    solver._parameter_key = {99: dict(solver.parameter_key[N])}
    with pytest.raises(KeyError):
        solver.tune([instance], parameter_ranges={"dt": [0.01]})


def test_tune_stacks_multi_instance_scoring_through_sweep(tmp_path, monkeypatch):
    """With more than one instance of a size, each candidate is scored by ONE
    sweep_solve (one stacked launch on the card)."""
    solver = _solver()
    insts = _scaled(tmp_path, (1, 2, 3), solver)
    calls = []
    real_sweep = sweep_mod.sweep_solve

    def counting_sweep(*args, **kwargs):
        calls.append(kwargs.get("seed"))
        return real_sweep(*args, **kwargs)

    monkeypatch.setattr(sweep_mod, "sweep_solve", counting_sweep)
    best = tuning.tune_solver(solver, insts, parameter_ranges={"dt": [0.005, 0.02]},
                              tuning_batch_size=16, seed=3)
    assert calls == [3, 3]  # one sweep per candidate, not per instance
    assert best[N]["dt"] in (0.005, 0.02)


def test_tune_use_sweep_false_goes_serial(tmp_path, monkeypatch):
    solver = _solver()
    insts = _scaled(tmp_path, (1, 2), solver)

    def boom(*args, **kwargs):
        raise AssertionError("sweep path must not be used")

    monkeypatch.setattr(sweep_mod, "sweep_solve", boom)
    best = tuning.tune_solver(solver, insts, parameter_ranges={"dt": [0.02]},
                              tuning_batch_size=8, use_sweep=False)
    assert best[N]["dt"] == 0.02


def test_a_sweep_value_error_scores_serially(tmp_path, monkeypatch):
    """A sweep that raises ValueError (a post-processor it lacks) leaves the
    candidate to the serial loop, as in the JAX package."""
    solver = _solver()
    insts = _scaled(tmp_path, (1, 2), solver)

    def refuse(*args, **kwargs):
        raise ValueError("sweep_solve does not know post-processor")

    monkeypatch.setattr(sweep_mod, "sweep_solve", refuse)
    assert tuning.tune_solver(solver, insts, parameter_ranges={"dt": [0.02]},
                              tuning_batch_size=8)[N]["dt"] == 0.02


def test_setting_parameter_key_clears_is_tuned(instance):
    solver = _solver()
    solver.tune([instance], parameter_ranges={"dt": [0.02]}, tuning_batch_size=8)
    assert solver.is_tuned
    solver.parameter_key = {N: dict(BASE, dt=0.01)}
    assert not solver.is_tuned


def test_tune_confirmation_pass_rescores_top_k(tmp_path, monkeypatch):
    """confirm_seeds > 1 re-scores the top-k finalists with extra seeds and
    picks the winner by MEAN score."""
    solver = _solver()
    insts = _scaled(tmp_path, (1, 2, 3), solver, prefix="c")
    seeds_seen = []
    real_sweep = sweep_mod.sweep_solve

    def counting_sweep(*args, **kwargs):
        seeds_seen.append(kwargs.get("seed"))
        return real_sweep(*args, **kwargs)

    monkeypatch.setattr(sweep_mod, "sweep_solve", counting_sweep)
    best = tuning.tune_solver(solver, insts, parameter_ranges={"dt": [0.005, 0.02]},
                              tuning_batch_size=16, seed=3, confirm_seeds=3,
                              confirm_top_k=2)
    # 2 grid sweeps + 2 finalists x 2 extra confirmation seeds = 6.
    assert len(seeds_seen) == 6
    assert set(seeds_seen) == {3, 3 + 7919, 3 + 2 * 7919}
    assert best[N]["dt"] in (0.005, 0.02)


def test_tune_accepts_algorithm_parameters(tmp_path):
    solver = _solver()
    insts = _scaled(tmp_path, (1, 2), solver, prefix="a")
    best = tuning.tune_solver(solver, insts, parameter_ranges={"dt": [0.02]},
                              tuning_batch_size=8,
                              algorithm_parameters=AdamParameters(alpha=0.1, beta1=0.9,
                                                                  beta2=0.999))
    assert best[N]["dt"] == 0.02


def _scores(caplog, logger_name, confirm=False):
    """Each candidate's score as the tuner logged it."""
    tag = "tune confirm" if confirm else "tune size"
    return [r.args[-1] for r in caplog.records
            if r.name == logger_name and r.msg.startswith(tag)]


GRID = {"dt": [0.005, 0.02, 0.05], "feedback_scale": [0.5, 1.0]}


@pytest.mark.parametrize("confirm_seeds", [1, 3])
def test_tune_matches_jax_without_noise(tmp_path, caplog, confirm_seeds):
    """sigma = 0: the port and the JAX package score every candidate alike
    and pick the same winner, through the confirmation pass too."""
    caplog.set_level(logging.INFO)
    winners = []
    for cls, inst_cls, logger_name in (
            (JLangevinSolver, JProblemInstance, jtuning.logger.name),
            (LangevinSolver, ProblemInstance, tuning.logger.name)):
        solver = _solver(cls, sigma=0.0)
        insts = _scaled(tmp_path, (1, 2, 3), solver, inst_cls,
                        prefix=f"{cls.__module__.split('.')[0]}_")
        winners.append(solver.tune(insts, parameter_ranges=GRID, tuning_batch_size=16,
                                   seed=7, confirm_seeds=confirm_seeds, confirm_top_k=2,
                                   post_processor="grad-descent"))
    assert winners[0] == winners[1]
    for confirm in ((False, True) if confirm_seeds > 1 else (False,)):
        theirs = _scores(caplog, jtuning.logger.name, confirm)
        ours = _scores(caplog, tuning.logger.name, confirm)
        assert len(ours) == len(theirs) == (2 if confirm else 6)
        assert any(score[0] > 0 for score in ours)
        for a, b in zip(ours, theirs, strict=True):
            assert a[:2] == b[:2]
            assert a[2] == pytest.approx(b[2], rel=1e-6)


def test_sweep_and_serial_scoring_give_identical_scores(tmp_path, caplog):
    """Noise on: the serial loop seeds instance i with seed + i, as the
    sweep does, so both paths score every candidate alike."""
    caplog.set_level(logging.INFO, logger=tuning.logger.name)
    solver = _solver()
    insts = _scaled(tmp_path, (1, 2, 3), solver)
    winners, scores = [], []
    for use_sweep in (True, False):
        caplog.clear()
        winners.append(solver.tune(insts, parameter_ranges=GRID, tuning_batch_size=16,
                                   seed=7, use_sweep=use_sweep,
                                   post_processor="grad-descent"))
        scores.append(_scores(caplog, tuning.logger.name))
    assert winners[0] == winners[1]
    assert len(scores[0]) == 6 and scores[0] == scores[1]
