"""The port's float64 readout (``compute_energy_readout64``,
``stacked_readout64``) against the host's float64 energies
(``compute_energy_host64``) on every row, and on rows that tie in float32
near the best (CPU)."""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest
import torch

from ccvm_tpu_torch import DLSolver, ProblemInstance
from ccvm_tpu_torch.dynamics.common import change_variables_boxqp, langevin_change_variables
from ccvm_tpu_torch.problem_classes.boxqp import problem_instance as tpi
from ccvm_tpu_torch.solution import Solution

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE20 = os.path.join(REPO, "examples", "benchmarking_instances", "Size20")
TIED = [os.path.join(SIZE20, f"tuningH020-100-{i}.in") for i in (11, 17)]
SIZE70 = sorted(glob.glob(os.path.join(REPO, "examples", "benchmarking_instances",
                                       "Size70", "*.in")))[:2]


def _scaled(path):
    inst = ProblemInstance(device="cpu", file_path=path, instance_type="test")
    inst.scale_coefs(DLSolver(device="cpu").get_scaling_factor(inst.q_matrix))
    return inst


def _tied(path, rows=1000, seed=0):
    """The instance and its recorded solution replicated ``rows`` times,
    perturbed by at most 3e-8 (so the rows tie in float32), the float64-best
    row last, and ``optimal_sol`` 7% above its value (so no row lies near a
    gap threshold)."""
    inst = _scaled(path)
    sol = np.asarray(inst.solution_vector, np.float32)
    rng = np.random.RandomState(seed)
    x = np.clip(sol + rng.uniform(-3e-8, 3e-8, (rows, sol.size)), 0, 1).astype(np.float32)
    best = int(np.argmin(inst.compute_energy_host64(x)))
    x[[best, -1]] = x[[-1, best]]
    inst.optimal_sol *= 1.07
    assert len(np.unique(inst.compute_energy(torch.from_numpy(x)).numpy())) <= 2
    return inst, x


def _solution(inst, energies):
    return Solution(problem_size=inst.problem_size, batch_size=energies.shape[0],
                    instance_name=inst.name, iterations=1, objective_values=energies,
                    solve_time=0.0, pp_time=0.0, optimal_value=inst.optimal_sol,
                    best_value=inst.best_sol, num_frac_values=inst.num_frac_values,
                    solution_vector=[], variables={})


@pytest.mark.parametrize("stacked", [False, True], ids=["alone", "stacked"])
def test_best_row_of_a_float32_tie_is_the_float64_best(stacked):
    tied = [_tied(p) for p in TIED]
    if stacked:
        energies = tpi.stacked_readout64([inst for inst, _ in tied],
                                         torch.from_numpy(np.stack([x for _, x in tied])))
    else:
        energies = [inst.compute_energy_readout64(torch.from_numpy(x)) for inst, x in tied]
    for (inst, x), e in zip(tied, energies):
        host = inst.compute_energy_host64(x)
        assert host[-1] == host.min()
        assert -e.min() == pytest.approx(-host.min(), rel=1e-12, abs=0)
        assert _solution(inst, e).best_objective_value == pytest.approx(
            _solution(inst, host).best_objective_value, rel=1e-12, abs=0)
        assert _solution(inst, e).solution_performance == \
            _solution(inst, host).solution_performance


def _abs_energy(inst, x):
    """0.5 |x||Q||x| + |V||x| of the readout's coefficients in float64: the
    scale of each row's round-off."""
    x = np.abs(np.asarray(x, np.float64))
    return 0.5 * np.sum(x * (x @ np.abs(inst._q64)), axis=-1) + x @ np.abs(inst._v64)


def _rows(inst, batch=512, seed=5):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1.0, 1.0, (batch, inst.problem_size)).astype(np.float32)


def _case(case):
    """(readout energies, the host's float64 energies, the rows' scale)."""
    if case == "stacked":
        insts = [_scaled(p) for p in SIZE70]
        x = np.stack([(1 + _rows(inst, seed=i)) / 2 for i, inst in enumerate(insts)])
        energies = tpi.stacked_readout64(insts, torch.from_numpy(x))
        return (energies, np.stack([i.compute_energy_host64(r) for i, r in zip(insts, x)]),
                np.stack([_abs_energy(i, r) for i, r in zip(insts, x)]))
    inst = _scaled(SIZE70[0])
    raw = torch.from_numpy(_rows(inst))
    if case == "plain":
        x = (1 + raw) / 2
        energies = inst.compute_energy_readout64(x)
    elif case == "boxqp":
        lo, hi, S = 0.0, 1.0, 0.75
        energies = inst.compute_energy_readout64(raw * S, change_vars=("boxqp", lo, hi, S))
        x = change_variables_boxqp(raw * S, lo, hi, torch.tensor(S))
    elif case == "langevin":
        S = 0.5
        energies = inst.compute_energy_readout64(raw * S, change_vars=("langevin", 0.0, 1.0, S))
        x = langevin_change_variables(raw * S, torch.tensor(S))
    else:
        assert case == "no-q64"  # an instance built without float64 coefficients
        built = ProblemInstance(device="cpu")
        built.q_matrix, built.v_vector = inst.q_matrix, inst.v_vector
        built.scaled_by = inst.scaled_by
        x = (1 + raw) / 2
        energies = built.compute_energy_readout64(x)
        q = inst.q_matrix.double().numpy()
        v = inst.v_vector.double().numpy()
        xa = np.abs(x.double().numpy())
        scale = (0.5 * np.sum(xa * (xa @ np.abs(q)), axis=-1) + xa @ np.abs(v)) * inst.scaled_by
        return energies, built.compute_energy_host64(x), scale
    return energies, inst.compute_energy_host64(x), _abs_energy(inst, x.numpy())


@pytest.mark.parametrize("case", ["boxqp", "langevin", "plain", "stacked", "no-q64"])
def test_every_row_is_the_hosts_float64_energy(case):
    energies, host, scale = _case(case)
    assert energies.dtype == np.float64 and energies.shape == host.shape
    assert np.all(np.abs(energies - host) <= 1e-12 * scale)


def test_readout_keeps_one_float64_copy_of_the_coefficients():
    inst = _scaled(SIZE70[0])
    assert inst._card64 is None  # made at the first readout, not at the load
    x = torch.from_numpy((1 + _rows(inst)) / 2)
    first = inst.compute_energy_readout64(x)
    kept = inst._card64
    n = inst.problem_size
    assert kept.dtype == torch.float64 and kept.shape == (n + 1, n)
    np.testing.assert_array_equal(kept[:-1].numpy(), inst._q64)
    np.testing.assert_array_equal(kept[-1].numpy(), inst._v64)
    coefs, scale = inst._coefs64(x.device)
    assert coefs is kept and scale == 1.0
    # Scaling leaves the readout's coefficients (the original ones) alone.
    inst.scale_coefs(2.0)
    np.testing.assert_array_equal(inst.compute_energy_readout64(x), first)
    assert inst._card64 is kept
    # Loading the instance again makes a new copy at the next readout.
    inst.load_instance(device="cpu", file_path=SIZE70[1])
    assert inst._card64 is None
    inst.compute_energy_readout64(x)
    assert inst._card64 is not kept


def test_a_sweep_copies_the_missing_coefficients_together():
    insts = [_scaled(p) for p in SIZE70]
    kept = _scaled(SIZE70[0])
    kept.compute_energy_readout64(torch.from_numpy((1 + _rows(kept)) / 2))
    before = kept._card64
    x = torch.from_numpy(np.stack([(1 + _rows(i, seed=k)) / 2
                                   for k, i in enumerate(insts + [kept])]))
    tpi.stacked_readout64(insts + [kept], x)
    assert kept._card64 is before
    storages = {i._card64.untyped_storage().data_ptr() for i in insts}
    assert len(storages) == 1 and before.untyped_storage().data_ptr() not in storages


def test_readout_rejects_a_vector_s():
    inst = _scaled(SIZE70[0])
    raw = torch.from_numpy(_rows(inst))
    with pytest.raises(ValueError, match="scalar S"):
        inst.compute_energy_readout64(raw, change_vars=("boxqp", 0.0, 1.0,
                                                        np.ones(inst.problem_size)))


def test_readout_over_leading_dims_and_without_an_optimum():
    inst = _scaled(SIZE70[0])
    x = (1 + _rows(inst, batch=24)) / 2
    inst.optimal_sol = None
    energies = inst.compute_energy_readout64(torch.from_numpy(x.reshape(2, 3, 4, -1)))
    assert energies.shape == (2, 3, 4)
    host = inst.compute_energy_host64(x)
    assert np.all(np.abs(energies.reshape(-1) - host) <= 1e-12 * _abs_energy(inst, x))
