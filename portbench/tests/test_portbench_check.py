"""What decides ``correct``, driven on the CPU at a small size: the run
passes on the port's plain versions, and comes out not correct with the
timed path broken underneath in each way a cell can break, and with the
control (the reference in TF32) in the program's place."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from ccvm_tpu_torch.ops import dl_kernels, mf_kernels
from ccvm_tpu_torch.parallel import sweep
from ccvm_tpu_torch.problem_classes.boxqp import problem_instance
from portbench import check, spec
from portbench import control as control_tool

SHRINK = {"batch": 32, "iterations": 120, "call_pool": 3}
MAIN = ["dl-main-n70-b65536", "mf-main-n70-b65536"]
SEED = 2**31 + 1234


def _run_module():
    path = os.path.join(spec.HERE, "run.py")
    s = importlib.util.spec_from_file_location("portbench_run_under_test", path)
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module


RUN = _run_module()


def run(cell, seed=SEED):
    result, numbers = RUN.run_cell(cell, seed, 2.0, False, device="cpu", shrink=SHRINK)
    assert result["attempted"] >= SHRINK["call_pool"]
    return result, numbers


@pytest.mark.parametrize("cell", MAIN)
def test_the_plain_program_is_correct(cell):
    result, numbers = run(cell)
    assert result["correct"], numbers
    assert list(result)[-1] == "checks" and set(result["checks"]) == set(numbers)
    for value, limit in numbers.values():
        assert value <= limit


def test_a_study_cell_is_correct():
    result, numbers = RUN.run_cell("dl-study-b1000", SEED, 3.0, False, device="cpu",
                                   shrink={"batch": 8, "iterations": 60, "call_pool": 6})
    assert result["correct"], numbers
    assert "call_p90_s" in result["metrics"]


def _state_unchanged(solve):
    def broken(seed, q, v, params, **kw):
        out = solve(seed, q, v, params, **kw)
        if solve is mf_kernels.mf_solve:  # (mu, mu_tilde, sigma) as they start
            return torch.zeros_like(out[0]), torch.zeros_like(out[1]), torch.full_like(out[2], 0.5)
        return tuple(torch.zeros_like(x) for x in out)
    return broken


def _half_batch(solve):
    def broken(seed, q, v, params, *, batch_size, **kw):
        out = solve(seed, q, v, params, batch_size=batch_size // 2, **kw)
        return tuple(torch.cat([x, x], dim=-2) for x in out)
    return broken


def _altered_energy(readout):
    def broken(*args, **kwargs):
        e = np.array(readout(*args, **kwargs), copy=True)
        flat = e.reshape(-1)
        flat[np.argmin(flat)] *= 1.001  # the best row's energy, where it is made
        return e
    return broken


FAULTS = {
    "state unchanged": lambda mp: (
        mp.setattr(dl_kernels, "dl_solve", _state_unchanged(dl_kernels.dl_solve)),
        mp.setattr(mf_kernels, "mf_solve", _state_unchanged(mf_kernels.mf_solve))),
    "half the batch": lambda mp: (
        mp.setattr(dl_kernels, "dl_solve", _half_batch(dl_kernels.dl_solve)),
        mp.setattr(mf_kernels, "mf_solve", _half_batch(mf_kernels.mf_solve))),
    "an answer altered": lambda mp: (
        mp.setattr(problem_instance.ProblemInstance, "compute_energy_readout64",
                   _altered_energy(problem_instance.ProblemInstance.compute_energy_readout64)),
        mp.setattr(sweep, "stacked_readout64", _altered_energy(sweep.stacked_readout64))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", MAIN)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, numbers = run(cell)
    assert not result["correct"], numbers


def _one_size(solve, n=30):
    """A wrong build for one size: its solves draw another seed's noise."""
    def broken(seed, q, v, params, **kw):
        return solve(seed + (q.shape[-1] == n), q, v, params, **kw)
    return broken


def _one_slot(solve, slot=3):
    """A stacking fault on one slot of a sweep: it returns the next slot's
    trajectories."""
    def broken(seed, q, v, params, **kw):
        out = solve(seed, q, v, params, **kw)
        if q.dim() == 3 and q.shape[0] > slot + 1:
            out = tuple(torch.cat([x[:slot], x[slot + 1:slot + 2], x[slot + 1:]]) for x in out)
        return out
    return broken


SWEEP_FAULTS = {
    "half the batch": FAULTS["half the batch"],
    "one size": lambda mp: mp.setattr(dl_kernels, "dl_solve", _one_size(dl_kernels.dl_solve)),
    "one slot": lambda mp: mp.setattr(dl_kernels, "dl_solve", _one_slot(dl_kernels.dl_solve)),
}


@pytest.mark.parametrize("fault", sorted(SWEEP_FAULTS))
def test_a_broken_sweep_is_not_correct(fault, monkeypatch):
    SWEEP_FAULTS[fault](monkeypatch)
    result, numbers = RUN.run_cell("dl-study-b1000", SEED + 1, 3.0, False, device="cpu",
                                   shrink={"batch": 8, "iterations": 60, "call_pool": 6})
    assert not result["correct"], numbers
    if fault != "half the batch":
        assert numbers["state_gap"][0] > numbers["state_gap"][1], numbers


@pytest.mark.parametrize("cell", MAIN)
def test_the_control_is_not_correct(cell):
    """The reference in TF32, put in the program's place, fails the cell's
    limits; the program's readings on the same calls pass them."""
    rows = []
    control_tool.readings(cell, [SEED], {SEED}, device="cpu", shrink=SHRINK, emit=rows.append)
    limits = spec.cell(cell)["workload"]["limits"]
    program, ctrl = (next(r for r in rows if r["side"] == side) for side in ("program", "control"))
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(ctrl[k] > limits[k] for k in limits), ctrl


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert RUN.main(["--workload", MAIN[0], "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""


def test_the_check_samples_rows_and_calls_from_the_seed():
    cell = spec.cell(MAIN[0])
    files = spec.instance_files(cell["config"])
    from portbench import generator

    plan = generator.plan(cell["traffic"], {70: files[70]}, 5, 100)
    chk = cell["workload"]["check"]
    assert check.kept_calls(plan, chk, 5) == check.kept_calls(plan, chk, 5)
    assert len(check.kept_calls(plan, chk, 5)) == chk["per_size"]
    assert all(i < chk["call_pool"] for i in check.kept_calls(plan, chk, 5))
    a = check.sample_rows(5, 3, 0, 65536, 64)
    assert len(set(a.tolist())) == 64 and not np.array_equal(a, check.sample_rows(6, 3, 0, 65536, 64))


@pytest.mark.cuda
def test_a_main_cell_runs_correct_on_the_card(card):
    result, numbers = RUN.run_cell(MAIN[0], SEED, 5.0, False, device=card)
    assert result["correct"], numbers
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    assert result["metrics"]["traj_iter_per_s"]["value"] > 0
