"""The Langevin configuration on the CPU at a small size: the plain
reference against the port's plain Langevin path, the shrunk cell
``correct``, and the cell failing with the control in the program's place
and with the timed path broken underneath."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from ccvm_tpu_torch.dynamics.langevin import LangevinParams
from ccvm_tpu_torch.ops import langevin_kernels
from ccvm_tpu_torch.post_processor.grad_descent import PostProcessorGradDescent
from portbench import spec
from portbench import control as control_tool
from portbench.reference import langevin
from portbench.reference.sde import Groups

CELL = "langevin-main-n70-b65536"
SHRINK = {"batch": 32, "iterations": 120, "call_pool": 3}
SEED = 2**31 + 4321
PARAMS = {"S": 0.5, "dt": 0.002, "sigma": 0.5, "feedback_scale": 2.0}


def _run_module():
    path = os.path.join(spec.HERE, "run.py")
    s = importlib.util.spec_from_file_location("portbench_run_langevin", path)
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module


RUN = _run_module()


def run(seed=SEED):
    result, numbers = RUN.run_cell(CELL, seed, 2.0, False, device="cpu", shrink=SHRINK)
    assert result["attempted"] >= SHRINK["call_pool"]
    return result, numbers


def _instance(n, seed):
    """A random BoxQP instance, scaled as the Langevin solver scales it."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-50, 50, (n, n))
    q = ((a + a.T) / 2).astype(np.float32)
    v = rng.uniform(-50, 50, n).astype(np.float32)
    sf = np.float32(np.sqrt(np.abs(q.astype(np.float64)).sum())) * np.float32(
        langevin.SCALING_MULTIPLIER)
    return q / sf, v / sf


@pytest.mark.parametrize("n", [12, 20])
def test_the_reference_follows_the_ports_plain_solve(n):
    q, v = _instance(n, n)
    seed, batch, steps = 2**31 + 99 + n, 32, 200
    f32 = {k: float(np.float32(x)) for k, x in PARAMS.items()}
    params = LangevinParams(**f32, lower_limit=0.0, upper_limit=1.0)
    c = langevin_kernels.langevin_solve(seed, torch.from_numpy(q), torch.from_numpy(v),
                                        params, iterations=steps, batch_size=batch)
    groups = Groups([{"q": q, "v": v, "seed": seed, "rows": np.arange(batch),
                      "params": PARAMS}], "cpu")
    ref = langevin.solve(groups, steps)["c"][0]
    # Both sides take the same float32 operations in the same order on the
    # same draws; only the matrix product's summation (one (B, n) product
    # against a batched (1, B, n) one) may round apart: an ulp or two of
    # the drift a step, times dt fs, well under 1e-6 of c after 200 steps.
    assert (c - ref).abs().max() <= 1e-6
    # The clamp at +-S binds on some coordinates and not on others.
    assert 0 < (ref.abs() == 0.5).float().mean() < 1


def test_the_shrunk_cell_is_correct():
    result, numbers = run()
    assert result["correct"], numbers
    assert set(numbers) == {"state_gap", "pv_gap", "energy_gap", "stats_mismatch"}


def test_the_control_is_not_correct():
    """The reference in TF32, put in the program's place, fails the cell's
    limits; the program's readings on the same calls pass them."""
    rows = []
    control_tool.readings(CELL, [SEED], {SEED}, device="cpu", shrink=SHRINK, emit=rows.append)
    limits = spec.cell(CELL)["workload"]["limits"]
    program, ctrl = (next(r for r in rows if r["side"] == side) for side in ("program", "control"))
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(ctrl[k] > limits[k] for k in limits), ctrl


def _state_unchanged(solve):
    def broken(seed, q, v, params, **kw):
        return torch.zeros_like(solve(seed, q, v, params, **kw))
    return broken


def _half_batch(solve):
    def broken(seed, q, v, params, *, batch_size, **kw):
        out = solve(seed, q, v, params, batch_size=batch_size // 2, **kw)
        return torch.cat([out, out], dim=-2)
    return broken


def _no_refinement(self, c, q_matrix, v_vector, **kw):
    self.pp_time = 1e-6
    return torch.as_tensor(c, dtype=torch.float32)


FAULTS = {
    "state unchanged": lambda mp: mp.setattr(
        langevin_kernels, "langevin_solve", _state_unchanged(langevin_kernels.langevin_solve)),
    "half the batch": lambda mp: mp.setattr(
        langevin_kernels, "langevin_solve", _half_batch(langevin_kernels.langevin_solve)),
    "grad-descent skipped": lambda mp: mp.setattr(
        PostProcessorGradDescent, "postprocess", _no_refinement),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, numbers = run()
    assert not result["correct"], numbers
