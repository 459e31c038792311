"""The port's profiling hooks (``ccvm_tpu_torch/profiling.py``) on the CPU:
the JAX package's profiling tests (``tests/unit/test_aux_subsystems.py``
``TestProfiling``) on the port, and ``annotate`` spans in the Chrome-format
trace that ``trace`` writes around a plain solve."""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest
import torch

from ccvm_tpu import profiling as jprofiling
from ccvm_tpu_torch import LangevinSolver, ProblemInstance, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST020 = os.path.join(REPO, "tests", "data", "test020.in")


class _Sol:
    solve_time = 0.001  # per-batch normalized
    batch_size = 100
    iterations = 1000


def test_solve_rate_counters():
    rates = profiling.solve_rate(_Sol(), num_chips=4)
    assert rates["iterations_per_sec"] == pytest.approx(1000 / 0.1)
    assert rates["trajectory_iterations_per_sec"] == pytest.approx(1e6)
    assert rates["trajectory_iterations_per_sec_per_chip"] == pytest.approx(2.5e5)
    assert rates == jprofiling.solve_rate(_Sol(), num_chips=4)
    zero = _Sol()
    zero.solve_time = 0.0
    assert profiling.solve_rate(zero)["iterations_per_sec"] == float("inf")


def test_timer_normalizes_by_batch():
    timer = profiling.Timer(batch_size=10)
    out, per_batch = timer(lambda: (torch.ones(4), [torch.zeros(2)]))
    assert per_batch == pytest.approx(timer.elapsed / 10)
    assert out[0].shape == (4,)


def test_annotated_spans_show_in_the_trace(tmp_path):
    solver = LangevinSolver(device="cpu", batch_size=8)
    solver.parameter_key = {20: {"dt": 0.002, "S": 0.5, "iterations": 4, "sigma": 0.5,
                                 "feedback_scale": 2.0}}
    inst = ProblemInstance(device="cpu", file_path=TEST020, instance_type="test")
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir, create_perfetto_link=True) as prof:
        with profiling.annotate("ccvm-solve"):
            sol = solver(inst, seed=0)
        with profiling.annotate("ccvm-readout"):
            sol.solution_performance
    assert np.isfinite(sol.objective_values).all()
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"ccvm-solve", "ccvm-readout"} <= names
    assert "ccvm-solve" in {e.key for e in prof.key_averages()}
