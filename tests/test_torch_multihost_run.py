"""Multi-process runs of the port's entry points over gloo (CPU).

``python -m ccvm_tpu_torch.tools.multihost_smoke`` (the twin of
``tools/multihost_smoke.py``) starts two processes that join one group,
split the instance list, solve a sharded batch and gather it; it must pass.
``examples/torch_port/tensor_parallel_boxqp.py --cpu`` spawns a 2 x 2 mesh
of gloo ranks and solves the JAX example's instance through the façade's
tensor-parallel route; its best objective is held against the port's
single-process solve by the rule of tests/unit/test_sharding.py's façade
test.  The study's ``--mesh 1`` runs as a one-rank world that it starts and
ends itself, equal to the study without a mesh.
"""

from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist
from test_torch_sweep import _write_instance
from torch_ranks import study_argv

import ccvm_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO)


def test_two_process_smoke_passes():
    res = subprocess.run([sys.executable, "-m", "ccvm_tpu_torch.tools.multihost_smoke"],
                         cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "multihost smoke: PASS" in res.stdout
    assert "process 0 OK" in res.stdout and "process 1 OK" in res.stdout


def test_tensor_parallel_example_over_four_gloo_ranks(tmp_path):
    script = os.path.join(REPO, "examples", "torch_port", "tensor_parallel_boxqp.py")
    res = subprocess.run([sys.executable, script, "--cpu", "--ranks", "4",
                          "--iterations", "200"], cwd=tmp_path, env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "mesh: {'batch': 2, 'model': 2} over 4 cpu rank(s)" in res.stdout
    best = float(re.search(r"best objective: (\S+)", res.stdout).group(1))
    # The single-process solve of the same instance, parameters and seed.
    solver = port.LangevinSolver(device="cpu", batch_size=512)
    solver.parameter_key = {20: {"dt": 0.002, "S": 0.5, "iterations": 200, "sigma": 0.5,
                                 "feedback_scale": 1.0}}
    inst = port.ProblemInstance(
        instance_type="test", device="cpu", file_path=os.path.join(
            REPO, "examples", "benchmarking_instances", "single_test_instance",
            "tuningH020-100-0.in"))
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    one = solver(inst, post_processor="grad-descent", seed=42).best_objective_value
    assert abs(best - one) <= max(0.05 * abs(one), 1.0)


def test_study_mesh_of_one_rank_equals_no_mesh(tmp_path):

    spec = importlib.util.spec_from_file_location(
        "run_study", os.path.join(REPO, "examples", "torch_port", "benchmarking_study.py"))
    study = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(study)
    rng = np.random.RandomState(1)
    for n in (6, 8):
        (tmp_path / "instances" / f"Size{n}").mkdir(parents=True)
        _write_instance(tmp_path / "instances" / f"Size{n}" / f"toy{n:03d}.in", rng, n)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("RANK", raising=False)
        meshed = study.run_sweep(study.parse_args(study_argv(str(tmp_path), "mesh",
                                                             "--mesh", "1", "--sweep")))
    assert not dist.is_initialized()
    plain = study.run_sweep(study.parse_args(study_argv(str(tmp_path), "one", "--sweep")))
    assert [row[:4] for row in meshed] == [row[:4] for row in plain]
    assert sorted(os.listdir(tmp_path / "mesh")) == sorted(os.listdir(tmp_path / "one"))
