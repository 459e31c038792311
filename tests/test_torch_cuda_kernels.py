"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips with a reason on a host without a card
(the kernels cannot run in an interpreter).  On the card:
``python -m pytest tests/test_torch_cuda_kernels.py``.
"""

from __future__ import annotations

import os

import pytest
import torch

from ccvm_tpu_torch import AdamParameters, DLSolver, MFSolver, ProblemInstance
from ccvm_tpu_torch.ops import dl_kernels, mf_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCE = os.path.join(REPO, "tests", "data", "test020.in")
TOL = 1e-4  # fp32 sum order over 200 steps (100 for MF)


@pytest.fixture
def cuda_instance():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    inst = ProblemInstance(device="cuda", file_path=INSTANCE, instance_type="test")
    solver = DLSolver(device="cuda")
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    solver.solution_bounds = inst.solution_bounds
    return inst, solver


@pytest.mark.cuda
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("rng", ["popcount16", "popcount32", "popcount", "box_muller"])
@pytest.mark.parametrize("beta2", [None, 0.999, 1.0])
def test_kernel_matches_plain(cuda_instance, noise_scale, rng, beta2):
    inst, solver = cuda_instance
    hp = None if beta2 is None else AdamParameters(beta2=beta2).to_hyperparameters()
    p = solver._make_params(8.0, 1.0, 0.001, 10.0, 100.0, 0.05, 200)
    kw = dict(iterations=200, batch_size=300, pump_rate_flag=True,
              pump_is_gt_one=True, noise_scale=noise_scale, rng=rng, hp=hp)
    ck, sk = dl_kernels.dl_solve(4, inst.q_matrix, inst.v_vector, p, **kw)
    cr, sr = dl_kernels.dl_solve_reference(4, inst.q_matrix, inst.v_vector, p, **kw)
    torch.cuda.synchronize()
    assert (ck - cr).abs().max().item() <= TOL
    assert (sk - sr).abs().max().item() <= TOL


@pytest.fixture
def cuda_mf_instance():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    inst = ProblemInstance(device="cuda", file_path=INSTANCE, instance_type="test")
    solver = MFSolver(device="cuda")
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    solver.solution_bounds = inst.solution_bounds
    return inst, solver


@pytest.mark.cuda
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("rng", ["popcount32", "popcount16", "popcount", "box_muller"])
@pytest.mark.parametrize("beta2", [None, 0.999, 1.0])
def test_mf_kernel_matches_plain(cuda_mf_instance, noise_scale, rng, beta2):
    inst, solver = cuda_mf_instance
    hp = None if beta2 is None else AdamParameters(beta2=beta2).to_hyperparameters()
    p = solver._make_params(0.5, 20.0, 0.0025, 5.0, 4000.0, 0.01, 100)
    kw = dict(iterations=100, batch_size=300, pump_rate_flag=True,
              noise_scale=noise_scale, rng=rng, hp=hp)
    out = mf_kernels.mf_solve(4, inst.q_matrix, inst.v_vector, p, **kw)
    ref = mf_kernels.mf_solve_reference(4, inst.q_matrix, inst.v_vector, p, **kw)
    torch.cuda.synchronize()
    for k, r in zip(out, ref):
        assert (k - r).abs().max().item() <= TOL
