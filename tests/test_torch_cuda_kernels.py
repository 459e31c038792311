"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips with a reason on a host without a card
(the kernels cannot run in an interpreter).  On the card:
``python -m pytest tests/test_torch_cuda_kernels.py``.
"""

from __future__ import annotations

import os

import pytest
import torch

from ccvm_tpu_torch import (AdamParameters, DLSolver, LangevinSolver, MFSolver,
                            ProblemInstance, PumpedLangevinSolver)
from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCE = os.path.join(REPO, "tests", "data", "test020.in")
TOL = 1e-4  # fp32 sum order over 200 steps (100 for MF and the Langevin family)


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


def _langevin_case(family):
    """(solver, kernel wrapper, plain version, params, extra kwargs) of a
    Langevin-family kernel on the scaled test instance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    inst = ProblemInstance(device="cuda", file_path=INSTANCE, instance_type="test")
    if family == "langevin":
        solver = LangevinSolver(device="cuda")
        inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
        solver.solution_bounds = inst.solution_bounds
        return (inst, langevin_kernels.langevin_solve,
                langevin_kernels.langevin_solve_reference,
                solver._make_params(0.5, 0.002, 0.5, 2.0), {})
    solver = PumpedLangevinSolver(device="cuda")
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    solver.solution_bounds = inst.solution_bounds
    return (inst, langevin_kernels.pumped_langevin_solve,
            langevin_kernels.pumped_langevin_solve_reference,
            solver._make_params(2.0, 0.5, 0.002, 0.25, 1.0, 100),
            {"pump_rate_flag": True})


@pytest.mark.cuda
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("rng", ["popcount32", "popcount16", "popcount", "box_muller"])
@pytest.mark.parametrize("beta2", [None, 0.999, 1.0])
@pytest.mark.parametrize("family", ["langevin", "pumped"])
def test_langevin_kernels_match_plain(family, noise_scale, rng, beta2):
    inst, kernel, plain, p, kw = _langevin_case(family)
    hp = None if beta2 is None else AdamParameters(beta2=beta2).to_hyperparameters()
    kw = dict(kw, iterations=100, batch_size=300, noise_scale=noise_scale,
              rng=rng, hp=hp)
    ck = kernel(4, inst.q_matrix, inst.v_vector, p, **kw)
    cr = plain(4, inst.q_matrix, inst.v_vector, p, **kw)
    torch.cuda.synchronize()
    assert ck.shape == (300, 20) and torch.isfinite(ck).all()
    assert (ck - cr).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("family,pump_rate_flag",
                         [("langevin", None), ("pumped", True), ("pumped", False)])
def test_langevin_kernels_stacked_equal_serial_launches(family, pump_rate_flag):
    inst, kernel, _, p, kw = _langevin_case(family)
    if pump_rate_flag is not None:
        kw = {"pump_rate_flag": pump_rate_flag}
    q2 = torch.stack([inst.q_matrix, inst.q_matrix.flip(0, 1)])
    v2 = torch.stack([inst.v_vector, inst.v_vector.flip(0)])
    kw = dict(kw, iterations=100, batch_size=130)
    stacked = kernel(11, q2, v2, p, **kw)
    for i in range(2):
        assert torch.equal(stacked[i], kernel(11 + i, q2[i], v2[i], p, **kw))
