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
from ccvm_tpu_torch.ops import (build, dl_kernels, dl_variant_kernels,
                                langevin_kernels, mf_kernels, philox)
from ccvm_tpu_torch.tools.kernel_experiments import cuda_core_dl_solve, harness_params

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


# The DL kernel's tensor-core design (csrc/dl_solve.cu) at every n-tile
# count the bundled sizes give, its padding (2 -> 8, 4 -> 8, 20 -> 24) and its
# ragged last block: batch 100 is not a multiple of 64 (DL) or 128 (DL-Adam).
_DL_FILES = {2: ("test", "tests/data/test002.in"), 4: ("test", "tests/data/test004.in"),
             20: ("test", "tests/data/test020.in"),
             70: ("tuning", "examples/benchmarking_instances/Size70/tuningH070-100-0.in")}
_BETA2 = [None, 0.999, 1.0]


def _hp(beta2):
    return None if beta2 is None else AdamParameters(beta2=beta2).to_hyperparameters()


@pytest.fixture(scope="module")
def dl_problems():
    """{n: (Q, V, solver)} scaled on the card, with every DL specialisation
    below built first in one parallel nvcc run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    specs = []
    for n in _DL_FILES:
        for beta2 in _BETA2:
            for noise in (0.0, 1.0):
                specs.append(dl_kernels._spec(n, _hp(beta2), noise, "popcount16",
                                              True))
                if n == 70:
                    specs.append(dl_kernels._spec(n, _hp(beta2), noise, "popcount16",
                                                  False))
    build.build(specs)
    problems = {}
    for n, (kind, path) in _DL_FILES.items():
        inst = ProblemInstance(device="cuda", file_path=os.path.join(REPO, path),
                               instance_type=kind)
        solver = DLSolver(device="cuda")
        inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
        solver.solution_bounds = inst.solution_bounds
        problems[n] = (inst.q_matrix, inst.v_vector, solver)
    return problems


def _dl_pair(problem, batch, beta2, noise_scale, pump=8.0, pump_rate_flag=True,
             kernel=dl_kernels.dl_solve):
    q, v, solver = problem
    p = solver._make_params(pump, 1.0, 0.001, 10.0, 100.0, 0.05, 200)
    kw = dict(iterations=200, batch_size=batch, pump_rate_flag=pump_rate_flag,
              pump_is_gt_one=pump > 1, noise_scale=noise_scale, rng="popcount16",
              hp=_hp(beta2))
    ck, sk = kernel(4, q, v, p, **kw)
    cr, sr = dl_kernels.dl_solve_reference(4, q, v, p, **kw)
    torch.cuda.synchronize()
    assert ck.shape == sk.shape == (batch, q.shape[-1])
    assert torch.isfinite(ck).all() and torch.isfinite(sk).all()
    return max((ck - cr).abs().max().item(), (sk - sr).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 100])
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("beta2", _BETA2)
@pytest.mark.parametrize("n", sorted(_DL_FILES))
def test_dl_tensor_core_kernel_matches_plain(dl_problems, n, beta2, noise_scale,
                                             batch):
    assert _dl_pair(dl_problems[n], batch, beta2, noise_scale) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("beta2", _BETA2)
@pytest.mark.parametrize("pump,pump_rate_flag", [(0.5, True), (8.0, False)])
def test_dl_tensor_core_kernel_flags_match_plain(dl_problems, pump, pump_rate_flag,
                                                 beta2, noise_scale):
    assert _dl_pair(dl_problems[20], 100, beta2, noise_scale, pump=pump,
                    pump_rate_flag=pump_rate_flag) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("beta2", _BETA2)
def test_dl_cuda_core_matvec_matches_plain(dl_problems, beta2, noise_scale):
    """The specialisation production does not launch (the race's row)."""
    assert _dl_pair(dl_problems[70], 100, beta2, noise_scale,
                    kernel=cuda_core_dl_solve) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("beta2", _BETA2)
def test_dl_tensor_core_stacked_equals_serial_launches(dl_problems, beta2):
    q, v, solver = dl_problems[70]
    q2 = torch.stack([q, q.flip(0, 1)])
    v2 = torch.stack([v, v.flip(0)])
    p = solver._make_params(8.0, 1.0, 0.001, 10.0, 100.0, 0.05, 100)
    kw = dict(iterations=100, batch_size=100, pump_rate_flag=True,
              pump_is_gt_one=True, rng="popcount16", hp=_hp(beta2))
    cs, ss = dl_kernels.dl_solve(11, q2, v2, p, **kw)
    for i in range(2):
        ci, si = dl_kernels.dl_solve(11 + i, q2[i], v2[i], p, **kw)
        assert torch.equal(cs[i], ci) and torch.equal(ss[i], si)


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


# (variant, fuse, unroll) of each race-harness specialisation held here:
# 200 steps leave v3 unroll 16 a tail of 8.
_VARIANTS = [("v2", False, 1), ("v2", True, 8), ("v3", False, 8), ("v3", False, 16)]


@pytest.fixture(scope="module")
def variant_problem():
    """The scaled test instance on the card, with every specialisation below
    built first in one parallel nvcc run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    build.build([
        build.DLVariantSpec(variant == "v3", fuse, unroll, noise, rng)
        for variant, fuse, unroll in _VARIANTS
        for noise, rng in [(False, 0)] + [(True, r) for r in range(3)]
    ])
    inst = ProblemInstance(device="cuda", file_path=INSTANCE, instance_type="test")
    inst.scale_coefs(DLSolver(device="cuda").get_scaling_factor(inst.q_matrix))
    return inst.q_matrix, inst.v_vector


def _variant(variant, fuse, unroll, **kw):
    """(kernel wrapper, plain version, keyword arguments) of a variant."""
    kw = dict(kw, unroll=unroll)
    if variant == "v2":
        return (dl_variant_kernels.dl_v2, dl_variant_kernels.dl_v2_reference,
                dict(kw, fuse_matvec=fuse))
    return dl_variant_kernels.dl_v3, dl_variant_kernels.dl_v3_reference, kw


@pytest.mark.cuda
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("rng_name", philox.HARNESS_RNG_NAMES)
@pytest.mark.parametrize("variant,fuse,unroll", _VARIANTS)
def test_dl_variant_kernels_match_plain(variant_problem, variant, fuse, unroll,
                                        rng_name, noise_scale):
    q, v = variant_problem
    kernel, plain, kw = _variant(variant, fuse, unroll, iterations=200,
                                 batch_size=300, rng_name=rng_name,
                                 noise_scale=noise_scale)
    ck, sk = kernel(4, q, v, harness_params(200), **kw)
    cr, sr = plain(4, q, v, harness_params(200), **kw)
    torch.cuda.synchronize()
    assert ck.shape == sk.shape == (300, 20)
    assert torch.isfinite(ck).all() and torch.isfinite(sk).all()
    assert (ck - cr).abs().max().item() <= TOL
    assert (sk - sr).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("variant,fuse,unroll", [("v2", True, 8), ("v3", False, 8)])
def test_dl_variant_stacked_equals_serial_launches(variant_problem, variant, fuse,
                                                   unroll):
    q, v = variant_problem
    q2 = torch.stack([q, q.flip(0, 1)])
    v2 = torch.stack([v, v.flip(0)])
    kernel, _, kw = _variant(variant, fuse, unroll, iterations=96, batch_size=130,
                             rng_name="popcount2")
    cs, ss = kernel(11, q2, v2, harness_params(96), **kw)
    for i in range(2):
        ci, si = kernel(11 + i, q2[i], v2[i], harness_params(96), **kw)
        assert torch.equal(cs[i], ci) and torch.equal(ss[i], si)
