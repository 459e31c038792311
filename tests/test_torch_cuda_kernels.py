"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips with a reason on a host without a card
(the kernels cannot run in an interpreter).  On the card:
``python -m pytest tests/test_torch_cuda_kernels.py``.
"""

from __future__ import annotations

import json
import os

import numpy as np
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


@pytest.fixture(scope="module")
def mf_problems():
    """{n: (Q, V, solver)} scaled on the card for MF, with every MF
    specialisation below built first in one parallel nvcc run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    build.build([mf_kernels._spec(n, _hp(beta2), noise, "popcount32")
                 for n in _DL_FILES for beta2 in _BETA2 for noise in (0.0, 1.0)])
    problems = {}
    for n, (kind, path) in _DL_FILES.items():
        inst = ProblemInstance(device="cuda", file_path=os.path.join(REPO, path),
                               instance_type=kind)
        solver = MFSolver(device="cuda")
        inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
        solver.solution_bounds = inst.solution_bounds
        problems[n] = (inst.q_matrix, inst.v_vector, solver)
    return problems


def _mf_pair(problem, batch, beta2, noise_scale, pump=0.5, pump_rate_flag=True):
    q, v, solver = problem
    p = solver._make_params(pump, 20.0, 0.0025, 5.0, 4000.0, 0.01, 100)
    kw = dict(iterations=100, batch_size=batch, pump_rate_flag=pump_rate_flag,
              noise_scale=noise_scale, rng="popcount32", hp=_hp(beta2))
    out = mf_kernels.mf_solve(4, q, v, p, **kw)
    ref = mf_kernels.mf_solve_reference(4, q, v, p, **kw)
    torch.cuda.synchronize()
    for x in out:
        assert x.shape == (batch, q.shape[-1]) and torch.isfinite(x).all()
    return max((k - r).abs().max().item() for k, r in zip(out, ref))


# The MF kernel at every padding the bundled sizes give (2 -> 4, 20, 70 ->
# 72) and its ragged last block (batch 100 is not a multiple of 64).
@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 100])
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("beta2", _BETA2)
@pytest.mark.parametrize("n", sorted(_DL_FILES))
def test_mf_kernel_matches_plain_at_every_size(mf_problems, n, beta2, noise_scale,
                                               batch):
    assert _mf_pair(mf_problems[n], batch, beta2, noise_scale) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("beta2", _BETA2)
@pytest.mark.parametrize("pump_rate_flag", [True, False])
def test_mf_kernel_pump_schedules_match_plain(mf_problems, pump_rate_flag, beta2,
                                              noise_scale):
    assert _mf_pair(mf_problems[20], 100, beta2, noise_scale, pump=2.0,
                    pump_rate_flag=pump_rate_flag) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("beta2", _BETA2)
def test_mf_stacked_equals_serial_launches(mf_problems, beta2):
    q, v, solver = mf_problems[70]
    q2 = torch.stack([q, q.flip(0, 1)])
    v2 = torch.stack([v, v.flip(0)])
    p = solver._make_params(0.5, 20.0, 0.0025, 5.0, 4000.0, 0.01, 100)
    kw = dict(iterations=100, batch_size=100, pump_rate_flag=True,
              rng="popcount32", hp=_hp(beta2))
    stacked = mf_kernels.mf_solve(11, q2, v2, p, **kw)
    for i in range(2):
        serial = mf_kernels.mf_solve(11 + i, q2[i], v2[i], p, **kw)
        assert all(torch.equal(a[i], b) for a, b in zip(stacked, serial))


@pytest.mark.cuda
@pytest.mark.parametrize("beta2", _BETA2)
def test_mf_residency_is_read_from_the_card(mf_problems, beta2):
    """The main path's specialisations: the card keeps the blocks that the
    launch rule plans, 18 warps per SM at N=70."""
    shape = build.mf_launch_shape(70, beta2 is not None)
    blocks = mf_kernels.blocks_per_sm(70, hp=_hp(beta2))
    assert blocks == shape.blocks_per_sm == 2
    assert blocks * shape.threads // 32 >= 16


@pytest.mark.cuda
@pytest.mark.parametrize("pump_rate_flag", [True, False])
@pytest.mark.parametrize("beta2", _BETA2)
def test_mf_step_table_is_the_plain_versions_on_the_card(pump_rate_flag, beta2):
    """The table's every value is the plain version's own 0-dim float32
    scalar on the card, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    from test_torch_mf_redesign import _PARAMS, plain_step_scalars

    table = mf_kernels._step_table(_PARAMS, _hp(beta2), 40, pump_rate_flag, "cuda")
    for i in range(40):
        want = plain_step_scalars(_PARAMS, _hp(beta2), i, pump_rate_flag, "cuda")
        assert torch.equal(table[i, :9], want), i


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


# The Langevin family's redesign (csrc/langevin_solve.cu) at every padding
# the bundled sizes give (2 -> 8, 4 -> 8, 20 -> 24, 70 -> 72) and its ragged
# last block (batch 100 is not a multiple of 128 or 256): each kernel plain
# and Adam, beta2 0.999 and 1.0 with add_assign on and off, noise off and
# on, and for pumped both pump schedules.
_LGV_ADAM = [None, (0.999, True), (0.999, False), (1.0, True), (1.0, False)]


def _lgv_hp(adam):
    if adam is None:
        return None
    beta2, add_assign = adam
    return AdamParameters(beta2=beta2, add_assign=add_assign).to_hyperparameters()


@pytest.fixture(scope="module")
def lgv_problems():
    """{(family, n): (Q, V, solver)} scaled on the card, with every
    Langevin-family specialisation below built first in one parallel nvcc
    run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    build.build([langevin_kernels._spec(n, _lgv_hp(adam), noise, "popcount32",
                                        pumped=pumped)
                 for n in (2, 20, 70) for adam in _LGV_ADAM for noise in (0.0, 1.0)
                 for pumped in (False, True)])
    problems = {}
    for family, cls in (("langevin", LangevinSolver), ("pumped", PumpedLangevinSolver)):
        for n, (kind, path) in _DL_FILES.items():
            inst = ProblemInstance(device="cuda", file_path=os.path.join(REPO, path),
                                   instance_type=kind)
            solver = cls(device="cuda")
            inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
            solver.solution_bounds = inst.solution_bounds
            problems[family, n] = (inst.q_matrix, inst.v_vector, solver)
    return problems


def _lgv_params(family, solver, iterations=100):
    if family == "langevin":
        return solver._make_params(0.5, 0.002, 0.5, 2.0)
    return solver._make_params(1.0, 0.5, 0.002, 0.25, 1.0, iterations)


def _lgv_pair(problem, family, batch, adam, noise_scale, pump_rate_flag=True):
    q, v, solver = problem
    kernel, plain, _ = _LGV_FNS[family]
    kw = dict(iterations=100, batch_size=batch, noise_scale=noise_scale,
              rng="popcount32", hp=_lgv_hp(adam))
    if family == "pumped":
        kw["pump_rate_flag"] = pump_rate_flag
    p = _lgv_params(family, solver)
    ck = kernel(4, q, v, p, **kw)
    cr = plain(4, q, v, p, **kw)
    torch.cuda.synchronize()
    assert ck.shape == (batch, q.shape[-1]) and torch.isfinite(ck).all()
    return (ck - cr).abs().max().item()


_LGV_FNS = {
    "langevin": (langevin_kernels.langevin_solve, langevin_kernels.langevin_solve_reference,
                 LangevinSolver),
    "pumped": (langevin_kernels.pumped_langevin_solve,
               langevin_kernels.pumped_langevin_solve_reference, PumpedLangevinSolver),
}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 100])
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("adam", _LGV_ADAM)
@pytest.mark.parametrize("n", sorted(_DL_FILES))
@pytest.mark.parametrize("family", ["langevin", "pumped"])
def test_langevin_kernels_match_plain_at_every_size(lgv_problems, family, n, adam,
                                                  noise_scale, batch):
    assert _lgv_pair(lgv_problems[family, n], family, batch, adam, noise_scale) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("adam", _LGV_ADAM)
@pytest.mark.parametrize("pump_rate_flag", [True, False])
def test_pumped_kernel_pump_schedules_match_plain(lgv_problems, pump_rate_flag, adam,
                                                  noise_scale):
    assert _lgv_pair(lgv_problems["pumped", 20], "pumped", 100, adam, noise_scale,
                     pump_rate_flag=pump_rate_flag) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("adam", [None, (0.999, True), (1.0, True)])
@pytest.mark.parametrize("family", ["langevin", "pumped"])
def test_langevin_stacked_equals_serial_launches_at_n70(lgv_problems, family, adam):
    q, v, solver = lgv_problems[family, 70]
    kernel = _LGV_FNS[family][0]
    q2 = torch.stack([q, q.flip(0, 1)])
    v2 = torch.stack([v, v.flip(0)])
    kw = dict(iterations=100, batch_size=300, rng="popcount32", hp=_lgv_hp(adam))
    if family == "pumped":
        kw["pump_rate_flag"] = True
    p = _lgv_params(family, solver)
    stacked = kernel(11, q2, v2, p, **kw)
    for i in range(2):
        assert torch.equal(stacked[i], kernel(11 + i, q2[i], v2[i], p, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("adam", [None, (0.999, True), (1.0, True)])
@pytest.mark.parametrize("pumped", [False, True])
def test_langevin_residency_is_read_from_the_card(lgv_problems, pumped, adam):
    """The main path's specialisations: the card keeps the blocks that the
    launch rule plans, two blocks of 4 warps per SM at N=70."""
    shape = build.langevin_launch_shape(70, adam is not None)
    blocks = langevin_kernels.blocks_per_sm(70, pumped=pumped, hp=_lgv_hp(adam))
    assert blocks == shape.blocks_per_sm == 2
    assert blocks * shape.threads // 32 == 8


@pytest.fixture(scope="module")
def lgv_problems_100():
    """{family: (Q, V, solver)} of a random symmetric BoxQP instance at N=100
    (integer entries in [-50, 50], scaled as the façades scale), where a
    thread owns 13 columns of 4 rows (Adam: 2), the launch rule's branch
    beyond 9 columns; its specialisations built first in one nvcc run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    build.build([langevin_kernels._spec(100, _lgv_hp(adam), noise, "popcount32",
                                        pumped=pumped)
                 for adam in (None, (0.999, True)) for noise in (0.0, 1.0)
                 for pumped in (False, True)])
    rng = np.random.default_rng(100)
    a = rng.integers(-50, 51, (100, 100)).astype(np.float32)
    q = torch.from_numpy((a + a.T) / 2).cuda()
    v = torch.from_numpy(rng.integers(-50, 51, 100).astype(np.float32)).cuda()
    problems = {}
    for family, cls in (("langevin", LangevinSolver), ("pumped", PumpedLangevinSolver)):
        solver = cls(device="cuda")
        sf = solver.get_scaling_factor(q)
        solver.solution_bounds = (0.0, 1.0)
        problems[family] = (q / sf, v / sf, solver)
    return problems


@pytest.mark.cuda
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("adam", [None, (0.999, True)])
@pytest.mark.parametrize("family", ["langevin", "pumped"])
def test_langevin_kernels_match_plain_beyond_nine_columns(lgv_problems_100, family, adam,
                                                          noise_scale):
    assert _lgv_pair(lgv_problems_100[family], family, 100, adam, noise_scale) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("pump_rate_flag", [True, False])
@pytest.mark.parametrize("beta2", _BETA2)
def test_langevin_step_table_is_the_plain_versions_on_the_card(pump_rate_flag, beta2):
    """The table's every value is the plain version's own 0-dim float32
    scalar on the card, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    from test_torch_langevin_redesign import _PUMPED, plain_step_scalars

    table = langevin_kernels._step_table(_PUMPED, _hp(beta2), 40, pump_rate_flag, "cuda")
    for i in range(40):
        want = plain_step_scalars(_PUMPED, _hp(beta2), i, pump_rate_flag, "cuda")
        assert torch.equal(table[i, :5], want), i


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
        build.DLVariantSpec(variant == "v3", fuse, unroll, noise, rng, nt)
        for variant, fuse, unroll in _VARIANTS
        for noise, rng in [(False, 0)] + [(True, r) for r in range(3)]
        for nt in (3, 9)
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
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("fuse", [False, True])
def test_dl_variant_fused_and_two_pass_kernels_match_plain_at_n70(variant_problem, fuse,
                                                                   noise_scale):
    """Both tensor-core layouts at 9 n-tiles (N=70, the last one padded):
    c and s stacked in one m16 tile (8 warps of 8 trajectories) and a c tile
    and an s tile in two passes over Q (4 warps of 16); batch 300 leaves
    each a ragged last block of 64."""
    rng = np.random.default_rng(70)
    q = rng.normal(size=(70, 70)).astype(np.float32) / 8.0
    q = torch.from_numpy(0.5 * (q + q.T)).cuda()
    v = torch.from_numpy(rng.normal(size=(70,)).astype(np.float32) / 8.0).cuda()
    kw = dict(iterations=200, batch_size=300, rng_name="popcount1", unroll=8,
              fuse_matvec=fuse, noise_scale=noise_scale)
    ck, sk = dl_variant_kernels.dl_v2(4, q, v, harness_params(200), **kw)
    cr, sr = dl_variant_kernels.dl_v2_reference(4, q, v, harness_params(200), **kw)
    torch.cuda.synchronize()
    assert ck.shape == sk.shape == (300, 70)
    assert torch.isfinite(ck).all() and torch.isfinite(sk).all()
    assert sk.abs().max().item() > 0.01
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


# Segment launches and a per-column S (the builds behind the façades'
# evolution sampling and per-variable S), for each of the eight production
# kernels: (whole solve, sampled solve, plain version, Adam, extra kwargs) by
# kernel name.
_FEATURE_KERNELS = {
    "dl_solve": (dl_kernels.dl_solve, dl_kernels.dl_solve_sampled,
                 dl_kernels.dl_solve_reference, False, {"rng": "popcount16"}),
    "mf_solve": (mf_kernels.mf_solve, mf_kernels.mf_solve_sampled,
                 mf_kernels.mf_solve_reference, False, {"rng": "popcount32"}),
    "langevin_solve": (langevin_kernels.langevin_solve,
                       langevin_kernels.langevin_solve_sampled,
                       langevin_kernels.langevin_solve_reference, False,
                       {"rng": "popcount32"}),
    "pumped_langevin_solve": (langevin_kernels.pumped_langevin_solve,
                              langevin_kernels.pumped_langevin_solve_sampled,
                              langevin_kernels.pumped_langevin_solve_reference, False,
                              {"rng": "popcount32"}),
}
for _name in list(_FEATURE_KERNELS):
    _FEATURE_KERNELS[_name.replace("_solve", "_adam_solve")] = (
        _FEATURE_KERNELS[_name][:3] + (True, _FEATURE_KERNELS[_name][4]))
_FEATURE_ITERS = 120


def _feature_case(kname, n, pump=None, s_scale=None, s_values=None):
    """(q, v, params, kwargs) of a kernel at size n on its bundled instance
    (_DL_FILES), or at N = 100 a random symmetric one (seeded, as
    ``lgv_problems_100``), scaled as the family's façade scales it, with the
    family's test parameters; ``s_values``: one S a column, else
    ``s_scale`` draws them (seeded) in [0.5 S, 1.5 S]."""
    rng = np.random.default_rng(n)
    family = kname.split("_")[0]
    cls = {"dl": DLSolver, "mf": MFSolver, "langevin": LangevinSolver,
           "pumped": PumpedLangevinSolver}[family]
    solver = cls(device="cuda")
    if n in _DL_FILES:
        kind, path = _DL_FILES[n]
        inst = ProblemInstance(device="cuda", file_path=os.path.join(REPO, path),
                               instance_type=kind)
        inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
        q, v = inst.q_matrix, inst.v_vector
    else:
        a = rng.integers(-50, 51, (n, n)).astype(np.float32)
        q = torch.from_numpy((a + a.T) / 2).cuda()
        v = torch.from_numpy(rng.integers(-50, 51, n).astype(np.float32)).cuda()
        sf = solver.get_scaling_factor(q)
        q, v = q / sf, v / sf
    solver.solution_bounds = (0.0, 1.0)
    scalar_s = {"dl": 1.0, "mf": 20.0, "langevin": 0.5, "pumped": 0.5}[family]
    S = scalar_s
    if s_values is not None:
        S = s_values
    elif s_scale:
        S = (scalar_s * rng.uniform(0.5, 1.5, n)).astype(np.float32)
    it = _FEATURE_ITERS
    if family == "dl":
        pump = 8.0 if pump is None else pump
        p = solver._make_params(pump, S, 0.001, 10.0, 100.0, 0.05, it)
        extra = dict(pump_rate_flag=True, pump_is_gt_one=pump > 1)
    elif family == "mf":
        p = solver._make_params(0.5, S, 0.0025, 5.0, 4000.0, 0.01, it)
        extra = dict(pump_rate_flag=True)
    elif family == "langevin":
        p = solver._make_params(S, 0.002, 0.5, 2.0)
        extra = {}
    else:
        p = solver._make_params(1.0, S, 0.002, 0.25, 1.0, it)
        extra = dict(pump_rate_flag=True)
    whole, _, _, adam, base = _FEATURE_KERNELS[kname]
    hp = AdamParameters(beta2=0.999).to_hyperparameters() if adam else None
    return q, v, p, dict(base, **extra, batch_size=100, hp=hp)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 70])
@pytest.mark.parametrize("kname", sorted(_FEATURE_KERNELS))
def test_segmented_kernel_equals_the_whole_launch(kname, n):
    """Noise on: the segment launches of the sample plan (step 25: segments
    1, 25, 25, 25, 25, 19) end where the whole launch ends, bit for bit, and
    each sample matches the plain version's segments at TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    whole, sampled, _, _, _ = _FEATURE_KERNELS[kname]
    q, v, p, kw = _feature_case(kname, n)
    segments = DLSolver._evolution_sample_plan(_FEATURE_ITERS, 25)[1]
    want = _as_tuple(whole(7, q, v, p, iterations=_FEATURE_ITERS, **kw))
    got, samples = sampled(7, q, v, p, segments, **kw)
    assert all(torch.equal(a, b) for a, b in zip(_as_tuple(got), want))
    for a, b in zip(_as_tuple(samples), _plain_samples(kname, q, v, p, segments, kw)):
        assert a.shape == (len(segments), 100, n)
        assert (a - b).abs().max().item() <= TOL


def _plain_samples(kname, q, v, p, segments, kw):
    """The plain versions' samples of the same segments, on the card."""
    family = kname.split("_")[0]
    sampled = {"dl": dl_kernels.dl_solve_sampled_reference,
               "mf": mf_kernels.mf_solve_sampled_reference,
               "langevin": langevin_kernels.langevin_solve_sampled_reference,
               "pumped": langevin_kernels.pumped_langevin_solve_sampled_reference}[family]
    return _as_tuple(sampled(7, q, v, p, segments, **kw)[1])


# DL at pump 0.9 and N=70 with the noise on: S_j down to 0.5 S doubles both
# x and the feedback's scale of a column, and DL below pump 1 parts from
# its plain version fast (chaotic at chip_smoke.py phase 12's tuned
# parameters); every other case holds TOL.
_PER_COLUMN_TOL = {("dl_solve pump 0.9", 70, 1.0): 2e-4}


_PER_COLUMN_CASES = [
    (k, n) for n in (2, 20, 70)
    for k in sorted(_FEATURE_KERNELS) + ["dl_solve pump 0.9", "dl_adam_solve pump 0.9"]
] + [(k, 100) for k in sorted(_FEATURE_KERNELS) if not k.startswith("mf")]


@pytest.mark.cuda
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("kname,n", _PER_COLUMN_CASES)
def test_per_column_s_kernel_matches_plain(kname, n, noise_scale):
    """S_j drawn in [0.5 S, 1.5 S]; DL at pump 8 (S in the final clamp
    only) and 0.9 (S_d = S_j in the drift too); N = 100 (a random instance)
    takes the Langevin launch rule's branch beyond nine columns, and is held
    for the Langevin family and DL at pump 8 (MF's and DL's pump-0.9
    scalar-S kernels already part from their plain versions beyond TOL on
    that instance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    name, _, pump = kname.partition(" pump ")
    whole, _, plain, _, _ = _FEATURE_KERNELS[name]
    q, v, p, kw = _feature_case(name, n, pump=float(pump) if pump else None, s_scale=True)
    kw = dict(kw, iterations=_FEATURE_ITERS, noise_scale=noise_scale)
    out = _as_tuple(whole(4, q, v, p, **kw))
    ref = _as_tuple(plain(4, q, v, p, **kw))
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in out)
    assert max((a - b).abs().max().item() for a, b in zip(out, ref)) <= \
        _PER_COLUMN_TOL.get((kname, n, noise_scale), TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kname", sorted(_FEATURE_KERNELS) + ["dl_solve pump 0.9"])
def test_constant_s_vector_equals_the_scalar_kernel(kname):
    """The per-column build with every S_j = S gives the scalar build's
    result bit for bit (the same products, S_j read where S was)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    name, _, pump = kname.partition(" pump ")
    whole = _FEATURE_KERNELS[name][0]
    pump = float(pump) if pump else None
    q, v, p, kw = _feature_case(name, 70, pump=pump)
    _, _, pc, _ = _feature_case(name, 70, pump=pump, s_values=np.full(70, p.S, np.float32))
    kw = dict(kw, iterations=_FEATURE_ITERS)
    assert all(torch.equal(a, b) for a, b in
               zip(_as_tuple(whole(4, q, v, p, **kw)), _as_tuple(whole(4, q, v, pc, **kw))))


# A per-element S (the per-element builds, csrc/*.cu CCVM_ELEM) and MF's
# per-column S by its reciprocals.
_FEATURE_BATCH = 100  # _feature_case's batch


def _element_s(kname, n, seed=15):
    """A (batch, n) S whose rows differ around the family's scalar S: rows
    scaled over [0.75, 1.25], each element by a factor in [0.9, 1.1],
    drawn from ``seed``."""
    family = kname.split("_")[0]
    scalar_s = {"dl": 1.0, "mf": 20.0, "langevin": 0.5, "pumped": 0.5}[family]
    rng = np.random.default_rng(seed)
    rows = np.linspace(0.75, 1.25, _FEATURE_BATCH)[:, None] * rng.uniform(0.9, 1.1, n)
    return (scalar_s * rows * rng.uniform(0.9, 1.1, (_FEATURE_BATCH, n))).astype(np.float32)


_PER_ELEMENT_CASES = [
    (k, n) for n in (20, 70)
    for k in sorted(_FEATURE_KERNELS) + ["dl_solve pump 0.9", "dl_adam_solve pump 0.9"]
]
# DL at pump 0.9 is chaotic (chip_smoke.py holds it over 50 steps in phases
# 12 and 15): with this per-element S its kernel read 2.46e-4 from the plain
# version after 120 steps at N=70, noise off (an NVIDIA H100 80GB HBM3 at
# 700 W), so it is held over 50.
_PER_ELEMENT_STEPS = {"dl_solve pump 0.9": 50}


def _element_case(kname, n, S):
    name, _, pump = kname.partition(" pump ")
    return (name,) + _feature_case(name, n, pump=float(pump) if pump else None,
                                   s_values=S)


@pytest.mark.cuda
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("kname,n", _PER_ELEMENT_CASES)
def test_per_element_s_kernel_matches_plain(kname, n, noise_scale):
    """The per-element build against its plain version on the card, its S
    one an element with rows that differ (DL at pump 8, S in the final
    clamp only, and at 0.9, S_d = S_ij in the drift too), at TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    name, q, v, p, kw = _element_case(kname, n, _element_s(kname, n))
    assert tuple(p.S.shape) == (_FEATURE_BATCH, n)
    whole, _, plain, _, _ = _FEATURE_KERNELS[name]
    kw = dict(kw, iterations=_PER_ELEMENT_STEPS.get(kname, _FEATURE_ITERS),
              noise_scale=noise_scale)
    out = _as_tuple(whole(4, q, v, p, **kw))
    ref = _as_tuple(plain(4, q, v, p, **kw))
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in out)
    assert max((a - b).abs().max().item() for a, b in zip(out, ref)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kname", sorted(_FEATURE_KERNELS) + ["dl_solve pump 0.9",
                                                              "dl_adam_solve pump 0.9"])
def test_per_element_s_with_equal_rows_equals_the_per_column_kernel(kname):
    """A (batch, n) S with equal rows run through the per-element build (the
    façades take such an S to its row) gives the per-column build's result
    bit for bit, whole and as segments; and the per-element segments end
    where its whole launch ends, bit for bit (noise on)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    row = _element_s(kname, 70)[0]
    name, q, v, pc, kw = _element_case(kname, 70, row)
    pe = pc._replace(S=torch.from_numpy(np.tile(row, (_FEATURE_BATCH, 1))).cuda())
    whole, sampled, _, _, _ = _FEATURE_KERNELS[name]
    segments = DLSolver._evolution_sample_plan(_FEATURE_ITERS, 25)[1]
    want = _as_tuple(whole(4, q, v, pc, iterations=_FEATURE_ITERS, **kw))
    got = _as_tuple(whole(4, q, v, pe, iterations=_FEATURE_ITERS, **kw))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    (seg, _), (seg_c, _) = (sampled(4, q, v, p_, segments, **kw) for p_ in (pe, pc))
    assert all(torch.equal(a, b) for a, b in zip(_as_tuple(seg), want))
    assert all(torch.equal(a, b) for a, b in zip(_as_tuple(seg_c), want))
    # Rows that differ: the segments against the whole per-element launch.
    _, q, v, p, kw = _element_case(kname, 70, _element_s(kname, 70))
    want = _as_tuple(whole(4, q, v, p, iterations=_FEATURE_ITERS, **kw))
    seg, _ = sampled(4, q, v, p, segments, **kw)
    assert all(torch.equal(a, b) for a, b in zip(_as_tuple(seg), want))


@pytest.mark.cuda
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
def test_mf_per_column_kernel_by_reciprocals_equals_plain(noise_scale):
    """MF's per-column build divides by S_j with div_rn and the reciprocals
    of its wrapper; with chip_smoke.py phase 12's S (whose divisions
    tests/test_torch_mf_redesign.py proves exact) it equals the plain
    version bit for bit at N=70, batch 1024 (a shape where cuBLAS sums the
    plain matmul over k in order), with the tuned parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    from test_torch_mf_redesign import _phase12_saturation

    with open(os.path.join(REPO, "examples", "tuned_parameters.json")) as f:
        t = json.load(f)["mf"]["70"]
    solver = MFSolver(device="cuda")
    inst = ProblemInstance(device="cuda", instance_type="tuning", file_path=os.path.join(
        REPO, "examples", "benchmarking_instances", "Size70", "tuningH070-100-0.in"))
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    solver.solution_bounds = inst.solution_bounds
    p = solver._make_params(t["pump"], _phase12_saturation(), t["dt"], t["j"],
                            t["feedback_scale"], 0.01, 300)
    kw = dict(iterations=300, batch_size=1024, pump_rate_flag=True, rng="popcount32",
              noise_scale=noise_scale)
    out = mf_kernels.mf_solve(4, inst.q_matrix, inst.v_vector, p, **kw)
    ref = mf_kernels.mf_solve_reference(4, inst.q_matrix, inst.v_vector, p, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.cuda
def test_the_derived_arrays_on_the_card_equal_the_hosts():
    """The wrappers take S's derived arrays on the card (MF's 1/S, DL's
    span / S, the Langevin family's span / (2 S)): each equals the IEEE
    division on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    S = _element_s("mf_solve", 70) * np.float32(3.7)
    f = np.float32
    p = MFSolver(device="cuda")
    p.solution_bounds = (0.0, 1.0)
    params = p._make_params(0.5, torch.from_numpy(S).cuda(), 0.0025, 5.0, 4000.0, 0.01, 10)
    arrays = {
        "mf": (mf_kernels._columns(params, "cuda", 64, 72), f(1) / S),
        "dl": (dl_kernels._columns(params, "cuda", 64, 72, 1), f(1) / S),
        "langevin": (langevin_kernels._columns(params, "cuda", 128, 72),
                     f(1) / (f(2) * S)),
    }
    for family, (arr, want) in arrays.items():
        got = arr[1, :_FEATURE_BATCH, :70].cpu().numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), family


# Sweeps and checkpoints on the card: the stacked launch at the Size70
# instances' shape (batch 1000 leaves each instance's last block partial)
# and the segment build of DL-Adam behind checkpointed_solve.
_SWEEP_CLASSES = {"dl": DLSolver, "mf": MFSolver, "langevin": LangevinSolver,
                  "pumped": PumpedLangevinSolver}


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(_SWEEP_CLASSES))
def test_five_instance_sweep_equals_serial_launches(family):
    """sweep_solve over five Size70 instances at batch 1000 (tuned
    parameters, 300 steps, noise on) gives each instance the kernel outputs
    and statistics of ``solver(instance, seed=seed + i)``, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    from ccvm_tpu_torch.parallel import sweep_solve

    with open(os.path.join(REPO, "examples", "tuned_parameters.json")) as f:
        tuned = json.load(f)[family]["70"]
    folder = os.path.join(REPO, "examples", "benchmarking_instances", "Size70")
    files = sorted(os.listdir(folder))[:5]
    solver = _SWEEP_CLASSES[family](device="cuda", batch_size=1000)
    solver.parameter_key = {70: dict(tuned, iterations=300)}
    insts = [ProblemInstance(device="cuda", instance_type="tuning",
                             file_path=os.path.join(folder, f)) for f in files]
    swept = sweep_solve(solver, insts, seed=3, scale=True)
    for i, inst in enumerate(insts):
        serial = solver(inst, seed=3 + i)
        for key, value in serial.variables.items():
            assert torch.equal(swept[i].variables[key], value), (i, key)
        assert swept[i].solution_performance == serial.solution_performance
        assert swept[i].best_objective_value == serial.best_objective_value


@pytest.mark.cuda
def test_checkpointed_dl_adam_solve_equals_the_whole_launch(tmp_path):
    """checkpointed_solve of DL-Adam (segments of 40 of 120 steps, the six
    state arrays through each snapshot) ends where the whole launch ends,
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    from ccvm_tpu_torch import checkpoint

    q, v, p, kw = _feature_case("dl_adam_solve", 70)
    path = str(tmp_path / "dl_adam.npz")
    state = checkpoint.checkpointed_solve(dl_kernels.dl_solve_segment, 7, q, v, p, None,
                                          _FEATURE_ITERS, every=40, path=path, **kw)
    c, s = dl_kernels.dl_solve(7, q, v, p, iterations=_FEATURE_ITERS, **kw)
    assert len(state) == 6
    assert torch.equal(torch.clamp(state[0], -p.S, p.S), c) and torch.equal(state[1], s)
    assert checkpoint.load_state(path)[1] == _FEATURE_ITERS


# The one-step builds (CCVM_EXT) of a tensor-parallel solve: (step wrapper,
# its plain version, params, flags, state arrays (plain, Adam), matvec
# inputs, whole-solve wrapper).
def _step_cases():
    from ccvm_tpu_torch.dynamics import dl as ddl
    from ccvm_tpu_torch.dynamics import langevin as dlg
    from ccvm_tpu_torch.dynamics import mf as dmf
    from ccvm_tpu_torch.dynamics import pumped_langevin as dpl

    return {
        "dl": (dl_kernels.dl_step, dl_kernels.dl_step_reference,
               ddl.DLParams(8.0, 1.0, 0.001, 10.0, 100.0, 0.05, 0.0, 1.0, 300.0),
               dict(pump_rate_flag=True, pump_is_gt_one=True), (2, 6), 2,
               dl_kernels.dl_solve),
        "mf": (mf_kernels.mf_step, mf_kernels.mf_step_reference,
               dmf.MFParams(0.0, 20.0, 0.0025, 5.0, 4000.0, 0.01, 0.0, 1.0, 300.0),
               dict(pump_rate_flag=True), (3, 5), 1, mf_kernels.mf_solve),
        "langevin": (langevin_kernels.langevin_step, langevin_kernels.langevin_step_reference,
                     dlg.LangevinParams(0.5, 0.002, 0.5, 1.0, 0.0, 1.0), {}, (1, 3), 1,
                     langevin_kernels.langevin_solve),
        "pumped": (langevin_kernels.pumped_langevin_step,
                   langevin_kernels.pumped_langevin_step_reference,
                   dpl.PumpedLangevinParams(2.0, 0.5, 0.002, 0.5, 1.0, 0.0, 1.0, 300.0),
                   dict(pump_rate_flag=True), (1, 3), 1,
                   langevin_kernels.pumped_langevin_solve),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
@pytest.mark.parametrize("beta2", [None, 0.999])
@pytest.mark.parametrize("family", ["dl", "mf", "langevin", "pumped"])
def test_one_step_build_matches_its_plain_step(cuda_instance, family, beta2, noise_scale):
    """Ten steps of the build against its plain version on the same Philox
    words, from a shard at global row 100 and column 3 of a wider solve."""
    inst, _ = cuda_instance
    step, plain, params, flags, arrays, x_arrays, _ = _step_cases()[family]
    hp = _hp(beta2)
    q, v = inst.q_matrix, inst.v_vector
    cols = slice(3, 13)
    states = []
    for fn in (step, plain):
        state = torch.zeros(arrays[hp is not None], 256, 10, device="cuda")
        if family == "mf":
            state[1] = 0.5
        x = torch.empty(x_arrays, 256, 10, device="cuda")
        kw = dict(iterations=300, noise_scale=noise_scale, hp=hp, row_base=100,
                  col_base=3, **flags)
        fn(4, None, v[cols].contiguous(), params, state, x, None, **kw)
        for i in range(10):
            mv = torch.matmul(x, q[cols, cols]).contiguous()
            fn(4, mv, v[cols].contiguous(), params, state, x, i, **kw)
        states.append(state)
    torch.cuda.synchronize()
    # In units of max(1, |x|): Adam's second moments of MF reach ~1e7.
    assert ((states[0] - states[1]).abs() / states[1].abs().clamp(min=1.0)).max() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("beta2", [None, 0.999])
@pytest.mark.parametrize("family", ["dl", "mf", "langevin", "pumped"])
def test_row_base_launches_make_up_the_whole_batch(cuda_instance, family, beta2):
    """Two launches of half the batch each, the second from row base 128,
    are the launch of the whole batch bit for bit (a data-parallel rank's
    rows draw what those rows of one launch draw)."""
    inst, _ = cuda_instance
    *_, flags, _, _, solve = _step_cases()[family]
    params = _step_cases()[family][2]
    kw = dict(iterations=300, hp=_hp(beta2), **flags)
    whole = solve(6, inst.q_matrix, inst.v_vector, params, batch_size=256, **kw)
    halves = [solve(6, inst.q_matrix, inst.v_vector, params, batch_size=128, row_base=r,
                    **kw) for r in (0, 128)]
    whole = whole if isinstance(whole, tuple) else (whole,)
    halves = [h if isinstance(h, tuple) else (h,) for h in halves]
    for w, a, b in zip(whole, *halves):
        assert torch.equal(w, torch.cat([a, b]))


@pytest.mark.cuda
def test_wrappers_launch_on_the_tensor_s_card(cuda_instance, monkeypatch):
    """Every wrapper enters ``torch.cuda.device`` of its tensors' card
    around its launch, so a rank whose tensors lie on cuda:k launches there
    whatever device is current."""
    inst, solver = cuda_instance
    entered = []

    class Spy(torch.cuda.device):
        def __init__(self, device):
            entered.append(torch.device(device))
            super().__init__(device)

    q, v = inst.q_matrix, inst.v_vector
    cases = _step_cases()
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "device", Spy)
        for family, (step, _, params, flags, arrays, x_arrays, solve) in cases.items():
            solve(1, q, v, params, iterations=10, batch_size=64, **flags)
            state = torch.zeros(arrays[0], 64, 20, device="cuda")
            x = torch.empty(x_arrays, 64, 20, device="cuda")
            step(1, None, v, params, state, x, None, iterations=10, **flags)
        dl_variant_kernels.dl_v2(1, q, v, harness_params(10), iterations=10, batch_size=64,
                                 rng_name="popcount1", fuse_matvec=True, unroll=1)
    torch.cuda.synchronize()
    assert len(entered) == 2 * len(cases) + 1
    assert all(d == q.device for d in entered)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dl", "mf", "langevin", "pumped"])
def test_row_base_launches_with_a_per_element_s(cuda_instance, family):
    """A (batch, n) S whose rows differ, cut by rows as a data-parallel
    rank cuts it: the two halves' launches are the whole launch, bit for
    bit (the per-element array of the second half has its row base's
    leading rows)."""
    inst, _ = cuda_instance
    *_, flags, _, _, solve = _step_cases()[family]
    params = _step_cases()[family][2]
    S0 = float(params.S)
    rng = np.random.RandomState(3)
    S = torch.tensor(S0 * rng.uniform(0.5, 1.5, (256, 20)), dtype=torch.float32,
                     device="cuda")
    kw = dict(iterations=100, **flags)
    whole = solve(6, inst.q_matrix, inst.v_vector, params._replace(S=S), batch_size=256,
                  **kw)
    halves = [solve(6, inst.q_matrix, inst.v_vector, params._replace(S=S[r:r + 128]),
                    batch_size=128, row_base=r, **kw) for r in (0, 128)]
    whole = whole if isinstance(whole, tuple) else (whole,)
    halves = [h if isinstance(h, tuple) else (h,) for h in halves]
    for w, a, b in zip(whole, *halves):
        assert torch.equal(w, torch.cat([a, b]))


@pytest.mark.cuda
@pytest.mark.parametrize("adam", [False, True])
def test_dl_probe_without_matvec_equals_plain_solve_with_zero_q(adam):
    """``breakdown --family dl``'s probe build without its matvecs
    (csrc/dl_solve.cu ``CCVM_MATVEC=0``), given the scaled Size70 Q, equals
    a plain DL solve with Q = 0: noise off, 300 steps, batch 1024, at TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpreter")
    from ccvm_tpu_torch.tools import breakdown

    q, v, params = breakdown.dl_problem("cuda")
    hp = AdamParameters().to_hyperparameters() if adam else None
    spec = breakdown.DLProbeSpec(*dl_kernels._spec(70, hp, 0.0, "popcount16", True),
                                 matvec=False)
    p = params(300)
    c = torch.empty((1, 1024, 70), device="cuda")
    s = torch.empty_like(c)
    q1, v1 = q[None].contiguous(), v[None].contiguous()
    assert breakdown.launch_dl(build.load(spec), q1, v1, p, hp, 0.0, c, s) == 0
    cr, sr = dl_kernels.dl_solve_reference(
        100, torch.zeros_like(q), v, p, iterations=300, batch_size=1024,
        pump_rate_flag=True, pump_is_gt_one=float(p.pump) > 1, noise_scale=0.0, hp=hp)
    torch.cuda.synchronize()
    assert torch.isfinite(c).all() and c.abs().max().item() > 0
    assert (c[0] - cr).abs().max().item() <= TOL
    assert (s[0] - sr).abs().max().item() <= TOL
