"""The MF kernel's redesign (csrc/mf_solve.cu) on the CPU.

The kernel runs only on a card; what can be held here is its launch rule
(``build.mf_launch_shape``, the Python statement of ``mf_launch_shape`` in
the source), the per-step and per-solve scalars its wrapper hands it, and
the choice of its matvec: emulations of tensor-core schemes
(``ccvm_tpu_torch.tools.tc_model``), patched in as ``common.dense_matvec``
for the plain MF solve at the main path's N=70 with the tuned parameters,
against the fp32 plain solve.

The values pinned below were measured with this file's checks on the CPU
(torch 2.13, whose float32 matmul at these shapes is one FMA chain over k,
as the card's cuBLAS is by ``python -m ccvm_tpu_torch.tools.tc_model``):
max |model - plain| over (mu, mu_tilde, sigma) for MF / MF-Adam beta2 0.999
/ MF-Adam beta2 1.0,

    scheme                                  300 steps            1,000 steps
                                            (phase 3's check)    noise off
    fp32 chain over k (the kernel's)        0 / 0 / 0            0 / 0 / 0
    float64 sum rounded once                3.1e-5 / 3.1 / 3.1   3.4e-5 / 4.0 / 3.1
    4xTF32, a fresh accumulator per k-tile  3.8e-5 / 3.1 / 4.6   3.1e-5 / 2.3 / 6.9
    3xTF32, a fresh accumulator per k-tile  3.8e-5 / 3.2 / 6.5   3.1e-5 / 3.8 / 7.6
    the same, centred                       5.3e-5 / 3.1 / 4.6   7.6e-5 / 7.6 / 6.1
    DL's truncating chain, centred          1.8e-4 / 1.9 / 1.9   1.8e-4 / 2.2 / 2.1

MF's state sits near |mu| = 270, where one float32 ulp is 3.05e-5, and the
feedback scale (32000) makes mu's equilibrium follow the matvec's rounding:
every change of the summation lands a few ulps away.  By this CPU model no
tensor-core scheme keeps the redesign's bound of 5e-5 (half of
chip_smoke.py's 1e-4 hold) in both checks, so the kernel keeps the plain
version's own chain.  The CPU figures are not the card's: on the card
(``python -m ccvm_tpu_torch.tools.tc_model --device cuda``, PERF.md) 4xTF32
per k-tile reads 4.58e-5 at phase 3's check and 3.62e-5 over 1,000 steps,
and at most 8.39e-5 at phase 7's, within the 1e-4 hold everywhere, where a
float64 sum rounded once reads 7.63e-5 at phase 7: so the card's margin
cannot rule that scheme out, and a 4xTF32 kernel stays open.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from ccvm_tpu_torch import AdamParameters
from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics import mf as dyn
from ccvm_tpu_torch.dynamics.mf import MFParams
from ccvm_tpu_torch.ops import build, mf_kernels
from ccvm_tpu_torch.tools import tc_model

MAIN_BATCH = 65536
# The redesign's bound on a matvec scheme's model: half of chip_smoke.py's
# PARITY_TOL, for the max over 65,536 trajectories on the card.
MODEL_TOL = 5e-5
PARITY_TOL = 1e-4
MID = 1.0  # u + l of the instance's [0, 1] box
PHASE3 = dict(seed=0, batch=1024, iterations=300, noise_scale=0.0)
# Noise off every trajectory is the same: 16 stand for any batch.
NOISE_OFF_1000 = dict(seed=0, batch=16, iterations=1000, noise_scale=0.0)


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("n", [2, 4, 20, 30, 40, 50, 60, 70])
def test_launch_shape_pads_to_four_and_fills_whole_waves(n, adam):
    shape = build.mf_launch_shape(n, adam)
    assert shape.np % 4 == 0 and shape.np - 4 < n <= shape.np
    groups = shape.np // 4
    # A thread owns 4 trajectories x 4 columns; at most 16 row groups and
    # 288 threads a block.
    assert shape.threads == groups * shape.rows // 4 <= 288
    assert shape.rows == 4 * min(16, 288 // groups)
    # Q, the V term, the x buffers (two; Adam one), and each thread's sigma
    # (64 bytes) and Adam's moments and mu (192 bytes).
    assert shape.smem == (4 * (shape.np ** 2 + shape.np
                               + (1 if adam else 2) * shape.rows * (shape.np + 4))
                          + (256 if adam else 64) * shape.threads)
    assert shape.smem <= build.SMEM_LIMIT == 232448
    assert shape.blocks_per_sm * (shape.smem + 1024) <= build.SM_SMEM
    # 96 registers a thread, the warps spread over an SM's four quarters of
    # 16,384 registers (two blocks of 288 threads at N=70: 18 warps).
    warps = -(-shape.threads // 32)
    assert -(-shape.blocks_per_sm * warps // 4) * 32 * 96 <= 16384
    # At least 16 warps per SM but where blocks of 5 to 7 warps leave a
    # quarter's registers short of another block (N=40 Adam, N=50: 14-15).
    assert shape.blocks_per_sm * warps >= (14 if n in (40, 50) else 16)
    assert mf_kernels.launch_shape(n, adam) == shape[:3]


@pytest.mark.parametrize("adam", [False, True])
def test_main_shape_fills_whole_waves(adam):
    shape = build.mf_launch_shape(70, adam)
    assert shape[:3] == ((64, 288, 114208) if adam else (64, 288, 78368))
    assert shape.blocks_per_sm == 2  # 18 warps per SM at 96 registers
    w = build.waves(MAIN_BATCH, shape)
    assert w == pytest.approx(1024 / 264)
    assert w / math.ceil(w) >= 0.9


@pytest.mark.parametrize("adam", [False, True])
def test_launch_shape_raises_beyond_the_largest_n(adam):
    build.mf_launch_shape(128, adam)
    with pytest.raises(ValueError, match="does not fit the MF"):
        build.mf_launch_shape(400, adam)


def test_specialisations_carry_the_padded_size_and_no_pump_rate_flag(monkeypatch,
                                                                     tmp_path):
    """The pump schedule is in the step table, so one library serves both
    pump_rate_flag values; each problem size class (N padded to 4) has its
    own, whose matvec loop has a bound known at build time; the card's
    residency is read from the built library."""
    hp = AdamParameters().to_hyperparameters()
    spec = mf_kernels._spec(70, hp, 1.0, "popcount32")
    assert spec == build.MFSpec(True, False, True, True, 0, 72)
    assert spec.defines() == ["-DCCVM_ADAM=1", "-DCCVM_BETA2_ONE=0",
                              "-DCCVM_ADD_ASSIGN=1", "-DCCVM_NOISE=1", "-DCCVM_RNG=0",
                              "-DCCVM_NP=72"]
    assert mf_kernels._spec(70, None, 0.0, "box_muller").rng == 0
    assert [mf_kernels._spec(n, None, 1.0, "popcount32").np for n in (2, 4, 20, 69)] == \
        [4, 4, 20, 72]
    assert build.library_path(spec) != build.library_path(spec._replace(np=20))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mf_kernels.blocks_per_sm(70)


_PARAMS = MFParams(0.5, 20.0, 0.0025, 5.0, 4000.0, 0.01, 0.0, 1.0, 40.0)


def plain_step_scalars(params, hp, i, pump_rate_flag, device):
    """Step ``i``'s scalars as the plain version computes them, one 0-dim
    float32 operation at a time (``dynamics/mf.py``,
    ``dynamics/common.adam_moment_update``), in the table's column order."""
    p = common.float32_scalars(params, device)
    j_i = dyn.measurement_strength(p, i)
    pump = p.pump * dyn._rate(p, i, pump_rate_flag) + 1.0 + j_i
    fi1 = torch.tensor(i + 1.0, device=device)
    b1 = b2 = torch.tensor(1.0, device=device)
    if hp is not None:
        b1 = 1.0 - torch.pow(hp.beta1, fi1)
        if hp.beta2 != 1.0:
            b2 = 1.0 - torch.pow(hp.beta2, fi1)
    return torch.stack([torch.sqrt(1.0 / (4.0 * j_i)), -(1 + j_i) + pump, 1 + j_i,
                        -2 * j_i, torch.sqrt(j_i), b1, 1.0 / b1, b2, 1.0 / b2])


@pytest.mark.parametrize("pump_rate_flag", [True, False])
@pytest.mark.parametrize("beta2", [None, 0.999, 1.0])
def test_step_table_holds_the_plain_versions_scalars(pump_rate_flag, beta2):
    """The kernel reads each step's schedules and Adam bias corrections from
    the wrapper's table, built by the plain version's own float32
    operations: the same values at every step, bit for bit but for Adam's
    four, which the CPU's vectorised pow may round an ulp away from its
    scalar pow (at step 30 of beta1 0.9 here).  On the card both are one
    elementwise kernel: tests/test_torch_cuda_kernels.py holds the table there
    bit for bit."""
    hp = None if beta2 is None else AdamParameters(beta2=beta2).to_hyperparameters()
    table = mf_kernels._step_table(_PARAMS, hp, 40, pump_rate_flag, "cpu")
    assert table.shape == (40, 12) and table.dtype == torch.float32
    for i in range(40):
        want = plain_step_scalars(_PARAMS, hp, i, pump_rate_flag, "cpu")
        assert torch.equal(table[i, :5], want[:5]), i
        ulp = torch.nextafter(want[5:], torch.full_like(want[5:], math.inf)) - want[5:]
        assert ((table[i, 5:9] - want[5:]).abs() <= ulp).all(), i
        assert torch.equal(table[i, 9:], torch.zeros(3))


def test_per_solve_constants_round_as_the_plain_version():
    """The host's float32 constants: the plain version's own roundings (and
    exact multiples of them), and 1/S and 1/sqrt(dt) rounded to nearest (the
    divisors of div_rn)."""
    hp = AdamParameters().to_hyperparameters()
    vals = np.array(list(mf_kernels._scalars(_PARAMS, hp, 0.5)), np.float32)
    p = common.float32_scalars(_PARAMS, "cpu")
    sqrt_dt = torch.sqrt(p.dt)
    g_sq = p.g ** 2
    span = p.upper_limit - p.lower_limit
    want = [1.0 / p.S, sqrt_dt, 1.0 / sqrt_dt, span, p.upper_limit + p.lower_limit,
            g_sq, 2 * (3 * g_sq), 2 * g_sq, -0.25 * span]
    assert np.array_equal(vals[15:], torch.stack(want).numpy())
    assert vals[14] == np.float32(0.5)
    assert vals[11] == np.float32(1.0 - hp.beta1)
    assert vals[13] == np.float32(1.0 - hp.beta2)


def div_rn_emulated(a32, b, inv):
    """csrc/ccvm_common.cuh ``div_rn(a, b, inv)`` on float32 ``a``, each of
    its three roundings (a product, then two FMAs) taken exactly: products
    of two float32 are exact in float64, and so is the residual a - q b;
    the last sum is rounded once (float64's rounding of it is corrected
    where it lands on a float32 tie: only there can rounding twice differ
    from rounding once)."""
    a = a32.astype(np.float64)
    q = (a * np.float64(inv)).astype(np.float32).astype(np.float64)
    r = (a - q * np.float64(b)).astype(np.float32).astype(np.float64)
    prod = r * np.float64(inv)
    s = q + prod
    f = s.astype(np.float32)
    # float64 values of normal float32 magnitude on a float32 tie: the 29
    # bits below float32's precision are 1 then zeros.
    at = np.flatnonzero((s.view(np.uint64) & np.uint64(0x1FFFFFFF)) ==
                        np.uint64(0x10000000))
    if at.size:
        qt, pt, st = q[at], prod[at], s[at]
        bb = st - qt
        err = (qt - (st - bb)) + (pt - bb)  # q + prod == s + err exactly
        ft = f[at]
        fd = ft.astype(np.float64)
        other = np.where(fd > st, np.nextafter(ft, np.float32(-np.inf)),
                         np.nextafter(ft, np.float32(np.inf)))
        fix = (err != 0) & (np.sign(other.astype(np.float64) - st) == np.sign(err))
        f[at[fix]] = other[fix]
    return f


def _phase12_saturation():
    """chip_smoke.py phase 12's per-column S of MF (the script loaded by
    path; it imports no more at its top than the standard library)."""
    import importlib.util
    import json
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(repo, "examples", "tuned_parameters.json")) as f:
        return smoke.phase12_saturations(json.load(f))["mf"]


def _divisors(case):
    """(divisor, its reciprocal) pairs of the kernel, as its wrapper hands
    them over: S and sqrt(dt) of the N=70 and N=20 parameters; Adam's bias
    corrections 1 - beta^(i+1) at some steps of a 15,000-step solve; and the
    per-column S_j of tests/test_torch_per_variable_s.py and chip_smoke.py
    phase 12 with the reciprocals of the per-column build's array."""
    if case == "S_j":
        from test_torch_per_variable_s import S_VECTORS

        pairs = []
        for S in (S_VECTORS["mf"], _phase12_saturation()):
            cols = mf_kernels._columns(_PARAMS._replace(S=common.saturation(S)), "cpu",
                                       None, None).numpy()
            assert np.array_equal(cols[0], S)
            pairs += list(zip(cols[0], cols[1]))
        return pairs
    if case in ("S", "sqrt_dt"):
        pairs = []
        for S in (130.0, 20.0):  # examples/tuned_parameters.json, tools/tpu_validate.py
            v = np.array(list(mf_kernels._scalars(_PARAMS._replace(S=S), None, 1.0)),
                         np.float32)
            pairs.append((v[1], v[15]) if case == "S" else (v[16], v[17]))
        return pairs
    hp = AdamParameters(beta2=0.999).to_hyperparameters()
    table = mf_kernels._step_table(_PARAMS._replace(iterations=15000.0), hp, 15000,
                                   True, "cpu").numpy()
    col = 5 if case == "beta1" else 7
    return [(table[i, col], table[i, col + 1]) for i in (0, 1, 2, 9, 99, 999, 14999)]


@pytest.mark.parametrize("case", ["S", "sqrt_dt", "beta1", "beta2", "S_j"])
def test_division_by_a_known_divisor_rounds_as_ieee(case):
    """The kernel divides by S, sqrt(dt) and Adam's bias corrections, and
    the per-column build by each S_j, as ``div_rn``: the product by the
    rounded reciprocal and Markstein's one FMA correction.  Over every
    float32 significand of a (the quotient's significand depends on no
    more), it rounds as the IEEE division.  (The V term's division by 2 S_j
    with inv_j / 2 scales every step by 2, exactly: it rounds as S_j's.)"""
    sig = (np.arange(2 ** 23, dtype=np.uint32) | np.uint32(0x3F800000)).view(np.float32)
    for b, inv in _divisors(case):
        assert inv == np.float32(1.0) / b
        for c in range(0, sig.size, 2 ** 21):
            a = sig[c:c + 2 ** 21]
            got = div_rn_emulated(a, b, inv)
            assert np.array_equal(got.view(np.uint32), (a / b).view(np.uint32)), (case, b)


@pytest.fixture(scope="module")
def size70():
    """The problem of the emulations; they run on one thread (small float64
    products, which gain nothing from more and would contend with the other
    test workers for the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tc_model.mf_problem("cpu")
    torch.set_num_threads(threads)


def _difference(size70, scheme, beta2, check):
    return tc_model.mf_difference(size70, tc_model.MF_SCHEMES[scheme](MID), beta2,
                                  **check)


@pytest.mark.parametrize("check", [PHASE3, NOISE_OFF_1000], ids=["phase3", "noise_off_1000"])
@pytest.mark.parametrize("beta2", [None, 0.999, 1.0])
def test_the_kernels_chain_holds_the_plain_solve(size70, beta2, check):
    """The matvec the kernel keeps, one fp32 FMA chain per output over k,
    is the plain version's own order: it lands within the bound (at 0)."""
    assert _difference(size70, "fp32 sequential (CUDA-core)", beta2, check) <= MODEL_TOL


@pytest.mark.parametrize("scheme,beta2,check", [
    # 6.9e-5: the best tensor-core scheme modelled, Q carried exactly (on
    # the card the same check reads 3.62e-5, within the bound).
    ("4xTF32 (Q's residual) per-k-tile accumulators", 1.0, NOISE_OFF_1000),
    # 6.5e-5: the scheme the redesign started from, uncentred.
    ("3xTF32 per-k-tile accumulators", 1.0, PHASE3),
    # 5.3e-5: the same, centred as DL's kernel is.
    ("3xTF32 per-k-tile accumulators, centred", None, PHASE3),
], ids=["4xtf32", "3xtf32", "3xtf32_centred"])
def test_tensor_core_schemes_miss_the_bound(size70, scheme, beta2, check):
    """Each tensor-core scheme modelled on the CPU lands beyond the bound in
    one of the redesign's checks (the table of the module docstring; the
    card's readings differ, and 4xTF32's stay within it there)."""
    assert _difference(size70, scheme, beta2, check) > MODEL_TOL


def test_dls_truncating_chain_fails_the_cards_hold(size70):
    """The test has teeth: DL's accumulation (one truncating chain through
    every k-tile, centred), ported as it is, misses chip_smoke.py's 1e-4 hold
    in phase 3's check (1.82e-4 here)."""
    scheme = "3xTF32 one truncating chain, centred (DL's)"
    assert _difference(size70, scheme, None, PHASE3) > PARITY_TOL


def test_a_sum_rounded_once_reaches_the_bound(size70):
    """The bound is not out of reach of any reordering: a float64 sum
    rounded once (3.05e-5 here) keeps it; the tensor cores' truncating
    accumulation and TF32 split do not."""
    assert _difference(size70, "float64 rounded once", None, PHASE3) <= MODEL_TOL
