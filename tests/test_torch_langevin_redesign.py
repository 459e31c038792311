"""The Langevin family's kernel redesign (csrc/langevin_solve.cu) on the CPU.

The kernel runs only on a card; what can be held here is its launch rule
(``build.langevin_launch_shape``, the Python statement of
``lgv_launch_shape`` in the source), the per-step and per-solve scalars its
wrappers hand it, the division by a known divisor it takes for Adam's bias
corrections, and the model that chose its matvec: emulations of
tensor-core schemes (``ccvm_tpu_torch.tools.tc_model``, ``--family
langevin``), patched in as ``common.dense_matvec`` for the plain solves at
the main path's N=70 with the tuned parameters, against the fp32 plain
solve.

On the CPU (torch 2.13, batch 256 for phase 7's checks) every scheme keeps
the short holds: 3xTF32 with a fresh accumulator per k-tile lands within
5.1e-6 of the plain solve over 1,000 steps and 4.5e-7 at phase 3's check,
DL's one truncating chain at 3.4e-5 over 1,000 steps.  On the card
(``python -m ccvm_tpu_torch.tools.tc_model --device cuda --family langevin
--deep ...``, PERF.md) the three schemes held over 15,000 steps at batch
65536 (3xTF32 and 4xTF32 per k-tile, 3xTF32 per k-tile centred) read
6.02e-3 to 1.13e-2 for pumped-Adam, beyond chip_smoke.py's 2e-3, so the
kernels' shared template keeps the plain matmul's own order, the fp32 chain
over k, which the model puts at 0.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from ccvm_tpu_torch import AdamParameters
from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics import pumped_langevin as plgv
from ccvm_tpu_torch.dynamics.langevin import LangevinParams
from ccvm_tpu_torch.dynamics.pumped_langevin import PumpedLangevinParams
from ccvm_tpu_torch.ops import build, langevin_kernels
from ccvm_tpu_torch.tools import breakdown, tc_model

from test_torch_mf_redesign import div_rn_emulated

MAIN_BATCH = 65536
PARITY_TOL = tc_model.PARITY_TOL  # the hold of a kernel against its plain version
_BETA2 = [None, 0.999, 1.0]


def _hp(beta2):
    return None if beta2 is None else AdamParameters(beta2=beta2).to_hyperparameters()


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("n", [2, 4, 20, 30, 40, 50, 60, 70, 73, 128])
def test_launch_shape_pads_to_eight_and_fills_whole_waves(n, adam):
    shape = build.langevin_launch_shape(n, adam)
    assert shape.np % 8 == 0 and shape.np - 8 < n <= shape.np
    cols = shape.np // 8
    # 8 column groups by 16 row groups; a thread owns N/8 columns of 8 rows
    # (Adam: 4), half as many rows beyond 9 columns.
    assert shape.threads == 128
    assert shape.rows == 16 * (4 if adam else 8) // (2 if cols > 9 else 1)
    # Q, two x buffers of the block's rows at stride NP + 4, and Adam's
    # second moment of each element.
    assert shape.smem == (4 * (shape.np ** 2 + 2 * shape.rows * (shape.np + 4))
                          + (4 * shape.rows * shape.np if adam else 0))
    assert shape.smem <= build.SMEM_LIMIT
    assert 1 <= shape.blocks_per_sm <= 2
    assert shape.blocks_per_sm * (shape.smem + 1024) <= build.SM_SMEM
    w = build.waves(MAIN_BATCH, shape)
    assert w / math.ceil(w) >= 0.9
    assert langevin_kernels.launch_shape(n, adam) == shape[:3]


@pytest.mark.parametrize("adam", [False, True])
def test_main_shape_fills_whole_waves(adam):
    shape = build.langevin_launch_shape(70, adam)
    assert shape[:3] == ((64, 128, 78080) if adam else (128, 128, 98560))
    # Two blocks of 4 warps per SM: two warps to each quarter of the SM, at
    # up to 255 registers a thread.
    assert shape.blocks_per_sm == 2
    w = build.waves(MAIN_BATCH, shape)
    assert w == pytest.approx(1024 / 264 if adam else 512 / 264)
    assert w / math.ceil(w) >= 0.9


def test_launch_shape_raises_beyond_the_largest_n():
    build.langevin_launch_shape(128, True)
    with pytest.raises(ValueError, match="does not fit the Langevin-Adam kernel"):
        build.langevin_launch_shape(129, True)


def test_one_library_serves_both_pump_schedules():
    """The pump schedule is in the step table, so a specialisation has no
    pump flag; each problem size class (N padded to 8) has its own
    library, whose matvec loop has a bound known at build time."""
    hp = AdamParameters().to_hyperparameters()
    spec = langevin_kernels._spec(70, hp, 1.0, "popcount32", pumped=True)
    assert spec == build.LangevinSpec(True, True, False, True, True, 0, 72)
    assert [langevin_kernels._spec(n, None, 0.0, "box_muller", pumped=False).np
            for n in (2, 8, 9, 20, 70)] == [8, 8, 16, 24, 72]
    assert build.library_path(spec) != build.library_path(spec._replace(np=24))


_LANGEVIN = LangevinParams(0.5, 0.002, 0.5, 2.0, 0.0, 1.0)
_PUMPED = PumpedLangevinParams(1.0, 0.5, 0.002, 0.25, 1.0, 0.0, 1.0, 40.0)


def plain_step_scalars(params, hp, i, pump_rate_flag, device):
    """Step ``i``'s scalars as the plain version computes them, one 0-dim
    float32 operation at a time (``dynamics/pumped_langevin.pump_field``,
    ``dynamics/common.adam_moment_update``), in the table's column order."""
    zero, one = torch.tensor(0.0, device=device), torch.tensor(1.0, device=device)
    k1 = zero
    if isinstance(params, PumpedLangevinParams):
        pump = plgv.pump_field(common.float32_scalars(params, device), i, pump_rate_flag)
        k1 = -1.0 + pump
    fi1 = torch.tensor(i + 1.0, device=device)
    b1 = b2 = one
    if hp is not None:
        b1 = 1.0 - torch.pow(hp.beta1, fi1)
        if hp.beta2 != 1.0:
            b2 = 1.0 - torch.pow(hp.beta2, fi1)
    return torch.stack([k1, b1, 1.0 / b1, b2, 1.0 / b2])


@pytest.mark.parametrize("beta2", _BETA2)
@pytest.mark.parametrize("params,pump_rate_flag", [(_LANGEVIN, False), (_PUMPED, True),
                                                   (_PUMPED, False)],
                         ids=["langevin", "pumped_rate", "pumped_constant"])
def test_step_table_holds_the_plain_versions_scalars(params, pump_rate_flag, beta2):
    """The kernel reads each step's k1 and Adam bias corrections from
    the wrapper's table, built by the plain version's own float32
    operations: the same values at every step, bit for bit but for Adam's
    four, which the CPU's vectorised pow may round an ulp away from its
    scalar pow.  On the card both are one elementwise kernel:
    tests/test_torch_cuda_kernels.py holds the table there bit for bit."""
    hp = _hp(beta2)
    table = langevin_kernels._step_table(params, hp, 40, pump_rate_flag, "cpu")
    assert table.shape == (40, 8) and table.dtype == torch.float32
    for i in range(40):
        want = plain_step_scalars(params, hp, i, pump_rate_flag, "cpu")
        assert torch.equal(table[i, :1], want[:1]), i
        ulp = torch.nextafter(want[1:], torch.full_like(want[1:], math.inf)) - want[1:]
        assert ((table[i, 1:5] - want[1:]).abs() <= ulp).all(), i
        assert torch.equal(table[i, 5:], torch.zeros(3))


@pytest.mark.parametrize("params", [_LANGEVIN, _PUMPED], ids=["langevin", "pumped"])
def test_per_solve_constants_round_as_the_plain_version(params):
    """The host's float32 constants are the plain version's own roundings:
    scale = (u - l) / (2 S), the box midpoint (u + l) / 2, dt fs and
    sigma sqrt(dt)."""
    hp = AdamParameters(alpha=0.01).to_hyperparameters()
    vals = np.array(list(langevin_kernels._scalars(params, hp, 0.5)), np.float32)
    p = common.float32_scalars(params, "cpu")
    want = [p.S, p.dt, p.feedback_scale,
            (p.upper_limit - p.lower_limit) / (2 * p.S),
            (p.upper_limit + p.lower_limit) / 2, p.dt * p.feedback_scale,
            p.sigma * torch.sqrt(p.dt)]
    assert np.array_equal(vals[:7], torch.stack(want).numpy())
    assert vals[7] == np.float32(0.5)
    assert list(vals[8:]) == [np.float32(x) for x in (0.01, hp.beta1, 1.0 - hp.beta1,
                                                      hp.beta2, 1.0 - hp.beta2)]


@pytest.mark.parametrize("case", ["beta1", "beta2"])
def test_division_covers_every_divisor_of_the_table(case):
    """The kernel divides Adam's moments by the step's bias correction as
    ``div_rn`` (csrc/ccvm_common.cuh): the product by the table's rounded
    reciprocal and Markstein's one FMA correction.  For every distinct
    divisor a 15,000-step table holds (146 of 1 - 0.9^(i+1), which rounds
    to 1 in float32 from step 164 on, and 10,718 of 1 - 0.999^(i+1), which
    stays below 1), its emulation rounds
    as the IEEE division on both ends of the significand range and 2,048
    random significands; tests/test_torch_mf_redesign.py sweeps every
    significand for some of the same divisors."""
    hp = AdamParameters(beta2=0.999).to_hyperparameters()
    table = langevin_kernels._step_table(_PUMPED, hp, 15000, True, "cpu").numpy()
    col = 1 if case == "beta1" else 3
    pairs = np.unique(table[:, col:col + 2], axis=0)
    assert len(pairs) == (146 if case == "beta1" else 10718)
    rng = np.random.default_rng(7)
    bits = np.concatenate([np.arange(64, dtype=np.uint32),
                           np.uint32(2 ** 23 - 64) + np.arange(64, dtype=np.uint32),
                           rng.integers(0, 2 ** 23, 2048, dtype=np.uint32)])
    sig = (bits | np.uint32(0x3F800000)).view(np.float32)
    a = np.concatenate([sig, -sig * np.float32(0.25), sig * np.float32(2.0 ** -20)])
    for b, inv in pairs:
        assert inv == np.float32(1.0) / b
        got = div_rn_emulated(a, b, inv)
        assert np.array_equal(got.view(np.uint32), (a / b).view(np.uint32)), (case, b)


@pytest.fixture(scope="module")
def problems():
    """The Langevin and pumped problems of the emulations, on one thread
    (small float64 products, which gain nothing from more and would contend
    with the other test workers for the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield {f: tc_model.langevin_problem("cpu", f) for f in ("langevin", "pumped")}
    torch.set_num_threads(threads)


# Noise off every trajectory is the same: 8 stand for phase 3's 1024.
_PHASE3 = dict(seed=0, batch=8, iterations=300, noise_scale=0.0)
_NOISE_ON = dict(seed=100, batch=16, iterations=60, noise_scale=1.0)


@pytest.mark.parametrize("check", [_PHASE3, _NOISE_ON], ids=["phase3", "noise_on"])
@pytest.mark.parametrize("kname", sorted(tc_model.LANGEVIN_KERNELS))
def test_the_kernels_chain_holds_the_plain_solve(problems, kname, check):
    """The matvec the kernel keeps, one fp32 FMA chain per output over k, is
    the plain version's own order: it lands at 0.  The best tensor-core
    scheme, 3xTF32 with a fresh accumulator per k-tile, also keeps the short
    holds (within a tenth of chip_smoke.py's), but not at zero: on the card
    it missed only pumped-Adam's hold over 15,000 steps."""
    family, adam = tc_model.LANGEVIN_KERNELS[kname]
    problem = problems[family]
    hp = problem[3] if adam else None
    plain = tc_model.langevin_model_solve(problem, hp, **check)
    schemes = tc_model.LANGEVIN_SCHEMES
    numel = check["batch"] * 70
    chain = tc_model.langevin_difference(
        problem, schemes["fp32 chain over k (the plain matmul's order)"](0.5), hp,
        plain=plain, **check)
    assert chain == (0.0, 0, numel)
    err, over, _ = tc_model.langevin_difference(
        problem, schemes["3xTF32 per-k-tile accumulators"](tc_model.MID_LANGEVIN), hp,
        plain=plain, **check)
    assert 0 < err <= PARITY_TOL / 10 and over == 0


def test_the_model_sees_the_accumulation(problems):
    """The test has teeth: the same products through DL's one truncating
    chain, uncentred, land further from the plain solve than the per-k-tile
    scheme (2.9e-6 against 4.5e-7 at phase 3's check)."""
    problem = problems["langevin"]
    schemes = tc_model.LANGEVIN_SCHEMES
    plain = tc_model.langevin_model_solve(problem, None, **_PHASE3)
    per_tile, chain = (tc_model.langevin_difference(
        problem, schemes[label](0.5), None, plain=plain, **_PHASE3)[0]
        for label in ("3xTF32 per-k-tile accumulators",
                      "3xTF32 one truncating chain (DL's)"))
    assert 0 < per_tile < chain / 3


@pytest.mark.parametrize("kname", sorted(tc_model.LANGEVIN_KERNELS))
def test_the_4xtf32_scheme_keeps_the_short_holds(problems, kname):
    """4xTF32 with a fresh accumulator per k-tile (Q's residual as a fourth
    product, so the products carry Q exactly) keeps phase 3's hold within a
    tenth of chip_smoke.py's, but not at zero; on the card it is held over
    15,000 steps by ``tc_model --family langevin --deep``."""
    family, adam = tc_model.LANGEVIN_KERNELS[kname]
    problem = problems[family]
    hp = problem[3] if adam else None
    err, over, _ = tc_model.langevin_difference(
        problem, tc_model.LANGEVIN_SCHEMES["4xTF32 (Q's residual) per-k-tile accumulators"](
            tc_model.MID_LANGEVIN), hp, **_PHASE3)
    assert 0 < err <= PARITY_TOL / 10 and over == 0


def test_breakdown_times_the_wrappers_at_another_size():
    """``tools/breakdown.py --n N`` times the production kernels through the
    public wrappers alone (so that it can time another checkout's); on the
    CPU the same rows time the plain versions."""
    us = breakdown.wrapper_us_per_step(20, 4, 1, 2, 1, device="cpu")
    assert list(us) == ["Langevin", "Langevin, noise off", "Langevin-Adam", "pumped",
                        "pumped, noise off", "pumped-Adam"]
    assert all(math.isfinite(x) for x in us.values())
