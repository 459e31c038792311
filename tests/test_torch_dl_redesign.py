"""The DL kernel's tensor-core design (csrc/dl_solve.cu, MMA = 1) on the CPU.

The kernel runs only on a card; what can be held here is its launch rule
(``build.dl_launch_shape``, the Python statement of ``dl_launch_shape`` in
the source) and its arithmetic: PyTorch emulations of the 3xTF32 matvec,
patched in as ``common.dense_matvec`` for the plain solve, predict how far
the card's kernel lands from the fp32 plain version, and show that a kernel
with one TF32 product per fp32 product would fail the card's holds.
"""

from __future__ import annotations

import json
import math
import os

import pytest
import torch

from ccvm_tpu_torch import AdamParameters, DLSolver, ProblemInstance
from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.ops import build, dl_kernels
from ccvm_tpu_torch.tools import kernel_experiments

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE70 = os.path.join(REPO, "examples", "benchmarking_instances", "Size70",
                      "tuningH070-100-0.in")
TUNED = os.path.join(REPO, "examples", "tuned_parameters.json")
MAIN_BATCH = 65536
# The noise-off difference of a 300-step solve at N=70 between the 3xTF32
# emulation and the fp32 plain version.  The omitted lo*lo term and the
# three rounded partial sums leave about 2^-22 of each product, so the
# difference stays near 1e-6 of the state's O(1) amplitude; a single TF32
# product (1xTF32) misses this bound in every case below.  It is the CPU's
# prediction of the card's phase-3 hold (chip_smoke.py PARITY_TOL is 1e-4).
EMULATION_TOL = 1e-5
# chip_smoke.py's hold of each kernel against its plain version.
PARITY_TOL = 1e-4
# The kernel's model (centred x, 3xTF32, the tensor cores' truncating
# accumulation) against the fp32 plain version in phase 3's check: DL lands
# at 1.13e-5 here, where the card read 8.1e-6 (1.94e-5 before the centring,
# which the model, uncentred, puts at 2.8e-5).
KERNEL_MODEL_TOL = 2e-5


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("n", [2, 4, 20, 30, 40, 50, 60, 70])
def test_launch_shape_pads_to_eight_and_fills_whole_waves(n, adam):
    shape = build.dl_launch_shape(n, adam)
    nt = shape.np // 8
    assert shape.np % 8 == 0 and shape.np - 8 < n <= shape.np
    # A warp owns 8 trajectories; DL 8 warps at two blocks per SM, DL-Adam
    # 16 warps at one: 16 resident warps per SM either way.
    assert shape.threads == 4 * shape.rows
    assert (shape.rows, shape.blocks_per_sm) == ((128, 1) if adam else (64, 2))
    assert shape.threads // 32 * shape.blocks_per_sm == 16
    # Each lane's own float4s: DL's c and s; DL-Adam's c and s beyond the four
    # n-tiles it keeps in registers, and its two moments.
    own = 512 * (max(0, nt - 4) + 2 * nt if adam else nt) * shape.threads // 32
    assert shape.smem == 8 * shape.np ** 2 + 4 * shape.np + own
    assert shape.smem <= build.SMEM_LIMIT == 232448
    assert shape.blocks_per_sm * (shape.smem + 1024) <= build.SM_SMEM
    w = build.waves(MAIN_BATCH, shape)
    assert w == pytest.approx(1024 / 264 if not adam else 512 / 132)
    assert w / math.ceil(w) >= 0.9
    assert dl_kernels.launch_shape(n, adam) == shape[:3]


@pytest.mark.parametrize("n", [129, 400])
@pytest.mark.parametrize("adam", [False, True])
def test_launch_shape_raises_beyond_the_largest_n(n, adam):
    build.dl_launch_shape(128, adam)
    with pytest.raises(ValueError, match="does not fit the DL"):
        build.dl_launch_shape(n, adam)


def test_adam_blocks_shrink_where_the_moments_do_not_fit():
    shape = build.dl_launch_shape(128, True)
    assert shape.rows < 128 and shape.smem <= build.SMEM_LIMIT


def test_specialisations_carry_the_matvec_and_the_tile_count(monkeypatch, tmp_path):
    hp = AdamParameters().to_hyperparameters()
    kw = dict(noise_scale=1.0, rng="popcount16")
    spec = dl_kernels._spec(70, None, mma=True, **kw)
    assert (spec.mma, spec.nt) == (True, 9)
    assert spec.defines()[-2:] == ["-DCCVM_MMA=1", "-DCCVM_NT=9"]
    assert dl_kernels._spec(20, hp, mma=True, **kw).nt == 3
    core = dl_kernels._spec(70, hp, mma=False, **kw)
    assert (core.mma, core.nt) == (False, 0)
    assert build.library_path(spec) != build.library_path(spec._replace(nt=3))
    # The card's residency is read from the built library: no nvcc, no count.
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        dl_kernels.blocks_per_sm(70, **kw)


def test_race_has_the_tensor_core_knob():
    rows = {label: kind for label, kind, _ in kernel_experiments.ROWS
            if kind in ("production", "cuda-core")}
    assert rows == {"dl_solve CUDA-core matvec popcount16 (clip)": "cuda-core",
                    "production dl_solve popcount16 (clip)": "production"}
    knobs = {k: (a, b) for k, a, b in kernel_experiments.KNOBS}
    assert knobs["tensor-core matvec (3xTF32 against CUDA cores)"] == tuple(rows)


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, on the 13 low mantissa bits (the sign bit is apart, so adding
    half a unit to the magnitude's bits rounds ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matvec_3xtf32(x, q):
    """x @ Q as the kernel's 3xTF32 product: hi = tf32(a), lo = tf32(a - hi)
    for x and Q, then lo*hi + hi*lo before hi*hi, each in fp32."""
    xh, qh = tf32(x), tf32(q)
    xl, ql = tf32(x - xh), tf32(q - qh)
    return (torch.matmul(xl, qh) + torch.matmul(xh, ql)) + torch.matmul(xh, qh)


def matvec_1xtf32(x, q):
    return torch.matmul(tf32(x), tf32(q))


def _toward_zero(x64):
    """float64 to float32, rounded toward zero."""
    r = x64.to(torch.float32)
    over = r.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def matvec_3xtf32_truncating(x, q):
    """x @ Q as the kernel's chain of m16n8k8 mma: for each k-tile of 8
    rows of Q, lo*hi, hi*lo and hi*hi are one mma each, which adds its 8
    products (exact: TF32 times TF32 fits float64) to the fp32 accumulator
    and rounds the sum toward zero, a model of the tensor cores'
    truncating accumulation."""
    xh, qh = tf32(x), tf32(q)
    parts = {"h": (xh, qh), "l": (tf32(x - xh), tf32(q - qh))}
    acc = torch.zeros(x.shape[:-1] + q.shape[-1:], dtype=torch.float32)
    for k in range(0, q.shape[-2], 8):
        for a, b in (("l", "h"), ("h", "l"), ("h", "h")):
            prod = torch.matmul(parts[a][0][..., k:k + 8].double(),
                                parts[b][1][..., k:k + 8, :].double())
            acc = _toward_zero(acc.double() + prod)
    return acc


def centred(matvec, mid):
    """The kernel's centring: the mma takes x - (u+l), and (u+l) times Q's
    column sums is added in fp32."""
    return lambda x, q: matvec(x - mid, q) + mid * q.sum(-2, keepdim=True)


def test_tf32_rounds_to_nearest_with_ties_away():
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0 ** -20,
                      1.0 + 1.5 * ulp, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp, 3.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    assert (tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF).eq(0).all()
    # hi + lo carries 22 of fp32's 24 bits.
    q = torch.randn(64, 64, dtype=torch.float32)
    hi = tf32(q)
    err = (hi.double() + tf32(q - hi).double() - q.double()).abs()
    assert (err <= q.double().abs() * 2.0 ** -21).all()


@pytest.fixture(scope="module")
def size70():
    """The scaled N=70 instance of the main path, and the DL tuned
    parameters over 300 steps."""
    inst = ProblemInstance(device="cpu", instance_type="tuning", file_path=SIZE70)
    solver = DLSolver(device="cpu")
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    solver.solution_bounds = inst.solution_bounds
    with open(TUNED) as f:
        t = json.load(f)["dl"]["70"]
    params = solver._make_params(t["pump"], 1.0, t["dt"], t["noise_ratio"],
                                 t["feedback_scale"], 0.05, 300)
    return inst.q_matrix, inst.v_vector, params, t["pump"] > 1


def _noise_off_difference(size70, monkeypatch, matvec, beta2, *, seed=0,
                          batch=64, iterations=300, noise_scale=0.0):
    """Largest difference of c and s between the plain solve with ``matvec``
    and the fp32 plain solve (params with T = ``iterations``)."""
    q, v, params, pump_gt_one = size70
    params = params._replace(iterations=float(iterations))
    hp = None if beta2 is None else AdamParameters(beta2=beta2).to_hyperparameters()
    kw = dict(iterations=iterations, batch_size=batch, pump_rate_flag=True,
              pump_is_gt_one=pump_gt_one, noise_scale=noise_scale, hp=hp)
    plain = dl_kernels.dl_solve_reference(seed, q, v, params, **kw)
    with monkeypatch.context() as m:
        m.setattr(common, "dense_matvec", matvec)
        emulated = dl_kernels.dl_solve_reference(seed, q, v, params, **kw)
    for x in emulated:
        assert x.shape == (batch, 70) and torch.isfinite(x).all()
    return max((a - b).abs().max().item() for a, b in zip(emulated, plain))


def _mid(size70):
    params = size70[2]
    return params.upper_limit + params.lower_limit


@pytest.mark.parametrize("beta2", [None, 0.999, 1.0])
def test_3xtf32_matvec_holds_the_fp32_plain_solve(size70, monkeypatch, beta2):
    assert _noise_off_difference(size70, monkeypatch, matvec_3xtf32, beta2) \
        <= EMULATION_TOL


@pytest.mark.parametrize("beta2", [None, 0.999, 1.0])
def test_1xtf32_matvec_misses_the_bound(size70, monkeypatch, beta2):
    """The bound has teeth: one TF32 product per fp32 product misses it."""
    assert _noise_off_difference(size70, monkeypatch, matvec_1xtf32, beta2) \
        > EMULATION_TOL


@pytest.mark.parametrize("beta2", [None, 0.999, 1.0])
def test_kernel_model_predicts_the_cards_noise_off_hold(size70, monkeypatch, beta2):
    """Phase 3's check of chip_smoke.py (seed 0, batch 1024, 300 steps,
    noise off) with the kernel's arithmetic modelled."""
    matvec = centred(matvec_3xtf32_truncating, _mid(size70))
    assert _noise_off_difference(size70, monkeypatch, matvec, beta2,
                                 batch=1024) <= KERNEL_MODEL_TOL


@pytest.mark.parametrize("beta2,seed,iterations,noise_scale", [
    (None, 0, 300, 0.0),     # DL, phase 3
    (0.999, 100, 1000, 1.0),  # DL-Adam, phase 7
])
def test_1xtf32_control_fails_the_cards_hold(size70, monkeypatch, beta2, seed,
                                            iterations, noise_scale):
    """A kernel without the lo terms (one TF32 product per fp32 product),
    centred as the kernel is, fails chip_smoke.py's 1e-4 hold of each main-path
    DL kernel: DL in phase 3 (8.2e-3 here), DL-Adam in phase 7, over 1,000
    steps of the same noise (9.7e-4 here; its 300-step noise-off difference
    stays near 3e-6, as Adam's normalised step absorbs a relative error of
    the gradient).  Batch 1024 is phase 7's first 1024 trajectories (the
    noise is keyed by row), so the card's largest difference is at least
    this one's."""
    matvec = centred(matvec_1xtf32, _mid(size70))
    assert _noise_off_difference(size70, monkeypatch, matvec, beta2, seed=seed,
                                 batch=1024, iterations=iterations,
                                 noise_scale=noise_scale) > PARITY_TOL


def test_cuda_core_row_runs_the_plain_version_on_the_cpu(size70):
    """The race harness's CUDA-core row: on CPU tensors the plain version,
    with no launch counted; on another device it raises."""
    q, v, params, pump_gt_one = size70
    kw = dict(iterations=5, batch_size=4, pump_rate_flag=True,
              pump_is_gt_one=pump_gt_one)
    row = kernel_experiments.cuda_core_dl_solve
    before = (row.launches, dl_kernels.dl_solve.dl_launches)
    got = row(3, q, v, params, **kw)
    want = dl_kernels.dl_solve_reference(3, q, v, params, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert before == (row.launches, dl_kernels.dl_solve.dl_launches)
    with pytest.raises(ValueError, match="cpu or cuda"):
        row(3, q.to("meta"), v.to("meta"), params, **kw)


@pytest.mark.parametrize("pump_rate_flag", [True, False])
@pytest.mark.parametrize("beta2", [None, 0.999, 1.0])
def test_step_table_holds_the_plain_versions_scalars(pump_rate_flag, beta2):
    """The kernel reads each step's schedules, noise factors and Adam bias
    corrections from the wrapper's table, built by the plain version's own
    float32 operations: the same values, bit for bit."""
    from ccvm_tpu_torch.dynamics import dl as dyn
    from ccvm_tpu_torch.dynamics.dl import DLParams

    params = DLParams(8.0, 1.0, 0.001, 10.0, 200.0, 0.05, 0.0, 1.0, 40.0)
    hp = None if beta2 is None else AdamParameters(beta2=beta2).to_hyperparameters()
    table = dl_kernels._step_table(params, hp, 0.5, 30, pump_rate_flag, "cpu")
    assert table.shape == (30, 8) and table.dtype == torch.float32
    p = dyn._scalars(params, "cpu")
    sqrt_dt = torch.sqrt(p.dt)
    for i in (0, 1, 17, 29):
        rate = dyn.pump_rate_schedule(p, i, pump_rate_flag)
        nr_i = dyn.noise_ratio_schedule(p, i)
        want = [p.feedback_scale * (0.5 + rate), p.pump * rate,
                0.5 * sqrt_dt * nr_i, 0.5 * sqrt_dt / nr_i]
        fi1 = torch.tensor(i + 1.0)
        want += [torch.tensor(1.0) if hp is None else 1.0 / (1.0 - torch.pow(hp.beta1, fi1)),
                 torch.tensor(1.0) if hp is None or beta2 == 1.0
                 else 1.0 / (1.0 - torch.pow(hp.beta2, fi1))]
        assert torch.equal(table[i, :6], torch.stack(want).float())
        assert torch.equal(table[i, 6:], torch.zeros(2))
