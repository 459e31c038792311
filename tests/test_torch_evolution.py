"""Evolution sampling on the port's four façades against the JAX ones, and
the segment launch's plain versions (CPU).

The noise is off on both sides as the façade files do it: ``g=0`` for DL,
``sigma=0`` for the Langevin family, and for MF ``common.normal`` patched to
zeros on the JAX side and ``noise_scale=0`` on the port's.  Samples agree
to rtol 1e-4 (atol 1e-5 where a sample is near 0), the evolution files
(rounded to 4 decimals) to atol 2e-4, and objective values to rtol 1e-4;
the port's file equals, byte for byte, what the JAX package's writer writes
of the port's samples.

Inside the port, with the noise on: a solve cut into segments equals the
whole solve bit for bit, for all eight plain versions (the kernels' own
segment launches are held to the same on the card,
``tests/test_torch_cuda_kernels.py``).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvm_tpu import AdamParameters as JAdamParameters
from ccvm_tpu import DLSolver as JDLSolver
from ccvm_tpu import LangevinSolver as JLangevinSolver
from ccvm_tpu import MFSolver as JMFSolver
from ccvm_tpu import ProblemInstance as JProblemInstance
from ccvm_tpu import PumpedLangevinSolver as JPumpedLangevinSolver
from ccvm_tpu import native as jnative
from ccvm_tpu.dynamics import common as jcommon
from ccvm_tpu_torch import (AdamParameters, DLSolver, LangevinSolver, MFSolver,
                            ProblemInstance, PumpedLangevinSolver)
from ccvm_tpu_torch.dynamics.dl import DLParams
from ccvm_tpu_torch.dynamics.langevin import LangevinParams
from ccvm_tpu_torch.dynamics.mf import MFParams
from ccvm_tpu_torch.dynamics.pumped_langevin import PumpedLangevinParams
from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels
from jax_native_loader import jax_native_library

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST020 = os.path.join(REPO, "tests", "data", "test020.in")
# (JAX façade, port façade, parameter key, call, Adam alpha, sample names,
# trailing tab in the file) of each family; the noise is off in each.
FAMILIES = {
    "dl": (JDLSolver, DLSolver,
           {20: {"pump": 8.0, "feedback_scale": 100.0, "noise_ratio": 10.0,
                 "dt": 0.001, "iterations": 200}},
           {"g": 0.0}, 0.05, ("c_sample", "s_sample")),
    "mf": (JMFSolver, MFSolver,
           {20: {"pump": 0.5, "feedback_scale": 4000.0, "j": 5.0, "S": 20.0,
                 "dt": 0.0025, "iterations": 300}},
           {}, 0.05, ("mu_sample", "sigma_sample")),
    "langevin": (JLangevinSolver, LangevinSolver,
                 {20: {"dt": 0.002, "S": 0.5, "iterations": 300, "sigma": 0.0,
                       "feedback_scale": 2.0}},
                 {}, 0.1, ("c_sample",)),
    "pumped": (JPumpedLangevinSolver, PumpedLangevinSolver,
               {20: {"pump": 1.0, "dt": 0.002, "S": 0.5, "iterations": 300,
                     "sigma": 0.0, "feedback_scale": 1.0}},
               {}, 0.01, ("c_sample",)),
}
SAMPLE_RTOL, SAMPLE_ATOL, FILE_ATOL = 1e-4, 1e-5, 2e-4


@pytest.fixture
def noise_off(monkeypatch):
    """MF without noise on either side (the JAX solve is jitted: its trace
    cache is cleared around the patch)."""
    monkeypatch.setattr(jcommon, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    for name in ("mf_solve", "mf_solve_sampled"):
        monkeypatch.setattr(mf_kernels, name,
                            functools.partial(getattr(mf_kernels, name), noise_scale=0.0))
    jax.clear_caches()
    yield
    jax.clear_caches()


def solve_pair(family, tmp_path, adam=False, batch=32, solver_kwargs=None,
               params=None, **call):
    """The JAX and the port's façade on test020.in with ``call``; the
    evolution files (when sampling) go to ``tmp_path``."""
    jcls, tcls, pkey, base, alpha, _ = FAMILIES[family]
    out = []
    for side, cls, inst_cls in (("jax", jcls, JProblemInstance),
                                ("torch", tcls, ProblemInstance)):
        solver = cls(device="cpu", batch_size=batch, **(solver_kwargs or {}))
        solver.parameter_key = params or pkey
        inst = inst_cls(device="cpu", file_path=TEST020, instance_type="test")
        inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
        kw = dict(base, **call)
        if adam:
            kw["algorithm_parameters"] = (JAdamParameters if side == "jax"
                                          else AdamParameters)(alpha=alpha)
        if kw.get("evolution_step_size"):
            kw["evolution_file"] = str(tmp_path / f"{side}_{family}.txt")
        out.append((solver, solver(inst, seed=3, **kw)))
    return out


def assert_samples_agree(family, pair, tmp_path):
    """Each sample stack ((batch, n, samples), on the port's device) and the
    evolution file of the two façades, and the port's file against the JAX
    package's writer on the port's samples (in ``tmp_path``)."""
    (jsolver, jsol), (tsolver, tsol) = pair
    for name in FAMILIES[family][5]:
        t, j = getattr(tsolver, name), np.asarray(getattr(jsolver, name))
        assert isinstance(t, torch.Tensor) and tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)
    np.testing.assert_allclose(np.loadtxt(tsol.evolution_file),
                               np.loadtxt(jsol.evolution_file), atol=FILE_ATOL)
    with open(tsol.evolution_file) as tf, open(jsol.evolution_file) as jf:
        t_lines, j_lines = tf.read().splitlines(), jf.read().splitlines()
    # The same rows, and the same trailing tab (MF's writer has none).
    assert len(t_lines) == len(j_lines)
    assert [ln.endswith("\t") for ln in t_lines] == [ln.endswith("\t") for ln in j_lines]
    # Byte for byte, the port's file is what the JAX package's writer (its
    # C++ path, which writes -0.0 as 0.0 and rounds half away from zero)
    # writes of the same samples: the best trajectory's blocks.  (The two
    # façades' samples part by round-off, which can move a fourth decimal.)
    assert jax_native_library() is not None
    best = int(np.argmax(-np.asarray(tsol.objective_values)))
    jax_written = tmp_path / f"jax_writer_{family}.txt"
    with open(jax_written, "w") as f:
        for name in FAMILIES[family][5]:
            jnative.write_sample_rows(f, getattr(tsolver, name)[best].numpy(),
                                      append_trailing_tab=family != "mf")
    with open(tsol.evolution_file, "rb") as tf:
        assert tf.read() == jax_written.read_bytes()


def assert_objectives_agree(pair, rtol=1e-4):
    (_, jsol), (_, tsol) = pair
    np.testing.assert_allclose(np.asarray(tsol.objective_values),
                               np.asarray(jsol.objective_values), rtol=rtol)
    assert tsol.solution_performance == jsol.solution_performance


@pytest.mark.parametrize("step", [70, 100])
@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_evolution_sampling_matches_jax(noise_off, tmp_path, family, adam, step):
    """``evolution_step_size`` on each façade, plain and Adam: the sample
    plan (a sample after step 0, every ``step``-th and the last; 100
    divides 200 and 300, 70 does not), the samples, the file and the
    objective values."""
    pair = solve_pair(family, tmp_path, adam=adam, evolution_step_size=step)
    assert_samples_agree(family, pair, tmp_path)
    assert_objectives_agree(pair)
    iterations = FAMILIES[family][2][20]["iterations"]
    num = iterations // step + 1 + (iterations % step != 0)
    (_, jsol), (tsolver, tsol) = pair
    assert getattr(tsolver, FAMILIES[family][5][0]).shape == (32, 20, num)
    assert tsol.evolution_file.endswith(f"torch_{family}.txt")


@pytest.mark.parametrize("post_processor", ["grad-descent", "adam", "bfgs"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_evolution_sampling_with_a_post_processor(noise_off, tmp_path, family,
                                                  post_processor):
    """Post-processing reads the solve's result as without sampling; the
    samples and the file are the solve's.  Objective values at the façade
    files' tolerances where round-off decides a post-processor's result
    (Adam's first step, BFGS's line search: tests/test_torch_dl_solver.py)."""
    pair = solve_pair(family, tmp_path, evolution_step_size=70,
                      post_processor=post_processor)
    assert_samples_agree(family, pair, tmp_path)
    assert_objectives_agree(pair, rtol={"adam": 1e-4, "bfgs": 2e-3}.get(
        post_processor, 1e-4))
    assert pair[1][1].pp_time > 0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_evolution_file_defaults_to_the_instance_name(noise_off, tmp_path,
                                                      monkeypatch, family):
    """Without ``evolution_file`` the port writes ``./{name}_evolution.txt``,
    as the JAX façade does, and a step size below 1 raises its error."""
    monkeypatch.chdir(tmp_path)
    _, tcls, pkey, base, _, _ = FAMILIES[family]
    solver = tcls(device="cpu", batch_size=8)
    solver.parameter_key = pkey
    inst = ProblemInstance(device="cpu", file_path=TEST020, instance_type="test",
                           name="inst20")
    sol = solver(inst, seed=1, evolution_step_size=150, **base)
    assert sol.evolution_file == "./inst20_evolution.txt"
    assert (tmp_path / "inst20_evolution.txt").is_file()
    with pytest.raises(ValueError, match="greater than or equal to 1"):
        solver(inst, seed=1, evolution_step_size=0.5, **base)


def test_sample_plan_is_the_jax_packages():
    for iterations, step in ((300, 70), (200, 100), (15000, 1000), (5, 1), (7, 10)):
        assert DLSolver._evolution_sample_plan(iterations, step) == \
            JDLSolver._evolution_sample_plan(None, iterations, step)


# Noise on, inside the port: each plain version's segments against its whole
# solve.  (family, Adam, wrapper names, parameters, extra arguments)
_RNG = np.random.RandomState(11)
_A = _RNG.randn(20, 20).astype(np.float32)
_Q = torch.from_numpy((_A + _A.T) / 8)
_V = torch.from_numpy(_RNG.randn(20).astype(np.float32))
_ITERS = 120
_SEGMENTS = DLSolver._evolution_sample_plan(_ITERS, 25)[1]
_PLAIN = {
    "dl": (dl_kernels.dl_solve, dl_kernels.dl_solve_sampled,
           DLParams(8.0, 1.0, 0.001, 3.0, 100.0, 0.05, 0.0, 1.0, float(_ITERS)),
           dict(pump_rate_flag=True, pump_is_gt_one=True, rng="popcount16")),
    "mf": (mf_kernels.mf_solve, mf_kernels.mf_solve_sampled,
           MFParams(0.5, 20.0, 0.0025, 5.0, 400.0, 0.01, 0.0, 1.0, float(_ITERS)),
           dict(pump_rate_flag=True, rng="popcount32")),
    "langevin": (langevin_kernels.langevin_solve, langevin_kernels.langevin_solve_sampled,
                 LangevinParams(0.5, 0.002, 0.5, 2.0, 0.0, 1.0), dict(rng="popcount32")),
    "pumped": (langevin_kernels.pumped_langevin_solve,
               langevin_kernels.pumped_langevin_solve_sampled,
               PumpedLangevinParams(1.0, 0.5, 0.002, 0.5, 1.0, 0.0, 1.0, float(_ITERS)),
               dict(pump_rate_flag=True, rng="popcount32")),
}


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("family", sorted(_PLAIN))
def test_segmented_plain_solve_equals_the_whole_bit_for_bit(family, adam):
    """Noise on: the Philox counter and the schedules are keyed by the
    absolute step and the whole state (Adam's moments too) is carried, so
    the segments of the sample plan give the whole solve's result bit for
    bit, and the last sample is the final (raw) state."""
    whole, sampled, params, extra = _PLAIN[family]
    hp = AdamParameters(beta2=0.999).to_hyperparameters() if adam else None
    kw = dict(extra, batch_size=16, hp=hp)
    want = whole(7, _Q, _V, params, iterations=_ITERS, **kw)
    got, samples = sampled(7, _Q, _V, params, _SEGMENTS, **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    samples = samples if isinstance(samples, tuple) else (samples,)
    assert all(x.shape == (len(_SEGMENTS), 16, 20) for x in samples)
    assert all(torch.isfinite(x).all() for x in samples)
    if family != "dl":  # DL's final c is clamped; its samples are raw
        assert torch.equal(samples[0][-1], got[0])


@pytest.mark.parametrize("adam", [False, True])
def test_dl_segment_hands_its_whole_state_on(adam):
    """Two DL segments chained by hand (the state, Adam's four moments
    included) equal one; the raw c of the first is not clamped, and only
    the segment that ends the solve returns the clamped c."""
    _, _, params, extra = _PLAIN["dl"]
    hp = AdamParameters(beta2=0.999).to_hyperparameters() if adam else None
    kw = dict(extra, iterations=_ITERS, batch_size=16, hp=hp)
    state, c_final = dl_kernels.dl_solve_segment(7, _Q, _V, params, None, 0, 50, **kw)
    assert c_final is None and len(state) == (6 if adam else 2)
    state, c_final = dl_kernels.dl_solve_segment(7, _Q, _V, params, state, 50, 70, **kw)
    c, s = dl_kernels.dl_solve(7, _Q, _V, params, **kw)
    assert torch.equal(c_final, c) and torch.equal(state[1], s)
    assert torch.equal(c_final, state[0].clamp(-1.0, 1.0))
    with pytest.raises(ValueError, match="does not lie"):
        dl_kernels.dl_solve_segment(7, _Q, _V, params, state, 100, 30, **kw)
