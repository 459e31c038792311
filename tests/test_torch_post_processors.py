"""The port's Adam, ASGD, BFGS and L-BFGS post-processors and its batched
box-projected L-BFGS against the JAX package (CPU).

The same numpy inputs go through both.  The fixtures follow
``tests/unit/postprocessor/test_post_processors.py:13-22`` (a symmetric Q
with its diagonal lowered by n/2, V in [-1, 0], c in [0, 1]) at n 8 and 12,
batch 16 and 32, and one asymmetric Q (the same draw without the
symmetrisation): L-BFGS's objective uses ``Q x`` per row where the other
post-processors use ``c Q``, and only an asymmetric Q tells the two apart.

Tolerances: float32 products summed in another order differ by an ulp or
two a step.  Adam, ASGD (up to 25 steps) and L-BFGS (up to 10 iterations,
first step scaled by 0.001) carry that to ~1e-7 on values in [0, 1]: atol
1e-5, as in the port's other parity tests.  BFGS runs 50 L-BFGS iterations
whose Armijo tests and step rejections compare float32 energies, so a
round-off difference can move a row's decision by an iteration: atol 1e-4
(over 30 seeds of these fixtures, 1,920 rows, the largest difference was
3.2e-5).  Where a test falls within round-off a row can also end at another
point: on the card against the CPU at the main shape, 0.9-1.7% of the rows
of MF's and Langevin's outputs (``chip_smoke.py`` phase 10, PERF.md).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ccvm_tpu import post_processor as jpp
from ccvm_tpu.ops.lbfgs import lbfgs_box_batch as jax_lbfgs
from ccvm_tpu_torch import post_processor as tpp
from ccvm_tpu_torch.ops import lbfgs as tlbfgs
from ccvm_tpu_torch.tools import lbfgs_race

METHODS = ["grad-descent", "adam", "asgd", "bfgs", "lbfgs"]
CLASSES = {"grad-descent": tpp.PostProcessorGradDescent, "adam": tpp.PostProcessorAdam,
           "asgd": tpp.PostProcessorASGD, "bfgs": tpp.PostProcessorBFGS,
           "lbfgs": tpp.PostProcessorLBFGS}
TOL = 1e-5
BFGS_TOL = 1e-4
FIXTURES = {"n8_b16": (8, 16, True), "n12_b32": (12, 32, True),
            "asymmetric_n12_b32": (12, 32, False)}


def _problem(n, batch, symmetric):
    rng = np.random.RandomState(5)
    a = rng.uniform(-1, 1, (n, n)).astype(np.float32)
    q = (a + a.T) / 2 if symmetric else a
    q[np.diag_indices(n)] -= n / 2
    v = rng.uniform(-1, 0, n).astype(np.float32)
    c = rng.uniform(0, 1, (batch, n)).astype(np.float32)
    return c, q, v


@pytest.fixture(params=sorted(FIXTURES))
def problem(request):
    return _problem(*FIXTURES[request.param])


def _both(name, c, q, v, **kwargs):
    """(JAX result, port result) as numpy, from the same numpy inputs."""
    j = np.asarray(getattr(jpp, name)().postprocess(c, q, v, **kwargs))
    out = getattr(tpp, name)().postprocess(torch.from_numpy(c), torch.from_numpy(q),
                                           torch.from_numpy(v), **kwargs)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    assert out.shape == c.shape
    return j, out.numpy()


@pytest.mark.parametrize("num_iter", [1, 5, 25])
@pytest.mark.parametrize("name", ["PostProcessorAdam", "PostProcessorASGD"])
def test_adam_and_asgd_match_jax(problem, name, num_iter):
    c, q, v = problem
    j, t = _both(name, c, q, v, num_iter=num_iter)
    np.testing.assert_allclose(t, j, atol=TOL)
    assert not np.allclose(j, c)  # the refinement moved the batch


@pytest.mark.parametrize("num_iter", [1, 3, 10])
def test_lbfgs_matches_jax(problem, num_iter):
    c, q, v = problem
    j, t = _both("PostProcessorLBFGS", c, q, v, num_iter=num_iter)
    np.testing.assert_allclose(t, j, atol=TOL)
    assert not np.allclose(j, c)


def test_bfgs_matches_jax(problem):
    c, q, v = problem
    j, t = _both("PostProcessorBFGS", c, q, v)
    np.testing.assert_allclose(t, j, atol=BFGS_TOL)
    assert not np.allclose(j, 2 * c - 1)


@pytest.mark.parametrize("kwargs", [
    {"lower_clamp": 0.2, "upper_clamp": 0.8, "num_iter": 5},
    {"num_iter": 0},
])
@pytest.mark.parametrize("name", ["PostProcessorAdam", "PostProcessorASGD",
                                  "PostProcessorLBFGS"])
def test_clamps_and_zero_iterations_match_jax(name, kwargs):
    c, q, v = _problem(*FIXTURES["asymmetric_n12_b32"])
    j, t = _both(name, c, q, v, **kwargs)
    np.testing.assert_allclose(t, j, atol=TOL)


@pytest.mark.parametrize("history,max_backtracks,max_iter,first_step_scale", [
    (1, 25, 10, 1.0),
    (3, 5, 20, 1.0),
    (8, 1, 10, 0.001),
    (8, 25, 50, 1.0),
    (12, 10, 30, 0.5),
])
def test_lbfgs_box_batch_matches_jax(problem, history, max_backtracks, max_iter,
                                     first_step_scale):
    c, q, v = problem
    kw = dict(max_iter=max_iter, history=history, max_backtracks=max_backtracks)
    j = np.asarray(jax_lbfgs(c, q, v, 0.0, 1.0, first_step_scale, **kw))
    t = tlbfgs.lbfgs_box_batch(torch.from_numpy(c), torch.from_numpy(q),
                               torch.from_numpy(v), 0.0, 1.0, first_step_scale, **kw)
    np.testing.assert_allclose(t.numpy(), j, atol=BFGS_TOL)
    assert t.min() >= 0.0 and t.max() <= 1.0


def test_lbfgs_objective_is_q_x_not_c_q():
    """An asymmetric Q: the port's L-BFGS follows Q x + V, as the JAX
    module does, and c Q + V would lead it elsewhere."""
    c, q, v = _problem(*FIXTURES["asymmetric_n12_b32"])
    kw = dict(max_iter=10)
    j = np.asarray(jax_lbfgs(c, q, v, **kw))
    t = tlbfgs.lbfgs_box_batch(torch.from_numpy(c), torch.from_numpy(q),
                               torch.from_numpy(v), **kw).numpy()
    transposed = tlbfgs.lbfgs_box_batch(torch.from_numpy(c), torch.from_numpy(q.T.copy()),
                                        torch.from_numpy(v), **kw).numpy()
    np.testing.assert_allclose(t, j, atol=BFGS_TOL)
    assert np.abs(transposed - j).max() > 1e-2


def test_early_stop_backtracking_equals_the_masked_one():
    """The production backtracking (stops once no row is left) and the
    race's masked variant (every trial, no sync) give the same rows bit for
    bit, and the early stop runs fewer trials."""
    c, q, v = (torch.from_numpy(x) for x in _problem(*FIXTURES["n12_b32"]))
    for label, fn in lbfgs_race.workloads(c, q, v).items():
        counted = lbfgs_race.Counted()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tlbfgs, "_step_length", counted)
            stopped = fn()
            mp.setattr(tlbfgs, "_step_length", lbfgs_race.Masked())
            masked = fn()
        assert torch.equal(stopped, masked) and torch.equal(stopped, fn()), label
        iterations = 50 if label.startswith("bfgs") else 1
        assert 0 < counted.trials < 25 * iterations, label


def test_lbfgs_race_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        lbfgs_race.race("cuda", batch=8, rounds=1)


@pytest.mark.parametrize("method", METHODS)
def test_factory_creates_every_method(method):
    for name in (method, method.upper()):
        pp = tpp.PostProcessorFactory.create_postprocessor(name)
        assert type(pp) is CLASSES[method]
        assert type(jpp.PostProcessorFactory.create_postprocessor(name)).__name__ == \
            CLASSES[method].__name__
    with pytest.raises(AssertionError, match="not valid"):
        tpp.PostProcessorFactory.create_postprocessor("magic")


def test_exports_match_the_jax_package():
    assert tpp.__all__ == jpp.__all__
    for name in ("PostProcessorAdam", "PostProcessorASGD", "PostProcessorLBFGS"):
        assert getattr(tpp, name)().method_type.value == \
            getattr(jpp, name)().method_type.value


@pytest.mark.parametrize("bad", ["c", "q_matrix", "v_vector"])
@pytest.mark.parametrize("method", METHODS)
def test_type_guards(method, bad):
    args = dict(zip(("c", "q_matrix", "v_vector"), _problem(*FIXTURES["n8_b16"])))
    args[bad] = args[bad].tolist()
    with pytest.raises(TypeError, match=f"parameter {bad} must be a tensor"):
        tpp.PostProcessorFactory.create_postprocessor(method).postprocess(**args)


@pytest.mark.parametrize("method", METHODS)
def test_ndarrays_in_tensors_out_and_pp_time(method):
    c, q, v = _problem(*FIXTURES["n8_b16"])
    pp = tpp.PostProcessorFactory.create_postprocessor(method)
    out = pp.postprocess(c, q, v)
    ref = tpp.PostProcessorFactory.create_postprocessor(method).postprocess(
        torch.from_numpy(c), torch.from_numpy(q), torch.from_numpy(v))
    assert out.device == torch.device("cpu") and torch.equal(out, ref)
    assert torch.isfinite(out).all() and pp.pp_time > 0


@pytest.mark.parametrize("name", ["PostProcessorAdam", "PostProcessorASGD"])
def test_device_argument_is_ignored(name):
    c, q, v = (torch.from_numpy(x) for x in _problem(*FIXTURES["n8_b16"]))
    a = getattr(tpp, name)().postprocess(c, q, v, num_iter=3)
    b = getattr(tpp, name)().postprocess(c, q, v, num_iter=3, device="cuda")
    assert torch.equal(a, b)


def test_bfgs_never_raises_the_energy(problem):
    c, q, v = problem
    c_in = 2 * c - 1  # bfgs maps through 0.5 (c + 1)
    out = tpp.PostProcessorBFGS().postprocess(c_in, q, v).numpy()

    def energy(x):
        x = x.astype(np.float64)
        return 0.5 * np.einsum("bi,ij,bj->b", x, q, x) + x @ v

    e_in, e_out = energy(0.5 * (c_in + 1)), energy(0.5 * (out + 1))
    assert np.all(e_out <= e_in + 1e-5)
    assert np.any(e_out < e_in - 1e-3)


def test_func_post_and_jac_match_jax():
    c, q, v = _problem(*FIXTURES["asymmetric_n12_b32"])
    t, j = tpp.PostProcessorBFGS(), jpp.PostProcessorBFGS()
    for row in c[:4]:
        assert t.func_post(row, q, v) == pytest.approx(j.func_post(row, q, v),
                                                       rel=1e-12)
        np.testing.assert_array_equal(t.func_post_jac(row, q, v),
                                      j.func_post_jac(row, q, v))
        np.testing.assert_allclose(t.func_post_jac(row, q, v), q @ row + v, rtol=1e-5)
