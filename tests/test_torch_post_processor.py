"""The port's grad-descent post-processor and factory against the JAX
package (CPU).

Both refine the same numpy inputs.  Float32 products summed in another
order differ by an ulp or two a step, which up to 25 steps of feedback
carry to ~1e-6 on values clamped to [0, 1]; the tolerance is atol 1e-5, as
in the port's other parity tests.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ccvm_tpu.post_processor import PostProcessorGradDescent as JGradDescent
from ccvm_tpu.post_processor.post_processor import MethodType as JMethodType
from ccvm_tpu_torch.post_processor import (
    MethodType,
    PostProcessorFactory,
    PostProcessorGradDescent,
)

TOL = 1e-5


@pytest.fixture
def problem():
    rng = np.random.RandomState(5)
    n, batch = 12, 32
    a = rng.uniform(-1, 1, (n, n)).astype(np.float32)
    q = (a + a.T) / 2
    q[np.diag_indices(n)] -= n / 2
    v = rng.uniform(-1, 0, n).astype(np.float32)
    c = rng.uniform(0, 1, (batch, n)).astype(np.float32)
    return c, q, v


@pytest.mark.parametrize(
    "kwargs",
    [
        {},  # 1% of the default num_iter_main: 10 steps
        {"num_iter_main": 3000},
        {"num_iter_pp": 25, "step_size": 0.05},
        {"num_iter_pp": 15, "lower_clamp": 0.2, "upper_clamp": 0.8},
    ],
    ids=["default", "one_percent_of_main", "explicit", "clamps"],
)
def test_grad_descent_matches_jax(problem, kwargs):
    c, q, v = problem
    j_out = np.asarray(JGradDescent().postprocess(c, q, v, **kwargs))
    pp = PostProcessorGradDescent()
    t_out = pp.postprocess(torch.from_numpy(c), torch.from_numpy(q),
                           torch.from_numpy(v), **kwargs)
    assert isinstance(t_out, torch.Tensor) and t_out.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=TOL)
    assert not np.allclose(j_out, c)  # the refinement moved the batch
    assert pp.pp_time > 0


def test_grad_descent_takes_ndarrays_and_keeps_the_device(problem):
    c, q, v = problem
    out = PostProcessorGradDescent().postprocess(c, q, v)
    ref = PostProcessorGradDescent().postprocess(
        torch.from_numpy(c), torch.from_numpy(q), torch.from_numpy(v))
    assert out.device == torch.device("cpu")
    assert torch.equal(out, ref)


@pytest.mark.parametrize("bad", ["c", "q_matrix", "v_vector"])
def test_type_guards(problem, bad):
    args = dict(zip(("c", "q_matrix", "v_vector"), problem))
    args[bad] = args[bad].tolist()
    with pytest.raises(TypeError, match=f"parameter {bad} must be a tensor"):
        PostProcessorGradDescent().postprocess(**args)


def test_factory_names_and_errors():
    """Every method of the JAX package's factory is created (the other four
    are held in tests/test_torch_post_processors.py); an unknown name
    raises as there."""
    assert [m.value for m in MethodType] == [m.value for m in JMethodType]
    for name in ("grad-descent", "Grad-Descent"):
        assert isinstance(PostProcessorFactory.create_postprocessor(name),
                          PostProcessorGradDescent)
    for name in ("adam", "asgd", "bfgs", "lbfgs", "BFGS"):
        pp = PostProcessorFactory.create_postprocessor(name)
        assert type(pp).__name__ == {"adam": "PostProcessorAdam",
                                     "asgd": "PostProcessorASGD",
                                     "lbfgs": "PostProcessorLBFGS"}.get(
            name, "PostProcessorBFGS")
    with pytest.raises(AssertionError, match="not valid"):
        PostProcessorFactory.create_postprocessor("magic")
