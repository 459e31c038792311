"""The port's DL dynamics and plain solve against the JAX package (CPU).

Noise off, ``dl_solve_reference`` must match both the JAX lax oracle
(``dldyn.solve`` with ``common.normal`` patched to zeros) and the Pallas
kernel in interpret mode to atol 1e-5 — the tolerance and method of
``tests/unit/test_pallas_kernels.py:84-106``.  Noise on, the JAX step
functions and the port's are fed the same numpy Wiener draws step by step.
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvm_tpu.dynamics import common as jcommon
from ccvm_tpu.dynamics import dl as jdl
from ccvm_tpu.ops import pallas_kernels as pk
from ccvm_tpu_torch import interop
from ccvm_tpu_torch.dynamics import dl as tdl
from ccvm_tpu_torch.ops.dl_kernels import dl_solve_reference

N = 20
BATCH = 16
ITERS = 50
TOL = 1e-5
NOISY_STEPS = 30


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(0)
    a = rng.randn(N, N).astype(np.float32)
    return (a + a.T) / 2, rng.randn(N).astype(np.float32)


def _params(pump, iterations=ITERS):
    return jdl.DLParams(
        pump=jnp.float32(pump), S=jnp.float32(1.0), dt=jnp.float32(0.001),
        noise_ratio=jnp.float32(10.0), feedback_scale=jnp.float32(100.0),
        g=jnp.float32(0.05), lower_limit=jnp.float32(0.0),
        upper_limit=jnp.float32(1.0), iterations=jnp.float32(iterations),
    )


def _port_params(p):
    return interop.dl_params_from_numpy(
        **{k: np.asarray(v) for k, v in p._asdict().items() if v is not None}
    )


def _zeros_normal(key, shape, dtype=jnp.float32):
    return jnp.zeros(shape, dtype)


def _noise_off_case(problem, pump, hp):
    q, v = problem
    p = _params(pump)
    pump_is_gt_one = pump > 1
    key = jax.random.PRNGKey(0)
    with mock.patch.object(jcommon, "normal", _zeros_normal):
        c_lax, s_lax = jdl.solve(
            key, jnp.asarray(q), jnp.asarray(v), p, iterations=ITERS,
            batch_size=BATCH, pump_rate_flag=True,
            pump_is_gt_one=pump_is_gt_one, hp=hp,
        )
    c_pal, s_pal = pk.dl_solve(
        key, jnp.asarray(q), jnp.asarray(v), p, iterations=ITERS,
        batch_size=BATCH, pump_rate_flag=True, pump_is_gt_one=pump_is_gt_one,
        interpret=True, noise_scale=0.0, hp=hp,
    )
    port_hp = None if hp is None else interop.adam_from_numpy(*hp)
    c_t, s_t = dl_solve_reference(
        0, torch.from_numpy(q), torch.from_numpy(v), _port_params(p),
        iterations=ITERS, batch_size=BATCH, pump_rate_flag=True,
        pump_is_gt_one=pump_is_gt_one, noise_scale=0.0, hp=port_hp,
    )
    for ref in (c_lax, c_pal):
        np.testing.assert_allclose(c_t.numpy(), np.asarray(ref), atol=TOL)
    for ref in (s_lax, s_pal):
        np.testing.assert_allclose(s_t.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("pump", [8.0, 0.5])
def test_plain_solve_matches_lax_and_pallas_noise_off(problem, pump):
    _noise_off_case(problem, pump, None)


@pytest.mark.parametrize("beta2", [0.999, 1.0])
@pytest.mark.parametrize("add_assign", [True, False])
def test_adam_plain_solve_matches_lax_and_pallas_noise_off(
    problem, beta2, add_assign
):
    hp = jcommon.AdamHyperparameters(
        alpha=0.05, beta1=0.9, beta2=beta2, add_assign=add_assign
    )
    _noise_off_case(problem, 8.0, hp)


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("pump", [8.0, 0.5])
def test_steps_match_jax_steps_with_the_same_noise(problem, adam, pump):
    q, v = problem
    p = _params(pump, NOISY_STEPS)
    pump_is_gt_one = pump > 1
    rng = np.random.RandomState(1)
    draws = rng.randn(NOISY_STEPS, 2, BATCH, N).astype(np.float32)
    hp = jcommon.AdamHyperparameters(0.05, 0.9, 0.999, True) if adam else None
    if adam:
        j_step = jdl.make_adam_step(jnp.asarray(q), jnp.asarray(v), p, True,
                                    pump_is_gt_one, hp)
        t_step = tdl.make_adam_step(torch.from_numpy(q), torch.from_numpy(v),
                                    _port_params(p), True, pump_is_gt_one,
                                    interop.adam_from_numpy(*hp))
        zeros = (np.zeros((BATCH, N), np.float32),) * 6
    else:
        j_step = jdl.make_step(jnp.asarray(q), jnp.asarray(v), p, True,
                               pump_is_gt_one)
        t_step = tdl.make_step(torch.from_numpy(q), torch.from_numpy(v),
                               _port_params(p), True, pump_is_gt_one)
        zeros = (np.zeros((BATCH, N), np.float32),) * 2
    j_state = tuple(jnp.asarray(z) for z in zeros)
    t_state = tuple(torch.from_numpy(z) for z in zeros)
    for i in range(NOISY_STEPS):
        feed = iter([jnp.asarray(draws[i, 0]), jnp.asarray(draws[i, 1])])
        with mock.patch.object(jcommon, "normal",
                               lambda key, shape, dtype=jnp.float32: next(feed)):
            j_state = j_step(j_state, jnp.int32(i), jax.random.PRNGKey(i))
        t_state = t_step(t_state, i, torch.from_numpy(draws[i, 0]),
                         torch.from_numpy(draws[i, 1]))
    for j_arr, t_arr in zip(j_state, t_state):
        np.testing.assert_allclose(t_arr.numpy(), np.asarray(j_arr), atol=TOL)
