"""The port's Langevin and pumped-Langevin dynamics and plain solves against
the JAX package (CPU).

Noise off, ``langevin_solve_reference`` and
``pumped_langevin_solve_reference`` must match both the JAX lax oracle
(``lgv.solve`` / ``plgv.solve`` with ``common.normal`` patched to zeros) and
the Pallas kernels in interpret mode to atol 1e-5 — the tolerance,
parameters and method of ``tests/unit/test_pallas_kernels.py:46-80`` and
``:291-370`` (c is clamped to +-0.5, so 1e-5 is ~100 float32 ulps).  Noise
on, the JAX step functions and the port's are fed the same numpy Wiener
draws step by step for 30 steps, to the same tolerance (the lax path scales
the draw as ``sigma * (w * sqrt(dt))``, the port as ``(sigma * sqrt(dt)) *
w``; the two differ by round-off).  A stacked two-instance plain solve
equals serial solves with seeds s and s + 1 bit for bit.
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvm_tpu.dynamics import common as jcommon
from ccvm_tpu.dynamics import langevin as jlgv
from ccvm_tpu.dynamics import pumped_langevin as jplgv
from ccvm_tpu.ops import pallas_kernels as pk
from ccvm_tpu_torch import interop
from ccvm_tpu_torch.dynamics import langevin as tlgv
from ccvm_tpu_torch.dynamics import pumped_langevin as tplgv
from ccvm_tpu_torch.ops.langevin_kernels import (
    langevin_solve_reference, pumped_langevin_solve_reference)

N = 20
BATCH = 16
ITERS = 50
TOL = 1e-5
NOISY_STEPS = 30
ADAM_CASES = [(0.99, False), (1.0, False), (0.99, True)]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(0)
    a = rng.randn(N, N).astype(np.float32)
    return (a + a.T) / 2, rng.randn(N).astype(np.float32)


def _langevin_params():
    return jlgv.LangevinParams(
        S=jnp.float32(0.5), dt=jnp.float32(0.002), sigma=jnp.float32(0.5),
        feedback_scale=jnp.float32(1.0), lower_limit=jnp.float32(0.0),
        upper_limit=jnp.float32(1.0),
    )


def _pumped_params(iterations=ITERS):
    return jplgv.PumpedLangevinParams(
        pump=jnp.float32(2.0), S=jnp.float32(0.5), dt=jnp.float32(0.002),
        sigma=jnp.float32(0.5), feedback_scale=jnp.float32(1.0),
        lower_limit=jnp.float32(0.0), upper_limit=jnp.float32(1.0),
        iterations=jnp.float32(iterations),
    )


def _port_params(p):
    fields = {k: np.asarray(v) for k, v in p._asdict().items()}
    if isinstance(p, jplgv.PumpedLangevinParams):
        return interop.pumped_langevin_params_from_numpy(**fields)
    return interop.langevin_params_from_numpy(**fields)


def _hp(case):
    if case is None:
        return None
    beta2, add_assign = case
    return jcommon.AdamHyperparameters(alpha=0.1, beta1=0.9, beta2=beta2,
                                       add_assign=add_assign)


def _zeros_normal(key, shape, dtype=jnp.float32):
    return jnp.zeros(shape, dtype)


def _noise_off_case(problem, pumped, pump_rate_flag, hp):
    q, v = problem
    key = jax.random.PRNGKey(0)
    kw = dict(iterations=ITERS, batch_size=BATCH, hp=hp)
    if pumped:
        p, jmod, kernel = _pumped_params(), jplgv, pk.pumped_langevin_solve
        kw["pump_rate_flag"] = pump_rate_flag
        plain = pumped_langevin_solve_reference
    else:
        p, jmod, kernel = _langevin_params(), jlgv, pk.langevin_solve
        plain = langevin_solve_reference
    with mock.patch.object(jcommon, "normal", _zeros_normal):
        lax = jmod.solve(key, jnp.asarray(q), jnp.asarray(v), p, **kw)
    pallas = kernel(key, jnp.asarray(q), jnp.asarray(v), p, interpret=True,
                    noise_scale=0.0, **kw)
    kw["hp"] = None if hp is None else interop.adam_from_numpy(*hp)
    port = plain(0, torch.from_numpy(q), torch.from_numpy(v), _port_params(p),
                 noise_scale=0.0, **kw)
    assert port.shape == (BATCH, N) and port.abs().max().item() <= 0.5
    for ref in (lax, pallas):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("adam", [None] + ADAM_CASES)
def test_langevin_plain_solve_matches_lax_and_pallas_noise_off(problem, adam):
    _noise_off_case(problem, False, None, _hp(adam))


@pytest.mark.parametrize("pump_rate_flag", [True, False])
def test_pumped_plain_solve_matches_lax_and_pallas_noise_off(problem, pump_rate_flag):
    _noise_off_case(problem, True, pump_rate_flag, None)


@pytest.mark.parametrize("adam", ADAM_CASES)
def test_pumped_adam_plain_solve_matches_lax_and_pallas_noise_off(problem, adam):
    _noise_off_case(problem, True, True, _hp(adam))


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("pumped", [False, True])
def test_steps_match_jax_steps_with_the_same_noise(problem, pumped, adam):
    q, v = problem
    jq, jv, tq, tv = jnp.asarray(q), jnp.asarray(v), torch.from_numpy(q), torch.from_numpy(v)
    p = _pumped_params(NOISY_STEPS) if pumped else _langevin_params()
    tp = _port_params(p)
    draws = np.random.RandomState(1).randn(NOISY_STEPS, BATCH, N).astype(np.float32)
    c0 = np.zeros((BATCH, N), np.float32)
    hp = _hp((0.999, True)) if adam else None
    flag = (True,) if pumped else ()
    jmod, tmod = (jplgv, tplgv) if pumped else (jlgv, tlgv)
    if adam:
        j_step = jmod.make_adam_step(jq, jv, p, *flag, hp)
        t_step = tmod.make_adam_step(tq, tv, tp, *flag, interop.adam_from_numpy(*hp))
        j_state = tuple(jnp.asarray(c0) for _ in range(3))
        t_state = tuple(torch.from_numpy(c0) for _ in range(3))
    else:
        j_step = jmod.make_step(jq, jv, p, *flag)
        t_step = tmod.make_step(tq, tv, tp, *flag)
        j_state, t_state = jnp.asarray(c0), torch.from_numpy(c0)
    for i in range(NOISY_STEPS):
        w = jnp.asarray(draws[i])
        with mock.patch.object(jcommon, "normal",
                               lambda key, shape, dtype=jnp.float32: w):
            j_state = j_step(j_state, jnp.int32(i), jax.random.PRNGKey(i))
        t_state = t_step(t_state, i, torch.from_numpy(draws[i]))
    if not adam:
        j_state, t_state = (j_state,), (t_state,)
    # c (and the Adam moments); the noise moves c by ~0.02 a step.
    assert np.abs(np.asarray(j_state[0])).max() > 0.05
    for j_arr, t_arr in zip(j_state, t_state):
        np.testing.assert_allclose(t_arr.numpy(), np.asarray(j_arr), atol=TOL)


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("pumped", [False, True])
def test_stacked_reference_equals_serial_solves_with_seed_plus_instance(pumped, adam):
    rng = np.random.RandomState(5)
    a = rng.randn(2, 10, 10).astype(np.float32)
    q = torch.from_numpy((a + a.transpose(0, 2, 1)) / 2)
    v = torch.from_numpy(rng.randn(2, 10).astype(np.float32))
    hp = interop.adam_from_numpy(0.1, 0.9, 0.999, True) if adam else None
    kw = dict(iterations=40, batch_size=12, hp=hp)
    if pumped:
        p = tplgv.PumpedLangevinParams(1.0, 0.5, 0.002, 0.25, 1.0, 0.0, 1.0, 40.0)
        solve = pumped_langevin_solve_reference
        kw["pump_rate_flag"] = True
    else:
        p = tlgv.LangevinParams(0.5, 0.002, 0.5, 2.0, 0.0, 1.0)
        solve = langevin_solve_reference
    stacked = solve(7, q, v, p, **kw)
    assert stacked.shape == (2, 12, 10)
    for i in range(2):
        assert torch.equal(stacked[i], solve(7 + i, q[i], v[i], p, **kw))
