"""The port's MF dynamics and plain solve against the JAX package (CPU).

Noise off, ``mf_solve_reference`` must match both the JAX lax oracle
(``mfdyn.solve`` with ``common.normal`` patched to zeros) and the Pallas
kernel in interpret mode to atol 1e-5 — the tolerance, parameters and
method of ``tests/unit/test_pallas_kernels.py:109-129`` and ``:372-398``.
Noise on, the JAX step functions and the port's are fed the same numpy
Wiener draws step by step, to the same tolerance.
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvm_tpu.dynamics import common as jcommon
from ccvm_tpu.dynamics import mf as jmf
from ccvm_tpu.ops import pallas_kernels as pk
from ccvm_tpu_torch import interop
from ccvm_tpu_torch.dynamics import mf as tmf
from ccvm_tpu_torch.ops.mf_kernels import mf_solve_reference

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


def _params(pump=0.0, iterations=ITERS):
    return jmf.MFParams(
        pump=jnp.float32(pump), S=jnp.float32(20.0), dt=jnp.float32(0.0025),
        j=jnp.float32(5.0), feedback_scale=jnp.float32(4000.0),
        g=jnp.float32(0.001), lower_limit=jnp.float32(0.0),
        upper_limit=jnp.float32(1.0), iterations=jnp.float32(iterations),
    )


def _port_params(p):
    return interop.mf_params_from_numpy(
        **{k: np.asarray(v) for k, v in p._asdict().items()}
    )


def _zeros_normal(key, shape, dtype=jnp.float32):
    return jnp.zeros(shape, dtype)


def _noise_off_case(problem, pump, pump_rate_flag, hp):
    q, v = problem
    p = _params(pump)
    key = jax.random.PRNGKey(0)
    with mock.patch.object(jcommon, "normal", _zeros_normal):
        lax = jmf.solve(
            key, jnp.asarray(q), jnp.asarray(v), p, iterations=ITERS,
            batch_size=BATCH, pump_rate_flag=pump_rate_flag, hp=hp,
        )
    pallas = pk.mf_solve(
        key, jnp.asarray(q), jnp.asarray(v), p, iterations=ITERS,
        batch_size=BATCH, pump_rate_flag=pump_rate_flag, interpret=True,
        noise_scale=0.0, hp=hp,
    )
    port_hp = None if hp is None else interop.adam_from_numpy(*hp)
    port = mf_solve_reference(
        0, torch.from_numpy(q), torch.from_numpy(v), _port_params(p),
        iterations=ITERS, batch_size=BATCH, pump_rate_flag=pump_rate_flag,
        noise_scale=0.0, hp=port_hp,
    )
    for ref in (lax, pallas):
        for t_arr, j_arr in zip(port, ref):  # mu, mu_tilde, sigma
            np.testing.assert_allclose(t_arr.numpy(), np.asarray(j_arr), atol=TOL)


@pytest.mark.parametrize("pump", [0.0, 2.0])
@pytest.mark.parametrize("pump_rate_flag", [True, False])
def test_plain_solve_matches_lax_and_pallas_noise_off(problem, pump, pump_rate_flag):
    _noise_off_case(problem, pump, pump_rate_flag, None)


@pytest.mark.parametrize(
    "beta2,add_assign", [(0.99, False), (1.0, False), (0.99, True)]
)
def test_adam_plain_solve_matches_lax_and_pallas_noise_off(problem, beta2, add_assign):
    hp = jcommon.AdamHyperparameters(
        alpha=0.1, beta1=0.9, beta2=beta2, add_assign=add_assign
    )
    _noise_off_case(problem, 0.0, True, hp)


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("pump_rate_flag", [True, False])
def test_steps_match_jax_steps_with_the_same_noise(problem, adam, pump_rate_flag):
    q, v = problem
    p = _params(2.0, NOISY_STEPS)
    draws = np.random.RandomState(1).randn(NOISY_STEPS, BATCH, N).astype(np.float32)
    mu0 = np.zeros((BATCH, N), np.float32)
    zeros = (mu0, np.full_like(mu0, 0.5), mu0)
    if adam:
        hp = jcommon.AdamHyperparameters(0.1, 0.9, 0.999, True)
        j_step = jmf.make_adam_step(jnp.asarray(q), jnp.asarray(v), p,
                                    pump_rate_flag, hp)
        t_step = tmf.make_adam_step(torch.from_numpy(q), torch.from_numpy(v),
                                    _port_params(p), pump_rate_flag,
                                    interop.adam_from_numpy(*hp))
        zeros = zeros + (mu0, mu0)
    else:
        j_step = jmf.make_step(jnp.asarray(q), jnp.asarray(v), p, pump_rate_flag)
        t_step = tmf.make_step(torch.from_numpy(q), torch.from_numpy(v),
                               _port_params(p), pump_rate_flag)
    j_state = tuple(jnp.asarray(z) for z in zeros)
    t_state = tuple(torch.from_numpy(z) for z in zeros)
    for i in range(NOISY_STEPS):
        w = jnp.asarray(draws[i])
        with mock.patch.object(jcommon, "normal",
                               lambda key, shape, dtype=jnp.float32: w):
            j_state = j_step(j_state, jnp.int32(i), jax.random.PRNGKey(i))
        t_state = t_step(t_state, i, torch.from_numpy(draws[i]))
    # mu, sigma, mu_tilde (and the Adam moments)
    for j_arr, t_arr in zip(j_state, t_state):
        np.testing.assert_allclose(t_arr.numpy(), np.asarray(j_arr), atol=TOL)


def test_solve_applies_the_safety_clip_and_the_final_clamp(problem, monkeypatch):
    """``MF_SAFETY_BOUND`` clips mu every step, as the kernel does; mu_tilde
    is clamped to +-S only after the loop."""
    q, v = problem
    p = tmf.MFParams(0.0, 0.5, 0.0025, 5.0, 4000.0, 0.001, 0.0, 1.0, 20.0)
    kw = dict(iterations=20, batch_size=BATCH)
    mu, mt, _ = tmf.solve(torch.from_numpy(q), torch.from_numpy(v), p, **kw)
    assert mu.abs().max().item() > 0.5 >= mt.abs().max().item()
    monkeypatch.setattr(tmf, "MF_SAFETY_BOUND", 0.25)
    mu_c, _, _ = tmf.solve(torch.from_numpy(q), torch.from_numpy(v), p, **kw)
    assert mu_c.abs().max().item() <= 0.25


@pytest.mark.parametrize("adam", [False, True])
def test_stacked_reference_equals_serial_solves_with_seed_plus_instance(adam):
    rng = np.random.RandomState(5)
    a = rng.randn(2, 10, 10).astype(np.float32)
    q = torch.from_numpy((a + a.transpose(0, 2, 1)) / 2)
    v = torch.from_numpy(rng.randn(2, 10).astype(np.float32))
    p = tmf.MFParams(0.5, 20.0, 0.0025, 5.0, 400.0, 0.01, 0.0, 1.0, 40.0)
    hp = interop.adam_from_numpy(0.1, 0.9, 0.999, True) if adam else None
    kw = dict(iterations=40, batch_size=12, pump_rate_flag=True, hp=hp)
    stacked = mf_solve_reference(7, q, v, p, **kw)
    for i in range(2):
        serial = mf_solve_reference(7 + i, q[i], v[i], p, **kw)
        assert all(torch.equal(a[i], b) for a, b in zip(stacked, serial))
