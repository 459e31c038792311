"""MF-CCVM (measurement-feedback) dynamics for BoxQP, in PyTorch.

Mean-field SDE over (mu, sigma) with a measured field mu_tilde (reference
``mf_solver.py:141-198``, ``:493-593``; JAX ``ccvm_tpu/dynamics/mf.py``):

    j_i       = j * exp(-3 (i+1)/T)
    W         ~ N(0,1);  w_inc = W / sqrt(dt)          (note the division!)
    mu_tilde  = mu + sqrt(1/(4 j_i)) * w_inc;  mu_tilde_c = clip(mu_tilde,+-S)
    pump_inst = pump * rate + 1 + j_i,  rate = (i+1)/T (or 1)
    drift_mu  = (-(1+j_i) + pump_inst - g^2 mu^2) mu
                + fs * ( -(1/4) ((mu_tilde_c*(u-l)/S + (u+l)) @ Q) (u-l)/S
                         - V (u-l)/(2S) )
    drift_sig = 2(-(1+j_i) + pump_inst - 3 g^2 mu^2) sigma
                - 2 j_i (sigma - 1/2)^2 + (1+j_i) + 2 g^2 mu^2
    mu       += dt * (drift_mu + sqrt(j_i)(sigma - 1/2) w_inc)
    sigma    += dt * drift_sig

The *same* Wiener draw feeds both the measured field and the mu diffusion in
one iteration, and the readout is the mu_tilde of the **last** iteration
(computed from the pre-update mu), clamped to +-S only after the loop.

All scalar arithmetic runs on float32 0-dim tensors on the state's device,
so the plain solve rounds as the CUDA kernel does.  The step functions take
the standard-normal draw ``w`` as an argument.  ``S`` is a scalar, one
value a column (the JAX façades' 1-D S, broadcast over the batch) or a
(batch, n) tensor, one an element (broadcast over a stack's instances).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics.common import AdamHyperparameters

# Reference _MF_SAFETY_BOUND (pallas_kernels.py:259-271): the kernel clips mu
# here every step, far above any physical amplitude.  The JAX lax path has no
# such clip.
MF_SAFETY_BOUND = 1.0e5


class MFParams(NamedTuple):
    """Per-solve parameters (``mf_solver.py:120-139`` + call args), each a
    Python float holding a float32 value; ``S`` may be a tuple of them, one
    a column, or a (batch, n) float32 tensor."""

    pump: float
    S: float
    dt: float
    j: float
    feedback_scale: float
    g: float
    lower_limit: float
    upper_limit: float
    iterations: float


def matvec_input(mu_tilde_c, S, lower_limit, upper_limit):
    """x = mu_tilde_c (u - l) / S + (u + l), the matvec's input."""
    return mu_tilde_c * (upper_limit - lower_limit) / S + (upper_limit + lower_limit)


def feedback_terms(mu_tilde_c, q_matrix, v_vector, S, lower_limit, upper_limit,
                   matvec=None):
    """fs-independent feedback terms (``mf_solver.py:176-189``); ``matvec``
    selects the x @ Q implementation (dense, or
    :func:`ccvm_tpu_torch.dynamics.common.tp_matvec`; None: ``dense_matvec``,
    looked up at the call, where ``tools/tc_model.py`` patches it)."""
    matvec = matvec or common.dense_matvec
    span = upper_limit - lower_limit
    qx = matvec(matvec_input(mu_tilde_c, S, lower_limit, upper_limit), q_matrix)
    term2_1 = -0.25 * qx * span / S
    term2_2 = -v_vector * span / (2 * S)
    return term2_1 + term2_2


def _physical_drift(mu, sigma, pump, j, g):
    """The pump and measurement terms: mu's ``(-(1+j) + pump - g^2 mu^2) mu``
    and the whole drift of sigma (``mf_solver.py:141-198``)."""
    mu_pow = torch.square(mu)
    mu_term1 = (-(1 + j) + pump - g**2 * mu_pow) * mu
    sigma_term1 = 2 * (-(1 + j) + pump - 3 * g**2 * mu_pow) * sigma
    sigma_term2 = -2 * j * torch.square(sigma - 0.5)
    sigma_term3 = (1 + j) + 2 * g**2 * mu_pow
    return mu_term1, sigma_term1 + sigma_term2 + sigma_term3


def drift_boxqp(
    mu, mu_tilde, sigma, pump, j, g, S, fs, q_matrix, v_vector,
    lower_limit=0, upper_limit=1, matvec=None,
):
    """Drift of mu and sigma (``mf_solver.py:141-198``).  ``pump`` here is
    the instantaneous pump."""
    mu_term1, drift_sigma = _physical_drift(mu, sigma, pump, j, g)
    fb = feedback_terms(mu_tilde, q_matrix, v_vector, S, lower_limit, upper_limit,
                        matvec)
    return mu_term1 + fs * fb, drift_sigma


def grads_boxqp(mu_tilde, S, fs, q_matrix, v_vector, lower_limit=0,
                upper_limit=1, matvec=None):
    """Feedback-only gradient for the Adam path (``mf_solver.py:200-233``)."""
    return fs * feedback_terms(
        mu_tilde, q_matrix, v_vector, S, lower_limit, upper_limit, matvec
    )


def _fi1(p, i):
    """(i + 1) as a float32 tensor, as the kernel's schedules use it."""
    return torch.full((), float(i) + 1.0, dtype=torch.float32,
                      device=p.iterations.device)


def measurement_strength(p, i):
    """j_i = j e^{-3(i+1)/T} (``mf_solver.py:550``)."""
    return p.j * torch.exp(-_fi1(p, i) / p.iterations * 3.0)


def _rate(p, i, pump_rate_flag: bool):
    if not pump_rate_flag:
        return torch.ones((), dtype=torch.float32, device=p.iterations.device)
    return _fi1(p, i) / p.iterations


def _measure(p, i, mu, w, sqrt_dt, pump_rate_flag):
    """The step's j_i, w_inc, mu_tilde, its clamp and the pump."""
    j_i = measurement_strength(p, i)
    w_inc = w / sqrt_dt
    mu_tilde = mu + torch.sqrt(1.0 / (4.0 * j_i)) * w_inc
    mu_tilde_c = torch.clamp(mu_tilde, -p.S, p.S)
    pump_inst = p.pump * _rate(p, i, pump_rate_flag) + 1.0 + j_i
    return j_i, w_inc, mu_tilde, mu_tilde_c, pump_inst


def make_step(q_matrix, v_vector, p: MFParams, pump_rate_flag: bool,
              matvec=None):
    """``step((mu, sigma, mu_tilde), i, w) -> (mu, sigma, mu_tilde)``; ``w``
    is a standard-normal draw shaped like the state; ``matvec`` as
    :func:`feedback_terms`'."""
    p = common.float32_scalars(p, q_matrix.device)
    sqrt_dt = torch.sqrt(p.dt)

    def step(state, i, w):
        mu, sigma, _ = state
        j_i, w_inc, mu_tilde, mu_tilde_c, pump_inst = _measure(
            p, i, mu, w, sqrt_dt, pump_rate_flag
        )
        drift_mu, drift_sigma = drift_boxqp(
            mu, mu_tilde_c, sigma, pump_inst, j_i, p.g, p.S, p.feedback_scale,
            q_matrix, v_vector, p.lower_limit, p.upper_limit, matvec,
        )
        mu_diffusion = torch.sqrt(j_i) * (sigma - 0.5) * w_inc
        mu = mu + p.dt * (drift_mu + mu_diffusion)
        sigma = sigma + p.dt * drift_sigma
        return (mu, sigma, mu_tilde)

    return step


def make_adam_step(
    q_matrix, v_vector, p: MFParams, pump_rate_flag: bool, hp: AdamHyperparameters,
    matvec=None,
):
    """Adam variant (``mf_solver.py:595-764``): Adam filters the fs-scaled
    feedback only.  State is ``(mu, sigma, mu_tilde, m_mu, v_mu)``."""
    p = common.float32_scalars(p, q_matrix.device)
    sqrt_dt = torch.sqrt(p.dt)

    def step(state, i, w):
        mu, sigma, _, m_mu, v_mu = state
        j_i, w_inc, mu_tilde, mu_tilde_c, pump_inst = _measure(
            p, i, mu, w, sqrt_dt, pump_rate_flag
        )
        grads_mu = grads_boxqp(
            mu_tilde_c, p.S, p.feedback_scale, q_matrix, v_vector,
            p.lower_limit, p.upper_limit, matvec,
        )
        grads_mu, m_mu, v_mu = common.adam_moment_update(grads_mu, m_mu, v_mu, i, hp)
        mu_drift, sigma_drift = _physical_drift(mu, sigma, pump_inst, j_i, p.g)
        mu_drift = mu_drift + torch.sqrt(j_i) * (sigma - 0.5) * w_inc
        new_mu = mu + p.dt * (grads_mu + mu_drift)
        sigma = sigma + p.dt * sigma_drift
        return (new_mu, sigma, mu_tilde, m_mu, v_mu)

    return step


def initial_state(shape, device, hp=None):
    """The solve's first state (``mf.py:171-174`` of the JAX package):
    ``(mu, sigma, mu_tilde)`` = (0, 0.5, 0), and with Adam its two
    moments (0)."""
    mu0 = torch.zeros(shape, dtype=torch.float32, device=device)
    return (mu0, torch.full_like(mu0, 0.5), mu0) + ((mu0, mu0) if hp is not None else ())


def advance(q_matrix, v_vector, params: MFParams, state, start, num, *,
            pump_rate_flag=True, hp=None, draw=None):
    """Steps ``start`` to ``start + num - 1`` from ``state`` (JAX
    ``dynamics/mf.py`` ``solve_segment``); returns the whole state,
    ``mu_tilde`` the last step's, unclamped.

    ``q_matrix`` is (n, n) or a stack (I, n, n) with ``v_vector`` (I, 1, n).
    ``draw(i)`` gives step ``i``'s standard-normal draw shaped like the
    state; ``None`` integrates without noise.  mu is clipped at
    ``MF_SAFETY_BOUND`` every step, as the kernel does."""
    if hp is None:
        step = make_step(q_matrix, v_vector, params, pump_rate_flag)
    else:
        step = make_adam_step(q_matrix, v_vector, params, pump_rate_flag, hp)
    zeros = torch.zeros_like(state[0])
    for i in range(int(start), int(start) + int(num)):
        state = step(state, i, zeros if draw is None else draw(i))
        state = (state[0].clamp(-MF_SAFETY_BOUND, MF_SAFETY_BOUND),) + state[1:]
    return state


def clamp_readout(mu_tilde, params: MFParams):
    """The readout mu_tilde clamped to +-S (the one, one a column or one an
    element)."""
    S = common.saturation_tensor(params.S, mu_tilde.device)
    return torch.clamp(mu_tilde, -S, S)


def solve(q_matrix, v_vector, params: MFParams, *, iterations, batch_size,
          pump_rate_flag=True, hp=None, draw=None):
    """Plain MF-CCVM solve (JAX ``dynamics/mf.py`` ``solve``); returns
    ``(mu, mu_tilde clamped to +-S, sigma)``; the arguments as
    :func:`advance`'s."""
    n = q_matrix.shape[-1]
    shape = tuple(q_matrix.shape[:-2]) + (int(batch_size), n)
    state = advance(q_matrix, v_vector, params,
                    initial_state(shape, q_matrix.device, hp), 0, iterations,
                    pump_rate_flag=pump_rate_flag, hp=hp, draw=draw)
    return state[0], clamp_readout(state[2], params), state[1]
