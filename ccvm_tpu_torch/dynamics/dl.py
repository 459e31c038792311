"""DL-CCVM (delay-line) dynamics for BoxQP, in PyTorch.

Two-quadrature pump-saturated SDE (reference ``dl_solver.py:117-172``,
``:468-569``):
    rate        = (i+1)/T  (or 1)
    nr_i        = (noise_ratio - 1) * exp(-3 (i+1)/T) + 1
    S_d         = sqrt(pump - 1) if pump > 1 else S      (drift-only override!)
    c_grad_1    = 0.25 * ((c*(u-l)/S_d + (u+l)) @ Q) * (u-l)/S_d
    c_grad_2    = (-1 + pump*rate - c^2 - s^2) * c
    c_grad_3    = V * (u-l) / (2 S_d)
    fs_dyn      = feedback_scale * (0.5 + rate)
    c_drift     = -fs_dyn * (c_grad_1 + c_grad_3) + c_grad_2
    s_drift     = likewise with (-1 - pump*rate - ...) * s
    diff        = 2 g sqrt(c^2 + s^2 + 0.5)
    c          += dt*c_drift + diff * sqrt(dt)*nr_i * w_c
    s          += dt*s_drift + diff * sqrt(dt)/nr_i * w_s
Final c is clamped to the *original* +-S only after the loop (``:567``).

``S`` is a scalar, one value a column (the JAX façades' 1-D S, broadcast
over the batch) or a (batch, n) tensor, one an element; the pump ramp generalises to rate(i) = min((i+1)/T /
fraction, 1)^power (the JAX ``pump_ramp``, ``ccvm_tpu/dynamics/dl.py``).

All scalar arithmetic runs on float32 0-dim tensors on the state's device,
so the plain solve rounds as the CUDA kernel does.  The step functions take
the two standard-normal draws ``w_c, w_s`` as arguments.  The Adam variant
follows ``dl_solver.py:571-769``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics.common import AdamHyperparameters


class DLParams(NamedTuple):
    """Per-solve parameters (``dl_solver.py:96-115`` + call args), each a
    Python float holding a float32 value; ``S`` may be a tuple of them, one
    a column, or a (batch, n) float32 tensor.  ``ramp_power`` / ``ramp_fraction`` (both None: the
    reference's linear ramp) are the JAX ``DLParams``' generalised ramp."""

    pump: float
    S: float  # user-facing saturation (clamp / change of variables)
    dt: float
    noise_ratio: float
    feedback_scale: float
    g: float
    lower_limit: float
    upper_limit: float
    iterations: float
    ramp_power: float | None = None
    ramp_fraction: float | None = None


def _scalars(p: DLParams, device) -> DLParams:
    """DLParams as float32 tensors on one device (unset ramp fields None)."""
    return common.float32_scalars(p, device)


def drift_saturation(p, pump_is_gt_one: bool):
    """The drift-internal saturation override S_d (``dl_solver.py:140-141``).

    ``pump > 1`` is a host-side decision in the reference, so it is a static
    choice here as well.  ``p`` holds float32 tensors."""
    if pump_is_gt_one:
        return torch.sqrt(p.pump - 1.0)
    return p.S


def matvec_input(z, S, lower_limit, upper_limit):
    """x = z (u - l) / S + (u + l) of a quadrature z, the matvec's input
    (``S`` the drift's S_d)."""
    return z * (upper_limit - lower_limit) / S + (upper_limit + lower_limit)


def grads_boxqp(c, s, q_matrix, v_vector, lower_limit=0, upper_limit=1, S=1,
                matvec=None):
    """Feedback-only gradients (``dl_solver.py:174-217``)."""
    matvec = matvec or common.dense_matvec
    span = upper_limit - lower_limit

    def one(z):
        x = matvec_input(z, S, lower_limit, upper_limit)
        return 0.25 * matvec(x, q_matrix) * span / S

    g3 = v_vector * span / (2 * S)
    return -one(c) - g3, -one(s) - g3


def drift_boxqp(
    c, s, q_matrix, v_vector, pump, rate, feedback_scale=100,
    lower_limit=0, upper_limit=1, S=1, matvec=None,
):
    """Full drift for both quadratures (``dl_solver.py:117-172``).

    ``S`` here must already be the drift-internal S_d.  ``matvec`` selects
    the x @ Q implementation: dense by default,
    :func:`ccvm_tpu_torch.dynamics.common.tp_matvec` for a model-sharded
    solve (``ccvm_tpu_torch.parallel.tp``); None is
    :func:`ccvm_tpu_torch.dynamics.common.dense_matvec`, looked up at the
    call (``tools/tc_model.py`` patches it).
    """
    matvec = matvec or common.dense_matvec
    span = upper_limit - lower_limit
    c_pow = torch.square(c)
    s_pow = torch.square(s)

    def feedback(z):
        x = matvec_input(z, S, lower_limit, upper_limit)
        return 0.25 * matvec(x, q_matrix) * span / S

    g3 = v_vector * span / (2 * S)
    fs_dyn = feedback_scale * (0.5 + rate)
    c_drift = -fs_dyn * (feedback(c) + g3) + (-1 + pump * rate - c_pow - s_pow) * c
    s_drift = -fs_dyn * (feedback(s) + g3) + (-1 - pump * rate - c_pow - s_pow) * s
    return c_drift, s_drift


def _fi1(p, i):
    """(i + 1) as a float32 tensor: the step index is a float in the
    schedules, as in the kernel."""
    return torch.full((), float(i) + 1.0, dtype=torch.float32,
                      device=p.iterations.device)


def noise_ratio_schedule(p, i):
    """nr_i = (nr-1) e^{-3(i+1)/T} + 1 (``dl_solver.py:527``)."""
    return (p.noise_ratio - 1.0) * torch.exp(-_fi1(p, i) / p.iterations * 3.0) + 1.0


def pump_rate(p, fi1, pump_rate_flag: bool):
    """The pump ramp at (i + 1) = ``fi1`` (a float32 tensor of any shape):
    (i+1)/T (reference ``dl_solver.py:524``), through the generalised
    ramp's min(rate / fraction, 1)^power where those fields are set, with
    the JAX ``pump_rate_schedule``'s float32 operations
    (``ccvm_tpu/dynamics/dl.py:115-130``) but the power, which is taken in
    float64 and rounded to float32: PyTorch's float32 power on the CPU
    rounds differently in its vector loop and its scalar tail, and the
    kernel's step table takes the ramp over every step at once where a
    plain step takes one; rounded from float64 both are the same (and
    within an ulp of the JAX package's float32 power).  1 without the
    flag."""
    if not pump_rate_flag:
        return torch.ones_like(fi1)
    rate = fi1 / p.iterations
    if p.ramp_fraction is not None:
        rate = torch.minimum(rate / p.ramp_fraction, torch.ones_like(rate))
    if p.ramp_power is not None:
        rate = torch.pow(rate.double(), p.ramp_power.double()).float()
    return rate


def pump_rate_schedule(p, i, pump_rate_flag: bool):
    """rate(i) of step ``i`` (:func:`pump_rate`)."""
    return pump_rate(p, _fi1(p, i), pump_rate_flag)


def make_step(
    q_matrix, v_vector, p: DLParams, pump_rate_flag: bool, pump_is_gt_one: bool,
    matvec=None,
):
    """``step((c, s), i, w_c, w_s) -> (c, s)``; ``w_c``, ``w_s`` are
    standard-normal draws shaped like the state; ``matvec`` as
    :func:`drift_boxqp`'s."""
    p = _scalars(p, q_matrix.device)
    sqrt_dt = torch.sqrt(p.dt)
    s_drift_sat = drift_saturation(p, pump_is_gt_one)

    def step(state, i, w_c, w_s):
        c, s = state
        rate = pump_rate_schedule(p, i, pump_rate_flag)
        nr_i = noise_ratio_schedule(p, i)
        c_drift, s_drift = drift_boxqp(
            c, s, q_matrix, v_vector, p.pump, rate, p.feedback_scale,
            p.lower_limit, p.upper_limit, s_drift_sat, matvec,
        )
        w_c = w_c * sqrt_dt * nr_i
        w_s = w_s * sqrt_dt / nr_i
        diff = 2.0 * p.g * torch.sqrt(torch.square(c) + torch.square(s) + 0.5)
        c = c + p.dt * c_drift + diff * w_c
        s = s + p.dt * s_drift + diff * w_s
        return (c, s)

    return step


def make_adam_step(
    q_matrix,
    v_vector,
    p: DLParams,
    pump_rate_flag: bool,
    pump_is_gt_one: bool,
    hp: AdamHyperparameters,
    matvec=None,
):
    """Adam variant (``dl_solver.py:571-769``): the feedback gradients are
    Adam-filtered; the pump drift uses pump_rate = pump*(i+1)/T and
    ``feedback_scale`` is unused.  State is ``(c, s, m_c, v_c, m_s, v_s)``."""
    p = _scalars(p, q_matrix.device)
    sqrt_dt = torch.sqrt(p.dt)
    s_grad_sat = drift_saturation(p, pump_is_gt_one)

    def step(state, i, w_c, w_s):
        c, s, m_c, v_c, m_s, v_s = state
        # pump_rate includes the pump amplitude in the Adam path (:627-632)
        pump_rate = p.pump * pump_rate_schedule(p, i, pump_rate_flag)
        nr_i = noise_ratio_schedule(p, i)
        c_grads, s_grads = grads_boxqp(
            c, s, q_matrix, v_vector, p.lower_limit, p.upper_limit, s_grad_sat,
            matvec,
        )
        c_grads, m_c, v_c = common.adam_moment_update(c_grads, m_c, v_c, i, hp)
        s_grads, m_s, v_s = common.adam_moment_update(s_grads, m_s, v_s, i, hp)
        c_pow = torch.square(c)
        s_pow = torch.square(s)
        c_drift = (-1.0 + pump_rate - c_pow - s_pow) * c
        s_drift = (-1.0 - pump_rate - c_pow - s_pow) * s
        w_c = w_c * sqrt_dt * nr_i
        w_s = w_s * sqrt_dt / nr_i
        diff = 2.0 * p.g * torch.sqrt(c_pow + s_pow + 0.5)
        c = c + p.dt * (c_drift + c_grads) + diff * w_c
        s = s + p.dt * (s_drift + s_grads) + diff * w_s
        return (c, s, m_c, v_c, m_s, v_s)

    return step
