"""Pumped Langevin dynamics for BoxQP, in PyTorch.

SDE (reference ``pumped_langevin_solver.py:95-147``, ``:232-309``; JAX
``ccvm_tpu/dynamics/pumped_langevin.py``):

    p(i)   = pump * (i + 1) / T                (or the constant pump)
    scale  = (u - l) / (2 S);  x = c * scale + (u + l) / 2
    grads  = -(x @ Q) * scale - V * scale
    drift  = (-1 + p(i) - c^2) c + fs * grads
    c     += dt * drift + (sigma * sqrt(dt)) * w,   w ~ N(0, 1)
    c      = clip(c, -S, S)                     (every step)

``grads`` is ``-mv * scale - V * scale``, not Langevin's
``-(mv + V) * scale``; the two round differently.  In the Adam variant only
the feedback gradient goes through Adam; the pump drift stays physical.
``T`` is ``params.iterations`` as a float, not the loop bound.

The operation order is the fused kernel's (``pallas_kernels.py:680-688``,
``:790-799``); scalars are float32 0-dim tensors on the state's device, and
the step functions take the standard-normal draw ``w`` as an argument.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics.common import AdamHyperparameters
from ccvm_tpu_torch.dynamics.langevin import matvec_input


class PumpedLangevinParams(NamedTuple):
    """Per-solve parameters (``pumped_langevin_solver.py:74-93``), each a
    Python float holding a float32 value; ``S`` may be a tuple of them, one
    a column, or a (batch, n) float32 tensor."""

    pump: float
    S: float
    dt: float
    sigma: float
    feedback_scale: float
    lower_limit: float
    upper_limit: float
    iterations: float  # total T, used by the pump schedule


def grads_boxqp(c, q_matrix, v_vector, lower_limit=0, upper_limit=1, S=1,
                matvec=None):
    """Feedback gradient (``pumped_langevin_solver.py:118-147``); ``matvec``
    selects the x @ Q implementation (dense, or
    :func:`ccvm_tpu_torch.dynamics.common.tp_matvec`; None: ``dense_matvec``,
    looked up at the call, where ``tools/tc_model.py`` patches it)."""
    matvec = matvec or common.dense_matvec
    scale = (upper_limit - lower_limit) / (2 * S)
    qx = matvec(matvec_input(c, S, lower_limit, upper_limit), q_matrix)
    return -qx * scale - v_vector * scale


def pump_field(p: PumpedLangevinParams, i, pump_rate_flag: bool):
    """p(i) = pump (i+1) / T when rate-scaled, else pump
    (``pumped_langevin_solver.py:279-282``); ``p`` holds float32 0-dim
    tensors."""
    if not pump_rate_flag:
        return p.pump
    fi1 = torch.full((), float(i) + 1.0, dtype=torch.float32,
                     device=p.pump.device)
    return p.pump * fi1 / p.iterations


def _grads(p, q_matrix, v_vector, c, matvec):
    return grads_boxqp(c, q_matrix, v_vector, p.lower_limit, p.upper_limit, p.S,
                       matvec)


def _pump_drift(p, i, pump_rate_flag, c):
    """(-1 + p(i) - c^2) c."""
    return (-1.0 + pump_field(p, i, pump_rate_flag) - torch.square(c)) * c


def make_step(q_matrix, v_vector, p: PumpedLangevinParams, pump_rate_flag: bool,
              matvec=None):
    """``step(c, i, w) -> c``; ``w`` is a standard-normal draw shaped like
    ``c``; ``matvec`` as :func:`grads_boxqp`'s."""
    p = common.float32_scalars(p, q_matrix.device)
    diffusion = p.sigma * torch.sqrt(p.dt)

    def step(c, i, w):
        drift = (_pump_drift(p, i, pump_rate_flag, c)
                 + p.feedback_scale * _grads(p, q_matrix, v_vector, c, matvec))
        c = c + p.dt * drift + diffusion * w
        return torch.clamp(c, -p.S, p.S)

    return step


def make_adam_step(q_matrix, v_vector, p: PumpedLangevinParams,
                   pump_rate_flag: bool, hp: AdamHyperparameters,
                   matvec=None):
    """Adam variant (``pumped_langevin_solver.py:311-449``):
    ``step((c, m, v), i, w) -> (c, m, v)``."""
    p = common.float32_scalars(p, q_matrix.device)
    diffusion = p.sigma * torch.sqrt(p.dt)

    def step(state, i, w):
        c, m, v = state
        grads, m, v = common.adam_moment_update(
            _grads(p, q_matrix, v_vector, c, matvec), m, v, i, hp)
        c_pump = _pump_drift(p, i, pump_rate_flag, c)
        c = c + p.dt * (c_pump + p.feedback_scale * grads) + diffusion * w
        return (torch.clamp(c, -p.S, p.S), m, v)

    return step


def advance(q_matrix, v_vector, params, state, start, num, *, pump_rate_flag=True,
            hp=None, draw=None):
    """Steps ``start`` to ``start + num - 1`` from ``state`` (c, or with
    Adam (c, m, v)); the JAX ``dynamics/pumped_langevin.py`` ``solve_segment``.

    ``q_matrix`` is (n, n) or a stack (I, n, n) with ``v_vector`` (I, 1, n).
    ``draw(i)`` gives step ``i``'s standard-normal draw shaped like the
    state; ``None`` integrates without noise."""
    if hp is None:
        step = make_step(q_matrix, v_vector, params, pump_rate_flag)
    else:
        step = make_adam_step(q_matrix, v_vector, params, pump_rate_flag, hp)
    zeros = torch.zeros_like(state if hp is None else state[0])
    for i in range(int(start), int(start) + int(num)):
        state = step(state, i, zeros if draw is None else draw(i))
    return state


def solve(q_matrix, v_vector, params, *, iterations, batch_size,
          pump_rate_flag=True, hp=None, draw=None):
    """Plain solve (JAX ``dynamics/pumped_langevin.py`` ``solve``) from
    c = 0; returns the final c; the arguments as :func:`advance`'s."""
    n = q_matrix.shape[-1]
    shape = tuple(q_matrix.shape[:-2]) + (int(batch_size), n)
    c0 = torch.zeros(shape, dtype=torch.float32, device=q_matrix.device)
    state = advance(q_matrix, v_vector, params, c0 if hp is None else (c0, c0, c0),
                    0, iterations, pump_rate_flag=pump_rate_flag, hp=hp, draw=draw)
    return state if hp is None else state[0]
