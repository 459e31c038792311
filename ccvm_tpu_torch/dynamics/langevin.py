"""Langevin dynamics for BoxQP, in PyTorch.

SDE (reference ``langevin_solver.py:368-435``; JAX
``ccvm_tpu/dynamics/langevin.py``):

    scale  = (u - l) / (2 S);  x = c * scale + (u + l) / 2
    drift  = -((x @ Q) + V) * scale
    c     += dt * fs * drift + (sigma * sqrt(dt)) * w,   w ~ N(0, 1)
    c      = clip(c, -S, S)                              (every step)

The Adam variant (``langevin_solver.py:437-561``) runs the whole drift
through bias-corrected Adam moments before the update.

The operation order is the fused kernel's (``pallas_kernels.py:508-514``),
``(sigma * sqrt(dt)) * w``, not the lax path's ``sigma * (w * sqrt(dt))``;
the two differ by float32 round-off only.  All scalar arithmetic runs on
float32 0-dim tensors on the state's device, so the plain solve rounds as
the CUDA kernel does.  The step functions take the standard-normal draw
``w`` as an argument.  ``S`` is a scalar, one value a column (the JAX
façades' 1-D S, broadcast over the batch) or a (batch, n) tensor, one an
element.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics.common import AdamHyperparameters


class LangevinParams(NamedTuple):
    """Per-solve parameters (reference parameter_key keys
    ``langevin_solver.py:96-115`` plus the box bounds), each a Python float
    holding a float32 value; ``S`` may be a tuple of them, one a column, or
    a (batch, n) float32 tensor."""

    S: float
    dt: float
    sigma: float
    feedback_scale: float
    lower_limit: float
    upper_limit: float


def matvec_input(c, S, lower_limit, upper_limit):
    """x = c (u - l) / (2 S) + (u + l) / 2, the matvec's input (pumped
    Langevin's too)."""
    return c * ((upper_limit - lower_limit) / (2 * S)) + (upper_limit + lower_limit) / 2


def drift_boxqp(c, q_matrix, v_vector, lower_limit=0, upper_limit=1, S=1,
                matvec=None):
    """Langevin drift, which is also its gradient
    (``langevin_solver.py:117-166``).  ``matvec`` selects the x @ Q
    implementation: dense by default,
    :func:`ccvm_tpu_torch.dynamics.common.tp_matvec` for a model-sharded
    solve; None: ``dense_matvec``, looked up at the call, where
    ``tools/tc_model.py`` patches it."""
    matvec = matvec or common.dense_matvec
    scale = (upper_limit - lower_limit) / (2 * S)
    qx = matvec(matvec_input(c, S, lower_limit, upper_limit), q_matrix)
    return -(qx + v_vector) * scale


def _drift(p, q_matrix, v_vector, c, matvec):
    return drift_boxqp(c, q_matrix, v_vector, p.lower_limit, p.upper_limit, p.S,
                       matvec)


def make_step(q_matrix, v_vector, p: LangevinParams, matvec=None):
    """``step(c, i, w) -> c``; ``w`` is a standard-normal draw shaped like
    ``c``; ``matvec`` as :func:`drift_boxqp`'s."""
    p = common.float32_scalars(p, q_matrix.device)
    dt_fs = p.dt * p.feedback_scale
    diffusion = p.sigma * torch.sqrt(p.dt)

    def step(c, i, w):
        c = c + dt_fs * _drift(p, q_matrix, v_vector, c, matvec) + diffusion * w
        return torch.clamp(c, -p.S, p.S)

    return step


def make_adam_step(q_matrix, v_vector, p: LangevinParams, hp: AdamHyperparameters,
                   matvec=None):
    """Adam-filtered step; ``step((c, m, v), i, w) -> (c, m, v)``
    (``langevin_solver.py:437-561``)."""
    p = common.float32_scalars(p, q_matrix.device)
    dt_fs = p.dt * p.feedback_scale
    diffusion = p.sigma * torch.sqrt(p.dt)

    def step(state, i, w):
        c, m, v = state
        grads = _drift(p, q_matrix, v_vector, c, matvec)
        grads, m, v = common.adam_moment_update(grads, m, v, i, hp)
        c = c + dt_fs * grads + diffusion * w
        return (torch.clamp(c, -p.S, p.S), m, v)

    return step


def advance(q_matrix, v_vector, params, state, start, num, *, hp=None,
            draw=None):
    """Steps ``start`` to ``start + num - 1`` from ``state`` (c, or with
    Adam (c, m, v)); the JAX ``dynamics/langevin.py`` ``solve_segment``.

    ``q_matrix`` is (n, n) or a stack (I, n, n) with ``v_vector`` (I, 1, n).
    ``draw(i)`` gives step ``i``'s standard-normal draw shaped like the
    state; ``None`` integrates without noise."""
    if hp is None:
        step = make_step(q_matrix, v_vector, params)
    else:
        step = make_adam_step(q_matrix, v_vector, params, hp)
    zeros = torch.zeros_like(state if hp is None else state[0])
    for i in range(int(start), int(start) + int(num)):
        state = step(state, i, zeros if draw is None else draw(i))
    return state


def solve(q_matrix, v_vector, params, *, iterations, batch_size,
          hp=None, draw=None):
    """Plain solve (JAX ``dynamics/langevin.py`` ``solve``) from c = 0; returns
    the final c; the arguments as :func:`advance`'s."""
    n = q_matrix.shape[-1]
    shape = tuple(q_matrix.shape[:-2]) + (int(batch_size), n)
    c0 = torch.zeros(shape, dtype=torch.float32, device=q_matrix.device)
    state = advance(q_matrix, v_vector, params, c0 if hp is None else (c0, c0, c0),
                    0, iterations, hp=hp, draw=draw)
    return state if hp is None else state[0]
