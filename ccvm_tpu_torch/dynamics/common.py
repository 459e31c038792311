"""Shared machinery for the CCVM SDE dynamics (PyTorch).

Each dynamics family is a step function ``step(state, i, w_c, w_s)`` over
float32 tensors, closed over problem data and parameters.  The Wiener draws
are arguments, so a test can feed the JAX package's step functions and these
the same noise.  The plain solve loops over steps in Python
(:func:`ccvm_tpu_torch.ops.dl_kernels.dl_solve_reference`); the hot path is
the whole-solve CUDA kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AdamHyperparameters(NamedTuple):
    """Static Adam hyperparameters (mirrors ``solvers/algorithms.py:1-46``).

    ``beta2 == 1.0`` and ``add_assign`` select different update formulas in
    the reference (``dl_solver.py:644-686``); the CUDA kernel compiles each
    choice as its own specialisation.
    """

    alpha: float
    beta1: float
    beta2: float
    add_assign: bool


def adam_moment_update(grads, m, v, i, hp: AdamHyperparameters):
    """One step of the reference's in-loop Adam filtering.

    Returns the effective (bias-corrected, optionally add-assigned) gradients
    plus updated moments (``langevin_solver.py:513-540``,
    ``dl_solver.py:689-727``): first moment always; second moment only when
    ``beta2 != 1.0``; ``add_assign`` adds the raw gradient back.  ``i`` is the
    step index; the bias correction is ``beta ** (i + 1)`` in float32.
    """
    epsilon = 1e-8
    fi1 = torch.full((), float(i) + 1.0, dtype=torch.float32, device=grads.device)
    m = hp.beta1 * m + (1.0 - hp.beta1) * grads
    beta1i = 1.0 - torch.pow(hp.beta1, fi1)
    mhat = m / beta1i
    if hp.beta2 != 1.0:
        v = hp.beta2 * v + (1.0 - hp.beta2) * torch.square(grads)
        beta2i = 1.0 - torch.pow(hp.beta2, fi1)
        vhat = v / beta2i
        update = hp.alpha * mhat / (torch.sqrt(vhat) + epsilon)
    else:
        update = hp.alpha * mhat
    if hp.add_assign:
        effective = grads + update
    else:
        effective = update
    return effective, m, v


def float32_scalars(p, device):
    """A parameter tuple with each field as a float32 tensor on ``device``:
    0-dim, or for ``S`` (n,) one a column (a tuple of floats, or an array)
    or (batch, n) one an element (a tensor or an array); an unset (None)
    field stays None.  So the plain solves round their scalar arithmetic as
    the CUDA kernels do."""
    def f32(x):
        if x is None:
            return None
        if np.ndim(x) >= 1:
            return saturation_tensor(x, device)
        return torch.tensor(float(x), dtype=torch.float32, device=device)

    return type(p)(*(f32(x) for x in p))


def saturation(S):
    """A parameter tuple's ``S`` field from a scalar or a per-variable S: a
    float holding a float32 value; one value a column, a tuple of them
    (the JAX façades broadcast a 1-D S to (batch, n) with equal rows); or a
    (batch, n) S, a float32 tensor (on the device it was given on; an array
    goes to the CPU), never a tuple of batch x n floats."""
    if isinstance(S, tuple) or np.ndim(S) == 1:
        if isinstance(S, torch.Tensor):
            S = S.cpu().numpy()
        return tuple(float(x) for x in np.asarray(S, np.float32))
    if np.ndim(S) == 2:
        return saturation_tensor(S, S.device if isinstance(S, torch.Tensor) else "cpu")
    return float(np.float32(S))


def saturation_tensor(S, device):
    """``S`` (a scalar, a tuple, an array or a tensor) as a contiguous
    float32 tensor on ``device``: 0-dim, (n,) or (batch, n); a float32
    tensor already there is returned as it is."""
    return torch.as_tensor(S, dtype=torch.float32, device=device).contiguous()


def dense_matvec(x, q_matrix):
    """The hot-path contraction x @ Q for a (batch, n) or (I, batch, n)
    state against (n, n) or (I, n, n) Q (reference ``dl_solver.py:529-537``).
    Callers run it under :func:`ccvm_tpu_torch.runtime.fp32_matmul`."""
    return torch.matmul(x, q_matrix)


def tp_matvec(group):
    """Tensor-parallel matvec over the process group ``group`` (a mesh's
    "model" axis; the twin of ``ccvm_tpu/dynamics/common.py:68-86``).

    ``x`` holds the local feature shard (rows, n_local) and ``q_rows`` the
    matching row block (n_local, n) of Q: rows shard the contraction, so
    each rank computes a full-width partial sum, and one reduce-scatter over
    the feature dimension returns its columns of the full ``x @ Q``, as
    ``psum_scatter(..., scatter_dimension=1, tiled=True)`` does.  The list
    form of the collective scatters contiguous column chunks (the tensor
    form scatters dim 0, and gloo takes no other)."""
    import torch.distributed as dist

    def matvec(x, q_rows):
        partial = torch.matmul(x, q_rows)
        world = dist.get_world_size(group)
        chunks = [c.contiguous() for c in partial.chunk(world, dim=-1)]
        out = torch.empty_like(chunks[dist.get_rank(group)])
        dist.reduce_scatter(out, chunks, group=group)
        return out

    return matvec


def change_variables_boxqp(problem_variables, lower_limit=0, upper_limit=1, S=1):
    """Map solver amplitudes into the box (reference ``dl_solver.py:219-235``;
    identical in all four solvers)."""
    return 0.5 * problem_variables / S * (upper_limit - lower_limit) + 0.5 * (
        upper_limit + lower_limit
    )


def langevin_change_variables(c, S):
    """The Langevin family's readout map ``(c + S) / (2 S)``, applied BEFORE
    post-processing (reference ``langevin_solver.py:716-722``); it hardcodes
    the [0, 1] box, as the reference does."""
    return (c + S) / (2 * S)


def fit_to_constraints_boxqp(c, lower_clamp, upper_clamp):
    """Clamp amplitudes into the box (reference ``dl_solver.py:237-250``)."""
    return torch.clamp(c, lower_clamp, upper_clamp)


def scaling_factor(q_matrix, multiplier: float):
    """sqrt(sum |Q|) * multiplier (reference ``ccvm_solver.py:134-150``), as
    a float32 0-dim tensor on Q's device."""
    return torch.sqrt(torch.sum(torch.abs(q_matrix))) * multiplier
