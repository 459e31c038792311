"""Langevin dynamics for BoxQP on sampled rows, and its readout with
projected gradient descent.

The overdamped Langevin SDE of the Langevin baseline of arXiv:2209.04415's
BoxQP study, in the order of operations of the reference library's
``solvers/langevin_solver.py``: from c = 0, each step

    x     = c (u - l) / (2 S) + (u + l) / 2
    drift = -(x Q + V) (u - l) / (2 S)
    c     = clamp(c + dt fs drift + sigma sqrt(dt) w, -S, S)

and the readout ``(c + S) / (2 S)`` (the change of variables comes before
the refinement, and assumes the [0, 1] box, as the reference library's
does), refined by ten steps of ``x <- clamp(x - 0.1 (x Q + V), l, u)`` on
the scaled problem.

Departures from the reference library, each the convention of the program
under test: the normal ``w`` is the popcount32 normal of Philox4x32-10
keyed by (seed, step, row, column // 4, stream 0), in place of the
library's generator; the diffusion is grouped as ``(sigma sqrt(dt)) w``
rather than ``sigma (w sqrt(dt))`` (float32 round-off apart, the same).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import philox
from portbench.reference.mf import GD_STEP_SIZE, GD_STEPS
from portbench.reference.sde import Groups, matmul_for

SCALING_MULTIPLIER = 0.05
STATE = ("c",)


def solve(groups: Groups, iterations, *, precision="float32", lo=0.0, hi=1.0):
    """Final c, (G, R, n) float32, of every group's rows; per-group
    parameters ``S``, ``dt``, ``sigma``, ``feedback_scale``."""
    mm = matmul_for(precision)
    p = groups.params
    S = p["S"]
    f = np.float32
    scale = float(f(hi) - f(lo)) / (2 * S)
    mid = float((f(hi) + f(lo)) / f(2))
    dt_fs = p["dt"] * p["feedback_scale"]
    diffusion = p["sigma"] * torch.sqrt(p["dt"])
    c = groups.zeros()
    q = groups.q
    for _, (w,) in groups.noise_chunks(iterations, philox.popcount32_one):
        for t in range(w.shape[0]):
            drift = -(mm(c * scale + mid, q) + groups.v) * scale
            c = torch.clamp(c + dt_fs * drift + diffusion * w[t], -S, S)
    return {"c": c}


def readout(state, groups: Groups, *, precision="float32", lo=0.0, hi=1.0):
    """``(c + S) / (2 S)``, refined by projected gradient descent on each
    group's scaled Q and V."""
    mm = matmul_for(precision)
    S = groups.params["S"]
    x = (state["c"] + S) / (2 * S)
    for _ in range(GD_STEPS):
        x = torch.clamp(x - GD_STEP_SIZE * (mm(x, groups.q) + groups.v), lo, hi)
    return x


def box(pv, lo=0.0, hi=1.0, S=None):
    """The problem variables lie in the box already."""
    return pv
