"""The MF-CCVM (measurement-feedback CCVM) for BoxQP on sampled rows, and
its readout with projected gradient descent.

The mean-field SDE of arXiv:2209.04415 as the reference library's MF solver
writes it: measurement strength ``j_i = j exp(-3 (i + 1) / T)``, one
standard normal w a step feeding both the measured field ``mu + sqrt(1 /
(4 j_i)) w / sqrt(dt)`` (clamped to +-S in the feedback) and mu's
diffusion, the pump ``pump (i + 1) / T + 1 + j_i``, mu clipped at +-1e5
every step, the popcount32 normal; the readout is the last step's measured
field clamped to +-S, moved into the box and refined by ten steps of
``x <- clamp(x - 0.1 (x Q + V), lo, hi)`` on the scaled problem.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import philox
from portbench.reference.sde import Groups, matmul_for, schedule_f32

SCALING_MULTIPLIER = 0.05
G_DEFAULT = 0.01
SAFETY_BOUND = 1.0e5
STATE = ("mu",)
GD_STEPS, GD_STEP_SIZE = 10, 0.1


def solve(groups: Groups, iterations, *, precision="float32", lo=0.0, hi=1.0,
          g=G_DEFAULT):
    """Final (mu, sigma, measured field clamped to +-S), each (G, R, n)
    float32; per-group parameters ``pump``, ``dt``, ``j``,
    ``feedback_scale``, ``S``."""
    mm = matmul_for(precision)
    p = groups.params
    f = np.float32
    span, mid = f(hi) - f(lo), f(hi) + f(lo)
    S = p["S"]
    fb_v = groups.v * span / (2 * S)
    sqrt_dt = torch.sqrt(p["dt"])
    g2 = f(g) * f(g)
    fi1, rate = schedule_f32(iterations)
    mu, sigma, mt = groups.zeros(), groups.zeros() + 0.5, groups.zeros()
    q = groups.q
    for start, (w,) in groups.noise_chunks(iterations, philox.popcount32_one):
        for t in range(w.shape[0]):
            i = start + t
            j_i = p["j"] * float(np.exp(f(-fi1[i] / f(iterations) * f(3))))
            w_inc = w[t] / sqrt_dt
            mt = mu + torch.sqrt(1 / (4 * j_i)) * w_inc
            mt_c = torch.maximum(torch.minimum(mt, S), -S)
            pump = p["pump"] * float(rate[i]) + 1 + j_i
            mu2 = mu * mu
            mu_term = (-(1 + j_i) + pump - g2 * mu2) * mu
            sig_drift = (2 * (-(1 + j_i) + pump - 3 * g2 * mu2) * sigma
                         - 2 * j_i * (sigma - 0.5) ** 2 + (1 + j_i) + 2 * g2 * mu2)
            fb = -0.25 * mm(mt_c * span / S + mid, q) * span / S - fb_v
            drift = mu_term + p["feedback_scale"] * fb
            mu = mu + p["dt"] * (drift + torch.sqrt(j_i) * (sigma - 0.5) * w_inc)
            sigma = sigma + p["dt"] * sig_drift
            mu = mu.clamp(-SAFETY_BOUND, SAFETY_BOUND)
    return {"mu": mu, "sigma": sigma, "readout": torch.maximum(torch.minimum(mt, S), -S)}


def readout(state, groups: Groups, *, precision="float32", lo=0.0, hi=1.0):
    """The measured field in the box, refined by projected gradient descent
    on each group's scaled Q and V."""
    mm = matmul_for(precision)
    x = 0.5 * state["readout"] / groups.params["S"] * (hi - lo) + 0.5 * (hi + lo)
    for _ in range(GD_STEPS):
        x = torch.clamp(x - GD_STEP_SIZE * (mm(x, groups.q) + groups.v), lo, hi)
    return x


def box(pv, lo=0.0, hi=1.0, S=None):
    """MF's problem variables lie in the box already."""
    return pv
