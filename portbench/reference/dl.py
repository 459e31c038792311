"""The DL-CCVM (delay-line CCVM) for BoxQP on sampled rows, and its readout.

The two-quadrature SDE of arXiv:2209.04415 as the reference library's DL
solver writes it (pump ramp ``rate = (i + 1) / T``, noise ratio
``(noise_ratio - 1) exp(-3 (i + 1) / T) + 1``, the drift's saturation
``S_d = sqrt(pump - 1)`` for pump > 1, a final clamp of c to +-S), with a
clip of both quadratures at +-1e3 every step, the popcount16 pair of
normals, and the readout ``x = 0.5 c / S (u - l) + 0.5 (u + l)`` with no
post-processing.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import philox
from portbench.reference.sde import Groups, matmul_for, schedule_f32

SCALING_MULTIPLIER = 0.2
G_DEFAULT = 0.05
SAFETY_BOUND = 1.0e3
STATE = ("c", "s")


def solve(groups: Groups, iterations, *, precision="float32", lo=0.0, hi=1.0, S=1.0,
          g=G_DEFAULT):
    """Final (c clamped to +-S, s), each (G, R, n) float32, of every group's
    rows; per-group parameters ``pump``, ``dt``, ``noise_ratio``,
    ``feedback_scale``."""
    mm = matmul_for(precision)
    p = groups.params
    f = np.float32
    span, mid = f(hi) - f(lo), f(hi) + f(lo)
    s_d = torch.where(p["pump"] > 1, torch.sqrt(torch.clamp(p["pump"] - 1, min=0)),
                      torch.full_like(p["pump"], f(S)))
    g3 = groups.v * span / (2 * s_d)
    sqrt_dt = torch.sqrt(p["dt"])
    two_g = f(2) * f(g)
    fi1, rate = schedule_f32(iterations)
    c, s = groups.zeros(), groups.zeros()
    q = groups.q
    for start, (w_c, w_s) in groups.noise_chunks(iterations, philox.popcount16_pair):
        for t in range(w_c.shape[0]):
            i = start + t
            r = float(rate[i])
            nr = (p["noise_ratio"] - 1) * float(np.exp(f(-fi1[i] / f(iterations) * f(3)))) + 1
            fs_dyn = p["feedback_scale"] * f(f(0.5) + rate[i])
            c2s2 = c * c + s * s
            fb_c = 0.25 * mm(c * span / s_d + mid, q) * span / s_d
            fb_s = 0.25 * mm(s * span / s_d + mid, q) * span / s_d
            c_drift = -fs_dyn * (fb_c + g3) + (-1 + p["pump"] * r - c2s2) * c
            s_drift = -fs_dyn * (fb_s + g3) + (-1 - p["pump"] * r - c2s2) * s
            diff = two_g * torch.sqrt(c2s2 + 0.5)
            c = c + p["dt"] * c_drift + diff * (w_c[t] * sqrt_dt * nr)
            s = s + p["dt"] * s_drift + diff * (w_s[t] * sqrt_dt / nr)
            c = c.clamp(-SAFETY_BOUND, SAFETY_BOUND)
            s = s.clamp(-SAFETY_BOUND, SAFETY_BOUND)
    return {"c": c.clamp(-S, S), "s": s}


def readout(state, groups: Groups, *, precision="float32"):
    """The problem variables: c, clamped, with no post-processing (``box``
    moves them into the box)."""
    return state["c"]


def box(c, lo=0.0, hi=1.0, S=1.0):
    """The change of variables of the problem variables into the box."""
    return 0.5 * c / S * (hi - lo) + 0.5 * (hi + lo)
