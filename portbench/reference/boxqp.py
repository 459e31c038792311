"""BoxQP instances, energies and solution statistics, read and computed
without the program.

``.in`` format: a header ``size  optimal  best  optimality  time_gb
time_bfgs  seed  num_frac``, then the V row, then n rows of Q; the file
holds a maximisation problem, so V and Q are negated on reading.  The
energy of a configuration x in the box is ``0.5 x Q x + V x`` (float64,
original coefficients); a solve's statistics are the fractions of rows
whose gap ``(optimal - (-E)) * 100 / |E|`` lies within 0.1, 1, 2, 3, 4, 5
and 10 percent, rounded to 4 digits, and the best objective ``max(-E)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

GAP_THRESHOLDS = {"optimal": 0.1, "one_percent": 1, "two_percent": 2,
                  "three_percent": 3, "four_percent": 4, "five_percent": 5,
                  "ten_percent": 10}


@dataclass
class Instance:
    """One parsed instance: original float64 Q and V (minimisation signs)
    and the header's optimum."""

    n: int
    q64: np.ndarray
    v64: np.ndarray
    optimal: float

    def scaled32(self, multiplier: float):
        """Q and V as float32, divided by sqrt(sum |Q|) * multiplier, the
        solvers' problem scaling."""
        q32 = self.q64.astype(np.float32)
        v32 = self.v64.astype(np.float32)
        sf = np.float32(np.sqrt(np.abs(q32.astype(np.float64)).sum())) * np.float32(multiplier)
        return q32 / sf, v32 / sf


def read_instance(path: str) -> Instance:
    with open(path) as f:
        lines = f.read().split("\n")
    head = lines[0].split("\t")
    n = int(head[0])
    rows = [[float(t) for t in line.split("\t") if t.strip()] for line in lines[1:n + 2]]
    body = np.array(rows, dtype=np.float64)
    if body.shape != (n + 1, n):
        raise ValueError(f"{path}: expected {n + 1} rows of {n} numbers, got {body.shape}")
    return Instance(n=n, q64=-body[1:], v64=-body[0], optimal=float(head[1]))


def energies64(x, q64, v64):
    """0.5 x Q x + V x of each row of ``x`` (a tensor, any device) in
    float64, with float64 Q and V; returns a float64 numpy array."""
    x = torch.as_tensor(x).to(torch.float64)
    q = torch.as_tensor(q64, dtype=torch.float64, device=x.device)
    v = torch.as_tensor(v64, dtype=torch.float64, device=x.device)
    e = 0.5 * ((x @ q) * x).sum(-1) + x @ v
    return e.cpu().numpy()


def statistics(energies, optimal):
    """The fractions within each gap threshold and the best objective."""
    obj = -np.asarray(energies, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = (optimal - obj) * 100 / np.abs(obj)
    stats = {k: round(float(np.sum(gap <= thr)) / obj.shape[0], 4)
             for k, thr in GAP_THRESHOLDS.items()}
    stats["best"] = float(np.max(obj))
    return stats
