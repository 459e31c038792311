"""Shared machinery of the plain SDE solves: groups of sampled rows,
per-group parameters, the matrix product in a stated precision, and noise
drawn in chunks of steps.

A *group* is one solved instance of one call: its scaled float32 Q and V,
its 64-bit seed and the global rows of its batch that are followed.
Groups of different sizes are padded to the largest n with zero rows and
columns of Q and zeros of V, which leaves the real columns' drift as it is
(a padded variable adds 0 to every product), and the real columns draw
what they draw unpadded (a column's word depends on its own index only).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import philox

# Elements of int64 words produced at once when drawing noise.
_CHUNK_ELEMENTS = 1 << 23


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from 0)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_for(precision: str):
    """``x @ Q`` in float32 (IEEE products and sums), in TF32 (operands
    rounded to TF32, products summed in float32), and, for telling
    round-off that an instance amplifies from a fault: with float64 sums
    rounded to float32 (``float64-sums``), or in 3xTF32 (``3xtf32``: each
    operand split into a TF32 head and a TF32 tail, the three products
    without tail x tail summed in float32)."""
    if precision == "float32":
        return torch.matmul
    if precision == "tf32":
        return lambda x, q: torch.matmul(tf32(x), tf32(q))
    if precision == "float64-sums":
        return lambda x, q: torch.matmul(x.double(), q.double()).float()
    if precision == "3xtf32":
        def three(x, q):
            xh, qh = tf32(x), tf32(q)
            xl, ql = tf32(x - xh), tf32(q - qh)
            return torch.matmul(xh, qh) + (torch.matmul(xh, ql) + torch.matmul(xl, qh))
        return three
    raise ValueError(f"unknown precision {precision!r}")


class Groups:
    """Stacked groups on ``device``: ``q`` (G, n, n), ``v`` (G, 1, n),
    ``seeds`` (G,), ``rows`` (G, R), ``sizes`` (G,) and per-group parameter
    tensors (G, 1, 1) by name."""

    def __init__(self, items, device):
        n = max(it["q"].shape[0] for it in items)
        R = max(len(it["rows"]) for it in items)
        if any(len(it["rows"]) != R for it in items):
            raise ValueError("every group follows the same number of rows")
        G = len(items)
        q = np.zeros((G, n, n), np.float32)
        v = np.zeros((G, 1, n), np.float32)
        for g, it in enumerate(items):
            k = it["q"].shape[0]
            q[g, :k, :k] = it["q"]
            v[g, 0, :k] = it["v"]
        self.n, self.R, self.device = n, R, device
        self.q = torch.from_numpy(q).to(device)
        self.v = torch.from_numpy(v).to(device)
        self.sizes = [it["q"].shape[0] for it in items]
        self.seeds = torch.tensor([int(it["seed"]) for it in items], dtype=torch.int64)
        self.rows = torch.tensor(np.array([it["rows"] for it in items]), dtype=torch.int64,
                                 device=device)
        self.params = {k: torch.tensor([float(np.float32(it["params"][k])) for it in items],
                                       dtype=torch.float32, device=device).reshape(G, 1, 1)
                       for k in items[0]["params"]}

    def zeros(self):
        return torch.zeros((len(self.sizes), self.R, self.n), dtype=torch.float32,
                           device=self.device)

    def noise_chunks(self, iterations, transform):
        """Yield (first step, tuple of (T, G, R, n) float32 draws) over the
        solve, ``transform`` mapping a word tensor to its normals."""
        per_step = len(self.sizes) * self.R * ((self.n + 3) // 4) * 4
        T = max(1, _CHUNK_ELEMENTS // per_step)
        for start in range(0, int(iterations), T):
            steps = torch.arange(start, min(start + T, int(iterations)), dtype=torch.int64)
            w = philox.words(self.seeds.to(self.device), steps, self.rows, self.n)
            draws = transform(w)
            yield start, draws if isinstance(draws, tuple) else (draws,)

    def unpad(self, x, g):
        """Group g's (R, n_g) block of a stacked (G, R, n) tensor."""
        return x[g, :, :self.sizes[g]]


def schedule_f32(iterations):
    """(i + 1) / T of every step, float32 on the host."""
    fi1 = np.arange(1, int(iterations) + 1, dtype=np.float32)
    return fi1, fi1 / np.float32(iterations)
