"""Philox4x32-10 (Salmon et al., SC'11, "Random123") and the two normal
transforms the configurations draw, vectorised over steps, rows and
columns.

A draw is keyed by the 64-bit seed (two key words) and counted by
(step, trajectory row, column // 4, stream); output word ``column % 4`` is
the column's word.  ``popcount16`` gives a pair of normals from the two
16-bit halves of one word (Binomial(16, 1/2) centred, times 0.5);
``popcount32`` one normal from a word (Binomial(32, 1/2) centred, over
sqrt(8)).  Words are int64 tensors in [0, 2**32).
"""

from __future__ import annotations

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
POPC32_INV_STD = float(np.float32(1.0 / np.sqrt(8.0)))


def _mulhilo(m, x):
    a = x * (m & 0xFFFF)
    b = x * (m >> 16)
    t = b + (a >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (a & 0xFFFF)


def philox(c0, c1, c2, c3, k0, k1):
    """The four output words of Philox4x32-10; arguments broadcast."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def words(seeds, steps, rows, n, stream=0):
    """Words of shape (len(steps), G, R, n): ``seeds`` (G,) int64 64-bit
    seeds, ``steps`` (T,) int64, ``rows`` (G, R) int64 global rows."""
    device = rows.device
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=device)
    k0 = (seeds & _MASK).reshape(1, -1, 1, 1)
    k1 = ((seeds >> 32) & _MASK).reshape(1, -1, 1, 1)
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    out = philox(steps.to(device).reshape(-1, 1, 1, 1), rows[None, :, :, None],
                 groups.reshape(1, 1, 1, -1), torch.tensor(stream, device=device), k0, k1)
    out = torch.stack(torch.broadcast_tensors(*out), dim=-1)
    return out.flatten(-2)[..., :n]


def popcount(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _MASK) >> 24


def popcount16_pair(w):
    z1 = (popcount(w & 0xFFFF) - 8).to(torch.float32) * 0.5
    z2 = (popcount((w >> 16) & 0xFFFF) - 8).to(torch.float32) * 0.5
    return z1, z2


def popcount32_one(w):
    return (popcount(w) - 16).to(torch.float32) * POPC32_INV_STD
