"""Stateless Philox4x32-10 and the four Wiener transforms, on tensors.

The JAX kernels draw their noise from the TPU's hardware generator
(``pltpu.prng_seed`` / ``prng_random_bits``, ``pallas_kernels.py:350-364``),
whose stream cannot be replayed elsewhere.  The port uses the counter-based
Philox4x32-10 of Salmon et al. (SC'11, "Random123") instead, both here and
inside the CUDA kernel (``csrc/dl_solve.cu``), so the plain version and the
kernel draw the SAME words:

    key     = (seed + instance) as a 64-bit value split into two 32-bit words
    counter = (step, trajectory row, column // 4, stream)
    word    = output word (column % 4) of Philox4x32-10(counter, key)

A draw depends only on (seed, instance, step, row, column, stream), never on
how the batch is cut into thread blocks.  Instance ``i`` of a stacked solve
with ``seed`` therefore draws what a single solve with ``seed + i`` draws.

Words are held in int64 tensors with values in [0, 2**32).  A product of two
32-bit words overflows int64, so :func:`_mulhilo` splits the constant into
16-bit halves.

The transforms keep the names and the moments of ``_RNG_NAMES``
(``pallas_kernels.py:152-257``).  :func:`wiener_pair` gives the pair
``(z1, z2)`` of normals for the c and s quadratures (DL); :func:`wiener_one`
gives the single draw of the kernels that take one per step (MF), as
``_noise_one`` does (``pallas_kernels.py:301-319``).  :func:`harness_pair`
gives the pairs of the DL race harness's transforms (:data:`HARNESS_RNGS`),
which the variant kernels of ``csrc/dl_variants.cu`` draw.
"""

from __future__ import annotations

import numpy as np
import torch

RNG_NAMES = ("popcount32", "popcount16", "popcount", "box_muller")
# Philox streams (counter word 3) each transform consumes per element.
STREAMS = {"popcount16": 1, "popcount32": 2, "box_muller": 2, "popcount": 6}
# ... and for a single draw: the first normal of the pair, whose words come
# from the first streams (popcount16 draws one popcount32 normal instead).
STREAMS_ONE = {"popcount16": 1, "popcount32": 1, "box_muller": 2, "popcount": 3}

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK = 0xFFFFFFFF

# Binomial(64) + uniform-smoothing normalisation: Var = 64/4 + 1/12.
POPC_INV_STD = float(np.float32(1.0 / np.sqrt(16.0 + 1.0 / 12.0)))
# Binomial(32) normalisation: Var = 32/4.
POPC32_INV_STD = float(np.float32(1.0 / np.sqrt(8.0)))
_TWO_PI = float(np.float32(6.283185307179586))
_INV_2_23 = 1.0 / (1 << 23)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * x for a 32-bit
    constant ``m`` and int64 ``x`` in [0, 2**32)."""
    a = x * (m & 0xFFFF)  # < 2**48
    b = x * (m >> 16)  # < 2**48
    t = b + (a >> 16)  # = (m * x) >> 16, < 2**49
    hi = t >> 16
    lo = ((t & 0xFFFF) << 16) | (a & 0xFFFF)
    return hi, lo


def philox4x32_10(counter, key):
    """Philox4x32-10 of four counter words and two key words.

    Each word is an int or an int64 tensor with values in [0, 2**32); all
    broadcast together.  Returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.broadcast_tensors(c0, c1, c2, c3)


def seed_key(seed: int, instance=0):
    """The two Philox key words of ``seed + instance`` (int or tensor)."""
    s = torch.as_tensor(instance, dtype=torch.int64) + int(seed)
    return s & _MASK, (s >> 32) & _MASK


def words(seed: int, step: int, rows: torch.Tensor, n: int, stream: int,
          instance=0, col0: int = 0):
    """The word of every (row, column col0 .. col0 + n - 1) for one step and
    stream.

    ``rows`` is a (B,) int64 tensor of global trajectory rows; ``instance``
    an int, giving a (B, n) result, or an (I,) int64 tensor, giving
    (I, B, n).  ``col0`` is the first global column (a tensor-parallel
    rank's feature shard), any offset, not only a multiple of 4."""
    device = rows.device
    first = int(col0) // 4
    groups = torch.arange(first, (int(col0) + n + 3) // 4, dtype=torch.int64,
                          device=device)
    inst = torch.as_tensor(instance, dtype=torch.int64, device=device)
    k0, k1 = seed_key(seed, inst.reshape(inst.shape + (1, 1)))
    out = philox4x32_10((step, rows[:, None], groups, stream), (k0, k1))
    skip = int(col0) - 4 * first
    return torch.stack(out, dim=-1).flatten(-2)[..., skip:skip + n]


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Bit-population count of int64 words in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _MASK) >> 24


def popcount16_pair(w):
    """Two normals from ONE word: its 16-bit halves give Binomial(16, 1/2)
    popcounts, centred and scaled by 0.5.  Lattice spacing 0.5, support +-4,
    mean and variance exact (``_normal_pair_popcount16``,
    ``pallas_kernels.py:235-254``)."""
    z1 = (popcount(w & 0xFFFF) - 8).to(torch.float32) * 0.5
    z2 = (popcount((w >> 16) & 0xFFFF) - 8).to(torch.float32) * 0.5
    return z1, z2


def popcount32_one(w):
    """One normal per word: popcount - 16 is Binomial(32, 1/2) centred,
    scaled to unit variance.  Lattice spacing 1/sqrt(8) ~ 0.354, support
    +-5.66 (``_normal_one_popcount``, ``pallas_kernels.py:185-201``)."""
    return (popcount(w) - 16).to(torch.float32) * POPC32_INV_STD


def popcount32_pair(w0, w1):
    return popcount32_one(w0), popcount32_one(w1)


def popcount_one(b1, b2, b3):
    """A normal from three words: popcount(b1) + popcount(b2) - 32 plus a
    23-bit uniform on [-1/2, 1/2), scaled to unit variance; support about
    +-8.1 (``_normal_pair_popcount``, ``pallas_kernels.py:204-232``)."""
    pc = popcount(b1) + popcount(b2)
    u = (b3 & 0x7FFFFF).to(torch.float32) * _INV_2_23
    return ((pc - 32).to(torch.float32) + (u - 0.5)) * POPC_INV_STD


def popcount_pair(w0, w1, w2, w3, w4, w5):
    return popcount_one(w0, w1, w2), popcount_one(w3, w4, w5)


def _box_muller_polar(w0, w1):
    u1 = ((w0 & 0x7FFFFF).to(torch.float32) + 1.0) * _INV_2_23
    u2 = (w1 & 0x7FFFFF).to(torch.float32) * _INV_2_23
    return torch.sqrt(-2.0 * torch.log(u1)), _TWO_PI * u2


def box_muller_pair(w0, w1):
    """Exact Gaussians from 23-bit uniforms, u1 in (0, 1] so the log is
    finite; |z| <= sqrt(2 * 23 ln 2) ~ 5.65 (``_normal_pair_box_muller``,
    ``pallas_kernels.py:152-170``)."""
    r, theta = _box_muller_polar(w0, w1)
    return r * torch.cos(theta), r * torch.sin(theta)


def box_muller_one(w0, w1):
    """The first normal of :func:`box_muller_pair`, ``r cos(theta)``."""
    r, theta = _box_muller_polar(w0, w1)
    return r * torch.cos(theta)


TRANSFORMS = {
    "popcount16": popcount16_pair,
    "popcount32": popcount32_pair,
    "popcount": popcount_pair,
    "box_muller": box_muller_pair,
}
# Single draws: the half-word split of popcount16 pays only for pairs, so a
# single popcount16 draw is a popcount32 one (pallas_kernels.py:307-310).
TRANSFORMS_ONE = {
    "popcount16": popcount32_one,
    "popcount32": popcount32_one,
    "popcount": popcount_one,
    "box_muller": box_muller_one,
}


def popcount2_one(b1, b2):
    """A normal from two words: popcount(b1) + popcount(b2) - 32 is
    Binomial(64, 1/2) centred, variance 16, scaled by 1/4; no uniform
    smoothing, so lattice spacing 0.25 and support +-8
    (``noise_popcount2``, ``tools/kernel_experiments.py:68-78``)."""
    return (popcount(b1) + popcount(b2) - 32).to(torch.float32) * 0.25


def popcount2_pair(w0, w1, w2, w3):
    return popcount2_one(w0, w1), popcount2_one(w2, w3)


# The DL race harness's transforms (``tools/kernel_experiments.py:81-85``)
# by its own names: (pair transform, Philox streams per element).  The
# kernel of csrc/dl_variants.cu takes the index of a name here.  popcount2
# is the harness's alone: it is not a ``kernel_rng`` of the façades.
HARNESS_RNGS = {
    "popcount1": (popcount32_pair, 2),
    "popcount2": (popcount2_pair, 4),
    "popcount3(prod)": (popcount_pair, 6),
}
HARNESS_RNG_NAMES = tuple(HARNESS_RNGS)


def _pair(transform, streams, seed, step, rows, n, instance, col0=0):
    ws = [words(seed, step, rows, n, k, instance, col0) for k in range(streams)]
    return transform(*ws)


def wiener_pair(seed: int, step: int, rows: torch.Tensor, n: int, rng: str,
                instance=0, col0: int = 0):
    """The kernel's standard-normal pair ``(w_c, w_s)`` for one step, at
    columns ``col0`` .. ``col0 + n - 1``."""
    if rng not in TRANSFORMS:
        raise ValueError(f"rng must be one of {RNG_NAMES}, got {rng!r}")
    return _pair(TRANSFORMS[rng], STREAMS[rng], seed, step, rows, n, instance, col0)


def harness_pair(seed: int, step: int, rows: torch.Tensor, n: int, name: str,
                 instance=0):
    """The variant kernel's pair ``(z1, z2)`` for one step, by a name of
    :data:`HARNESS_RNGS`; ``popcount1`` draws what ``popcount32`` does."""
    if name not in HARNESS_RNGS:
        raise ValueError(f"rng_name must be one of {HARNESS_RNG_NAMES}, got {name!r}")
    return _pair(*HARNESS_RNGS[name], seed, step, rows, n, instance)


def wiener_one(seed: int, step: int, rows: torch.Tensor, n: int, rng: str,
               instance=0, col0: int = 0):
    """The kernel's single standard-normal draw ``w`` for one step, at
    columns ``col0`` .. ``col0 + n - 1``."""
    if rng not in TRANSFORMS_ONE:
        raise ValueError(f"rng must be one of {RNG_NAMES}, got {rng!r}")
    ws = [words(seed, step, rows, n, k, instance, col0)
          for k in range(STREAMS_ONE[rng])]
    return TRANSFORMS_ONE[rng](*ws)
