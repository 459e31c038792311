"""Philox4x32-10 and the four Wiener transforms of the port (CPU).

Known-answer vectors are Random123's (``kat_vectors``, philox4x32_10).  The
transforms keep the moments, lattices and supports the JAX docstrings state
(``ccvm_tpu/ops/pallas_kernels.py:152-254``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ccvm_tpu_torch.ops import philox

M = 0xFFFFFFFF


@pytest.mark.parametrize(
    "counter, key, expected",
    [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((M, M, M, M), (M, M),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
)
def test_philox_known_answers(counter, key, expected):
    out = philox.philox4x32_10(counter, key)
    assert tuple(int(w) for w in out) == expected


def _draws(rng, n_draws=10**6, n=100):
    rows = torch.arange(n_draws // (2 * n), dtype=torch.int64)
    z1, z2 = philox.wiener_pair(1234, 7, rows, n, rng)
    return torch.cat([z1.flatten(), z2.flatten()]).double().numpy()


# rng -> (lattice spacing or None for continuous, support bound)
_SHAPES = {
    "popcount16": (0.5, 4.0),
    "popcount32": (1 / np.sqrt(8.0), 16 / np.sqrt(8.0)),
    "popcount": (None, 32.5 / np.sqrt(16.0 + 1.0 / 12.0)),
    "box_muller": (None, np.sqrt(2.0 * 23.0 * np.log(2.0))),
}


@pytest.mark.parametrize("rng", philox.RNG_NAMES)
def test_transform_moments_lattice_and_support(rng):
    z = _draws(rng)
    se_mean = 1.0 / np.sqrt(z.size)
    # Var of the sample variance: (mu4 - 1) / n with mu4 <= 3.
    se_var = np.sqrt(2.0 / z.size)
    assert abs(z.mean()) < 5 * se_mean
    assert abs(z.var() - 1.0) < 5 * se_var
    spacing, support = _SHAPES[rng]
    assert np.abs(z).max() <= support + 1e-6
    if spacing is not None:
        k = z / spacing
        np.testing.assert_allclose(k, np.round(k), atol=1e-5)
    else:
        assert np.unique(z).size > z.size // 2


def test_words_do_not_depend_on_the_tile():
    n, batch = 70, 192
    rows = torch.arange(batch, dtype=torch.int64)
    whole = philox.words(99, 3, rows, n, 1)
    for tile in (8, 32, 64):
        parts = [philox.words(99, 3, rows[r:r + tile], n, 1)
                 for r in range(0, batch, tile)]
        assert torch.equal(torch.cat(parts), whole)
    # A column's word is the same whatever n the call covers.
    assert torch.equal(philox.words(99, 3, rows, 20, 1), whole[:, :20])


def test_stacked_instance_draws_match_seed_plus_instance():
    rows = torch.arange(16, dtype=torch.int64)
    stacked = philox.words(5, 2, rows, 10, 0, instance=torch.arange(3))
    for i in range(3):
        assert torch.equal(stacked[i], philox.words(5 + i, 2, rows, 10, 0))


def _single_draws(rng, n_draws=10**6, n=100):
    rows = torch.arange(n_draws // n, dtype=torch.int64)
    return philox.wiener_one(1234, 7, rows, n, rng).double().numpy()


@pytest.mark.parametrize("rng", philox.RNG_NAMES)
def test_single_draw_moments_lattice_and_support(rng):
    z = _single_draws(rng)
    assert abs(z.mean()) < 5 / np.sqrt(z.size)
    assert abs(z.var() - 1.0) < 5 * np.sqrt(2.0 / z.size)
    # A single popcount16 draw is a popcount32 one (pallas_kernels.py:307-310).
    spacing, support = _SHAPES["popcount32" if rng == "popcount16" else rng]
    assert np.abs(z).max() <= support + 1e-6
    if spacing is not None:
        k = z / spacing
        np.testing.assert_allclose(k, np.round(k), atol=1e-5)


@pytest.mark.parametrize("rng", philox.RNG_NAMES)
def test_single_draw_is_the_first_of_the_pair_on_the_first_streams(rng):
    """The stream mapping of _noise_one: the first normal of the pair
    transform (popcount32's for popcount16), from streams 0..k-1 only."""
    rows = torch.arange(24, dtype=torch.int64)
    one = philox.wiener_one(42, 5, rows, 30, rng, instance=torch.arange(2))
    pair_rng = "popcount32" if rng == "popcount16" else rng
    first, _ = philox.wiener_pair(42, 5, rows, 30, pair_rng, torch.arange(2))
    assert torch.equal(one, first)
    assert philox.STREAMS_ONE[rng] == {"popcount32": 1, "popcount16": 1,
                                       "box_muller": 2, "popcount": 3}[rng]
    words = [philox.words(42, 5, rows, 30, k) for k in range(philox.STREAMS_ONE[rng])]
    assert torch.equal(philox.TRANSFORMS_ONE[rng](*words), one[0])


def test_single_draw_rejects_unknown_rng():
    with pytest.raises(ValueError, match="rng must be one of"):
        philox.wiener_one(0, 0, torch.arange(2), 4, "mersenne")
