"""Host-side I/O helpers (NumPy only).

The reference parses instance files with a Python double loop over tokens
(``problem_instance.py:180-188``) and writes evolution files one value at a
time (``dl_solver.py:252-281``).  These NumPy versions keep the same formats;
an optional C++ tokenizer is left for a later slice (files are at most
N = 70 here, so parsing is milliseconds).
"""

from __future__ import annotations

import numpy as np


def fast_parse_matrix(lines, delimiter: str, problem_size: int) -> np.ndarray:
    """Parse ``problem_size + 1`` delimited rows (V then Q) into a
    ``(problem_size + 1, problem_size)`` float64 array."""
    out = np.empty((problem_size + 1, problem_size), dtype=np.float64)
    for r, line in enumerate(lines[: problem_size + 1]):
        toks = line.rstrip("\n").split(delimiter)
        out[r, :] = [float(t) for t in toks[:problem_size]]
    return out


def write_sample_rows(
    file_object, sample: np.ndarray, append_trailing_tab: bool = True
) -> None:
    """Write a (rows, cols) sample block as tab-separated values rounded to 4
    decimals, one row per line — the reference evolution-file format
    (``dl_solver.py:252-281``, ``mf_solver.py:267-300``).

    ``append_trailing_tab=False`` reproduces the MF writer's no-trailing-tab
    variant (``mf_solver.py:287-289``).
    """
    sample = np.asarray(sample, dtype=np.float64)
    end = "\t\n" if append_trailing_tab else "\n"
    for row in sample:
        file_object.write("\t".join(str(round(float(v), 4)) for v in row) + end)
