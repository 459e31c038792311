"""Host I/O of the port: the ``.in`` body tokenizer and the evolution-file
writer, in C++ (``ccvm_io.cpp``, loaded with ctypes).

The reference parses instance files with a Python double loop over tokens
(``problem_instance.py:180-188``) and writes evolution files one value at a
time (``dl_solver.py:252-281``).  :func:`fast_parse_matrix` and
:func:`write_sample_rows` run those loops in C++: the tokenizer reads a plain
decimal by Clinger's fast path (one correctly rounded operation on exact
doubles, the value ``strtod`` and Python's ``float`` give, bit for bit), and
the writer writes each value as the JAX package's C++ writer does
(``ccvm_tpu/native/ccvm_io.cpp:44-60``), so the two packages' evolution
files are equal byte for byte.

The library is built at first use, not at import, with ``g++ -O3 -shared
-fPIC -std=c++17`` into ``build/native`` at the root of the checkout (listed
in ``.gitignore``), named by a hash of the source; a build writes a file of
its own and renames it into place (``sharedlib``, as the CUDA kernels are
built), so processes that build at once each load a whole library.  There is
no fallback: without the compiler, or when the build fails, the first call
raises ``RuntimeError`` with the compiler's command and output.

:func:`fast_parse_matrix_reference` and :func:`write_sample_rows_reference`
(through :func:`format_rounded_reference`) are the plain Python versions,
which the tests hold the library against and nothing on the main path calls.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading

import numpy as np

from ccvm_tpu_torch import sharedlib

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "ccvm_io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
COMPILER = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_LOCK = threading.Lock()

# Characters of one formatted value at most (the writer's 64-byte buffer
# less its terminator, and the tab after it), and the bytes of text one
# formatting call may produce.
_VALUE_CHARS = 64
_CHUNK_BYTES = 1 << 22
_PARSE_ERRORS = {
    1: "row {row} of the body is missing ({rows} rows expected)",
    2: "row {row} of the body ends before field {field} ({cols} fields expected)",
    3: "field {field} of row {row} of the body is not a number",
    4: "the delimiter is empty",
}
_F64P = ctypes.POINTER(ctypes.c_double)


def library_path() -> str:
    """The library built from the current source (named by its hash)."""
    return os.path.join(BUILD_DIR, f"libccvm_io_{sharedlib.digest([SOURCE])}.so")


def compile_command(out: str) -> list:
    """The compiler line that builds the library into ``out``."""
    return [COMPILER, *FLAGS, SOURCE, "-o", out]


def load_library():
    """The loaded library, built first if it is missing."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not os.path.exists(path):
            sharedlib.compile_into([(path, compile_command)],
                                   "the native I/O library of ccvm_tpu_torch (g++)")
        lib = ctypes.CDLL(path)
        lib.ccvm_parse_table.restype = ctypes.c_int
        lib.ccvm_parse_table.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, _F64P, ctypes.POINTER(ctypes.c_long)]
        lib.ccvm_format_rows.restype = ctypes.c_long
        lib.ccvm_format_rows.argtypes = [
            _F64P, ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_long]
        _LIB = lib
        return lib


def fast_parse_matrix(lines, delimiter: str, problem_size: int) -> np.ndarray:
    """Parse ``problem_size + 1`` delimited rows (V then Q) into a
    ``(problem_size + 1, problem_size)`` float64 array, in C++.  Raises
    ``ValueError`` for a missing line, a short row or a field that is not a
    number."""
    rows, cols = problem_size + 1, problem_size
    text = "".join(lines[:rows]).encode()
    delim = delimiter.encode()
    out = np.empty((rows, cols), dtype=np.float64)
    where = (ctypes.c_long * 2)()
    rc = load_library().ccvm_parse_table(text, len(text), delim, len(delim), rows, cols,
                                         out.ctypes.data_as(_F64P), where)
    if rc:
        raise ValueError(_PARSE_ERRORS[rc].format(row=where[0], field=where[1],
                                                  rows=rows, cols=cols))
    return out


def fast_parse_matrix_reference(lines, delimiter: str, problem_size: int) -> np.ndarray:
    """The plain version of :func:`fast_parse_matrix`: Python's ``split`` and
    ``float`` a token."""
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
    (``dl_solver.py:252-281``, ``mf_solver.py:267-300``) as the JAX
    package's C++ writer formats it — to ``file_object`` (any text file).

    ``append_trailing_tab=False`` reproduces the MF writer's no-trailing-tab
    variant (``mf_solver.py:287-289``).
    """
    sample = np.ascontiguousarray(sample, dtype=np.float64)
    rows, cols = sample.shape
    lib = load_library()
    row_bytes = cols * _VALUE_CHARS + 1
    step = max(1, _CHUNK_BYTES // row_bytes)
    buf = ctypes.create_string_buffer(min(rows, step) * row_bytes)
    for r0 in range(0, rows, step):
        block = sample[r0:r0 + step]
        n = lib.ccvm_format_rows(block.ctypes.data_as(_F64P), block.shape[0], cols,
                                 int(bool(append_trailing_tab)), buf, len(buf))
        if n < 0:
            raise RuntimeError("ccvm_format_rows: the buffer is too small")
        file_object.write(buf.raw[:n].decode("ascii"))


def format_rounded_reference(v) -> str:
    """The plain version of the library's formatter, byte for byte: the
    double product ``v * 1e4`` rounded half away from zero (its fraction
    taken exactly, where ``floor(|p| + 0.5)`` would round ``|p| + 0.5``
    itself), divided by 1e4, -0.0 written as 0.0, ``"%.4f"`` cut to 63
    characters, trailing zeros trimmed down to one fractional digit; inf and
    nan as glibc's printf writes them."""
    p = float(v) * 10000.0
    if math.isfinite(p):
        frac, whole = math.modf(p)
        if abs(frac) >= 0.5:
            whole += math.copysign(1.0, p)
        p = whole
    r = p / 10000.0
    if r == 0.0:
        r = 0.0
    if not math.isfinite(r):
        return ("-" if math.copysign(1.0, r) < 0 else "") + ("nan" if r != r else "inf")
    s = ("%.4f" % r)[:_VALUE_CHARS - 1]
    if "." in s:
        s = s.rstrip("0")
        if s.endswith("."):
            s += "0"
    return s


def write_sample_rows_reference(
    file_object, sample: np.ndarray, append_trailing_tab: bool = True
) -> None:
    """The plain version of :func:`write_sample_rows`."""
    for row in np.asarray(sample, dtype=np.float64):
        vals = [format_rounded_reference(v) for v in row]
        file_object.write("\t".join(vals) + ("\t" if append_trailing_tab and vals else "")
                          + "\n")
