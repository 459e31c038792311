"""The port's native host I/O library (``ccvm_tpu_torch/native``) against the
JAX package's and against its own plain Python versions (CPU).

The tokenizer equals the JAX package's ``fast_parse_matrix`` bit for bit on
every bundled ``.in`` file; the evolution writer's files equal, byte for
byte, those of the JAX package's C++ writer (which its Python fallback does
not: the fallback writes -0.0 and rounds half to even); the library builds
at first use, also when processes build it at once, and raises when it
cannot.
"""

from __future__ import annotations

import glob
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import ccvm_tpu.native as jnative
from ccvm_tpu_torch import ProblemInstance, native
from jax_native_loader import jax_native_library

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(REPO, "examples", "benchmarking_instances")
FOLDERS = sorted(os.listdir(INSTANCES)) + ["tests/data"]
TEST020 = os.path.join(REPO, "tests", "data", "test020.in")

# Values where the two formats part or rounding is close: small negatives
# (-0.0 after rounding), half-way products (910.15625 and 2.00005 times 1e4
# are 9101562.5 and 20000.5: away from zero, where Python's round gives
# 910.1562 and 2.0), a value past the 17 digits of repr (1e17), zeros of
# both signs, huge and non-finite ones.
EDGE_VALUES = [-1e-6, -4e-5, -4.9e-5, 910.15625, 2.00005, -2.00005, 1e17, -1e17,
               0.0, -0.0, 5e-5, -5e-5, 1.5e-4, -2.5e-4, 123456.78915, 1e300, -1e300,
               1e-300, float("inf"), float("-inf"), float("nan"), -float("nan")]


def _sweep(n=200_000, seed=5):
    """float32-valued samples at scales 1e-5 to 1e3, both signs, and products
    a hair either side of a half-way point."""
    draw = np.random.RandomState(seed)
    x = draw.uniform(-1.0, 1.0, n) * 10.0 ** draw.randint(-5, 4, n)
    halves = (np.arange(-500, 500) + 0.5) / 1e4
    near = np.concatenate([np.nextafter(halves, -np.inf), halves,
                           np.nextafter(halves, np.inf)])
    return np.concatenate([x.astype(np.float32).astype(np.float64), near])


def _sample(cols=7):
    values = np.concatenate([np.array(EDGE_VALUES), _sweep()])
    return values[: len(values) // cols * cols].reshape(-1, cols)


def _body(path):
    with open(path) as f:
        lines = f.readlines()
    n = int(lines[0].split("\t")[0])
    return lines[1:n + 2], n


@pytest.mark.parametrize("folder", FOLDERS)
def test_tokenizer_equals_jax_parse_on_every_bundled_file(folder):
    """Every bundled .in body (300 files in Size20..Size70, the single test
    instance, tests/data) parses to the JAX package's array bit for bit,
    and to the plain version's."""
    root = os.path.join(REPO, folder) if folder.startswith("tests") else \
        os.path.join(INSTANCES, folder)
    paths = sorted(glob.glob(os.path.join(root, "*.in")))
    assert paths
    for path in paths:
        body, n = _body(path)
        ours = native.fast_parse_matrix(body, "\t", n)
        assert ours.dtype == np.float64 and ours.shape == (n + 1, n)
        assert ours.tobytes() == jnative.fast_parse_matrix(body, "\t", n).tobytes(), path
        assert ours.tobytes() == native.fast_parse_matrix_reference(body, "\t", n).tobytes()


def _tokens(seed, count):
    """Decimal fields of every form the tokenizer's fast path takes or hands
    to strtod: fixed and exponent notation, 1 to 30 significant digits, powers
    of ten beyond 1e+-22, leading zeros, signs, subnormals and non-finite."""
    draw = np.random.RandomState(seed)
    fixed = ["-0.0", "0", "+5", ".5", "5.", "1.e5", "1E+05", "inf", "-inf", "nan",
             "1e308", "4.9e-324", "2.2250738585072011e-308", "9007199254740993",
             "9007199254740992", "0.1", "123456789012345678901234567890"]
    out = []
    for _ in range(count):
        kind = draw.randint(6)
        if kind == 0:
            out.append(f"{draw.uniform(-1e3, 1e3):.{draw.randint(0, 13)}f}")
        elif kind == 1:
            out.append(repr(float(draw.uniform(-1, 1) * 10.0 ** draw.randint(-30, 31))))
        elif kind == 2:
            out.append(str(int(draw.randint(-2**62, 2**62)) * int(draw.randint(1, 10))))
        elif kind == 3:
            out.append(f"{draw.randint(0, 2**53)}e{draw.randint(-25, 26)}")
        elif kind == 4:
            out.append(f"{'-' if draw.rand() < 0.5 else ''}0.{'0' * draw.randint(0, 26)}"
                       f"{draw.randint(1, 2**62)}")
        else:
            out.append(fixed[draw.randint(len(fixed))])
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_tokenizer_equals_python_float_on_every_number_form(seed):
    """Fields that take the fast path (up to 16 significant digits, a power
    of ten within 1e+-22) and fields that go to strtod parse to Python's
    float bit for bit (NaN to NaN)."""
    n = 100
    toks = _tokens(seed, (n + 1) * n)
    lines = ["\t".join(toks[r * n:(r + 1) * n]) + "\n" for r in range(n + 1)]
    ours = native.fast_parse_matrix(lines, "\t", n)
    plain = native.fast_parse_matrix_reference(lines, "\t", n)
    same = (ours.view(np.uint64) == plain.view(np.uint64)) | (np.isnan(ours) & np.isnan(plain))
    assert same.all(), [t for t, ok in zip(toks, same.ravel()) if not ok][:10]


@pytest.mark.parametrize("delimiter", [";", "::", " | "])
def test_multi_character_delimiter_parses(tmp_path, delimiter):
    """A delimiter of one character or more goes through the tokenizer (the
    JAX package sends longer ones to NumPy); the loader reads the same
    instance as from the tab-separated file."""
    with open(TEST020) as f:
        text = f.read()
    path = tmp_path / "test020.in"
    path.write_text(text.replace("\t", delimiter))
    body, n = _body(TEST020)
    lines = [ln.replace("\t", delimiter) for ln in body]
    np.testing.assert_array_equal(native.fast_parse_matrix(lines, delimiter, n),
                                  native.fast_parse_matrix_reference(lines, delimiter, n))
    ours = ProblemInstance(device="cpu", instance_type="test", file_path=str(path),
                           file_delimiter=delimiter)
    tab = ProblemInstance(device="cpu", instance_type="test", file_path=TEST020)
    assert ours.problem_size == tab.problem_size == 20
    assert ours.q_matrix.equal(tab.q_matrix) and ours.v_vector.equal(tab.v_vector)


def _broken(lines, case):
    if case == "short row":
        lines[5] = "\t".join(lines[5].rstrip("\n").split("\t")[:-3]) + "\n"
    elif case == "blank row":
        lines[5] = "\n"
    elif case == "non-numeric token":
        toks = lines[7].split("\t")
        toks[3] = "1.5abc"
        lines[7] = "\t".join(toks)
    elif case == "hexadecimal token":
        toks = lines[7].split("\t")
        toks[2] = "0x1p3"
        lines[7] = "\t".join(toks)
    else:  # missing lines
        del lines[10:]
    return lines


@pytest.mark.parametrize("case", ["short row", "blank row", "non-numeric token",
                                  "hexadecimal token", "missing lines"])
def test_malformed_body_raises_through_problem_instance(tmp_path, case):
    """A short row, a token that is not a number (as Python's float reads
    it) and a body cut short raise the loader's "Error reading instance
    file", where the JAX package's strtod would read on into the next line;
    the tokenizer says which row."""
    with open(TEST020) as f:
        lines = f.readlines()
    path = tmp_path / "broken.in"
    path.write_text("".join(_broken(lines, case)))
    with pytest.raises(Exception, match="Error reading instance file"):
        ProblemInstance(device="cpu", instance_type="test", file_path=str(path))
    body, n = _body(str(path))
    with pytest.raises(ValueError, match="row"):
        native.fast_parse_matrix(body, "\t", n)


@pytest.mark.parametrize("trailing_tab", [True, False])
def test_evolution_writer_equals_jax_cpp_writer_byte_for_byte(tmp_path, trailing_tab):
    """Both packages' ``write_sample_rows`` on a real file: the JAX package's
    C++ path (asserted loaded, through ``jax_native_loader``, so that its
    Python fallback, which formats
    otherwise, is not what is compared) and the port's library write the
    same bytes, for both trailing-tab choices."""
    assert jax_native_library() is not None
    sample = _sample()
    paths = {side: tmp_path / f"{side}.txt" for side in ("jax", "port")}
    for side, write in (("jax", jnative.write_sample_rows),
                        ("port", native.write_sample_rows)):
        with open(paths[side], "w") as f:
            f.write("header\n")
            write(f, sample, append_trailing_tab=trailing_tab)
            write(f, sample[:3], append_trailing_tab=trailing_tab)
    ours = paths["port"].read_bytes()
    assert ours == paths["jax"].read_bytes()
    first = ours.split(b"\n")[1]
    assert first.startswith(b"0.0\t0.0\t0.0\t910.1563\t2.0001\t-2.0001\t100000000000000000.0")
    assert first.endswith(b"\t") == trailing_tab
    assert b"-0.0\t" not in ours and b"-0.0\n" not in ours


@pytest.mark.parametrize("trailing_tab", [True, False])
def test_reference_formatter_equals_the_library(trailing_tab):
    """``format_rounded_reference`` (through ``write_sample_rows_reference``)
    writes what the library writes, over the same values, into any text
    file object."""
    sample = _sample()
    ours, plain = io.StringIO(), io.StringIO()
    native.write_sample_rows(ours, sample, append_trailing_tab=trailing_tab)
    native.write_sample_rows_reference(plain, sample, append_trailing_tab=trailing_tab)
    assert ours.getvalue() == plain.getvalue()
    assert native.format_rounded_reference(910.15625) == "910.1563"
    assert native.format_rounded_reference(2.00005) == "2.0001"
    assert native.format_rounded_reference(-1e-6) == "0.0"
    assert native.format_rounded_reference(1e17) == "100000000000000000.0"
    # The product 0.49999999999999994 rounds to 0: floor(|p| + 0.5) would
    # give 1, since |p| + 0.5 itself rounds up to 1.0.
    v = 0.49999999999999994 / 1e4
    assert v * 1e4 == 0.49999999999999994
    assert native.format_rounded_reference(v) == "0.0"


_BUILD_AND_PARSE = """
import sys
from ccvm_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
body = open(sys.argv[2]).readlines()[1:22]
print(native.library_path(), float(native.fast_parse_matrix(body, "\\t", 20).sum()))
"""


def test_two_processes_that_build_at_once_both_load_it(tmp_path):
    """Two processes that find no library build it at once, each into a file
    of its own renamed into place: both load a whole library and parse."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_PARSE, str(tmp_path),
                               TEST020], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0][0] == outs[1][0]
    lib = outs[0][0].split()[0]
    assert os.path.dirname(lib) == str(tmp_path) and os.path.isfile(lib)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    body, n = _body(TEST020)
    assert float(outs[0][0].split()[1]) == float(
        native.fast_parse_matrix_reference(body, "\t", n).sum())


@pytest.mark.parametrize("how", ["compiler name", "PATH"])
def test_missing_compiler_raises_naming_it(monkeypatch, tmp_path, how):
    """Without the compiler the first parse raises ``RuntimeError`` with the
    compiler's command; nothing falls back to Python.  Through the loader
    too: the error is the build's, not "Error reading instance file"."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    if how == "PATH":
        monkeypatch.setenv("PATH", str(tmp_path))
    else:
        monkeypatch.setattr(native, "COMPILER", "no-such-g++")
    body, n = _body(TEST020)
    with pytest.raises(RuntimeError,
                       match=re.escape(f"{native.COMPILER} -O3 -shared -fPIC -std=c++17")):
        native.fast_parse_matrix(body, "\t", n)
    with pytest.raises(RuntimeError, match="native I/O library"):
        ProblemInstance(device="cpu", instance_type="test", file_path=TEST020)
    with pytest.raises(RuntimeError, match="native I/O library"):
        native.write_sample_rows(io.StringIO(), np.zeros((2, 2)))
    assert os.listdir(tmp_path) == []


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """A build that fails raises with the command and the compiler's stderr."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="(?s)failed.*bad.cpp.*error"):
        native.load_library()
    assert os.listdir(tmp_path / "out") == []
