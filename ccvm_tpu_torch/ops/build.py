"""Build the CUDA kernels of ``ccvm_tpu_torch/csrc`` at first use.

Each kernel source has a plain C interface and no PyTorch headers, so
``nvcc`` compiles it into a shared library in seconds; ``ctypes`` loads it.
A spec names its source, its exported symbol and one specialisation of the
source's kernel template (Adam or not, second moment or not, ...), selected
with ``-D`` flags and built into its own library, so a process builds only
what it launches.  Libraries go to ``build/kernels`` at the root of the
checkout (listed in ``.gitignore``) and are named by a hash of the source
and of every header under ``csrc/``, and by the flags, so an edited source or
header is rebuilt.

There is no fallback: without ``nvcc`` :func:`build` raises, and a CUDA
tensor never reaches the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LIBS: dict = {}
_LOCK = threading.Lock()

# Shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448
_TILE = 4  # rows and columns of a thread's tile (csrc/ccvm_common.cuh TR, TC)
_MAX_THREADS = 256  # csrc/ccvm_common.cuh kMaxThreads
_MAX_ROW_GROUPS = 16  # at most 64 trajectories per block


def _defines(spec):
    return [f"-DCCVM_{k.upper()}={int(v)}" for k, v in zip(spec._fields, spec)]


def _tag(spec):
    return "".join(str(int(v)) for v in spec)


_F32P = ctypes.POINTER(ctypes.c_float)
# (q, v, outputs..., instances, batch, n, iterations, seed, scalars,
# rows_per_block, stream) of the exported launch functions.
_HEAD = [ctypes.c_void_p, ctypes.c_void_p]
_TAIL = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_ulonglong, _F32P, ctypes.c_int, ctypes.c_void_p]


class DLSpec(NamedTuple):
    """One specialisation of ``dl_solve_kernel`` (csrc/dl_solve.cu)."""

    adam: bool
    beta2_one: bool
    add_assign: bool
    pump_rate_flag: bool
    pump_gt_one: bool
    noise: bool
    rng: int  # index into ops.philox.RNG_NAMES

    source = "dl_solve.cu"
    symbol = "ccvm_dl_solve"
    argtypes = _HEAD + [ctypes.c_void_p] * 2 + _TAIL  # c, s
    defines = _defines
    tag = _tag


class MFSpec(NamedTuple):
    """One specialisation of ``mf_solve_kernel`` (csrc/mf_solve.cu)."""

    adam: bool
    beta2_one: bool
    add_assign: bool
    pump_rate_flag: bool
    noise: bool
    rng: int  # index into ops.philox.RNG_NAMES

    source = "mf_solve.cu"
    symbol = "ccvm_mf_solve"
    argtypes = _HEAD + [ctypes.c_void_p] * 3 + _TAIL  # mu, mu_tilde, sigma
    defines = _defines
    tag = _tag


class LangevinSpec(NamedTuple):
    """One specialisation of ``langevin_solve_kernel``
    (csrc/langevin_solve.cu): Langevin or pumped Langevin, plain or Adam."""

    pumped: bool
    adam: bool
    beta2_one: bool
    add_assign: bool
    pump_rate_flag: bool
    noise: bool
    rng: int  # index into ops.philox.RNG_NAMES

    source = "langevin_solve.cu"
    symbol = "ccvm_langevin_solve"
    argtypes = _HEAD + [ctypes.c_void_p] + _TAIL  # c
    defines = _defines
    tag = _tag


class DLVariantSpec(NamedTuple):
    """One specialisation of ``dl_variant_kernel`` (csrc/dl_variants.cu):
    the race harness's v2 or v3 DL step."""

    v3: bool
    fuse: bool  # both matvecs in one pass over Q
    unroll: int  # steps per outer iteration
    noise: bool
    rng: int  # index into ops.philox.HARNESS_RNG_NAMES

    source = "dl_variants.cu"
    symbol = "ccvm_dl_variant"
    argtypes = _HEAD + [ctypes.c_void_p] * 2 + _TAIL  # c, s
    defines = _defines

    def tag(self):
        # Lettered, since unroll may take two digits.
        return (f"v{3 if self.v3 else 2}f{int(self.fuse)}u{self.unroll}"
                f"n{int(self.noise)}r{self.rng}")


def launch_shape(n: int, x_arrays: int, kernel: str):
    """(rows per block, threads, shared-memory bytes) of a whole-solve
    kernel at problem size ``n`` whose block holds Q and ``x_arrays`` x rows
    per trajectory (``launch_shape`` in csrc/ccvm_common.cuh); raises when
    they do not fit a block."""
    np_ = -(-n // _TILE) * _TILE
    groups = np_ // _TILE
    row_groups = min(_MAX_ROW_GROUPS, _MAX_THREADS // groups)
    rows = row_groups * _TILE
    smem = 4 * (np_ * np_ + x_arrays * rows * (np_ + 4))
    if row_groups < 1 or smem > SMEM_LIMIT:
        raise ValueError(
            f"problem size N={n} does not fit the {kernel} kernel: Q plus a "
            f"tile of trajectories needs {smem} bytes of shared memory (limit "
            f"{SMEM_LIMIT}) and {groups} column groups (limit {_MAX_THREADS})"
        )
    return rows, groups * row_groups, smem


def find_nvcc() -> str:
    """Path of ``nvcc``; raises when the CUDA toolkit is absent."""
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of ccvm_tpu_torch are built from "
        "csrc/ on a host with the CUDA toolkit (set CUDA_HOME or put nvcc on "
        "PATH); without a card, run the solvers with device='cpu'"
    )


def _source_hash(name: str) -> str:
    """Hash of the source ``name`` and of every header under ``csrc/``."""
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith((".cuh", ".h")))
    for f in [name, *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return h.hexdigest()[:12]


def library_path(spec) -> str:
    stem = os.path.splitext(spec.source)[0]
    return os.path.join(
        BUILD_DIR, f"lib{stem}_{_source_hash(spec.source)}_{spec.tag()}.so"
    )


def build(specs) -> dict:
    """Compile every missing specialisation in ``specs``, one ``nvcc`` per
    library, all started together.  Returns ``{spec: ptxas report}`` for
    the libraries built now; raises with the compiler's output on failure."""
    todo = [s for s in dict.fromkeys(specs) if not os.path.exists(library_path(s))]
    if not todo:
        return {}
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for spec in todo:
        out = library_path(spec)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", *spec.defines(),
               "-o", tmp, os.path.join(CSRC, spec.source)]
        procs.append((spec, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failures = {}, []
    for spec, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{spec}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[spec] = log
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return reports


def load(spec):
    """The ctypes launch function of ``spec``, built first if needed.  A
    process reads and hashes the sources only at its first load of a spec."""
    key = (type(spec), spec)
    with _LOCK:
        fn = _LIBS.get(key)
        if fn is not None:
            return fn
        build([spec])
        fn = getattr(ctypes.CDLL(library_path(spec)), spec.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = spec.argtypes
        _LIBS[key] = fn
        return fn
