"""Build the CUDA kernels of ``ccvm_tpu_torch/csrc`` at first use.

Each kernel source has a plain C interface and no PyTorch headers, so
``nvcc`` compiles it into a shared library in seconds; ``ctypes`` loads it.
A specialisation of the DL kernel template (Adam or not, second moment or
not, ...) is selected with ``-D`` flags and built into its own library, so a
process builds only what it launches.  Libraries go to ``build/kernels`` at
the root of the checkout (listed in ``.gitignore``) and are named by the
source's hash and the flags, so an edited source is rebuilt.

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


class DLSpec(NamedTuple):
    """One specialisation of ``dl_solve_kernel`` (csrc/dl_solve.cu)."""

    adam: bool
    beta2_one: bool
    add_assign: bool
    pump_rate_flag: bool
    pump_gt_one: bool
    noise: bool
    rng: int  # index into ops.philox.RNG_NAMES

    def defines(self):
        names = ("ADAM", "BETA2_ONE", "ADD_ASSIGN", "PUMP_RATE_FLAG",
                 "PUMP_GT_ONE", "NOISE", "RNG")
        return [f"-DCCVM_{k}={int(v)}" for k, v in zip(names, self)]

    def tag(self):
        return "".join(str(int(v)) for v in self)


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
    with open(os.path.join(CSRC, name), "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()[:12]


def library_path(spec: DLSpec) -> str:
    return os.path.join(
        BUILD_DIR, f"libdl_solve_{_source_hash('dl_solve.cu')}_{spec.tag()}.so"
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
    src = os.path.join(CSRC, "dl_solve.cu")
    procs = []
    for spec in todo:
        out = library_path(spec)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", *spec.defines(),
               "-o", tmp, src]
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


def load(spec: DLSpec):
    """The ctypes library of ``spec``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(spec)
        if lib is not None:
            return lib
        build([spec])
        lib = ctypes.CDLL(library_path(spec))
        lib.ccvm_dl_solve.restype = ctypes.c_int
        lib.ccvm_dl_solve.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_void_p,
        ]
        _LIBS[spec] = lib
        return lib
