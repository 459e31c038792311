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
    noise: bool
    rng: int  # index into ops.philox.RNG_NAMES
    mma: bool = True  # the 3xTF32 tensor-core matvec; False: fp32 CUDA cores
    nt: int = 9  # n-tiles of 8 columns, ceil(N / 8) (0 for the CUDA-core matvec)

    source = "dl_solve.cu"
    symbol = "ccvm_dl_solve"
    argtypes = _HEAD + [ctypes.c_void_p] * 3 + _TAIL  # step table, c, s
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


# Shared memory of one SM (228 KB), and what the card reserves per block.
SM_SMEM = 233472
_BLOCK_RESERVED_SMEM = 1024
SMS = 132  # streaming multiprocessors of an H100 SXM
_MAX_NT = 16  # csrc/dl_solve.cu: at most 16 n-tiles, N <= 128


class LaunchShape(NamedTuple):
    """A DL launch: trajectories and threads per block, shared-memory bytes,
    N padded (to 8 for the tensor-core matvec, 4 for the CUDA cores), and
    the blocks per SM that the kernel's launch bounds and shared memory
    allow (the card reports the real count: ``dl_kernels.blocks_per_sm``)."""

    rows: int
    threads: int
    smem: int
    np: int
    blocks_per_sm: int


def dl_launch_shape(n: int, adam: bool, mma: bool = True) -> LaunchShape:
    """The launch rule of csrc/dl_solve.cu (``dl_launch_shape`` there).

    Tensor cores: a warp owns 8 trajectories, N is padded to a multiple of
    8 (``nt`` = N/8 n-tiles, at most 16), and the block holds Q's 3xTF32
    fragments (8 NP^2 bytes), a per-column offset (4 NP), and each warp its
    lanes' own arrays, 512 bytes per n-tile and float4: DL's c and s (nt
    float4s); DL-Adam's c and s beyond the four n-tiles it keeps in
    registers, and its two moments (2 nt).  DL: 8 warps (64 trajectories)
    at two blocks per SM; DL-Adam: 16 warps (128 trajectories) at one;
    fewer warps where they do not fit.  Either way 16 warps per SM at
    N <= 72.  The CUDA-core matvec keeps :func:`launch_shape`'s rule (two x
    arrays).  Raises when N does not fit."""
    if not mma:
        rows, threads, smem = launch_shape(n, 2, "DL")
        return LaunchShape(rows, threads, smem, -(-n // _TILE) * _TILE, 1 if adam else 2)
    np_ = -(-n // 8) * 8
    nt = np_ // 8
    fixed = 8 * np_ * np_ + 4 * np_
    per_warp = 512 * (max(0, nt - 4) + 2 * nt if adam else nt)
    max_warps, want_blocks = (16, 1) if adam else (8, 2)
    warps = min(max_warps, (SMEM_LIMIT - fixed) // per_warp)
    if nt > _MAX_NT or warps < 1 or fixed > SMEM_LIMIT:
        raise ValueError(
            f"problem size N={n} does not fit the DL{'-Adam' if adam else ''} "
            f"tensor-core kernel: it takes N <= {8 * _MAX_NT} (Q's fragments "
            f"need {fixed} bytes of shared memory, limit {SMEM_LIMIT})"
        )
    smem = fixed + warps * per_warp
    blocks = min(want_blocks, SM_SMEM // (smem + _BLOCK_RESERVED_SMEM))
    return LaunchShape(8 * warps, 32 * warps, smem, np_, blocks)


def waves(batch: int, shape: LaunchShape, sms: int = SMS) -> float:
    """Blocks of a batch over the card's resident slots: a grid fills
    whole waves within 10% when ``waves / ceil(waves) >= 0.9``."""
    return -(-batch // shape.rows) / (shape.blocks_per_sm * sms)


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


def load(spec, symbol=None, argtypes=None):
    """The ctypes function ``symbol`` (default: the launch function
    ``spec.symbol``, with ``spec.argtypes``) of ``spec``'s library, built
    first if needed.  A process reads and hashes the sources only at its
    first load of a spec's symbol."""
    key = (type(spec), spec) if symbol is None else (type(spec), spec, symbol)
    with _LOCK:
        fn = _LIBS.get(key)
        if fn is not None:
            return fn
        build([spec])
        fn = getattr(ctypes.CDLL(library_path(spec)), symbol or spec.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = spec.argtypes if symbol is None else argtypes
        _LIBS[key] = fn
        return fn
