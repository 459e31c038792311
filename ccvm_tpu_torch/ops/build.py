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
import os
import shutil
import threading
from typing import NamedTuple

from ccvm_tpu_torch import sharedlib

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


# Fields of the solve kernels' specs that select a build for a feature (a
# per-column S, a segment launch, a per-element S, a tensor-parallel solve's
# one step): left out of the flags and the tag when 0, so a whole solve with
# a scalar S is built as before them.
_FEATURES = ("cols", "seg", "elem", "ext")


def _defines(spec):
    return [f"-DCCVM_{k.upper()}={int(v)}" for k, v in zip(spec._fields, spec)
            if k not in _FEATURES or v]


def _tag(spec):
    return "".join(str(int(v)) for k, v in zip(spec._fields, spec)
                   if k not in _FEATURES) + "".join(
        f"{k[0]}{int(v)}" for k, v in zip(spec._fields, spec) if k in _FEATURES and v)


_F32P = ctypes.POINTER(ctypes.c_float)
# (q, v, outputs..., instances, batch, n, iterations, seed, scalars,
# rows_per_block, stream) of the exported launch functions; the solve
# kernels' take the per-column (or per-element) S, a Segment and the row
# base after them (_SOLVE_TAIL).
_HEAD = [ctypes.c_void_p, ctypes.c_void_p]
_TAIL = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_ulonglong, _F32P, ctypes.c_int, ctypes.c_void_p]


class Segment(ctypes.Structure):
    """A segment launch's host arguments (csrc/ccvm_common.cuh ``Segment``):
    device pointers of the state to start from (``inp[0]`` None: the
    initial state) and of the moments to write, DL's clamped c, the absolute
    first step, the whole solve's steps and the first block that holds a row
    of the launch (which the entry point sets from its row base)."""

    _fields_ = [("inp", ctypes.c_void_p * 6), ("out", ctypes.c_void_p * 6),
                ("clamped", ctypes.c_void_p), ("start", ctypes.c_int),
                ("total", ctypes.c_int), ("first_block", ctypes.c_int)]


_SOLVE_TAIL = _TAIL + [ctypes.c_void_p, ctypes.POINTER(Segment), ctypes.c_int]


def check_row_base(row_base, rows, stacked, kernel):
    """Raise unless a launch's row base suits the kernel: a multiple of its
    ``rows`` a block (its grid starts that many blocks early, csrc/
    ccvm_common.cuh ``Segment``), and one instance."""
    if row_base < 0 or row_base % rows or (row_base and stacked):
        raise ValueError(
            f"{kernel} takes a row base that is a multiple of its {rows} rows a block, "
            f"for one instance: a data-parallel rank's batch must be such a multiple "
            f"(got row base {row_base})")
# (mv, v, steps, state, x_out, batch, nl, col_base, row_base, step, total,
# seed, scalars, stream) of the one-step builds' ccvm_*_step.
STEP_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                 + [ctypes.c_ulonglong, _F32P, ctypes.c_void_p])


def segment(state, shape, start, total, moments, clamped=None):
    """The ``Segment`` of a launch from ``state`` (tensors on the card in the
    kernel's order, or None: the initial state) at step ``start`` of
    ``total``, writing ``moments`` (and DL's ``clamped`` c); returns it with
    the contiguous state arrays it points at, which must outlive the
    launch."""
    arrays = [] if state is None else [x.reshape(shape).contiguous() for x in state]
    inp = [x.data_ptr() for x in arrays] + [None] * (6 - len(arrays))
    out = [m.data_ptr() for m in moments] + [None] * (6 - len(moments))
    return Segment((ctypes.c_void_p * 6)(*inp), (ctypes.c_void_p * 6)(*out),
                   None if clamped is None else clamped.data_ptr(), int(start),
                   int(total)), arrays


class DLSpec(NamedTuple):
    """One specialisation of ``dl_solve_kernel`` (csrc/dl_solve.cu)."""

    adam: bool
    beta2_one: bool
    add_assign: bool
    noise: bool
    rng: int  # index into ops.philox.RNG_NAMES
    mma: bool = True  # the 3xTF32 tensor-core matvec; False: fp32 CUDA cores
    nt: int = 9  # n-tiles of 8 columns, ceil(N / 8) (0 for the CUDA-core matvec)
    cols: int = 0  # per-column S: 1 in the final clamp only, 2 in the drift too
    seg: bool = False  # a segment launch
    elem: bool = False  # with cols, S one an element of a (batch, n) array
    ext: bool = False  # one step of a tensor-parallel solve (ccvm_dl_step)

    source = "dl_solve.cu"
    symbol = "ccvm_dl_solve"
    argtypes = _HEAD + [ctypes.c_void_p] * 3 + _SOLVE_TAIL  # step table, c, s
    defines = _defines
    tag = _tag


class MFSpec(NamedTuple):
    """One specialisation of ``mf_solve_kernel`` (csrc/mf_solve.cu)."""

    adam: bool
    beta2_one: bool
    add_assign: bool
    noise: bool
    rng: int  # index into ops.philox.RNG_NAMES
    np: int = 72  # N padded to a multiple of 4 (the matvec's bound, unrolled)
    cols: bool = False  # a per-column S
    seg: bool = False  # a segment launch
    elem: bool = False  # with cols, S one an element of a (batch, n) array
    ext: bool = False  # one step of a tensor-parallel solve (ccvm_mf_step)

    source = "mf_solve.cu"
    symbol = "ccvm_mf_solve"
    argtypes = _HEAD + [ctypes.c_void_p] * 4 + _SOLVE_TAIL  # step table, mu, mu_tilde, sigma
    defines = _defines
    tag = _tag


class LangevinSpec(NamedTuple):
    """One specialisation of ``langevin_solve_kernel``
    (csrc/langevin_solve.cu): Langevin or pumped Langevin, plain or Adam;
    the pump schedule is in the step table, so one library serves both."""

    pumped: bool
    adam: bool
    beta2_one: bool
    add_assign: bool
    noise: bool
    rng: int  # index into ops.philox.RNG_NAMES
    np: int  # N padded to a multiple of 8 (the matvec's bound, unrolled)
    cols: bool = False  # a per-column S
    seg: bool = False  # a segment launch
    elem: bool = False  # with cols, S one an element of a (batch, n) array
    ext: bool = False  # one step of a tensor-parallel solve (ccvm_langevin_step)

    source = "langevin_solve.cu"
    symbol = "ccvm_langevin_solve"
    argtypes = _HEAD + [ctypes.c_void_p] * 2 + _SOLVE_TAIL  # step table, c
    defines = _defines
    tag = _tag


class DLVariantSpec(NamedTuple):
    """One specialisation of ``dl_variant_kernel`` (csrc/dl_variants.cu):
    the race harness's v2 or v3 DL step."""

    v3: bool
    fuse: bool  # c and s stacked in one m16 tile, each Q fragment feeding both
    unroll: int  # steps per outer iteration
    noise: bool
    rng: int  # index into ops.philox.HARNESS_RNG_NAMES
    nt: int = 9  # n-tiles of 8 columns, ceil(N / 8)

    source = "dl_variants.cu"
    symbol = "ccvm_dl_variant"
    argtypes = _HEAD + [ctypes.c_void_p] * 3 + _TAIL  # step table, c, s
    defines = _defines

    def tag(self):
        # Lettered, since unroll and nt may take two digits.
        return (f"v{3 if self.v3 else 2}f{int(self.fuse)}u{self.unroll}"
                f"n{int(self.noise)}r{self.rng}t{self.nt}")


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
    """A DL or MF launch: trajectories and threads per block, shared-memory bytes,
    N padded (to 8 for the tensor-core matvec, 4 for the CUDA cores), and
    the blocks per SM that the kernel's launch bounds and shared memory
    allow (the card reports the real count: ``dl_kernels.blocks_per_sm``)."""

    rows: int
    threads: int
    smem: int
    np: int
    blocks_per_sm: int


def dl_launch_shape(n: int, adam: bool, mma: bool = True, cols: int = 0) -> LaunchShape:
    """The launch rule of csrc/dl_solve.cu (``dl_launch_shape`` there).

    Tensor cores: a warp owns 8 trajectories, N is padded to a multiple of
    8 (``nt`` = N/8 n-tiles, at most 16), and the block holds Q's 3xTF32
    fragments (8 NP^2 bytes), a per-column offset (4 NP; with ``cols`` 2,
    a per-column S_d, the x and feedback scales too), and each warp its
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
    fixed = 8 * np_ * np_ + 4 * np_ * (3 if cols == 2 else 1)
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


def variant_launch_shape(n: int, fuse: bool) -> LaunchShape:
    """The launch rule of csrc/dl_variants.cu (``variant_launch_shape``
    there): 64 trajectories a block, as 8 warps of 8 with ``fuse`` (c and s
    stacked in one m16 tile, at most 128 registers) or 4 warps of 16 without
    (a c tile and an s tile, up to 255 registers); N padded to a multiple of
    8 (at most 16 n-tiles).  The block holds Q's 3xTF32 fragments (8 NP^2
    bytes), the per-column offsets (4 NP) and each lane's state, 16 bytes
    per n-tile and float4 of c and s (nt float4s with ``fuse``, 2 nt
    without): the same bytes either way.  Two blocks per SM where shared
    memory allows.  Raises when N does not fit."""
    np_ = -(-n // 8) * 8
    nt = np_ // 8
    warps = 8 if fuse else 4
    smem = 8 * np_ * np_ + 4 * np_ + 16 * (nt if fuse else 2 * nt) * 32 * warps
    if nt > _MAX_NT or smem > SMEM_LIMIT:
        raise ValueError(
            f"problem size N={n} does not fit the DL variant kernel: it takes N <= "
            f"{8 * _MAX_NT} and {smem} bytes of shared memory (limit {SMEM_LIMIT})")
    blocks = min(2, SM_SMEM // (smem + _BLOCK_RESERVED_SMEM))
    return LaunchShape(64, 32 * warps, smem, np_, blocks)


_MF_THREADS = 288  # csrc/mf_solve.cu kThreads
_MF_MAX_ROW_GROUPS = 16  # csrc/mf_solve.cu kMaxRowGroups
# Registers a thread at __launch_bounds__(288, 2): an SM's 65,536 registers
# are four quarters of 16,384, each serving a quarter of its warps, so 18
# warps leave 96 (five warps to a quarter, at a multiple of 8).
_MF_REGISTERS = 96
_QUARTER_REGISTERS = 16384
_MAX_BLOCKS_PER_SM = 32


def mf_launch_shape(n: int, adam: bool, cols: bool = False) -> LaunchShape:
    """The launch rule of csrc/mf_solve.cu (``mf_launch_shape`` there).

    A thread owns a 4 x 4 tile of trajectories and columns (N padded to a
    multiple of 4); a block is at most 16 row groups (64 trajectories) and
    288 threads (two blocks per SM, 18 warps, at N=70), and holds Q (4 NP^2
    bytes), the per-column V term (4 NP; ``cols``: S_j and its reciprocal
    too, 8 NP more), two x buffers of its rows at
    stride NP + 4 (Adam: one), and each thread's own float4s: sigma of its
    four rows (64 bytes), and for Adam their two moments and mu (192 bytes
    more).  The blocks per SM are those that shared memory and 96 registers
    a thread allow (the card reports the real count:
    ``mf_kernels.blocks_per_sm``).  Raises when N does not fit a block."""
    np_ = -(-n // _TILE) * _TILE
    groups = np_ // _TILE
    row_groups = min(_MF_MAX_ROW_GROUPS, _MF_THREADS // groups)
    threads = groups * row_groups
    rows = _TILE * row_groups
    smem = (4 * (np_ * np_ + (3 if cols else 1) * np_
                 + (1 if adam else 2) * rows * (np_ + 4))
            + (256 if adam else 64) * threads)
    if row_groups < 1 or smem > SMEM_LIMIT:
        raise ValueError(
            f"problem size N={n} does not fit the MF{'-Adam' if adam else ''} kernel: "
            f"Q plus a tile of trajectories needs {smem} bytes of shared memory "
            f"(limit {SMEM_LIMIT}) and {groups} column groups (limit {_MF_THREADS})"
        )
    warps = -(-threads // 32)
    blocks = min(SM_SMEM // (smem + _BLOCK_RESERVED_SMEM), _MAX_BLOCKS_PER_SM)
    while -(-blocks * warps // 4) * 32 * _MF_REGISTERS > _QUARTER_REGISTERS:
        blocks -= 1
    return LaunchShape(rows, threads, smem, np_, blocks)


_LGV_GROUPS = 8  # csrc/langevin_solve.cu kGroups: column groups a block
_LGV_ROW_GROUPS = 16  # csrc/langevin_solve.cu kRowGroups
_LGV_MAX_COLS = 16  # csrc/langevin_solve.cu kMaxCols: N <= 128
# Blocks per SM that __launch_bounds__(128, 2) allows at up to 255 registers a
# thread: 8 warps, two to each quarter of the SM's 65,536 registers.
_LGV_MAX_BLOCKS = 2


def langevin_launch_shape(n: int, adam: bool, per_col: bool = False) -> LaunchShape:
    """The launch rule of csrc/langevin_solve.cu (``lgv_launch_shape``
    there).

    N is padded to a multiple of 8 (NP), and a block is 8 column groups by
    16 row groups, 128 threads: a thread owns NP/8 columns (9 at N=70) of 8
    trajectory rows, or 4 for Adam (half that beyond 9 columns), every 16th
    row of the block (128 trajectories a block, Adam 64).  It holds Q
    (4 NP^2 bytes; ``per_col``: S_j and scale_j, 8 NP more), two x buffers
    of its rows at stride NP + 4, and for Adam each thread's second moments
    of its tile (4 bytes an element).  The blocks
    per SM are those that shared memory and the launch bounds allow, at
    most two (the card reports the real count:
    ``langevin_kernels.blocks_per_sm``).  Raises when N does not fit."""
    np_ = -(-n // _LGV_GROUPS) * _LGV_GROUPS
    cols = np_ // _LGV_GROUPS
    rows = _LGV_ROW_GROUPS * (4 if adam else 8) // (2 if cols > 9 else 1)
    threads = _LGV_GROUPS * _LGV_ROW_GROUPS
    smem = (4 * np_ * np_ + (8 * np_ if per_col else 0) + 4 * 2 * rows * (np_ + 4)
            + (4 * rows * np_ if adam else 0))
    if cols > _LGV_MAX_COLS or smem > SMEM_LIMIT:
        raise ValueError(
            f"problem size N={n} does not fit the Langevin{'-Adam' if adam else ''} "
            f"kernel: it takes N <= {_LGV_GROUPS * _LGV_MAX_COLS} (Q and two x buffers "
            f"need {smem} bytes of shared memory, limit {SMEM_LIMIT})"
        )
    blocks = min(SM_SMEM // (smem + _BLOCK_RESERVED_SMEM), _LGV_MAX_BLOCKS)
    return LaunchShape(rows, threads, smem, np_, blocks)


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
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith((".cuh", ".h")))
    return sharedlib.digest(os.path.join(CSRC, f) for f in [name, *headers])


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

    def command(spec):
        return lambda tmp: [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                            "-Xcompiler", "-fPIC", "-Xptxas", "-v", *spec.defines(),
                            "-o", tmp, os.path.join(CSRC, spec.source)]

    outs = {spec: library_path(spec) for spec in todo}
    logs = sharedlib.compile_into([(outs[s], command(s)) for s in todo],
                                  "the CUDA kernels of ccvm_tpu_torch (nvcc)")
    return {spec: logs[out] for spec, out in outs.items()}


def kernel_report(log: str) -> str:
    """ptxas's registers and spills of the solve kernel in a library's
    build log (the entry function named *_solve_kernel, *_variant_kernel or
    *_step_kernel; a library may hold helper kernels too)."""
    lines = [ln.strip() for ln in log.splitlines()]
    entry = None
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln:
            entry = any(k in ln for k in ("solve_kernel", "variant_kernel", "step_kernel"))
        elif entry and "spill" in ln and i + 1 < len(lines) and "registers" in lines[i + 1]:
            return f"{lines[i + 1].split(':', 1)[-1].strip()}; {ln}"
    return log.strip()[-200:]


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
