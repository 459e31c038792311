"""The DL race harness's two variant kernels: wrappers and plain versions.

:func:`dl_v2` and :func:`dl_v3` take the arguments of ``dl_v2`` and
``dl_v3`` in ``tools/kernel_experiments.py:173-174`` and ``:283-284``, with
an int seed in place of the PRNG key, and return ``(c, s)``.  For CUDA
tensors they launch ``csrc/dl_variants.cu`` (the counterparts of
``_dl_kernel_v2`` and ``_dl_kernel_v3``); for CPU tensors they run
:func:`dl_v2_reference` and :func:`dl_v3_reference`.  There is no fallback
from the kernel to the plain version.

``params_vec`` holds the harness's nine float32s: pump, S, dt, noise_ratio,
fs, g, lo, hi, T.  Unlike production (:mod:`ccvm_tpu_torch.ops.dl_kernels`)
the variants clip nothing per step, always ramp the pump as (i+1)/T and
always take S_d = sqrt(pump-1).  The noise is the Philox words of
:mod:`ccvm_tpu_torch.ops.philox` through a transform of
``philox.HARNESS_RNGS``; ``noise_scale`` exists so the kernels can be held
noise-off (0 elides the generator).

The kernels run the production DL kernel's tensor-core design (3xTF32
``mma.sync`` through ``csrc/ccvm_mma.cuh``, two blocks per SM, 64
trajectories a block): ``fuse_matvec`` stacks a warp's 8
trajectories' c and s in one m16 tile; without it a warp owns 16
trajectories in a c tile and an s tile, two passes over Q (v3 always).  v2's
mma takes x as written and v3's c and s themselves
(``tools/tc_model.py --family variants`` holds both schemes on the CPU).
The wrapper hands the kernel its per-step scalars in a table
(:func:`_step_table`) and its per-solve constants (:func:`_scalars`), both
by the plain version's own float32 operations.

Each plain version mirrors its own kernel's order of operations (v2 scales
the draw before ``diff``, v3 after; v3 sums ``c^2 + s^2`` once), so noise
off the two agree to float32 round-off and noise on they draw the same
increments.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ccvm_tpu_torch.ops import build, philox
from ccvm_tpu_torch.ops.dl_kernels import check_problem
from ccvm_tpu_torch.runtime import fp32_matmul

PARAM_NAMES = ("pump", "S", "dt", "noise_ratio", "fs", "g", "lo", "hi", "T")


def _params(params_vec):
    """The nine parameters as float32 values; raises for pump <= 1, where
    S_d = sqrt(pump - 1) is not a number."""
    pv = np.asarray(params_vec, np.float32).reshape(-1)
    if pv.size != len(PARAM_NAMES):
        raise ValueError(f"params_vec holds {PARAM_NAMES}, got {pv.size} values")
    if not pv[0] > 1.0:
        raise ValueError(
            f"the DL variants take S_d = sqrt(pump - 1) and need pump > 1, got {pv[0]}"
        )
    return pv


def _validate(kernel, q_matrix, v_vector, params_vec, rng_name, unroll):
    check_problem(q_matrix, v_vector, kernel)
    if rng_name not in philox.HARNESS_RNGS:
        raise ValueError(
            f"rng_name must be one of {philox.HARNESS_RNG_NAMES}, got {rng_name!r}"
        )
    if int(unroll) < 1:
        raise ValueError(f"unroll must be at least 1, got {unroll}")
    return _params(params_vec)


def dl_v2(seed, q_matrix, v_vector, params_vec, *, iterations, batch_size,
          rng_name, fuse_matvec, unroll, noise_scale=1.0):
    """The v2 DL solve; ``iterations`` must be a multiple of ``unroll``, as
    the TPU kernel asserts.  Returns ``(c, s)`` shaped ``(batch, n)``, or
    ``(I, batch, n)`` for a stacked ``(I, n, n)`` Q, where instance ``i``
    draws the noise of a solve with ``seed + i``."""
    pv = _validate("dl_v2", q_matrix, v_vector, params_vec, rng_name, unroll)
    if int(iterations) % int(unroll):
        raise ValueError(
            f"dl_v2 runs whole unrolled bodies: iterations ({iterations}) must "
            f"be a multiple of unroll ({unroll})"
        )
    kw = dict(iterations=iterations, batch_size=batch_size, rng_name=rng_name,
              fuse_matvec=fuse_matvec, unroll=unroll, noise_scale=noise_scale)
    if q_matrix.device.type == "cpu":
        return dl_v2_reference(seed, q_matrix, v_vector, pv, **kw)
    out = _launch(False, seed, q_matrix, v_vector, pv, **kw)
    dl_v2.launches += 1
    return out


def dl_v3(seed, q_matrix, v_vector, params_vec, *, iterations, batch_size,
          rng_name, unroll, noise_scale=1.0):
    """The v3 DL solve (Q prescaled once, a tail loop for ``iterations %
    unroll``); returns as :func:`dl_v2`."""
    pv = _validate("dl_v3", q_matrix, v_vector, params_vec, rng_name, unroll)
    kw = dict(iterations=iterations, batch_size=batch_size, rng_name=rng_name,
              unroll=unroll, noise_scale=noise_scale)
    if q_matrix.device.type == "cpu":
        return dl_v3_reference(seed, q_matrix, v_vector, pv, **kw)
    # The TPU kernel runs its two matvecs as two dots.
    out = _launch(True, seed, q_matrix, v_vector, pv, fuse_matvec=False, **kw)
    dl_v3.launches += 1
    return out


# Launch counts of the two kernels (each wrapper adds one per launch).
dl_v2.launches = 0
dl_v3.launches = 0


def _spec(v3, fuse, unroll, noise_scale, rng_name, n):
    noise = float(noise_scale) != 0.0
    return build.DLVariantSpec(
        v3=v3, fuse=bool(fuse), unroll=int(unroll), noise=noise,
        rng=philox.HARNESS_RNG_NAMES.index(rng_name) if noise else 0, nt=-(-n // 8))


def blocks_per_sm(spec, n):
    """Blocks of a variant specialisation (a :class:`build.DLVariantSpec`)
    the card keeps resident per SM at problem size ``n``
    (``ccvm_dl_variant_blocks_per_sm``); builds it if needed."""
    rows = build.variant_launch_shape(n, spec.fuse).rows
    fn = build.load(spec, "ccvm_dl_variant_blocks_per_sm",
                    [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    err = fn(n, rows, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"ccvm_dl_variant_blocks_per_sm failed: cudaError_t {err}")
    return blocks.value


def _scalars(pv, noise_scale):
    """The kernel's per-solve constants in float32, in ``VariantScalars``
    order: S, dt, noise_scale, 2g, S_d, span, mid, span/S_d, 0.25 span/S_d
    and v3's qs = (0.25 span/S_d) (span/S_d), as the plain version takes
    them."""
    pump, S, dt, _, _, g, lo, hi, _ = (np.float32(x) for x in pv)
    S_d = np.sqrt(pump - np.float32(1.0))
    span, mid = hi - lo, hi + lo
    sc = span / S_d
    alpha = np.float32(0.25) * span / S_d
    values = [S, dt, np.float32(noise_scale), np.float32(2.0) * g, S_d, span, mid, sc,
              alpha, alpha * sc]
    return (ctypes.c_float * len(values))(*(float(x) for x in values))


def _step_table(pv, iterations, device):
    """The kernel's per-step scalars, (iterations, 4) float32 on ``device``,
    by the plain version's own float32 operations: fs (0.5 + rate), pump
    rate, sqrt(dt) nr_i and sqrt(dt) / nr_i, row i for step i."""
    pump, _, dt, noise_ratio, fs, _, _, _, T = (
        torch.tensor(float(x), dtype=torch.float32, device=device) for x in pv)
    fi1 = torch.arange(1, int(iterations) + 1, dtype=torch.float32, device=device)
    rate = fi1 / T
    nr_i = (noise_ratio - 1.0) * torch.exp(-fi1 / T * 3.0) + 1.0
    sqrt_dt = torch.sqrt(dt)
    return torch.stack([fs * (0.5 + rate), pump * rate, sqrt_dt * nr_i, sqrt_dt / nr_i],
                       dim=1).contiguous()


def _launch(v3, seed, q_matrix, v_vector, pv, *, iterations, batch_size,
            rng_name, fuse_matvec, unroll, noise_scale):
    if q_matrix.device.type != "cuda":
        raise ValueError(f"the DL variants run on cpu or cuda, not {q_matrix.device}")
    stacked = q_matrix.ndim == 3
    q = (q_matrix if stacked else q_matrix[None]).contiguous()
    v = (v_vector if stacked else v_vector[None]).contiguous()
    num_instances, n = q.shape[0], q.shape[-1]
    rows = build.variant_launch_shape(n, fuse_matvec).rows
    launch = build.load(_spec(v3, fuse_matvec, unroll, noise_scale, rng_name, n))
    c = torch.empty((num_instances, batch_size, n), dtype=torch.float32,
                    device=q.device)
    s = torch.empty_like(c)
    with torch.cuda.device(q.device):
        steps = _step_table(pv, iterations, q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            q.data_ptr(), v.data_ptr(), steps.data_ptr(), c.data_ptr(), s.data_ptr(),
            num_instances, int(batch_size), n, int(iterations),
            int(seed) % 2**64, _scalars(pv, noise_scale), rows, stream,
        )
    if err != 0:
        name = "dl_v3" if v3 else "dl_v2"
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    return (c, s) if stacked else (c[0], s[0])


def dl_v2_reference(seed, q_matrix, v_vector, params_vec, *, iterations,
                    batch_size, rng_name, fuse_matvec, unroll, noise_scale=1.0):
    """Plain PyTorch version of :func:`dl_v2` (same arguments, same result),
    on the tensors' own device.  ``fuse_matvec`` and ``unroll`` change how
    the kernel schedules the work, not what it computes."""
    del fuse_matvec, unroll
    return _reference(False, seed, q_matrix, v_vector, params_vec,
                      iterations, batch_size, rng_name, noise_scale)


def dl_v3_reference(seed, q_matrix, v_vector, params_vec, *, iterations,
                    batch_size, rng_name, unroll, noise_scale=1.0):
    """Plain PyTorch version of :func:`dl_v3`, on the tensors' own device."""
    del unroll
    return _reference(True, seed, q_matrix, v_vector, params_vec,
                      iterations, batch_size, rng_name, noise_scale)


def _reference(v3, seed, q_matrix, v_vector, params_vec, iterations,
               batch_size, rng_name, noise_scale, *, matvec=torch.matmul):
    """The plain solve of either variant; ``matvec(x, Q)`` computes each
    step's two products (the plain one, ``torch.matmul`` in full float32,
    by default; ``ccvm_tpu_torch/tools/tc_model.py`` passes models of the
    kernel's tensor-core products)."""
    stacked = q_matrix.ndim == 3
    q = q_matrix if stacked else q_matrix[None]
    v = (v_vector if stacked else v_vector[None])[:, None, :]
    num_instances, n = q.shape[0], q.shape[-1]
    device = q.device
    pump, S, dt, noise_ratio, fs, g, lo, hi, T = (
        torch.tensor(float(x), dtype=torch.float32, device=device)
        for x in _params(params_vec)
    )
    S_d = torch.sqrt(pump - 1.0)
    sqrt_dt = torch.sqrt(dt)
    span = hi - lo
    mid = hi + lo
    sc = span / S_d
    g3 = v * span / (2.0 * S_d)
    if v3:
        alpha = 0.25 * span / S_d
        fb0 = alpha * mid * q.sum(dim=1, keepdim=True) + g3
        qs = alpha * sc
    c = s = torch.zeros((num_instances, int(batch_size), n), dtype=torch.float32,
                        device=device)
    rows = torch.arange(int(batch_size), dtype=torch.int64, device=device)
    instances = torch.arange(num_instances, dtype=torch.int64, device=device)
    with fp32_matmul():
        for i in range(int(iterations)):
            fi1 = torch.full((), float(i) + 1.0, dtype=torch.float32, device=device)
            rate = fi1 / T
            nr_i = (noise_ratio - 1.0) * torch.exp(-fi1 / T * 3.0) + 1.0
            fs_dyn = fs * (0.5 + rate)
            pr = pump * rate
            c_pow = torch.square(c)
            s_pow = torch.square(s)
            if v3:
                fb_c = matvec(c, q) * qs
                fb_s = matvec(s, q) * qs
                sum_pow = c_pow + s_pow
                c_drift = -fs_dyn * (fb_c + fb0) + (-1.0 + pr - sum_pow) * c
                s_drift = -fs_dyn * (fb_s + fb0) + (-1.0 - pr - sum_pow) * s
            else:
                fb_c = 0.25 * matvec(c * sc + mid, q) * sc
                fb_s = 0.25 * matvec(s * sc + mid, q) * sc
                c_drift = -fs_dyn * (fb_c + g3) + (-1.0 + pr - c_pow - s_pow) * c
                s_drift = -fs_dyn * (fb_s + g3) + (-1.0 - pr - c_pow - s_pow) * s
            c_new = c + dt * c_drift
            s_new = s + dt * s_drift
            if noise_scale != 0.0:
                z1, z2 = philox.harness_pair(seed, i, rows, n, rng_name, instances)
                if noise_scale != 1.0:
                    z1, z2 = z1 * noise_scale, z2 * noise_scale
                if v3:
                    diff = 2.0 * g * torch.sqrt(sum_pow + 0.5)
                    c_new = c_new + (diff * (sqrt_dt * nr_i)) * z1
                    s_new = s_new + (diff * (sqrt_dt / nr_i)) * z2
                else:
                    diff = 2.0 * g * torch.sqrt(c_pow + s_pow + 0.5)
                    c_new = c_new + diff * (z1 * (sqrt_dt * nr_i))
                    s_new = s_new + diff * (z2 * (sqrt_dt / nr_i))
            c, s = c_new, s_new
    c = torch.clamp(c, -S, S)
    return (c, s) if stacked else (c[0], s[0])
