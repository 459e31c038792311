"""The whole-solve DL-CCVM kernel's wrapper and its plain version.

:func:`dl_solve` takes the arguments of ``pallas_kernels.dl_solve``
(``ccvm_tpu/ops/pallas_kernels.py:938-974``), with an int seed in place of
the PRNG key.  For CUDA tensors it launches ``csrc/dl_solve.cu`` (the
counterpart of ``_dl_kernel``, or of ``_dl_adam_kernel`` when ``hp`` is
given); for CPU tensors it runs :func:`dl_solve_reference`.  There is no
fallback from the kernel to the plain version.

:func:`dl_solve_reference` computes the same function in eager PyTorch with
the step functions of :mod:`ccvm_tpu_torch.dynamics.dl`, the kernel's per-step
safety clip, its final clamp of c, and its noise (the Philox words of
:mod:`ccvm_tpu_torch.ops.philox` through the same transform).  Noise off, the
two agree to float32 round-off; noise on, they draw the same increments.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ccvm_tpu_torch.dynamics import dl as dyn
from ccvm_tpu_torch.ops import build, philox
from ccvm_tpu_torch.runtime import fp32_matmul

# Reference _DL_SAFETY_BOUND (pallas_kernels.py:259-270): one clip per step at
# a bound far above any physical amplitude keeps an overshooting explicit
# Euler step from cascading to Inf.
DL_SAFETY_BOUND = 1.0e3


def launch_shape(n: int, adam: bool = False, mma: bool = True):
    """(rows per block, threads, shared-memory bytes) of the kernel at
    problem size ``n`` (:func:`ccvm_tpu_torch.ops.build.dl_launch_shape`),
    with its tensor-core matvec or, ``mma`` False, its CUDA-core one; raises
    when they do not fit a block."""
    return tuple(build.dl_launch_shape(n, adam, mma)[:3])


def _spec(n, hp, noise_scale, rng, mma):
    noise = float(noise_scale) != 0.0
    return build.DLSpec(
        adam=hp is not None,
        beta2_one=hp is not None and hp.beta2 == 1.0,
        add_assign=hp is not None and bool(hp.add_assign),
        noise=noise,
        rng=philox.RNG_NAMES.index(rng) if noise else 1,
        mma=bool(mma),
        nt=build.dl_launch_shape(n, hp is not None, mma).np // 8 if mma else 0,
    )


def blocks_per_sm(n, *, noise_scale=1.0, rng="popcount16", hp=None, mma=True):
    """Blocks of the specialisation that :func:`dl_solve` launches with these
    arguments (``mma`` False: the CUDA-core matvec of the race harness) that
    the card keeps resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); builds it first."""
    spec = _spec(n, hp, noise_scale, rng, mma)
    rows = build.dl_launch_shape(n, hp is not None, mma).rows
    fn = build.load(spec, "ccvm_dl_blocks_per_sm",
                    [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    err = fn(int(n), rows, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"ccvm_dl_blocks_per_sm failed: cudaError_t {err}")
    return blocks.value


def _scalars(params, hp, noise_scale, pump_is_gt_one):
    """The kernel's 20 float32 scalars (csrc/dl_solve.cu DLScalars): the
    solve's, then its per-solve constants in float32 arithmetic, as the
    device would round them."""
    alpha = beta1 = beta2 = 0.0
    if hp is not None:
        alpha, beta1, beta2 = hp.alpha, hp.beta1, hp.beta2
    f = np.float32
    pump, S, dt, g, lo, hi = (f(x) for x in (params.pump, params.S, params.dt,
                                             params.g, params.lower_limit,
                                             params.upper_limit))
    s_d = np.sqrt(pump - f(1.0)) if pump_is_gt_one else S
    span = hi - lo
    vals = np.array(
        [pump, S, dt, params.noise_ratio, params.feedback_scale, g, lo, hi,
         params.iterations, alpha, beta1, 1.0 - beta1, beta2, 1.0 - beta2,
         noise_scale,
         s_d, span / s_d, hi + lo, f(0.25) * span / s_d, f(2.0) * g],
        np.float32,
    )
    return (ctypes.c_float * 20)(*vals.tolist())


def _step_table(params, hp, noise_scale, iterations, pump_rate_flag, device):
    """The kernel's per-step scalars, (iterations, 8) float32 on ``device``,
    by the plain version's own float32 operations (``dynamics/dl.py``,
    ``dynamics/common.adam_moment_update``): fs (0.5 + rate), pump rate,
    noise_scale sqrt(dt) nr_i, noise_scale sqrt(dt) / nr_i, and Adam's
    1 / (1 - beta1^(i+1)), 1 / (1 - beta2^(i+1)) (1 without Adam, or for
    beta2 = 1), then two zeros."""
    def f32(x):
        return torch.tensor(float(x), dtype=torch.float32, device=device)

    fi1 = torch.arange(1, int(iterations) + 1, dtype=torch.float32, device=device)
    rate = fi1 / f32(params.iterations) if pump_rate_flag else torch.ones_like(fi1)
    nr_i = (f32(params.noise_ratio) - 1.0) * torch.exp(
        -fi1 / f32(params.iterations) * 3.0) + 1.0
    noise = f32(noise_scale) * torch.sqrt(f32(params.dt))
    ones, zeros = torch.ones_like(fi1), torch.zeros_like(fi1)
    inv_b1 = inv_b2 = ones
    if hp is not None:
        inv_b1 = 1.0 / (1.0 - torch.pow(hp.beta1, fi1))
        if hp.beta2 != 1.0:
            inv_b2 = 1.0 / (1.0 - torch.pow(hp.beta2, fi1))
    cols = [f32(params.feedback_scale) * (0.5 + rate), f32(params.pump) * rate,
            noise * nr_i, noise / nr_i, inv_b1, inv_b2, zeros, zeros]
    return torch.stack(cols, dim=1).contiguous()


def check_problem(q_matrix, v_vector, kernel="dl_solve"):
    """Raise unless Q is a float32 (n, n) or (I, n, n) and V a float32 (n,)
    or (I, n) on Q's device."""
    if q_matrix.dtype != torch.float32 or v_vector.dtype != torch.float32:
        raise TypeError(f"{kernel} takes float32 Q and V")
    if q_matrix.ndim not in (2, 3) or q_matrix.shape[-1] != q_matrix.shape[-2]:
        raise ValueError(f"Q must be (n, n) or (I, n, n), got {tuple(q_matrix.shape)}")
    if tuple(v_vector.shape) != tuple(q_matrix.shape[:-1]):
        raise ValueError(
            f"V must be shaped {tuple(q_matrix.shape[:-1])}, got {tuple(v_vector.shape)}"
        )
    if v_vector.device != q_matrix.device:
        raise ValueError("Q and V must lie on the same device")


def _check(q_matrix, v_vector, params):
    check_problem(q_matrix, v_vector)
    if np.ndim(params.S) != 0:
        raise ValueError("the DL kernel takes a scalar S")


def solve_with(mma, seed, q_matrix, v_vector, params, *, iterations,
               batch_size, pump_rate_flag, pump_is_gt_one, noise_scale=1.0,
               rng="popcount16", hp=None):
    """:func:`dl_solve` with the matvec chosen: ``mma`` True is the 3xTF32
    tensor-core design that :func:`dl_solve` launches, False the fp32
    CUDA-core one that only the race harness launches.  Counts no launch:
    each caller counts its own."""
    if rng not in philox.RNG_NAMES:
        raise ValueError(f"rng must be one of {philox.RNG_NAMES}, got {rng!r}")
    _check(q_matrix, v_vector, params)
    kwargs = dict(
        iterations=iterations, batch_size=batch_size,
        pump_rate_flag=pump_rate_flag, pump_is_gt_one=pump_is_gt_one,
        noise_scale=noise_scale, rng=rng, hp=hp,
    )
    if q_matrix.device.type == "cpu":
        return dl_solve_reference(seed, q_matrix, v_vector, params, **kwargs)
    if q_matrix.device.type != "cuda":
        raise ValueError(f"dl_solve runs on cpu or cuda, not {q_matrix.device}")

    stacked = q_matrix.ndim == 3
    q = (q_matrix if stacked else q_matrix[None]).contiguous()
    v = (v_vector if stacked else v_vector[None]).contiguous()
    num_instances, n = q.shape[0], q.shape[-1]
    rows, _, _ = launch_shape(n, hp is not None, mma)
    spec = _spec(n, hp, noise_scale, rng, mma)
    launch = build.load(spec)
    steps = _step_table(params, hp, noise_scale, iterations, pump_rate_flag,
                        q.device)
    c = torch.empty((num_instances, batch_size, n), dtype=torch.float32,
                    device=q.device)
    s = torch.empty_like(c)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            q.data_ptr(), v.data_ptr(), steps.data_ptr(), c.data_ptr(),
            s.data_ptr(),
            num_instances, int(batch_size), n, int(iterations),
            int(seed) % 2**64,
            _scalars(params, hp, float(noise_scale), pump_is_gt_one), rows,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"dl_solve kernel launch failed: cudaError_t {err}")
    return (c, s) if stacked else (c[0], s[0])


def dl_solve(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    pump_rate_flag, pump_is_gt_one, noise_scale=1.0, rng="popcount16",
    hp=None,
):
    """Fused DL solve; ``hp`` selects the Adam variant.  Returns ``(c, s)``
    shaped ``(batch, n)``, or ``(I, batch, n)`` for a stacked ``(I, n, n)``
    Q, where instance ``i`` draws the noise of a solve with ``seed + i``."""
    out = solve_with(
        True, seed, q_matrix, v_vector, params, iterations=iterations,
        batch_size=batch_size, pump_rate_flag=pump_rate_flag,
        pump_is_gt_one=pump_is_gt_one, noise_scale=noise_scale, rng=rng, hp=hp,
    )
    if q_matrix.device.type == "cuda":
        if hp is None:
            dl_solve.dl_launches += 1
        else:
            dl_solve.dl_adam_launches += 1
    return out


# Launch counts of the two kernels (the wrapper adds one per launch).
dl_solve.dl_launches = 0
dl_solve.dl_adam_launches = 0


def dl_solve_reference(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    pump_rate_flag, pump_is_gt_one, noise_scale=1.0, rng="popcount16",
    hp=None,
):
    """Plain PyTorch version of :func:`dl_solve` (same arguments, same
    result), on the tensors' own device."""
    if rng not in philox.RNG_NAMES:
        raise ValueError(f"rng must be one of {philox.RNG_NAMES}, got {rng!r}")
    stacked = q_matrix.ndim == 3
    q = q_matrix if stacked else q_matrix[None]
    v = (v_vector if stacked else v_vector[None])[:, None, :]
    num_instances, n = q.shape[0], q.shape[-1]
    device = q.device
    c0 = torch.zeros((num_instances, int(batch_size), n), dtype=torch.float32,
                     device=device)
    rows = torch.arange(int(batch_size), dtype=torch.int64, device=device)
    instances = torch.arange(num_instances, dtype=torch.int64, device=device)
    bound = DL_SAFETY_BOUND
    with fp32_matmul():
        if hp is None:
            step = dyn.make_step(q, v, params, pump_rate_flag, pump_is_gt_one)
            state = (c0, c0)
        else:
            step = dyn.make_adam_step(
                q, v, params, pump_rate_flag, pump_is_gt_one, hp
            )
            state = (c0,) * 6
        for i in range(int(iterations)):
            if noise_scale == 0.0:
                w_c = w_s = c0
            else:
                w_c, w_s = philox.wiener_pair(seed, i, rows, n, rng, instances)
                if noise_scale != 1.0:
                    w_c, w_s = w_c * noise_scale, w_s * noise_scale
            state = step(state, i, w_c, w_s)
            state = (state[0].clamp(-bound, bound),
                     state[1].clamp(-bound, bound)) + tuple(state[2:])
    c = state[0].clamp(-float(params.S), float(params.S))
    s = state[1]
    return (c, s) if stacked else (c[0], s[0])
