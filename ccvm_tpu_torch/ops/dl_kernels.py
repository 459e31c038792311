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


def launch_shape(n: int):
    """(rows per block, threads, shared-memory bytes) of the kernel at
    problem size ``n`` (Q and two x arrays, c and s, per block); raises when
    they do not fit a block."""
    return build.launch_shape(n, 2, "DL")


def _scalars(params, hp, noise_scale):
    """The kernel's 15 float32 scalars (csrc/dl_solve.cu DLScalars)."""
    alpha = beta1 = beta2 = 0.0
    if hp is not None:
        alpha, beta1, beta2 = hp.alpha, hp.beta1, hp.beta2
    vals = np.array(
        [params.pump, params.S, params.dt, params.noise_ratio,
         params.feedback_scale, params.g, params.lower_limit,
         params.upper_limit, params.iterations,
         alpha, beta1, 1.0 - beta1, beta2, 1.0 - beta2, noise_scale],
        np.float32,
    )
    return (ctypes.c_float * 15)(*vals.tolist())


def _check(q_matrix, v_vector, params):
    if q_matrix.dtype != torch.float32 or v_vector.dtype != torch.float32:
        raise TypeError("dl_solve takes float32 Q and V")
    if q_matrix.ndim not in (2, 3) or q_matrix.shape[-1] != q_matrix.shape[-2]:
        raise ValueError(f"Q must be (n, n) or (I, n, n), got {tuple(q_matrix.shape)}")
    if tuple(v_vector.shape) != tuple(q_matrix.shape[:-1]):
        raise ValueError(
            f"V must be shaped {tuple(q_matrix.shape[:-1])}, got {tuple(v_vector.shape)}"
        )
    if v_vector.device != q_matrix.device:
        raise ValueError("Q and V must lie on the same device")
    if np.ndim(params.S) != 0:
        raise ValueError("the DL kernel takes a scalar S")


def dl_solve(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    pump_rate_flag, pump_is_gt_one, noise_scale=1.0, rng="popcount16",
    hp=None,
):
    """Fused DL solve; ``hp`` selects the Adam variant.  Returns ``(c, s)``
    shaped ``(batch, n)``, or ``(I, batch, n)`` for a stacked ``(I, n, n)``
    Q, where instance ``i`` draws the noise of a solve with ``seed + i``."""
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
    rows, _, _ = launch_shape(n)
    spec = build.DLSpec(
        adam=hp is not None,
        beta2_one=hp is not None and hp.beta2 == 1.0,
        add_assign=hp is not None and bool(hp.add_assign),
        pump_rate_flag=bool(pump_rate_flag),
        pump_gt_one=bool(pump_is_gt_one),
        noise=float(noise_scale) != 0.0,
        rng=philox.RNG_NAMES.index(rng) if float(noise_scale) != 0.0 else 1,
    )
    launch = build.load(spec)
    c = torch.empty((num_instances, batch_size, n), dtype=torch.float32,
                    device=q.device)
    s = torch.empty_like(c)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            q.data_ptr(), v.data_ptr(), c.data_ptr(), s.data_ptr(),
            num_instances, int(batch_size), n, int(iterations),
            int(seed) % 2**64, _scalars(params, hp, float(noise_scale)), rows,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"dl_solve kernel launch failed: cudaError_t {err}")
    if hp is None:
        dl_solve.dl_launches += 1
    else:
        dl_solve.dl_adam_launches += 1
    return (c, s) if stacked else (c[0], s[0])


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
