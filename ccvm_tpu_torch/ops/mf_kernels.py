"""The whole-solve MF-CCVM kernel's wrapper and its plain version.

:func:`mf_solve` takes the arguments of ``pallas_kernels.mf_solve``
(``ccvm_tpu/ops/pallas_kernels.py:1186-1221``), with an int seed in place of
the PRNG key.  For CUDA tensors it launches ``csrc/mf_solve.cu`` (the
counterpart of ``_mf_kernel``, or of ``_mf_adam_kernel`` when ``hp`` is
given); for CPU tensors it runs :func:`mf_solve_reference`.  There is no
fallback from the kernel to the plain version.

:func:`mf_solve_reference` computes the same function in eager PyTorch with
:func:`ccvm_tpu_torch.dynamics.mf.solve`, the kernel's per-step safety clip
of mu and its noise (the single Philox draw of
:func:`ccvm_tpu_torch.ops.philox.wiener_one`).  Noise off, the two agree to
float32 round-off; noise on, they draw the same increments.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ccvm_tpu_torch.dynamics import mf as dyn
from ccvm_tpu_torch.ops import build, philox
from ccvm_tpu_torch.runtime import fp32_matmul

def launch_shape(n: int):
    """(rows per block, threads, shared-memory bytes) of the kernel at
    problem size ``n`` (Q and one x array per block); raises when they do
    not fit a block."""
    return build.launch_shape(n, 1, "MF")


def _scalars(params, hp, noise_scale):
    """The kernel's 15 float32 scalars (csrc/mf_solve.cu MFScalars)."""
    alpha = beta1 = beta2 = 0.0
    if hp is not None:
        alpha, beta1, beta2 = hp.alpha, hp.beta1, hp.beta2
    vals = np.array(
        [params.pump, params.S, params.dt, params.j, params.feedback_scale,
         params.g, params.lower_limit, params.upper_limit, params.iterations,
         alpha, beta1, 1.0 - beta1, beta2, 1.0 - beta2, noise_scale],
        np.float32,
    )
    return (ctypes.c_float * 15)(*vals.tolist())


def _check(q_matrix, v_vector, params, rng):
    if rng not in philox.RNG_NAMES:
        raise ValueError(f"rng must be one of {philox.RNG_NAMES}, got {rng!r}")
    if q_matrix.dtype != torch.float32 or v_vector.dtype != torch.float32:
        raise TypeError("mf_solve takes float32 Q and V")
    if q_matrix.ndim not in (2, 3) or q_matrix.shape[-1] != q_matrix.shape[-2]:
        raise ValueError(f"Q must be (n, n) or (I, n, n), got {tuple(q_matrix.shape)}")
    if tuple(v_vector.shape) != tuple(q_matrix.shape[:-1]):
        raise ValueError(
            f"V must be shaped {tuple(q_matrix.shape[:-1])}, got {tuple(v_vector.shape)}"
        )
    if v_vector.device != q_matrix.device:
        raise ValueError("Q and V must lie on the same device")
    if np.ndim(params.S) != 0:
        raise ValueError(
            "the MF kernel takes a scalar S (per-variable S is not ported to "
            "ccvm_tpu_torch yet: ROADMAP.md, queue 1 item 6)"
        )


def mf_solve(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    pump_rate_flag, noise_scale=1.0, rng="popcount32", hp=None,
):
    """Fused MF solve; ``hp`` selects the Adam variant.  Returns
    ``(mu, mu_tilde, sigma)`` shaped ``(batch, n)``, or ``(I, batch, n)`` for
    a stacked ``(I, n, n)`` Q, where instance ``i`` draws the noise of a
    solve with ``seed + i``; ``mu_tilde`` is the last step's, clamped to
    +-S."""
    _check(q_matrix, v_vector, params, rng)
    kwargs = dict(
        iterations=iterations, batch_size=batch_size,
        pump_rate_flag=pump_rate_flag, noise_scale=noise_scale, rng=rng, hp=hp,
    )
    if q_matrix.device.type == "cpu":
        return mf_solve_reference(seed, q_matrix, v_vector, params, **kwargs)
    if q_matrix.device.type != "cuda":
        raise ValueError(f"mf_solve runs on cpu or cuda, not {q_matrix.device}")

    stacked = q_matrix.ndim == 3
    q = (q_matrix if stacked else q_matrix[None]).contiguous()
    v = (v_vector if stacked else v_vector[None]).contiguous()
    num_instances, n = q.shape[0], q.shape[-1]
    rows, _, _ = launch_shape(n)
    noise = float(noise_scale) != 0.0
    spec = build.MFSpec(
        adam=hp is not None,
        beta2_one=hp is not None and hp.beta2 == 1.0,
        add_assign=hp is not None and bool(hp.add_assign),
        pump_rate_flag=bool(pump_rate_flag),
        noise=noise,
        rng=philox.RNG_NAMES.index(rng) if noise else 0,
    )
    launch = build.load(spec)
    mu = torch.empty((num_instances, batch_size, n), dtype=torch.float32,
                     device=q.device)
    mt = torch.zeros_like(mu)  # the readout of a solve of 0 iterations
    sigma = torch.empty_like(mu)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            q.data_ptr(), v.data_ptr(), mu.data_ptr(), mt.data_ptr(),
            sigma.data_ptr(), num_instances, int(batch_size), n,
            int(iterations), int(seed) % 2**64,
            _scalars(params, hp, float(noise_scale)), rows, stream,
        )
    if err != 0:
        raise RuntimeError(f"mf_solve kernel launch failed: cudaError_t {err}")
    if hp is None:
        mf_solve.mf_launches += 1
    else:
        mf_solve.mf_adam_launches += 1
    return (mu, mt, sigma) if stacked else (mu[0], mt[0], sigma[0])


# Launch counts of the two kernels (the wrapper adds one per launch).
mf_solve.mf_launches = 0
mf_solve.mf_adam_launches = 0


def mf_solve_reference(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    pump_rate_flag, noise_scale=1.0, rng="popcount32", hp=None,
):
    """Plain PyTorch version of :func:`mf_solve` (same arguments, same
    result), on the tensors' own device."""
    _check(q_matrix, v_vector, params, rng)
    stacked = q_matrix.ndim == 3
    q = q_matrix if stacked else q_matrix[None]
    v = (v_vector if stacked else v_vector[None])[:, None, :]
    n = q.shape[-1]
    rows = torch.arange(int(batch_size), dtype=torch.int64, device=q.device)
    instances = torch.arange(q.shape[0], dtype=torch.int64, device=q.device)

    def draw(i):
        w = philox.wiener_one(seed, i, rows, n, rng, instances)
        return w if noise_scale == 1.0 else w * noise_scale

    with fp32_matmul():
        mu, mt, sigma = dyn.solve(
            q, v, params, iterations=iterations, batch_size=batch_size,
            pump_rate_flag=pump_rate_flag, hp=hp,
            draw=None if noise_scale == 0.0 else draw,
        )
    return (mu, mt, sigma) if stacked else (mu[0], mt[0], sigma[0])
