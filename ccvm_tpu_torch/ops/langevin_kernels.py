"""The whole-solve Langevin-family kernel's wrappers and their plain versions.

:func:`langevin_solve` and :func:`pumped_langevin_solve` take the arguments
of ``pallas_kernels.langevin_solve`` and ``pumped_langevin_solve``
(``ccvm_tpu/ops/pallas_kernels.py:549-582``, ``:725-759``), with an int seed
in place of the PRNG key.  For CUDA tensors they launch
``csrc/langevin_solve.cu`` (the counterpart of ``_langevin_kernel`` and
``_pumped_langevin_kernel``, or of their Adam variants when ``hp`` is
given); for CPU tensors they run :func:`langevin_solve_reference` and
:func:`pumped_langevin_solve_reference`.  There is no fallback from the
kernel to the plain version.

The plain versions compute the same function in eager PyTorch with
:mod:`ccvm_tpu_torch.dynamics.langevin` and
:mod:`ccvm_tpu_torch.dynamics.pumped_langevin`, and the kernel's noise (the
single Philox draw of :func:`ccvm_tpu_torch.ops.philox.wiener_one`).  Noise
off, kernel and plain version agree to float32 round-off; noise on, they
draw the same increments.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ccvm_tpu_torch.dynamics import langevin as lgv
from ccvm_tpu_torch.dynamics import pumped_langevin as plgv
from ccvm_tpu_torch.ops import build, philox
from ccvm_tpu_torch.runtime import fp32_matmul


def launch_shape(n: int):
    """(rows per block, threads, shared-memory bytes) of the kernel at
    problem size ``n`` (Q and one x array per block); raises when they do
    not fit a block."""
    return build.launch_shape(n, 1, "Langevin")


def _scalars(params, hp, noise_scale):
    """The kernel's 14 float32 scalars (csrc/langevin_solve.cu
    LangevinScalars); Langevin has no pump and no pump schedule."""
    pump, T = 0.0, 1.0
    if isinstance(params, plgv.PumpedLangevinParams):
        pump, T = params.pump, params.iterations
    alpha = beta1 = beta2 = 0.0
    if hp is not None:
        alpha, beta1, beta2 = hp.alpha, hp.beta1, hp.beta2
    vals = np.array(
        [pump, params.S, params.dt, params.sigma, params.feedback_scale,
         params.lower_limit, params.upper_limit, T,
         alpha, beta1, 1.0 - beta1, beta2, 1.0 - beta2, noise_scale],
        np.float32,
    )
    return (ctypes.c_float * 14)(*vals.tolist())


def _check(q_matrix, v_vector, params, rng):
    if rng not in philox.RNG_NAMES:
        raise ValueError(f"rng must be one of {philox.RNG_NAMES}, got {rng!r}")
    if q_matrix.dtype != torch.float32 or v_vector.dtype != torch.float32:
        raise TypeError("the Langevin kernels take float32 Q and V")
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
            "the Langevin kernels take a scalar S (per-variable S is not "
            "ported to ccvm_tpu_torch yet: ROADMAP.md, queue 1 item 7)"
        )


def _launch(seed, q_matrix, v_vector, params, *, pumped, iterations,
            batch_size, pump_rate_flag, noise_scale, rng, hp):
    """One launch of ``csrc/langevin_solve.cu`` on CUDA tensors."""
    if q_matrix.device.type != "cuda":
        raise ValueError(
            f"the Langevin kernels run on cpu or cuda, not {q_matrix.device}")
    stacked = q_matrix.ndim == 3
    q = (q_matrix if stacked else q_matrix[None]).contiguous()
    v = (v_vector if stacked else v_vector[None]).contiguous()
    num_instances, n = q.shape[0], q.shape[-1]
    rows, _, _ = launch_shape(n)
    noise = float(noise_scale) != 0.0
    spec = build.LangevinSpec(
        pumped=pumped,
        adam=hp is not None,
        beta2_one=hp is not None and hp.beta2 == 1.0,
        add_assign=hp is not None and bool(hp.add_assign),
        pump_rate_flag=pumped and bool(pump_rate_flag),
        noise=noise,
        rng=philox.RNG_NAMES.index(rng) if noise else 0,
    )
    launch = build.load(spec)
    c = torch.zeros((num_instances, batch_size, n), dtype=torch.float32,
                    device=q.device)  # the result of a solve of 0 iterations
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            q.data_ptr(), v.data_ptr(), c.data_ptr(), num_instances,
            int(batch_size), n, int(iterations), int(seed) % 2**64,
            _scalars(params, hp, float(noise_scale)), rows, stream,
        )
    if err != 0:
        raise RuntimeError(f"{spec} kernel launch failed: cudaError_t {err}")
    return c if stacked else c[0]


def langevin_solve(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    noise_scale=1.0, rng="popcount32", hp=None,
):
    """Fused Langevin solve; ``hp`` selects the Adam variant.  Returns c
    shaped ``(batch, n)``, or ``(I, batch, n)`` for a stacked ``(I, n, n)``
    Q, where instance ``i`` draws the noise of a solve with ``seed + i``."""
    _check(q_matrix, v_vector, params, rng)
    kwargs = dict(iterations=iterations, batch_size=batch_size,
                  noise_scale=noise_scale, rng=rng, hp=hp)
    if q_matrix.device.type == "cpu":
        return langevin_solve_reference(seed, q_matrix, v_vector, params, **kwargs)
    c = _launch(seed, q_matrix, v_vector, params, pumped=False,
                pump_rate_flag=False, **kwargs)
    if hp is None:
        langevin_solve.langevin_launches += 1
    else:
        langevin_solve.langevin_adam_launches += 1
    return c


def pumped_langevin_solve(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    pump_rate_flag, noise_scale=1.0, rng="popcount32", hp=None,
):
    """Fused pumped-Langevin solve; ``hp`` selects the Adam variant.  Same
    shapes and seeding as :func:`langevin_solve`."""
    _check(q_matrix, v_vector, params, rng)
    kwargs = dict(iterations=iterations, batch_size=batch_size,
                  pump_rate_flag=pump_rate_flag, noise_scale=noise_scale,
                  rng=rng, hp=hp)
    if q_matrix.device.type == "cpu":
        return pumped_langevin_solve_reference(seed, q_matrix, v_vector, params,
                                               **kwargs)
    c = _launch(seed, q_matrix, v_vector, params, pumped=True, **kwargs)
    if hp is None:
        pumped_langevin_solve.pumped_launches += 1
    else:
        pumped_langevin_solve.pumped_adam_launches += 1
    return c


# Launch counts of the four kernels (the wrappers add one per launch).
langevin_solve.langevin_launches = 0
langevin_solve.langevin_adam_launches = 0
pumped_langevin_solve.pumped_launches = 0
pumped_langevin_solve.pumped_adam_launches = 0


def _reference(solve, seed, q_matrix, v_vector, params, *, iterations,
               batch_size, noise_scale, rng, **kwargs):
    """A plain solve on the tensors' own device, with the kernel's noise."""
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
        c = solve(q, v, params, iterations=iterations, batch_size=batch_size,
                  draw=None if noise_scale == 0.0 else draw, **kwargs)
    return c if stacked else c[0]


def langevin_solve_reference(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    noise_scale=1.0, rng="popcount32", hp=None,
):
    """Plain PyTorch version of :func:`langevin_solve` (same arguments,
    same result), on the tensors' own device."""
    return _reference(lgv.solve, seed, q_matrix, v_vector, params,
                      iterations=iterations, batch_size=batch_size,
                      noise_scale=noise_scale, rng=rng, hp=hp)


def pumped_langevin_solve_reference(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    pump_rate_flag, noise_scale=1.0, rng="popcount32", hp=None,
):
    """Plain PyTorch version of :func:`pumped_langevin_solve` (same
    arguments, same result), on the tensors' own device."""
    return _reference(plgv.solve, seed, q_matrix, v_vector, params,
                      iterations=iterations, batch_size=batch_size,
                      noise_scale=noise_scale, rng=rng, hp=hp,
                      pump_rate_flag=pump_rate_flag)
