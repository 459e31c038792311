"""The whole-solve Langevin-family kernel's wrappers and their plain versions.

:func:`langevin_solve` and :func:`pumped_langevin_solve` take the arguments
of ``pallas_kernels.langevin_solve`` and ``pumped_langevin_solve``
(``ccvm_tpu/ops/pallas_kernels.py:549-582``, ``:725-759``), with an int seed
in place of the PRNG key.  For CUDA tensors they launch
``csrc/langevin_solve.cu`` (the counterpart of ``_langevin_kernel`` and
``_pumped_langevin_kernel``, or of their Adam variants when ``hp`` is
given); for CPU tensors they run :func:`langevin_solve_reference` and
:func:`pumped_langevin_solve_reference`.  There is no fallback from the
kernel to the plain version.  The wrappers hand the kernel its per-step
scalars as a table (:func:`_step_table`) and its per-solve constants
(:func:`_scalars`), both by the plain version's own float32 operations.
``params.S`` is a scalar, one value a column (a tuple) or one an element (a
(batch, n) tensor), which the kernel's per-column and per-element builds
take (:func:`_columns`).

:func:`langevin_solve_segment` and :func:`pumped_langevin_solve_segment`
advance a given state (c and Adam's moments) from a given absolute step (the
JAX ``solve_segment``), and the ``*_solve_sampled`` functions run a whole
solve as segments with a sample of c after each (the JAX ``solve_sampled``):
the segments equal the whole launch bit for bit.

The plain versions compute the same function in eager PyTorch with
:mod:`ccvm_tpu_torch.dynamics.langevin` and
:mod:`ccvm_tpu_torch.dynamics.pumped_langevin`, and the kernel's noise (the
single Philox draw of :func:`ccvm_tpu_torch.ops.philox.wiener_one`).  The two
draw the same increments and round alike: the plain kernels agree bit for
bit where the plain matmul sums over k in order (cuBLAS does at the main
path's shapes), the Adam kernels to an ulp or so a step (their per-element
square root and division take the hardware's approximations).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics import langevin as lgv
from ccvm_tpu_torch.dynamics import pumped_langevin as plgv
from ccvm_tpu_torch.ops import build, philox
from ccvm_tpu_torch.ops.dl_kernels import (check_saturation, check_segment, check_step,
                                           per_element, run_step, shard_rows)
from ccvm_tpu_torch.runtime import fp32_matmul


def launch_shape(n: int, adam: bool = False):
    """(rows per block, threads, shared-memory bytes) of the kernel at
    problem size ``n`` (:func:`ccvm_tpu_torch.ops.build.langevin_launch_shape`);
    raises when they do not fit a block."""
    return tuple(build.langevin_launch_shape(n, adam)[:3])


def _spec(n, hp, noise_scale, rng, *, pumped, cols=False, seg=False, elem=False):
    """The kernel specialisation a launch with these arguments takes."""
    noise = float(noise_scale) != 0.0
    return build.LangevinSpec(
        pumped=pumped,
        adam=hp is not None,
        beta2_one=hp is not None and hp.beta2 == 1.0,
        add_assign=hp is not None and bool(hp.add_assign),
        noise=noise,
        rng=philox.RNG_NAMES.index(rng) if noise else 0,
        np=build.langevin_launch_shape(n, hp is not None).np,
        cols=bool(cols),
        seg=bool(seg),
        elem=bool(elem),
    )


def blocks_per_sm(n, *, pumped=False, noise_scale=1.0, rng="popcount32", hp=None,
                  cols=False, seg=False, elem=False):
    """Blocks of the specialisation that the wrappers launch with these
    arguments (``cols``, ``seg``, ``elem``: the per-column S, segment and
    per-element S builds) that the card keeps resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); builds it first."""
    fn = build.load(_spec(n, hp, noise_scale, rng, pumped=pumped, cols=cols, seg=seg,
                          elem=elem),
                    "ccvm_langevin_blocks_per_sm",
                    [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    err = fn(int(n), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"ccvm_langevin_blocks_per_sm failed: cudaError_t {err}")
    return blocks.value


def _scalars(params, hp, noise_scale):
    """The kernel's 13 float32 scalars (csrc/langevin_solve.cu
    LangevinScalars): S, dt, feedback_scale, then the per-solve constants as
    the plain version rounds them in float32 (scale = (u - l) / (2 S),
    (u + l) / 2, dt fs, sigma sqrt(dt)), the noise scale and Adam's.  With
    one S a column, S reads 1 here (the kernel takes :func:`_columns`)."""
    alpha = beta1 = beta2 = 0.0
    if hp is not None:
        alpha, beta1, beta2 = hp.alpha, hp.beta1, hp.beta2
    f = np.float32
    S = params.S if np.ndim(params.S) == 0 else 1.0
    S, dt, sigma, fs, lo, hi = (f(x) for x in (
        S, params.dt, params.sigma, params.feedback_scale,
        params.lower_limit, params.upper_limit))
    vals = np.array(
        [S, dt, fs, (hi - lo) / (f(2) * S), (hi + lo) / f(2), dt * fs,
         sigma * np.sqrt(dt), noise_scale, alpha, beta1, 1.0 - beta1, beta2,
         1.0 - beta2],
        np.float32,
    )
    return (ctypes.c_float * 13)(*vals.tolist())


def _columns(params, device, rows, np_, lead=0):
    """S's array for the kernel on ``device``, by float32 operations on the
    device that round as :func:`_scalars`'s on the host (None for a scalar
    S): S and scale = (u - l) / (2 S), the per-column build's (2, n), the
    per-element build's (2, rows', ``np_``)
    (:func:`ccvm_tpu_torch.ops.dl_kernels.per_element`; padding S 1, scale
    0)."""
    if np.ndim(params.S) == 0:
        return None
    S = common.saturation_tensor(params.S, device)
    span = (torch.tensor(float(params.upper_limit), dtype=torch.float32, device=device)
            - float(params.lower_limit))
    scale = span / (2.0 * S)
    if S.ndim == 2:
        return per_element([S, scale], (1.0, 0.0), rows, np_, lead=lead)
    return torch.stack([S, scale])


def _step_table(params, hp, iterations, pump_rate_flag, device):
    """The kernel's per-step scalars, (iterations, 8) float32 on ``device``,
    by the plain version's own float32 operations
    (``dynamics/pumped_langevin.pump_field``,
    ``dynamics/common.adam_moment_update``): k1 = -1 + p_i with the pump
    p_i = pump (i+1) / T, or pump (0 for Langevin, which has no pump), then
    Adam's 1 - beta1^(i+1), its reciprocal, 1 - beta2^(i+1) and its
    reciprocal (ones without Adam, or for beta2 = 1), then three zeros that
    pad a row to the kernel's two float4 reads.  Row i is step i of the
    whole solve; a segment reads its rows from its first step on."""
    fi1 = torch.arange(1, int(iterations) + 1, dtype=torch.float32, device=device)
    ones, zeros = torch.ones_like(fi1), torch.zeros_like(fi1)
    k1 = zeros
    if isinstance(params, plgv.PumpedLangevinParams):
        p = common.float32_scalars(params, device)
        pump = p.pump * fi1 / p.iterations if pump_rate_flag else p.pump.expand_as(fi1)
        k1 = -1.0 + pump
    b1 = inv_b1 = b2 = inv_b2 = ones
    if hp is not None:
        b1 = 1.0 - torch.pow(hp.beta1, fi1)
        inv_b1 = 1.0 / b1
        if hp.beta2 != 1.0:
            b2 = 1.0 - torch.pow(hp.beta2, fi1)
            inv_b2 = 1.0 / b2
    cols = [k1, b1, inv_b1, b2, inv_b2, zeros, zeros, zeros]
    return torch.stack(cols, dim=1).contiguous()


def _check(q_matrix, v_vector, params, rng, batch_size):
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
    check_saturation(params.S, q_matrix.shape[-1], "the Langevin kernels", batch_size)


def _run(launch, seed, q, v, params, *, iterations, batch_size, noise_scale, hp,
         pump_rate_flag, segment=None, row_base=0):
    """One launch of a built library's ``launch`` function on stacked
    (I, n, n) Q and (I, n) V on the card; returns c (I, batch, n), the
    moments (Adam's (m, v) of a segment launch, else none) and the
    cudaError_t of the launch.  ``segment``: (state, start, num, steps) of a
    segment launch (state None: c = 0; steps None: the table built here);
    ``row_base`` the global row of trajectory 0 (a data-parallel rank's
    first row).
    ``tools/breakdown.py`` times probe builds through it."""
    num_instances, n = q.shape[0], q.shape[-1]
    cols = np.ndim(params.S) != 0
    shape_ = build.langevin_launch_shape(n, hp is not None, cols)
    rows = shape_.rows
    build.check_row_base(int(row_base), rows, num_instances > 1, "the Langevin kernels")
    steps = None if segment is None else segment[3]
    if steps is None:
        steps = _step_table(params, hp, iterations, pump_rate_flag, q.device)
    col_values = _columns(params, q.device, rows, shape_.np, int(row_base))
    shape = (num_instances, int(batch_size), n)
    c = torch.zeros(shape, dtype=torch.float32,
                    device=q.device)  # the result of a solve of 0 iterations
    seg, moments, num = None, [], int(iterations)
    if segment is not None:
        state, start, num, _ = segment
        moments = [torch.empty_like(c) for _ in range(2 if hp is not None else 0)]
        seg, _held = build.segment(state, shape, start, iterations, moments)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            q.data_ptr(), v.data_ptr(), steps.data_ptr(), c.data_ptr(),
            num_instances, int(batch_size), n, int(num), int(seed) % 2**64,
            _scalars(params, hp, float(noise_scale)), rows, stream,
            None if col_values is None else col_values.data_ptr(),
            None if seg is None else ctypes.byref(seg), int(row_base),
        )
    return c, moments, err


def _launch(seed, q_matrix, v_vector, params, *, pumped, iterations,
            batch_size, pump_rate_flag, noise_scale, rng, hp, segment=None,
            row_base=0):
    """One launch of ``csrc/langevin_solve.cu`` on CUDA tensors: c, or a
    segment's state (c, or with Adam (c, m, v)), counted."""
    if q_matrix.device.type != "cuda":
        raise ValueError(
            f"the Langevin kernels run on cpu or cuda, not {q_matrix.device}")
    stacked = q_matrix.ndim == 3
    q = (q_matrix if stacked else q_matrix[None]).contiguous()
    v = (v_vector if stacked else v_vector[None]).contiguous()
    spec = _spec(q.shape[-1], hp, noise_scale, rng, pumped=pumped,
                 cols=np.ndim(params.S) != 0, seg=segment is not None,
                 elem=np.ndim(params.S) == 2)
    c, moments, err = _run(build.load(spec), seed, q, v, params,
                           iterations=iterations, batch_size=batch_size,
                           noise_scale=noise_scale, hp=hp,
                           pump_rate_flag=pump_rate_flag, segment=segment,
                           row_base=row_base)
    if err != 0:
        raise RuntimeError(f"{spec} kernel launch failed: cudaError_t {err}")
    counts = (pumped_langevin_solve, ("pumped_launches", "pumped_adam_launches")) \
        if pumped else (langevin_solve, ("langevin_launches", "langevin_adam_launches"))
    attr = counts[1][hp is not None]
    setattr(counts[0], attr, getattr(counts[0], attr) + 1)
    unstack = (lambda x: x) if stacked else (lambda x: x[0])
    if segment is None:
        return unstack(c)
    out = tuple(unstack(x) for x in [c] + moments)
    return out if hp is not None else out[0]


def langevin_solve(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    noise_scale=1.0, rng="popcount32", hp=None, row_base=0,
):
    """Fused Langevin solve; ``hp`` selects the Adam variant.  Returns c
    shaped ``(batch, n)``, or ``(I, batch, n)`` for a stacked ``(I, n, n)``
    Q, where instance ``i`` draws the noise of a solve with ``seed + i``.
    ``row_base``: the global row of trajectory 0, so that a data-parallel
    rank's rows draw what those rows of a single solve draw."""
    _check(q_matrix, v_vector, params, rng, batch_size)
    kwargs = dict(iterations=iterations, batch_size=batch_size,
                  noise_scale=noise_scale, rng=rng, hp=hp, row_base=row_base)
    if q_matrix.device.type == "cpu":
        return langevin_solve_reference(seed, q_matrix, v_vector, params, **kwargs)
    return _launch(seed, q_matrix, v_vector, params, pumped=False,
                   pump_rate_flag=False, **kwargs)


def pumped_langevin_solve(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    pump_rate_flag, noise_scale=1.0, rng="popcount32", hp=None, row_base=0,
):
    """Fused pumped-Langevin solve; ``hp`` selects the Adam variant.  Same
    shapes, seeding and row base as :func:`langevin_solve`."""
    _check(q_matrix, v_vector, params, rng, batch_size)
    kwargs = dict(iterations=iterations, batch_size=batch_size,
                  pump_rate_flag=pump_rate_flag, noise_scale=noise_scale,
                  rng=rng, hp=hp, row_base=row_base)
    if q_matrix.device.type == "cpu":
        return pumped_langevin_solve_reference(seed, q_matrix, v_vector, params,
                                               **kwargs)
    return _launch(seed, q_matrix, v_vector, params, pumped=True, **kwargs)


# Launch counts of the four kernels (the wrappers add one per launch of a
# kernel's builds, a segment's too).
langevin_solve.langevin_launches = 0
langevin_solve.langevin_adam_launches = 0
pumped_langevin_solve.pumped_launches = 0
pumped_langevin_solve.pumped_adam_launches = 0


def _check_segment(state, start, num, iterations, hp, q_matrix, batch_size):
    check_segment(None if state is None else ((state,) if hp is None else tuple(state)),
                  start, num, iterations, ("c",) if hp is None else ("c", "m", "v"),
                  q_matrix, batch_size)


def _segment(pumped, seed, q_matrix, v_vector, params, state, start, num, *,
             iterations, batch_size, pump_rate_flag, noise_scale, rng, hp, steps,
             row_base=0):
    kwargs = dict(iterations=iterations, batch_size=batch_size,
                  noise_scale=noise_scale, rng=rng, hp=hp, row_base=row_base)
    if q_matrix.device.type == "cpu":
        if pumped:
            return pumped_langevin_solve_segment_reference(
                seed, q_matrix, v_vector, params, state, start, num,
                pump_rate_flag=pump_rate_flag, **kwargs)
        return langevin_solve_segment_reference(seed, q_matrix, v_vector, params, state,
                                                start, num, **kwargs)
    _check(q_matrix, v_vector, params, rng, batch_size)
    _check_segment(state, start, num, iterations, hp, q_matrix, batch_size)
    arrays = None if state is None else ((state,) if hp is None else tuple(state))
    return _launch(seed, q_matrix, v_vector, params, pumped=pumped,
                   pump_rate_flag=pump_rate_flag,
                   segment=(arrays, int(start), num, steps), **kwargs)


def langevin_solve_segment(
    seed, q_matrix, v_vector, params, state, start, num, *, iterations,
    batch_size, noise_scale=1.0, rng="popcount32", hp=None, steps=None, row_base=0,
):
    """Advance ``state`` (c, or with ``hp`` (c, m, v); None: c = 0) by
    ``num`` steps from absolute step ``start`` of a solve of ``iterations``
    steps (the JAX ``solve_segment``); returns the state.  ``steps``: the
    solve's step table (:func:`_step_table`), to build it once for many
    segments; ``row_base`` as :func:`langevin_solve`'s."""
    return _segment(False, seed, q_matrix, v_vector, params, state, start, num,
                    iterations=iterations, batch_size=batch_size,
                    pump_rate_flag=False, noise_scale=noise_scale, rng=rng, hp=hp,
                    steps=steps, row_base=row_base)


def pumped_langevin_solve_segment(
    seed, q_matrix, v_vector, params, state, start, num, *, iterations,
    batch_size, pump_rate_flag, noise_scale=1.0, rng="popcount32", hp=None,
    steps=None, row_base=0,
):
    """:func:`langevin_solve_segment` of pumped Langevin."""
    return _segment(True, seed, q_matrix, v_vector, params, state, start, num,
                    iterations=iterations, batch_size=batch_size,
                    pump_rate_flag=pump_rate_flag, noise_scale=noise_scale,
                    rng=rng, hp=hp, steps=steps, row_base=row_base)


def _sampled(pumped, seed, q_matrix, v_vector, params, segments, *, batch_size,
             pump_rate_flag, noise_scale, rng, hp, plain=False, row_base=0):
    """The segments of a whole solve (``plain``: the plain versions', on any
    device) and the state after each."""
    iterations = int(sum(int(x) for x in segments))
    steps = None
    if q_matrix.device.type == "cuda" and not plain:
        steps = _step_table(params, hp, iterations, pump_rate_flag, q_matrix.device)
    kwargs = dict(iterations=iterations, batch_size=batch_size, noise_scale=noise_scale,
                  rng=rng, hp=hp, row_base=row_base)
    if plain:
        segment = (functools.partial(pumped_langevin_solve_segment_reference,
                                     pump_rate_flag=pump_rate_flag) if pumped
                   else langevin_solve_segment_reference)
    else:
        segment = functools.partial(_segment, pumped, pump_rate_flag=pump_rate_flag,
                                    steps=steps)
    state, start, samples = None, 0, []
    for num in segments:
        state = segment(seed, q_matrix, v_vector, params, state, start, int(num),
                        **kwargs)
        start += int(num)
        samples.append(state if hp is None else state[0])
    return samples[-1], torch.stack(samples)


def langevin_solve_sampled(
    seed, q_matrix, v_vector, params, segments, *, batch_size, noise_scale=1.0,
    rng="popcount32", hp=None, row_base=0,
):
    """A whole solve of ``sum(segments)`` steps as one segment launch each
    (the JAX ``solve_sampled``).  Returns ``(c, c_samples)``: the final c,
    and each segment's c stacked on a leading axis, on the tensors'
    device."""
    return _sampled(False, seed, q_matrix, v_vector, params, segments,
                    batch_size=batch_size, pump_rate_flag=False,
                    noise_scale=noise_scale, rng=rng, hp=hp, row_base=row_base)


def pumped_langevin_solve_sampled(
    seed, q_matrix, v_vector, params, segments, *, batch_size, pump_rate_flag,
    noise_scale=1.0, rng="popcount32", hp=None, row_base=0,
):
    """:func:`langevin_solve_sampled` of pumped Langevin."""
    return _sampled(True, seed, q_matrix, v_vector, params, segments,
                    batch_size=batch_size, pump_rate_flag=pump_rate_flag,
                    noise_scale=noise_scale, rng=rng, hp=hp, row_base=row_base)


def langevin_solve_sampled_reference(
    seed, q_matrix, v_vector, params, segments, *, batch_size, noise_scale=1.0,
    rng="popcount32", hp=None, row_base=0,
):
    """Plain PyTorch version of :func:`langevin_solve_sampled` (same
    arguments, same result), on the tensors' own device."""
    return _sampled(False, seed, q_matrix, v_vector, params, segments,
                    batch_size=batch_size, pump_rate_flag=False,
                    noise_scale=noise_scale, rng=rng, hp=hp, plain=True,
                    row_base=row_base)


def pumped_langevin_solve_sampled_reference(
    seed, q_matrix, v_vector, params, segments, *, batch_size, pump_rate_flag,
    noise_scale=1.0, rng="popcount32", hp=None, row_base=0,
):
    """Plain PyTorch version of :func:`pumped_langevin_solve_sampled`."""
    return _sampled(True, seed, q_matrix, v_vector, params, segments,
                    batch_size=batch_size, pump_rate_flag=pump_rate_flag,
                    noise_scale=noise_scale, rng=rng, hp=hp, plain=True,
                    row_base=row_base)


def _reference(solve, seed, q_matrix, v_vector, params, *, iterations,
               batch_size, noise_scale, rng, segment=None, row_base=0, **kwargs):
    """A plain solve (``segment`` (state, start, num): a plain segment with
    ``solve`` the dynamics' ``advance``) on the tensors' own device, with
    the kernel's noise."""
    _check(q_matrix, v_vector, params, rng, batch_size)
    stacked = q_matrix.ndim == 3
    q = q_matrix if stacked else q_matrix[None]
    v = (v_vector if stacked else v_vector[None])[:, None, :]
    n = q.shape[-1]
    rows = torch.arange(int(batch_size), dtype=torch.int64, device=q.device) + int(row_base)
    instances = torch.arange(q.shape[0], dtype=torch.int64, device=q.device)

    def draw(i):
        w = philox.wiener_one(seed, i, rows, n, rng, instances)
        return w if noise_scale == 1.0 else w * noise_scale

    draw = None if noise_scale == 0.0 else draw
    unstack = (lambda x: x) if stacked else (lambda x: x[0])
    with fp32_matmul():
        if segment is None:
            return unstack(solve(q, v, params, iterations=iterations,
                                 batch_size=batch_size, draw=draw, **kwargs))
        state, start, num = segment
        shape = (q.shape[0], int(batch_size), n)
        if state is None:
            c0 = torch.zeros(shape, dtype=torch.float32, device=q.device)
            state = c0 if kwargs["hp"] is None else (c0, c0, c0)
        elif kwargs["hp"] is None:
            state = state.reshape(shape)
        else:
            state = tuple(x.reshape(shape) for x in state)
        state = solve(q, v, params, state, start, num, draw=draw, **kwargs)
    return unstack(state) if kwargs["hp"] is None else tuple(unstack(x) for x in state)


def langevin_solve_reference(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    noise_scale=1.0, rng="popcount32", hp=None, row_base=0,
):
    """Plain PyTorch version of :func:`langevin_solve` (same arguments,
    same result), on the tensors' own device."""
    return _reference(lgv.solve, seed, q_matrix, v_vector, params,
                      iterations=iterations, batch_size=batch_size,
                      noise_scale=noise_scale, rng=rng, hp=hp, row_base=row_base)


def pumped_langevin_solve_reference(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    pump_rate_flag, noise_scale=1.0, rng="popcount32", hp=None, row_base=0,
):
    """Plain PyTorch version of :func:`pumped_langevin_solve` (same
    arguments, same result), on the tensors' own device."""
    return _reference(plgv.solve, seed, q_matrix, v_vector, params,
                      iterations=iterations, batch_size=batch_size,
                      noise_scale=noise_scale, rng=rng, hp=hp,
                      pump_rate_flag=pump_rate_flag, row_base=row_base)


def langevin_solve_segment_reference(
    seed, q_matrix, v_vector, params, state, start, num, *, iterations,
    batch_size, noise_scale=1.0, rng="popcount32", hp=None, row_base=0,
):
    """Plain PyTorch version of :func:`langevin_solve_segment` (same
    arguments, same result), on the tensors' own device."""
    _check_segment(state, start, num, iterations, hp, q_matrix, batch_size)
    return _reference(lgv.advance, seed, q_matrix, v_vector, params,
                      iterations=iterations, batch_size=batch_size,
                      noise_scale=noise_scale, rng=rng, hp=hp,
                      segment=(state, start, num), row_base=row_base)


def pumped_langevin_solve_segment_reference(
    seed, q_matrix, v_vector, params, state, start, num, *, iterations,
    batch_size, pump_rate_flag, noise_scale=1.0, rng="popcount32", hp=None,
    row_base=0,
):
    """Plain PyTorch version of :func:`pumped_langevin_solve_segment`."""
    _check_segment(state, start, num, iterations, hp, q_matrix, batch_size)
    return _reference(plgv.advance, seed, q_matrix, v_vector, params,
                      iterations=iterations, batch_size=batch_size,
                      noise_scale=noise_scale, rng=rng, hp=hp,
                      pump_rate_flag=pump_rate_flag, segment=(state, start, num),
                      row_base=row_base)


def _step(pumped, seed, mv, v_local, params, state, x, step, *, iterations,
          pump_rate_flag, noise_scale, rng, hp, row_base, col_base, steps, plain=False):
    if rng not in philox.RNG_NAMES:
        raise ValueError(f"rng must be one of {philox.RNG_NAMES}, got {rng!r}")
    name = "pumped_langevin_step" if pumped else "langevin_step"
    check_step(mv, v_local, state, x, step, 1 if hp is None else 3, 1, name)
    if plain or state.device.type == "cpu":
        if step is not None:
            w = torch.zeros_like(state[0])
            if noise_scale != 0.0:
                w = philox.wiener_one(seed, step, shard_rows(state, row_base), state.shape[-1],
                                      rng, col0=col_base)
                w = w if noise_scale == 1.0 else w * noise_scale
            # Q is not read: the matvec is given; mv stands in for it as the
            # carrier of the device.
            given = dict(matvec=lambda _x, _q: mv[0])
            flag = (pump_rate_flag,) if pumped else ()
            dyn = plgv if pumped else lgv
            if hp is None:
                state[0] = dyn.make_step(mv, v_local, params, *flag, **given)(state[0], step, w)
            else:
                new = dyn.make_adam_step(mv, v_local, params, *flag, hp, **given)(
                    tuple(state), step, w)
                state.copy_(torch.stack(new))
        p = common.float32_scalars(params, state.device)
        x.copy_(lgv.matvec_input(state[0], p.S, p.lower_limit, p.upper_limit)[None])
        return
    if step is not None and steps is None:
        steps = _step_table(params, hp, iterations, pump_rate_flag, state.device)
    spec = _spec(8, hp, noise_scale, rng, pumped=pumped)._replace(ext=True)  # NP 8: any N
    run_step(spec, "ccvm_langevin_step", seed, mv, v_local, steps, state, x, step,
             iterations, _scalars(params, hp, float(noise_scale)), row_base, col_base)
    counter = pumped_langevin_step if pumped else langevin_step
    attr = ("pumped" if pumped else "langevin") + ("_adam" if hp is not None else "") \
        + "_launches"
    setattr(counter, attr, getattr(counter, attr) + 1)


def langevin_step(seed, mv, v_local, params, state, x, step, *, iterations,
                  noise_scale=1.0, rng="popcount32", hp=None, row_base=0, col_base=0,
                  steps=None):
    """Step ``step`` of a tensor-parallel Langevin solve of ``iterations``
    steps on a rank's (batch, nl) shard, whose row 0 and column 0 are the
    global ``row_base`` and ``col_base``: ``state`` (c[, m, v]) stacked (1
    or 3, batch, nl) and ``x`` (1, batch, nl), the next step's matvec input,
    are updated in place.  ``mv`` (1, batch, nl) is the step's x @ Q at the
    shard's columns; ``step`` None writes only x of the state, for the first
    matvec.  ``params.S`` is a scalar.  On the card it launches the one-step
    build of csrc/langevin_solve.cu (``steps``: the solve's
    :func:`_step_table`, built once); on the CPU it runs
    :func:`langevin_step_reference`."""
    return _step(False, seed, mv, v_local, params, state, x, step, iterations=iterations,
                 pump_rate_flag=False, noise_scale=noise_scale, rng=rng, hp=hp,
                 row_base=row_base, col_base=col_base, steps=steps)


def pumped_langevin_step(seed, mv, v_local, params, state, x, step, *, iterations,
                         pump_rate_flag, noise_scale=1.0, rng="popcount32", hp=None,
                         row_base=0, col_base=0, steps=None):
    """:func:`langevin_step` of pumped Langevin."""
    return _step(True, seed, mv, v_local, params, state, x, step, iterations=iterations,
                 pump_rate_flag=pump_rate_flag, noise_scale=noise_scale, rng=rng, hp=hp,
                 row_base=row_base, col_base=col_base, steps=steps)


# Launch counts of the four one-step builds.
langevin_step.langevin_launches = 0
langevin_step.langevin_adam_launches = 0
pumped_langevin_step.pumped_launches = 0
pumped_langevin_step.pumped_adam_launches = 0


def langevin_step_reference(seed, mv, v_local, params, state, x, step, *, iterations,
                            noise_scale=1.0, rng="popcount32", hp=None, row_base=0,
                            col_base=0, steps=None):
    """Plain PyTorch version of :func:`langevin_step` (same arguments, same
    result), on the tensors' own device: the dynamics' step with the given
    matvec and the draws of the shard's global rows and columns."""
    return _step(False, seed, mv, v_local, params, state, x, step, iterations=iterations,
                 pump_rate_flag=False, noise_scale=noise_scale, rng=rng, hp=hp,
                 row_base=row_base, col_base=col_base, steps=steps, plain=True)


def pumped_langevin_step_reference(seed, mv, v_local, params, state, x, step, *,
                                   iterations, pump_rate_flag, noise_scale=1.0,
                                   rng="popcount32", hp=None, row_base=0, col_base=0,
                                   steps=None):
    """Plain PyTorch version of :func:`pumped_langevin_step`."""
    return _step(True, seed, mv, v_local, params, state, x, step, iterations=iterations,
                 pump_rate_flag=pump_rate_flag, noise_scale=noise_scale, rng=rng, hp=hp,
                 row_base=row_base, col_base=col_base, steps=steps, plain=True)
