"""The whole-solve MF-CCVM kernel's wrapper and its plain version.

:func:`mf_solve` takes the arguments of ``pallas_kernels.mf_solve``
(``ccvm_tpu/ops/pallas_kernels.py:1186-1221``), with an int seed in place of
the PRNG key.  For CUDA tensors it launches ``csrc/mf_solve.cu`` (the
counterpart of ``_mf_kernel``, or of ``_mf_adam_kernel`` when ``hp`` is
given); for CPU tensors it runs :func:`mf_solve_reference`.  There is no
fallback from the kernel to the plain version.  The wrapper hands the
kernel its per-step scalars as a table (:func:`_step_table`) and its
per-solve constants (:func:`_scalars`), both by the plain version's own
float32 operations.  ``params.S`` is a scalar, one value a column (a
tuple) or one an element (a (batch, n) tensor), which the kernel's
per-column and per-element builds take with their reciprocals
(:func:`_columns`), dividing by each as by the scalar S.

:func:`mf_solve_segment` advances a given state (mu, sigma and Adam's
moments) from a given absolute step (the JAX ``dynamics/mf.py``
``solve_segment``), and :func:`mf_solve_sampled` runs a whole solve as
segments with a sample of mu and sigma after each (the JAX ``solve_sampled``):
the segments equal the whole launch bit for bit.

:func:`mf_solve_reference` computes the same function in eager PyTorch with
:func:`ccvm_tpu_torch.dynamics.mf.solve`, the kernel's per-step safety clip
of mu and its noise (the single Philox draw of
:func:`ccvm_tpu_torch.ops.philox.wiener_one`).  The two draw the same
increments and round alike: MF agrees bit for bit where the plain matmul
sums over k in order (cuBLAS does at the main path's shapes), MF-Adam to an
ulp or so (its per-element division takes the hardware's approximation).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics import mf as dyn
from ccvm_tpu_torch.ops import build, philox
from ccvm_tpu_torch.ops.dl_kernels import (check_saturation, check_segment, check_step,
                                           per_element, run_step, shard_rows)
from ccvm_tpu_torch.runtime import fp32_matmul

def launch_shape(n: int, adam: bool = False):
    """(rows per block, threads, shared-memory bytes) of the kernel at
    problem size ``n`` (:func:`ccvm_tpu_torch.ops.build.mf_launch_shape`);
    raises when they do not fit a block."""
    return tuple(build.mf_launch_shape(n, adam)[:3])


def _spec(n, hp, noise_scale, rng, cols=False, seg=False, elem=False):
    noise = float(noise_scale) != 0.0
    return build.MFSpec(
        adam=hp is not None,
        beta2_one=hp is not None and hp.beta2 == 1.0,
        add_assign=hp is not None and bool(hp.add_assign),
        noise=noise,
        rng=philox.RNG_NAMES.index(rng) if noise else 0,
        np=build.mf_launch_shape(n, hp is not None).np,
        cols=bool(cols),
        seg=bool(seg),
        elem=bool(elem),
    )


def blocks_per_sm(n, *, noise_scale=1.0, rng="popcount32", hp=None, cols=False,
                  seg=False, elem=False):
    """Blocks of the specialisation that :func:`mf_solve` launches with these
    arguments (``cols``, ``seg``, ``elem``: the per-column S, segment and
    per-element S builds) that the card keeps resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); builds it first."""
    fn = build.load(_spec(n, hp, noise_scale, rng, cols, seg, elem),
                    "ccvm_mf_blocks_per_sm",
                    [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    err = fn(int(n), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"ccvm_mf_blocks_per_sm failed: cudaError_t {err}")
    return blocks.value


def _scalars(params, hp, noise_scale):
    """The kernel's 24 float32 scalars (csrc/mf_solve.cu MFScalars): the
    solve's, then its per-solve constants in float32 arithmetic as the plain
    version rounds them (1/S and 1/sqrt(dt) rounded to nearest; 2 (3 g^2)
    and -0.25 (u - l) are exact multiples of the plain version's).  With
    one S a column or an element, S reads 1 here (the kernel takes
    :func:`_columns`)."""
    alpha = beta1 = beta2 = 0.0
    if hp is not None:
        alpha, beta1, beta2 = hp.alpha, hp.beta1, hp.beta2
    f = np.float32
    S = params.S if np.ndim(params.S) == 0 else 1.0
    S, dt, g, lo, hi = (f(x) for x in (S, params.dt, params.g,
                                       params.lower_limit, params.upper_limit))
    sqrt_dt = np.sqrt(dt)
    g_sq = g * g
    vals = np.array(
        [params.pump, S, dt, params.j, params.feedback_scale, g, lo, hi,
         params.iterations, alpha, beta1, 1.0 - beta1, beta2, 1.0 - beta2,
         noise_scale,
         f(1.0) / S, sqrt_dt, f(1.0) / sqrt_dt, hi - lo, hi + lo, g_sq,
         f(2.0) * (f(3.0) * g_sq), f(2.0) * g_sq, f(-0.25) * (hi - lo)],
        np.float32,
    )
    return (ctypes.c_float * 24)(*vals.tolist())


def _columns(params, device, rows, np_, lead=0):
    """S's array for the kernel on ``device`` (None for a scalar S): S and
    its reciprocal 1/S rounded to nearest, by a float32 division on the
    device, as :func:`_scalars` takes 1/S on the host; the per-column
    build's (2, n), the per-element build's (2, rows', ``np_``)
    (:func:`ccvm_tpu_torch.ops.dl_kernels.per_element`; padding 1)."""
    if np.ndim(params.S) == 0:
        return None
    S = common.saturation_tensor(params.S, device)
    inv = torch.ones_like(S) / S
    if S.ndim == 2:
        return per_element([S, inv], (1.0, 1.0), rows, np_, lead=lead)
    return torch.stack([S, inv])


def _step_table(params, hp, iterations, pump_rate_flag, device):
    """The kernel's per-step scalars, (iterations, 12) float32 on ``device``,
    by the plain version's own float32 operations (``dynamics/mf.py``,
    ``dynamics/common.adam_moment_update``): sqrt(1/(4 j_i)), k1 = -(1 + j_i)
    + pump_i, 1 + j_i, -2 j_i, sqrt(j_i), then Adam's 1 - beta1^(i+1), its
    reciprocal, 1 - beta2^(i+1) and its reciprocal (ones without Adam, or
    for beta2 = 1), then three zeros.  Row i is step i of the whole solve;
    a segment reads its rows from its first step on."""
    p = common.float32_scalars(params, device)
    fi1 = torch.arange(1, int(iterations) + 1, dtype=torch.float32, device=device)
    j_i = p.j * torch.exp(-fi1 / p.iterations * 3.0)
    rate = fi1 / p.iterations if pump_rate_flag else torch.ones_like(fi1)
    pump_inst = p.pump * rate + 1.0 + j_i
    ones, zeros = torch.ones_like(fi1), torch.zeros_like(fi1)
    b1 = inv_b1 = b2 = inv_b2 = ones
    if hp is not None:
        b1 = 1.0 - torch.pow(hp.beta1, fi1)
        inv_b1 = 1.0 / b1
        if hp.beta2 != 1.0:
            b2 = 1.0 - torch.pow(hp.beta2, fi1)
            inv_b2 = 1.0 / b2
    cols = [torch.sqrt(1.0 / (4.0 * j_i)), -(1 + j_i) + pump_inst, 1 + j_i, -2 * j_i,
            torch.sqrt(j_i), b1, inv_b1, b2, inv_b2, zeros, zeros, zeros]
    return torch.stack(cols, dim=1).contiguous()


def _check(q_matrix, v_vector, params, rng, batch_size):
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
    check_saturation(params.S, q_matrix.shape[-1], "the MF kernel", batch_size)


def _launch(seed, q_matrix, v_vector, params, *, iterations, batch_size,
            pump_rate_flag, noise_scale, rng, hp, segment=None, row_base=0):
    """One launch of csrc/mf_solve.cu on CUDA tensors.  ``segment``: (state,
    start, num, steps) of a segment launch (state None: the solve's first
    state; steps None: the table built here), which returns ``(state,
    mu_tilde or None)``; else the whole solve's ``(mu, mu_tilde, sigma)``.
    ``row_base``: the global row of trajectory 0 (a data-parallel rank's
    first row)."""
    if q_matrix.device.type != "cuda":
        raise ValueError(f"mf_solve runs on cpu or cuda, not {q_matrix.device}")
    stacked = q_matrix.ndim == 3
    q = (q_matrix if stacked else q_matrix[None]).contiguous()
    v = (v_vector if stacked else v_vector[None]).contiguous()
    num_instances, n = q.shape[0], q.shape[-1]
    cols = np.ndim(params.S) != 0
    shape_ = build.mf_launch_shape(n, hp is not None, cols)
    rows = shape_.rows
    build.check_row_base(int(row_base), rows, stacked, "the MF kernel")
    launch = build.load(_spec(n, hp, noise_scale, rng, cols, segment is not None,
                              np.ndim(params.S) == 2))
    steps = None if segment is None else segment[3]
    if steps is None:
        steps = _step_table(params, hp, iterations, pump_rate_flag, q.device)
    col_values = _columns(params, q.device, rows, shape_.np, int(row_base))
    shape = (num_instances, int(batch_size), n)
    mu = torch.empty(shape, dtype=torch.float32, device=q.device)
    mt = torch.zeros_like(mu)  # the readout of a solve of 0 iterations
    sigma = torch.empty_like(mu)
    seg, moments, num = None, [], int(iterations)
    if segment is not None:
        state, start, num, _ = segment
        moments = [torch.empty_like(mu) for _ in range(2 if hp is not None else 0)]
        seg, _held = build.segment(state, shape, start, iterations, moments)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            q.data_ptr(), v.data_ptr(), steps.data_ptr(), mu.data_ptr(),
            mt.data_ptr(), sigma.data_ptr(), num_instances, int(batch_size), n,
            int(num), int(seed) % 2**64,
            _scalars(params, hp, float(noise_scale)), rows, stream,
            None if col_values is None else col_values.data_ptr(),
            None if seg is None else ctypes.byref(seg), int(row_base),
        )
    if err != 0:
        raise RuntimeError(f"mf_solve kernel launch failed: cudaError_t {err}")
    if hp is None:
        mf_solve.mf_launches += 1
    else:
        mf_solve.mf_adam_launches += 1
    unstack = (lambda x: x) if stacked else (lambda x: x[0])
    if segment is None:
        return unstack(mu), unstack(mt), unstack(sigma)
    ends = int(segment[1]) + int(num) == int(iterations)
    return (tuple(unstack(x) for x in [mu, sigma] + moments),
            unstack(mt) if ends else None)


def mf_solve(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    pump_rate_flag, noise_scale=1.0, rng="popcount32", hp=None, row_base=0,
):
    """Fused MF solve; ``hp`` selects the Adam variant.  Returns
    ``(mu, mu_tilde, sigma)`` shaped ``(batch, n)``, or ``(I, batch, n)`` for
    a stacked ``(I, n, n)`` Q, where instance ``i`` draws the noise of a
    solve with ``seed + i``; ``mu_tilde`` is the last step's, clamped to
    +-S.  ``row_base``: the global row of trajectory 0, so that a
    data-parallel rank's rows draw what those rows of a single solve draw."""
    _check(q_matrix, v_vector, params, rng, batch_size)
    kwargs = dict(
        iterations=iterations, batch_size=batch_size,
        pump_rate_flag=pump_rate_flag, noise_scale=noise_scale, rng=rng, hp=hp,
        row_base=row_base,
    )
    if q_matrix.device.type == "cpu":
        return mf_solve_reference(seed, q_matrix, v_vector, params, **kwargs)
    return _launch(seed, q_matrix, v_vector, params, **kwargs)


# Launch counts of the two kernels (the wrapper adds one per launch of the
# kernel's builds, a segment's too).
mf_solve.mf_launches = 0
mf_solve.mf_adam_launches = 0


def mf_solve_segment(
    seed, q_matrix, v_vector, params, state, start, num, *, iterations,
    batch_size, pump_rate_flag, noise_scale=1.0, rng="popcount32", hp=None,
    steps=None, row_base=0,
):
    """Advance ``state`` by ``num`` steps from absolute step ``start`` of a
    solve of ``iterations`` steps (the JAX ``solve_segment``).  ``state`` is
    ``(mu, sigma)``, with ``hp`` ``(mu, sigma, m, v)``, or None for the
    solve's first state.  Returns ``(state, mu_tilde)``: where the segment
    ends the solve, its readout (the last step's mu_tilde clamped to +-S, as
    :func:`mf_solve` returns it), else None.  ``steps``: the solve's step
    table (:func:`_step_table`), to build it once for many segments."""
    _check(q_matrix, v_vector, params, rng, batch_size)
    check_segment(state, start, num, iterations,
                  ("mu", "sigma") + (("m", "v") if hp is not None else ()), q_matrix,
                  batch_size)
    kwargs = dict(iterations=iterations, batch_size=batch_size,
                  pump_rate_flag=pump_rate_flag, noise_scale=noise_scale, rng=rng,
                  hp=hp, row_base=row_base)
    if q_matrix.device.type == "cpu":
        return mf_solve_segment_reference(seed, q_matrix, v_vector, params, state,
                                          start, num, **kwargs)
    return _launch(seed, q_matrix, v_vector, params,
                   segment=(state, int(start), num, steps), **kwargs)


def mf_solve_sampled(
    seed, q_matrix, v_vector, params, segments, *, batch_size, pump_rate_flag,
    noise_scale=1.0, rng="popcount32", hp=None, row_base=0,
):
    """A whole solve of ``sum(segments)`` steps as one segment launch each
    (the JAX ``solve_sampled``).  Returns ``((mu, mu_tilde, sigma),
    (mu_samples, sigma_samples))``: the whole solve's result, and each
    segment's mu and sigma stacked on a leading axis, on the tensors'
    device."""
    iterations = int(sum(int(x) for x in segments))
    kwargs = dict(iterations=iterations, batch_size=batch_size,
                  pump_rate_flag=pump_rate_flag, noise_scale=noise_scale, rng=rng,
                  hp=hp, row_base=row_base)
    if q_matrix.device.type == "cpu":
        return mf_solve_sampled_reference(seed, q_matrix, v_vector, params, segments,
                                          **kwargs)
    steps = _step_table(params, hp, iterations, pump_rate_flag, q_matrix.device)
    return _sampled(functools.partial(mf_solve_segment, steps=steps), seed, q_matrix,
                    v_vector, params, segments, kwargs)


def _sampled(segment, seed, q_matrix, v_vector, params, segments, kwargs):
    state, start, samples = None, 0, ([], [])
    for num in segments:
        state, mt = segment(seed, q_matrix, v_vector, params, state, start, int(num),
                            **kwargs)
        start += int(num)
        samples[0].append(state[0])
        samples[1].append(state[1])
    return (state[0], mt, state[1]), tuple(torch.stack(x) for x in samples)


def mf_solve_sampled_reference(seed, q_matrix, v_vector, params, segments, *,
                               iterations=None, **kwargs):
    """Plain PyTorch version of :func:`mf_solve_sampled` (same arguments,
    same result), on the tensors' own device."""
    kwargs["iterations"] = int(sum(int(x) for x in segments))
    return _sampled(mf_solve_segment_reference, seed, q_matrix, v_vector, params,
                    segments, kwargs)


def _draw(seed, q, batch_size, rng, noise_scale, row_base=0):
    """Step i's draw of the kernel's noise, for a stacked (I, n, n) Q whose
    trajectory 0 is the global row ``row_base``."""
    rows = torch.arange(int(batch_size), dtype=torch.int64, device=q.device) + int(row_base)
    instances = torch.arange(q.shape[0], dtype=torch.int64, device=q.device)

    def draw(i):
        w = philox.wiener_one(seed, i, rows, q.shape[-1], rng, instances)
        return w if noise_scale == 1.0 else w * noise_scale

    return None if noise_scale == 0.0 else draw


def mf_solve_segment_reference(
    seed, q_matrix, v_vector, params, state, start, num, *, iterations,
    batch_size, pump_rate_flag, noise_scale=1.0, rng="popcount32", hp=None,
    row_base=0,
):
    """Plain PyTorch version of :func:`mf_solve_segment` (same arguments,
    same result), on the tensors' own device."""
    _check(q_matrix, v_vector, params, rng, batch_size)
    stacked = q_matrix.ndim == 3
    q = q_matrix if stacked else q_matrix[None]
    v = (v_vector if stacked else v_vector[None])[:, None, :]
    shape = (q.shape[0], int(batch_size), q.shape[-1])
    full = dyn.initial_state(shape, q.device, hp)
    if state is not None:
        state = tuple(x.reshape(shape) for x in state)
        full = state[:2] + full[2:3] + state[2:]
    with fp32_matmul():
        full = dyn.advance(q, v, params, full, start, num,
                           pump_rate_flag=pump_rate_flag, hp=hp,
                           draw=_draw(seed, q, batch_size, rng, noise_scale, row_base))
    unstack = (lambda x: x) if stacked else (lambda x: x[0])
    mt = None
    if int(start) + int(num) == int(iterations):
        mt = unstack(dyn.clamp_readout(full[2], params))
    return tuple(unstack(x) for x in full[:2] + full[3:]), mt


def mf_solve_reference(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    pump_rate_flag, noise_scale=1.0, rng="popcount32", hp=None, row_base=0,
):
    """Plain PyTorch version of :func:`mf_solve` (same arguments, same
    result), on the tensors' own device."""
    _check(q_matrix, v_vector, params, rng, batch_size)
    stacked = q_matrix.ndim == 3
    q = q_matrix if stacked else q_matrix[None]
    v = (v_vector if stacked else v_vector[None])[:, None, :]

    with fp32_matmul():
        mu, mt, sigma = dyn.solve(
            q, v, params, iterations=iterations, batch_size=batch_size,
            pump_rate_flag=pump_rate_flag, hp=hp,
            draw=_draw(seed, q, batch_size, rng, noise_scale, row_base),
        )
    return (mu, mt, sigma) if stacked else (mu[0], mt[0], sigma[0])


def mf_step(seed, mv, v_local, params, state, x, step, *, iterations, pump_rate_flag,
            noise_scale=1.0, rng="popcount32", hp=None, row_base=0, col_base=0,
            steps=None):
    """Step ``step`` of a tensor-parallel MF solve of ``iterations`` steps on
    a rank's (batch, nl) shard, whose row 0 and column 0 are the global
    ``row_base`` and ``col_base``: ``state`` (mu, sigma, mu_tilde[, m, v])
    stacked (3 or 5, batch, nl), mu_tilde the step's measured field, and
    ``x`` (1, batch, nl), the next step's matvec input (its mu_tilde
    clamped, through the change of variables, with the next step's draw),
    are updated in place.  ``mv`` (1, batch, nl) is the step's x @ Q at the
    shard's columns; ``step`` None writes only step 0's x, for the first
    matvec.  ``params.S`` is a scalar.  On the card it launches the one-step
    build of csrc/mf_solve.cu (``steps``: the solve's :func:`_step_table`,
    built once); on the CPU it runs :func:`mf_step_reference`."""
    if rng not in philox.RNG_NAMES:
        raise ValueError(f"rng must be one of {philox.RNG_NAMES}, got {rng!r}")
    check_step(mv, v_local, state, x, step, 3 if hp is None else 5, 1, "mf_step")
    kwargs = dict(iterations=iterations, pump_rate_flag=pump_rate_flag,
                  noise_scale=noise_scale, rng=rng, hp=hp, row_base=row_base,
                  col_base=col_base)
    if state.device.type == "cpu":
        return mf_step_reference(seed, mv, v_local, params, state, x, step, **kwargs)
    if steps is None:
        steps = _step_table(params, hp, iterations, pump_rate_flag, state.device)
    spec = _spec(4, hp, noise_scale, rng)._replace(ext=True)  # NP 4: any N
    run_step(spec, "ccvm_mf_step", seed, mv, v_local, steps, state, x, step, iterations,
             _scalars(params, hp, float(noise_scale)), row_base, col_base)
    if hp is None:
        mf_step.mf_launches += 1
    else:
        mf_step.mf_adam_launches += 1


# Launch counts of the two one-step builds.
mf_step.mf_launches = 0
mf_step.mf_adam_launches = 0


def mf_step_reference(seed, mv, v_local, params, state, x, step, *, iterations,
                      pump_rate_flag, noise_scale=1.0, rng="popcount32", hp=None,
                      row_base=0, col_base=0, steps=None):
    """Plain PyTorch version of :func:`mf_step` (same arguments, same
    result), on the tensors' own device: the dynamics' step with the given
    matvec, the kernel's safety clip of mu, and the draws of the shard's
    global rows and columns."""
    rows, nl = shard_rows(state, row_base), state.shape[-1]

    def draw(i):
        if noise_scale == 0.0:
            return torch.zeros_like(state[0])
        w = philox.wiener_one(seed, i, rows, nl, rng, col0=col_base)
        return w if noise_scale == 1.0 else w * noise_scale

    if step is not None:
        # Q is not read: the matvec is given; mv stands in for it as the
        # carrier of the device.
        given = dict(matvec=lambda _x, _q: mv[0])
        if hp is None:
            fn = dyn.make_step(mv, v_local, params, pump_rate_flag, **given)
        else:
            fn = dyn.make_adam_step(mv, v_local, params, pump_rate_flag, hp, **given)
        new = fn(tuple(state), step, draw(step))
        bound = dyn.MF_SAFETY_BOUND
        state.copy_(torch.stack((new[0].clamp(-bound, bound),) + tuple(new[1:])))
    following = 0 if step is None else int(step) + 1
    if following < int(iterations):
        p = common.float32_scalars(params, state.device)
        mt_c = dyn._measure(p, following, state[0], draw(following), torch.sqrt(p.dt),
                            pump_rate_flag)[3]
        x.copy_(dyn.matvec_input(mt_c, p.S, p.lower_limit, p.upper_limit)[None])
