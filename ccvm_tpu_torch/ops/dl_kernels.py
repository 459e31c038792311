"""The whole-solve DL-CCVM kernel's wrapper and its plain version.

:func:`dl_solve` takes the arguments of ``pallas_kernels.dl_solve``
(``ccvm_tpu/ops/pallas_kernels.py:938-974``), with an int seed in place of
the PRNG key.  For CUDA tensors it launches ``csrc/dl_solve.cu`` (the
counterpart of ``_dl_kernel``, or of ``_dl_adam_kernel`` when ``hp`` is
given); for CPU tensors it runs :func:`dl_solve_reference`.  There is no
fallback from the kernel to the plain version.  ``params.S`` is a scalar,
one value a column (a tuple) or one an element (a (batch, n) tensor), and
``params`` may carry the generalised pump ramp; all go to the kernel.

:func:`dl_solve_segment` advances a given state from a given absolute step
(the JAX ``dynamics/dl.py`` ``solve_segment``), with the Adam moments in the
state, and :func:`dl_solve_sampled` runs a whole solve as segments with a
sample after each (the JAX ``solve_sampled``): one launch a segment of the
kernel's segment build, which keys its noise and reads its step table by the
absolute step, so the segments equal the whole launch bit for bit.

:func:`dl_solve_reference` computes the same function in eager PyTorch with
the step functions of :mod:`ccvm_tpu_torch.dynamics.dl`, the kernel's per-step
safety clip, its final clamp of c, and its noise (the Philox words of
:mod:`ccvm_tpu_torch.ops.philox` through the same transform).  Noise off, the
two agree to float32 round-off; noise on, they draw the same increments.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ccvm_tpu_torch.dynamics import common
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


def columns_kind(S, pump_is_gt_one):
    """The kernel's per-column S build (csrc/dl_solve.cu CCVM_COLS): 0 for a
    scalar S; for one a column or one an element (CCVM_ELEM), 1 where it
    enters the final clamp only (pump > 1, the drift's S_d = sqrt(pump -
    1)), else 2."""
    if np.ndim(S) == 0:
        return 0
    return 1 if pump_is_gt_one else 2


def per_element(values, fills, rows, np_, extra=0):
    """The per-element builds' array on the values' device: each (batch, n)
    tensor of ``values`` as a (rows', NP) slice, its padding (the batch to
    ``rows'``, a multiple of the launch's ``rows`` a block; the columns to
    ``np_``) filled with its ``fills`` value, then ``extra`` slices left for
    the kernel to write."""
    batch, n = values[0].shape
    out = torch.empty((len(values) + extra, -(-batch // rows) * rows, np_),
                      dtype=torch.float32, device=values[0].device)
    for k, (x, fill) in enumerate(zip(values, fills)):
        out[k].fill_(fill)
        out[k, :batch, :n] = x
    return out


def _spec(n, hp, noise_scale, rng, mma, cols=0, seg=False, elem=False):
    noise = float(noise_scale) != 0.0
    return build.DLSpec(
        adam=hp is not None,
        beta2_one=hp is not None and hp.beta2 == 1.0,
        add_assign=hp is not None and bool(hp.add_assign),
        noise=noise,
        rng=philox.RNG_NAMES.index(rng) if noise else 1,
        mma=bool(mma),
        nt=build.dl_launch_shape(n, hp is not None, mma).np // 8 if mma else 0,
        cols=int(cols),
        seg=bool(seg),
        elem=bool(elem),
    )


def blocks_per_sm(n, *, noise_scale=1.0, rng="popcount16", hp=None, mma=True,
                  cols=0, seg=False, elem=False):
    """Blocks of the specialisation that :func:`dl_solve` launches with these
    arguments (``mma`` False: the CUDA-core matvec of the race harness;
    ``cols``, ``seg``, ``elem``: the per-column S, segment and per-element S
    builds) that the card keeps resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); builds it first."""
    spec = _spec(n, hp, noise_scale, rng, mma, cols, seg, elem)
    rows = build.dl_launch_shape(n, hp is not None, mma, cols).rows
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
    device would round them.  With one S a column or an element, S reads 1
    here (the kernel takes them from :func:`_columns`)."""
    alpha = beta1 = beta2 = 0.0
    if hp is not None:
        alpha, beta1, beta2 = hp.alpha, hp.beta1, hp.beta2
    f = np.float32
    S = params.S if np.ndim(params.S) == 0 else 1.0
    pump, S, dt, g, lo, hi = (f(x) for x in (params.pump, S, params.dt,
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


def _columns(params, device, rows, np_, instances):
    """S's array for the kernel on ``device``, by float32 operations on the
    device that round as :func:`_scalars`'s on the host (None for a scalar
    S): the per-column build's (3, n) S_j, span / S_j and 0.25 span / S_j;
    the per-element build's (2 + ``instances``, rows', ``np_``) S_ij and
    span / S_ij (:func:`per_element`; padding S 1), then room for each
    instance's feedback offsets, which the kernel writes."""
    if np.ndim(params.S) == 0:
        return None
    S = common.saturation_tensor(params.S, device)
    span = (torch.tensor(float(params.upper_limit), dtype=torch.float32, device=device)
            - float(params.lower_limit))
    if S.ndim == 2:
        return per_element([S, span / S], (1.0, 0.0), rows, np_, extra=instances)
    return torch.stack([S, span / S, 0.25 * span / S])


def _step_table(params, hp, noise_scale, iterations, pump_rate_flag, device):
    """The kernel's per-step scalars, (iterations, 8) float32 on ``device``,
    by the plain version's own float32 operations (``dynamics/dl.py``,
    ``dynamics/common.adam_moment_update``): fs (0.5 + rate), pump rate
    (the generalised ramp's where ``params`` sets it), noise_scale sqrt(dt)
    nr_i, noise_scale sqrt(dt) / nr_i, and Adam's 1 / (1 - beta1^(i+1)),
    1 / (1 - beta2^(i+1)) (1 without Adam, or for beta2 = 1), then two
    zeros.  Row i is step i of the whole solve; a segment reads its rows
    from its first step on."""
    def f32(x):
        return torch.tensor(float(x), dtype=torch.float32, device=device)

    fi1 = torch.arange(1, int(iterations) + 1, dtype=torch.float32, device=device)
    rate = dyn.pump_rate(dyn._scalars(params, device), fi1, pump_rate_flag)
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


def check_saturation(S, n, kernel, batch_size):
    """Raise unless S is a scalar, one value a column of an n-variable
    problem, or one an element of a (batch_size, n) solve's."""
    shape = tuple(np.shape(S))
    if shape not in ((), (n,), (int(batch_size), n)):
        raise ValueError(f"{kernel} takes a scalar S, one a column ({n},) or one an "
                         f"element ({batch_size}, {n}), got shape {shape}")


def _check(q_matrix, v_vector, params, batch_size):
    check_problem(q_matrix, v_vector)
    check_saturation(params.S, q_matrix.shape[-1], "the DL kernel", batch_size)


def check_segment(state, start, num, iterations, names, q_matrix, batch_size):
    """Raise unless steps [start, start + num) lie in a solve of
    ``iterations`` and ``state`` (None, or arrays named ``names``) is shaped
    as the solve's state."""
    if not 0 <= int(start) <= int(start) + int(num) <= int(iterations):
        raise ValueError(f"a segment of steps [{start}, {start} + {num}) does not "
                         f"lie in a solve of {iterations}")
    shape = tuple(q_matrix.shape[:-2]) + (int(batch_size), q_matrix.shape[-1])
    if state is not None and (len(state) != len(names) or
                              any(tuple(x.shape) != shape for x in state)):
        raise ValueError(f"the state is ({', '.join(names)}), each shaped {shape}")


def _launch(mma, seed, q_matrix, v_vector, params, *, iterations, batch_size,
            pump_rate_flag, pump_is_gt_one, noise_scale, rng, hp, segment=None):
    """One launch of csrc/dl_solve.cu on CUDA tensors.  ``segment``: (state,
    start, num, steps) of a segment launch (state None: the zeros; steps
    None: the table built here), which returns ``(state, c clamped or
    None)``; else the whole solve's ``(c, s)``."""
    if q_matrix.device.type != "cuda":
        raise ValueError(f"dl_solve runs on cpu or cuda, not {q_matrix.device}")
    stacked = q_matrix.ndim == 3
    q = (q_matrix if stacked else q_matrix[None]).contiguous()
    v = (v_vector if stacked else v_vector[None]).contiguous()
    num_instances, n = q.shape[0], q.shape[-1]
    cols = columns_kind(params.S, pump_is_gt_one)
    if cols and not mma:
        raise ValueError("the CUDA-core DL matvec takes a scalar S")
    shape_ = build.dl_launch_shape(n, hp is not None, mma, cols)
    rows = shape_.rows
    launch = build.load(_spec(n, hp, noise_scale, rng, mma, cols, segment is not None,
                              np.ndim(params.S) == 2))
    steps = None if segment is None else segment[3]
    if steps is None:
        steps = _step_table(params, hp, noise_scale, iterations, pump_rate_flag,
                            q.device)
    col_values = _columns(params, q.device, rows, shape_.np, num_instances)
    shape = (num_instances, int(batch_size), n)
    c = torch.empty(shape, dtype=torch.float32, device=q.device)
    s = torch.empty_like(c)
    seg, moments, clamped, num = None, [], None, int(iterations)
    if segment is not None:
        state, start, num, _ = segment
        moments = [torch.empty_like(c) for _ in range(4 if hp is not None else 0)]
        if int(start) + int(num) == int(iterations):
            clamped = torch.empty_like(c)
        seg, _held = build.segment(state, shape, start, iterations, moments, clamped)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            q.data_ptr(), v.data_ptr(), steps.data_ptr(), c.data_ptr(),
            s.data_ptr(), num_instances, int(batch_size), n, int(num),
            int(seed) % 2**64,
            _scalars(params, hp, float(noise_scale), pump_is_gt_one), rows,
            stream, None if col_values is None else col_values.data_ptr(),
            None if seg is None else ctypes.byref(seg),
        )
    if err != 0:
        raise RuntimeError(f"dl_solve kernel launch failed: cudaError_t {err}")
    unstack = (lambda x: x) if stacked else (lambda x: x[0])
    if segment is None:
        return unstack(c), unstack(s)
    return (tuple(unstack(x) for x in [c, s] + moments),
            None if clamped is None else unstack(clamped))


def _count(q_matrix, hp):
    if q_matrix.device.type == "cuda":
        if hp is None:
            dl_solve.dl_launches += 1
        else:
            dl_solve.dl_adam_launches += 1


def solve_with(mma, seed, q_matrix, v_vector, params, *, iterations,
               batch_size, pump_rate_flag, pump_is_gt_one, noise_scale=1.0,
               rng="popcount16", hp=None):
    """:func:`dl_solve` with the matvec chosen: ``mma`` True is the 3xTF32
    tensor-core design that :func:`dl_solve` launches, False the fp32
    CUDA-core one that only the race harness launches.  Counts no launch:
    each caller counts its own."""
    if rng not in philox.RNG_NAMES:
        raise ValueError(f"rng must be one of {philox.RNG_NAMES}, got {rng!r}")
    _check(q_matrix, v_vector, params, batch_size)
    kwargs = dict(
        iterations=iterations, batch_size=batch_size,
        pump_rate_flag=pump_rate_flag, pump_is_gt_one=pump_is_gt_one,
        noise_scale=noise_scale, rng=rng, hp=hp,
    )
    if q_matrix.device.type == "cpu":
        return dl_solve_reference(seed, q_matrix, v_vector, params, **kwargs)
    return _launch(mma, seed, q_matrix, v_vector, params, **kwargs)


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
    _count(q_matrix, hp)
    return out


# Launch counts of the two kernels (the wrappers add one per launch of the
# kernel's builds, a segment's too).
dl_solve.dl_launches = 0
dl_solve.dl_adam_launches = 0


def dl_solve_segment(
    seed, q_matrix, v_vector, params, state, start, num, *, iterations,
    batch_size, pump_rate_flag, pump_is_gt_one, noise_scale=1.0,
    rng="popcount16", hp=None, steps=None,
):
    """Advance ``state`` by ``num`` steps from absolute step ``start`` of a
    solve of ``iterations`` steps (the JAX ``solve_segment``).  ``state`` is
    ``(c, s)``, with ``hp`` ``(c, s, m_c, v_c, m_s, v_s)``, or None for the
    solve's zeros.  Returns ``(state, c_final)``: the raw state (no clamp),
    and where the segment ends the solve c clamped to +-S, as
    :func:`dl_solve` returns it (else None).  ``steps``: the solve's step
    table (:func:`_step_table`), to build it once for many segments."""
    if rng not in philox.RNG_NAMES:
        raise ValueError(f"rng must be one of {philox.RNG_NAMES}, got {rng!r}")
    _check(q_matrix, v_vector, params, batch_size)
    check_segment(state, start, num, iterations,
                  ("c", "s") + (("m_c", "v_c", "m_s", "v_s") if hp is not None else ()),
                  q_matrix, batch_size)
    kwargs = dict(iterations=iterations, batch_size=batch_size,
                  pump_rate_flag=pump_rate_flag, pump_is_gt_one=pump_is_gt_one,
                  noise_scale=noise_scale, rng=rng, hp=hp)
    if q_matrix.device.type == "cpu":
        return dl_solve_segment_reference(seed, q_matrix, v_vector, params, state,
                                          start, num, **kwargs)
    out = _launch(True, seed, q_matrix, v_vector, params,
                  segment=(state, start, num, steps), **kwargs)
    _count(q_matrix, hp)
    return out


def dl_solve_sampled(
    seed, q_matrix, v_vector, params, segments, *, batch_size, pump_rate_flag,
    pump_is_gt_one, noise_scale=1.0, rng="popcount16", hp=None,
):
    """A whole solve of ``sum(segments)`` steps as one segment launch each
    (the JAX ``solve_sampled``).  Returns ``((c, s), (c_samples,
    s_samples))``: the final c clamped to +-S, and each segment's raw c and
    s stacked on a leading axis, on the tensors' device."""
    iterations = int(sum(int(x) for x in segments))
    kwargs = dict(iterations=iterations, batch_size=batch_size,
                  pump_rate_flag=pump_rate_flag, pump_is_gt_one=pump_is_gt_one,
                  noise_scale=noise_scale, rng=rng, hp=hp)
    if q_matrix.device.type == "cpu":
        return dl_solve_sampled_reference(seed, q_matrix, v_vector, params, segments,
                                          **kwargs)
    steps = _step_table(params, hp, noise_scale, iterations, pump_rate_flag,
                        q_matrix.device)
    return _sampled(functools.partial(dl_solve_segment, steps=steps), seed, q_matrix,
                    v_vector, params, segments, kwargs)


def _sampled(segment, seed, q_matrix, v_vector, params, segments, kwargs):
    state, start, samples = None, 0, ([], [])
    for num in segments:
        state, c_final = segment(seed, q_matrix, v_vector, params, state, start,
                                 int(num), **kwargs)
        start += int(num)
        samples[0].append(state[0])
        samples[1].append(state[1])
    return (c_final, state[1]), tuple(torch.stack(x) for x in samples)


def dl_solve_sampled_reference(seed, q_matrix, v_vector, params, segments, *,
                               iterations=None, **kwargs):
    """Plain PyTorch version of :func:`dl_solve_sampled` (same arguments,
    same result), on the tensors' own device."""
    kwargs["iterations"] = int(sum(int(x) for x in segments))
    return _sampled(dl_solve_segment_reference, seed, q_matrix, v_vector, params,
                    segments, kwargs)


def dl_solve_segment_reference(
    seed, q_matrix, v_vector, params, state, start, num, *, iterations,
    batch_size, pump_rate_flag, pump_is_gt_one, noise_scale=1.0,
    rng="popcount16", hp=None,
):
    """Plain PyTorch version of :func:`dl_solve_segment` (same arguments, same
    result), on the tensors' own device."""
    if rng not in philox.RNG_NAMES:
        raise ValueError(f"rng must be one of {philox.RNG_NAMES}, got {rng!r}")
    stacked = q_matrix.ndim == 3
    q = q_matrix if stacked else q_matrix[None]
    v = (v_vector if stacked else v_vector[None])[:, None, :]
    num_instances, n = q.shape[0], q.shape[-1]
    device = q.device
    zeros = torch.zeros((num_instances, int(batch_size), n), dtype=torch.float32,
                        device=device)
    rows = torch.arange(int(batch_size), dtype=torch.int64, device=device)
    instances = torch.arange(num_instances, dtype=torch.int64, device=device)
    if state is None:
        state = (zeros,) * (2 if hp is None else 6)
    else:
        state = tuple(x.reshape(zeros.shape) for x in state)
    bound = DL_SAFETY_BOUND
    with fp32_matmul():
        if hp is None:
            step = dyn.make_step(q, v, params, pump_rate_flag, pump_is_gt_one)
        else:
            step = dyn.make_adam_step(
                q, v, params, pump_rate_flag, pump_is_gt_one, hp
            )
        for i in range(int(start), int(start) + int(num)):
            if noise_scale == 0.0:
                w_c = w_s = zeros
            else:
                w_c, w_s = philox.wiener_pair(seed, i, rows, n, rng, instances)
                if noise_scale != 1.0:
                    w_c, w_s = w_c * noise_scale, w_s * noise_scale
            state = step(state, i, w_c, w_s)
            state = (state[0].clamp(-bound, bound),
                     state[1].clamp(-bound, bound)) + tuple(state[2:])
    c_final = None
    if int(start) + int(num) == int(iterations):
        S = common.saturation_tensor(params.S, device)
        c_final = torch.clamp(state[0], -S, S)
    unstack = (lambda x: x) if stacked else (lambda x: x[0])
    return (tuple(unstack(x) for x in state),
            None if c_final is None else unstack(c_final))


def dl_solve_reference(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    pump_rate_flag, pump_is_gt_one, noise_scale=1.0, rng="popcount16",
    hp=None,
):
    """Plain PyTorch version of :func:`dl_solve` (same arguments, same
    result), on the tensors' own device: one segment over the whole solve."""
    state, c = dl_solve_segment_reference(
        seed, q_matrix, v_vector, params, None, 0, iterations,
        iterations=iterations, batch_size=batch_size,
        pump_rate_flag=pump_rate_flag, pump_is_gt_one=pump_is_gt_one,
        noise_scale=noise_scale, rng=rng, hp=hp)
    return c, state[1]
