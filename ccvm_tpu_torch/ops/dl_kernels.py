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


def per_element(values, fills, rows, np_, extra=0, lead=0):
    """The per-element builds' array on the values' device: each (batch, n)
    tensor of ``values`` as a (rows', NP) slice, its padding (``lead``
    leading rows, a launch's row base, whose kernel indexes rows globally;
    the batch to ``rows'``, a multiple of the launch's ``rows`` a block; the
    columns to ``np_``) filled with its ``fills`` value, then ``extra``
    slices left for the kernel to write."""
    batch, n = values[0].shape
    out = torch.empty((len(values) + extra, lead + -(-batch // rows) * rows, np_),
                      dtype=torch.float32, device=values[0].device)
    for k, (x, fill) in enumerate(zip(values, fills)):
        out[k].fill_(fill)
        out[k, lead:lead + batch, :n] = x
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


def _columns(params, device, rows, np_, instances, lead=0):
    """S's array for the kernel on ``device``, by float32 operations on the
    device that round as :func:`_scalars`'s on the host (None for a scalar
    S): the per-column build's (3, n) S_j, span / S_j and 0.25 span / S_j;
    the per-element build's (2 + ``instances``, rows', ``np_``) S_ij and
    span / S_ij (:func:`per_element`, ``lead`` leading rows; padding S 1),
    then room for each instance's feedback offsets, which the kernel
    writes."""
    if np.ndim(params.S) == 0:
        return None
    S = common.saturation_tensor(params.S, device)
    span = (torch.tensor(float(params.upper_limit), dtype=torch.float32, device=device)
            - float(params.lower_limit))
    if S.ndim == 2:
        return per_element([S, span / S], (1.0, 0.0), rows, np_, extra=instances,
                           lead=lead)
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
            pump_rate_flag, pump_is_gt_one, noise_scale, rng, hp, segment=None,
            row_base=0):
    """One launch of csrc/dl_solve.cu on CUDA tensors.  ``segment``: (state,
    start, num, steps) of a segment launch (state None: the zeros; steps
    None: the table built here), which returns ``(state, c clamped or
    None)``; else the whole solve's ``(c, s)``.  ``row_base``: the global
    row of trajectory 0 (a data-parallel rank's first row)."""
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
    build.check_row_base(int(row_base), rows, stacked, "the DL kernel")
    launch = build.load(_spec(n, hp, noise_scale, rng, mma, cols, segment is not None,
                              np.ndim(params.S) == 2))
    steps = None if segment is None else segment[3]
    if steps is None:
        steps = _step_table(params, hp, noise_scale, iterations, pump_rate_flag,
                            q.device)
    col_values = _columns(params, q.device, rows, shape_.np, num_instances, int(row_base))
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
            None if seg is None else ctypes.byref(seg), int(row_base),
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
               rng="popcount16", hp=None, row_base=0):
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
        noise_scale=noise_scale, rng=rng, hp=hp, row_base=row_base,
    )
    if q_matrix.device.type == "cpu":
        return dl_solve_reference(seed, q_matrix, v_vector, params, **kwargs)
    return _launch(mma, seed, q_matrix, v_vector, params, **kwargs)


def dl_solve(
    seed, q_matrix, v_vector, params, *, iterations, batch_size,
    pump_rate_flag, pump_is_gt_one, noise_scale=1.0, rng="popcount16",
    hp=None, row_base=0,
):
    """Fused DL solve; ``hp`` selects the Adam variant.  Returns ``(c, s)``
    shaped ``(batch, n)``, or ``(I, batch, n)`` for a stacked ``(I, n, n)``
    Q, where instance ``i`` draws the noise of a solve with ``seed + i``.
    ``row_base``: the global row of trajectory 0, so that a data-parallel
    rank's rows draw what those rows of a single solve draw."""
    out = solve_with(
        True, seed, q_matrix, v_vector, params, iterations=iterations,
        batch_size=batch_size, pump_rate_flag=pump_rate_flag,
        pump_is_gt_one=pump_is_gt_one, noise_scale=noise_scale, rng=rng, hp=hp,
        row_base=row_base,
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
    rng="popcount16", hp=None, steps=None, row_base=0,
):
    """Advance ``state`` by ``num`` steps from absolute step ``start`` of a
    solve of ``iterations`` steps (the JAX ``solve_segment``).  ``state`` is
    ``(c, s)``, with ``hp`` ``(c, s, m_c, v_c, m_s, v_s)``, or None for the
    solve's zeros.  Returns ``(state, c_final)``: the raw state (no clamp),
    and where the segment ends the solve c clamped to +-S, as
    :func:`dl_solve` returns it (else None).  ``steps``: the solve's step
    table (:func:`_step_table`), to build it once for many segments;
    ``row_base`` as :func:`dl_solve`'s."""
    if rng not in philox.RNG_NAMES:
        raise ValueError(f"rng must be one of {philox.RNG_NAMES}, got {rng!r}")
    _check(q_matrix, v_vector, params, batch_size)
    check_segment(state, start, num, iterations,
                  ("c", "s") + (("m_c", "v_c", "m_s", "v_s") if hp is not None else ()),
                  q_matrix, batch_size)
    kwargs = dict(iterations=iterations, batch_size=batch_size,
                  pump_rate_flag=pump_rate_flag, pump_is_gt_one=pump_is_gt_one,
                  noise_scale=noise_scale, rng=rng, hp=hp, row_base=row_base)
    if q_matrix.device.type == "cpu":
        return dl_solve_segment_reference(seed, q_matrix, v_vector, params, state,
                                          start, num, **kwargs)
    out = _launch(True, seed, q_matrix, v_vector, params,
                  segment=(state, start, num, steps), **kwargs)
    _count(q_matrix, hp)
    return out


def dl_solve_sampled(
    seed, q_matrix, v_vector, params, segments, *, batch_size, pump_rate_flag,
    pump_is_gt_one, noise_scale=1.0, rng="popcount16", hp=None, row_base=0,
):
    """A whole solve of ``sum(segments)`` steps as one segment launch each
    (the JAX ``solve_sampled``).  Returns ``((c, s), (c_samples,
    s_samples))``: the final c clamped to +-S, and each segment's raw c and
    s stacked on a leading axis, on the tensors' device."""
    iterations = int(sum(int(x) for x in segments))
    kwargs = dict(iterations=iterations, batch_size=batch_size,
                  pump_rate_flag=pump_rate_flag, pump_is_gt_one=pump_is_gt_one,
                  noise_scale=noise_scale, rng=rng, hp=hp, row_base=row_base)
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
    rng="popcount16", hp=None, row_base=0,
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
    rows = torch.arange(int(batch_size), dtype=torch.int64, device=device) + int(row_base)
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
    hp=None, row_base=0,
):
    """Plain PyTorch version of :func:`dl_solve` (same arguments, same
    result), on the tensors' own device: one segment over the whole solve."""
    state, c = dl_solve_segment_reference(
        seed, q_matrix, v_vector, params, None, 0, iterations,
        iterations=iterations, batch_size=batch_size,
        pump_rate_flag=pump_rate_flag, pump_is_gt_one=pump_is_gt_one,
        noise_scale=noise_scale, rng=rng, hp=hp, row_base=row_base)
    return c, state[1]


# ------------------------------------------------------------------ one step
# A tensor-parallel solve (ccvm_tpu_torch/parallel/tp.py) runs each step as
# a matmul and a reduce-scatter of its partial x @ Q (outside any kernel, as
# the JAX package leaves them to XLA) and then one launch of a template's
# one-step build (CCVM_EXT), which takes the scattered matvec from a buffer,
# applies the template's step arithmetic and Philox draws at the shard's
# global rows and columns, and writes the next step's matvec input.


def check_step(mv, v_local, state, x, step, state_arrays, x_arrays, kernel):
    """Raise unless ``state`` is a float32 (state_arrays, batch, nl) tensor,
    ``x`` and ``mv`` (``mv`` None before the first step) (x_arrays, batch,
    nl) and ``v_local`` (nl,), contiguous, on one device."""
    if not isinstance(state, torch.Tensor) or state.ndim != 3 or \
            state.shape[0] != state_arrays:
        raise ValueError(f"{kernel} takes a state of {state_arrays} (batch, nl) arrays")
    _, batch, nl = state.shape
    want = {"state": (state, state.shape), "x": (x, (x_arrays, batch, nl)),
            "V": (v_local, (nl,))}
    if step is not None:
        want["mv"] = (mv, (x_arrays, batch, nl))
    for name, (t, shape) in want.items():
        if (not isinstance(t, torch.Tensor) or tuple(t.shape) != tuple(shape)
                or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != state.device):
            raise ValueError(f"{kernel} takes a contiguous float32 {name} shaped "
                             f"{tuple(shape)} on the state's device")


def run_step(spec, symbol, seed, mv, v_local, steps, state, x, step, iterations,
             scalars, row_base, col_base):
    """One launch of a one-step build on the card, on the state's card;
    raises when the launch fails."""
    launch = build.load(spec, symbol, build.STEP_ARGTYPES)
    _, batch, nl = state.shape
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = launch(None if mv is None else mv.data_ptr(), v_local.data_ptr(),
                     None if steps is None else steps.data_ptr(), state.data_ptr(),
                     x.data_ptr(), batch, nl, int(col_base), int(row_base),
                     -1 if step is None else int(step), int(iterations),
                     int(seed) % 2**64, scalars, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError_t {err}")


def shard_rows(state, row_base):
    return torch.arange(state.shape[1], dtype=torch.int64, device=state.device) + int(row_base)


def dl_step(seed, mv, v_local, params, state, x, step, *, iterations,
            pump_rate_flag, pump_is_gt_one, noise_scale=1.0, rng="popcount16",
            hp=None, row_base=0, col_base=0, steps=None):
    """Step ``step`` of a tensor-parallel DL solve of ``iterations`` steps on
    a rank's (batch, nl) shard, whose row 0 and column 0 are the global
    ``row_base`` and ``col_base``: ``state`` (c, s[, m_c, v_c, m_s, v_s])
    stacked (2 or 6, batch, nl) and ``x`` (2, batch, nl), the next step's
    matvec input of c and s, are updated in place.  ``mv`` (2, batch, nl)
    is the step's (x_c @ Q, x_s @ Q) at the shard's columns; ``step`` None
    writes only x of the state, for the first matvec.  ``params.S`` is a
    scalar.  On the card it launches the one-step build of csrc/dl_solve.cu
    (``steps``: the solve's :func:`_step_table`, built once); on the CPU it
    runs :func:`dl_step_reference`."""
    if rng not in philox.RNG_NAMES:
        raise ValueError(f"rng must be one of {philox.RNG_NAMES}, got {rng!r}")
    check_step(mv, v_local, state, x, step, 2 if hp is None else 6, 2, "dl_step")
    kwargs = dict(iterations=iterations, pump_rate_flag=pump_rate_flag,
                  pump_is_gt_one=pump_is_gt_one, noise_scale=noise_scale, rng=rng,
                  hp=hp, row_base=row_base, col_base=col_base)
    if state.device.type == "cpu":
        return dl_step_reference(seed, mv, v_local, params, state, x, step, **kwargs)
    if step is not None and steps is None:
        steps = _step_table(params, hp, noise_scale, iterations, pump_rate_flag,
                            state.device)
    spec = _spec(8, hp, noise_scale, rng, True)._replace(ext=True)  # one n-tile: any N
    run_step(spec, "ccvm_dl_step", seed, mv, v_local, steps, state, x, step,
             iterations, _scalars(params, hp, float(noise_scale), pump_is_gt_one),
             row_base, col_base)
    if hp is None:
        dl_step.dl_launches += 1
    else:
        dl_step.dl_adam_launches += 1


# Launch counts of the two one-step builds.
dl_step.dl_launches = 0
dl_step.dl_adam_launches = 0


def dl_step_reference(seed, mv, v_local, params, state, x, step, *, iterations,
                      pump_rate_flag, pump_is_gt_one, noise_scale=1.0,
                      rng="popcount16", hp=None, row_base=0, col_base=0, steps=None):
    """Plain PyTorch version of :func:`dl_step` (same arguments, same
    result), on the tensors' own device: the dynamics' step with the given
    matvec, the kernel's safety clip, and the draws of the shard's global
    rows and columns."""
    p = dyn._scalars(params, state.device)
    s_d = dyn.drift_saturation(p, pump_is_gt_one)
    if step is not None:
        if noise_scale == 0.0:
            w_c = w_s = torch.zeros_like(state[0])
        else:
            w_c, w_s = philox.wiener_pair(seed, step, shard_rows(state, row_base),
                                          state.shape[-1], rng, col0=col_base)
            if noise_scale != 1.0:
                w_c, w_s = w_c * noise_scale, w_s * noise_scale
        parts = iter(mv)  # the step takes x_c @ Q, then x_s @ Q
        given = dict(matvec=lambda _x, _q: next(parts))
        # Q is not read: the matvec is given; mv stands in for it as the
        # carrier of the device.
        if hp is None:
            fn = dyn.make_step(mv, v_local, params, pump_rate_flag, pump_is_gt_one, **given)
        else:
            fn = dyn.make_adam_step(mv, v_local, params, pump_rate_flag, pump_is_gt_one,
                                    hp, **given)
        new = fn(tuple(state), step, w_c, w_s)
        bound = DL_SAFETY_BOUND
        state.copy_(torch.stack((new[0].clamp(-bound, bound), new[1].clamp(-bound, bound))
                                + tuple(new[2:])))
    x.copy_(torch.stack([dyn.matvec_input(z, s_d, p.lower_limit, p.upper_limit)
                         for z in state[:2]]))
