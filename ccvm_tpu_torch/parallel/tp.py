"""Tensor + data parallel CCVM solves over a ("batch", "model") mesh (the
twin of ``ccvm_tpu/parallel/tp.py``, on ``torch.distributed``).

For problem sizes far beyond the bundled N<=70 set, the (batch, N) state and
the (N, N) coupling matrix both shard over the mesh:

* state (c / s / mu / sigma / Adam moments): rows over "batch", features
  over "model", (batch/dp, n/tp) on each rank;
* Q: its row block (n/tp, n) on each rank (rows shard the contraction);
* V: its feature shard (n/tp,).

Each step computes the local partial ``x_local @ q_rows`` (``torch.matmul``,
TF32 off, as the JAX package leaves it to XLA outside any kernel), one
reduce-scatter over "model" returns its columns of the full matvec
(:func:`ccvm_tpu_torch.dynamics.common.tp_matvec`; DL stacks its c and s
inputs into one product and one collective), and then the family's step runs
on the shard: on the card one launch of its template's one-step build
(``dl_kernels.dl_step``, ``mf_kernels.mf_step``,
``langevin_kernels.langevin_step`` / ``pumped_langevin_step``), on the CPU
that build's plain version, the dynamics' ``make_step`` /
``make_adam_step`` with the matvec given.  The step writes the next step's
matvec input.  The final state is all-gathered over both axes, so every rank
returns the global arrays, as the JAX entry points return global arrays.

Noise is drawn at the global (step, row, column) through the port's Philox
counter, so a draw never depends on the cut: a solve on any mesh draws the
very words of a single-card solve (the JAX package folds its key with the
mesh coordinates and matches a single device only in distribution).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.dynamics.dl import DLParams
from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels
from ccvm_tpu_torch.parallel.mesh import all_gather, axis_size
from ccvm_tpu_torch.runtime import fp32_matmul


def _check_divisibility(mesh, batch_size, n):
    if tuple(mesh.mesh_dim_names) != ("batch", "model"):
        raise ValueError('a tensor-parallel solve takes a ("batch", "model") mesh '
                         f"(make_mesh), got axes {tuple(mesh.mesh_dim_names)}")
    dp = axis_size(mesh, "batch")
    tp = axis_size(mesh, "model")
    if batch_size % dp != 0:
        raise ValueError(
            f"batch_size {batch_size} must divide over the batch axis ({dp})"
        )
    if n % tp != 0:
        raise ValueError(
            f"problem size {n} must divide over the model axis ({tp})"
        )
    return batch_size // dp, n // tp


def _require_scalar_s(params):
    if np.ndim(params.S) != 0:
        raise ValueError(
            "tensor-parallel solves require a scalar S (a per-variable S "
            "would need feature sharding of the clamp bounds; use the DP/lax "
            "path instead)"
        )


class _Family(NamedTuple):
    """How the engine runs one family: its step wrapper, the arrays of its
    state (plain, Adam) and of its matvec input, its first state and its
    readout."""

    step: object
    arrays: tuple
    x_arrays: int
    init: object
    read: object


def _zeros(k, b, nl, device):
    return torch.zeros((k, b, nl), dtype=torch.float32, device=device)


def _mf_init(k, b, nl, device):
    state = _zeros(k, b, nl, device)
    state[1] = 0.5  # sigma
    return state


def _clamp_s(x, params):
    S = float(params.S)
    return torch.clamp(x, -S, S)


_FAMILIES = {
    "langevin": _Family(langevin_kernels.langevin_step, (1, 3), 1, _zeros,
                        lambda st, p: st[0]),
    "pumped": _Family(langevin_kernels.pumped_langevin_step, (1, 3), 1, _zeros,
                      lambda st, p: st[0]),
    "dl": _Family(dl_kernels.dl_step, (2, 6), 2, _zeros,
                  lambda st, p: (_clamp_s(st[0], p), st[1])),
    "mf": _Family(mf_kernels.mf_step, (3, 5), 1, _mf_init,
                  lambda st, p: (st[0], _clamp_s(st[2], p), st[1])),
}


def _step_table(family, params, hp, noise_scale, iterations, flags, device):
    """The one-step builds' per-step scalars: the family's whole-solve
    table, built once a solve."""
    flag = flags.get("pump_rate_flag", False)
    if family == "dl":
        return dl_kernels._step_table(params, hp, noise_scale, iterations, flag, device)
    module = mf_kernels if family == "mf" else langevin_kernels
    return module._step_table(params, hp, iterations, flag, device)


def _local_solve(family, mesh, seed, q, v, params, *, iterations, batch_size, hp,
                 noise_scale, rng, **flags):
    """This rank's (arrays, batch/dp, n/tp) final state of a family's solve
    on ``mesh``, and the mesh's model group."""
    _require_scalar_s(params)
    n = q.shape[-1]
    b_local, n_local = _check_divisibility(mesh, batch_size, n)
    row_base = mesh.get_local_rank("batch") * b_local
    col_base = mesh.get_local_rank("model") * n_local
    model = mesh.get_group("model")
    q_rows = q[col_base:col_base + n_local].to(torch.float32).contiguous()
    v_local = v[col_base:col_base + n_local].to(torch.float32).contiguous()
    spec = _FAMILIES[family]
    state = spec.init(spec.arrays[hp is not None], b_local, n_local, q.device)
    x = torch.empty((spec.x_arrays, b_local, n_local), dtype=torch.float32,
                    device=q.device)
    steps = None
    if q.is_cuda:
        steps = _step_table(family, params, hp, noise_scale, iterations, flags, q.device)
    kwargs = dict(iterations=iterations, noise_scale=noise_scale, rng=rng, hp=hp,
                  row_base=row_base, col_base=col_base, steps=steps, **flags)
    matvec = common.tp_matvec(model)
    spec.step(seed, None, v_local, params, state, x, None, **kwargs)
    with fp32_matmul():
        for i in range(int(iterations)):
            mv = matvec(x.view(-1, n_local), q_rows).view(x.shape)
            spec.step(seed, mv, v_local, params, state, x, i, **kwargs)
    return state, model


def _gather(mesh, state):
    """The global (arrays, batch, n) state from every rank's shard."""
    return all_gather(all_gather(state, mesh.get_group("model"), -1),
                      mesh.get_group("batch"), -2)


def _run_family(family, mesh, seed, q, v, params, iterations, batch_size, hp,
                noise_scale, rng, **flags):
    state, _ = _local_solve(family, mesh, seed, q, v, params, iterations=iterations,
                            batch_size=batch_size, hp=hp, noise_scale=noise_scale,
                            rng=rng, **flags)
    return _FAMILIES[family].read(_gather(mesh, state), params)


# --------------------------------------------------------------------------
# Family entry points: the JAX ones' signatures and return values, with an
# int seed in place of the key (and the kernels' noise scale and Philox
# transform), so the façades can swap them in.
# --------------------------------------------------------------------------


def langevin_solve(mesh, seed, q, v, params, *, iterations, batch_size, hp=None,
                   noise_scale=1.0, rng="popcount32"):
    """Mesh-sharded Langevin solve; same contract as dynamics.langevin.solve."""
    return _run_family("langevin", mesh, seed, q, v, params, iterations, batch_size,
                       hp, noise_scale, rng)


def pumped_langevin_solve(mesh, seed, q, v, params, *, iterations, batch_size,
                          pump_rate_flag=True, hp=None, noise_scale=1.0,
                          rng="popcount32"):
    """Mesh-sharded pumped-Langevin solve (contract of dynamics.pumped.solve)."""
    return _run_family("pumped", mesh, seed, q, v, params, iterations, batch_size,
                       hp, noise_scale, rng, pump_rate_flag=pump_rate_flag)


def dl_solve(mesh, seed, q, v, params, *, iterations, batch_size,
             pump_rate_flag=True, pump_is_gt_one=False, hp=None, noise_scale=1.0,
             rng="popcount16"):
    """Mesh-sharded DL-CCVM solve -> (c, s), c clamped (dynamics.dl.solve)."""
    return _run_family("dl", mesh, seed, q, v, params, iterations, batch_size, hp,
                       noise_scale, rng, pump_rate_flag=pump_rate_flag,
                       pump_is_gt_one=pump_is_gt_one)


def mf_solve(mesh, seed, q, v, params, *, iterations, batch_size,
             pump_rate_flag=True, hp=None, noise_scale=1.0, rng="popcount32"):
    """Mesh-sharded MF-CCVM solve -> (mu, mu_tilde_clamped, sigma)."""
    return _run_family("mf", mesh, seed, q, v, params, iterations, batch_size, hp,
                       noise_scale, rng, pump_rate_flag=pump_rate_flag)


# --------------------------------------------------------------------------
# DL convenience wrapper: (c, s, objective values, best objective), as the
# JAX one returns them.
# --------------------------------------------------------------------------


def dl_sharded_solve(mesh, seed, q, v, params: DLParams, batch_size: int,
                     *, iterations: int, pump_rate_flag: bool = True,
                     noise_scale=1.0, rng="popcount16"):
    """Sharded DL solve + readout energy: (c, s, objval, best).  The energy
    is reduced over the mesh from each rank's shard: the local x's
    tensor-parallel matvec, its columns' share of x Q x / 2 + x V summed
    over "model", the rows gathered over "batch"."""
    pump_gt_one = bool(float(params.pump) > 1)
    state, model = _local_solve("dl", mesh, seed, q, v, params, iterations=iterations,
                                batch_size=batch_size, hp=None, noise_scale=noise_scale,
                                rng=rng, pump_rate_flag=pump_rate_flag,
                                pump_is_gt_one=pump_gt_one)
    n_local = state.shape[-1]
    col_base = mesh.get_local_rank("model") * n_local
    c = _clamp_s(state[0], params)
    span = params.upper_limit - params.lower_limit
    mid = params.upper_limit + params.lower_limit
    x = 0.5 * c / float(params.S) * span + 0.5 * mid
    q_rows = q[col_base:col_base + n_local].to(torch.float32)
    with fp32_matmul():
        qx = common.tp_matvec(model)(x, q_rows)
        objval = 0.5 * torch.sum(x * qx, dim=-1) + x @ v[col_base:col_base + n_local]
    dist.all_reduce(objval, group=model)
    objval = all_gather(objval, mesh.get_group("batch"), 0)
    c_full, s_full = _FAMILIES["dl"].read(_gather(mesh, state), params)
    return c_full, s_full, objval, -torch.min(objval)
