"""Instance sweeps: many same-size instances in one stacked launch.

The counterpart of ``ccvm_tpu/parallel/sweep.py``.  The reference solves
instance files in a serial Python loop (``examples/ccvm_boxqp_dl.py:28``);
the JAX package ``vmap``s the solve over a leading instance axis.  Here the
instances stack into an (I, n, n) Q and an (I, n) V, and one launch of the
solver's whole-solve kernel integrates every instance's batch (on "cpu" its
plain version): instance ``i`` draws the noise of a solve with ``seed + i``,
so it equals ``solver(instance_i, seed=seed + i)`` on the same device.
With a mesh, the instances shard over its "batch" axis where they divide
evenly (as the JAX sweep shards them; replicated otherwise): each rank runs
one stacked launch of its instances, instance i keeping seed + i by its
global index, and the results are all-gathered, so every rank returns every
instance's Solution.  The
post-processor's core then refines the (I, batch, n) sweep in one call, and
the float64 readout runs on the device and crosses to the host in one
(I, batch) copy
(:func:`ccvm_tpu_torch.problem_classes.boxqp.problem_instance.stacked_readout64`).

Each solver's readout asymmetries are kept by dispatching on its class, as
each façade's ``__call__`` does.
"""

from __future__ import annotations

import time

import torch

from ccvm_tpu_torch import profiling
from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels
from ccvm_tpu_torch.ops.lbfgs import lbfgs_box_batch
from ccvm_tpu_torch.parallel.mesh import all_gather, axis_group, axis_index, axis_size
from ccvm_tpu_torch.post_processor.adam import _adam_refine
from ccvm_tpu_torch.post_processor.asgd import _asgd_refine
from ccvm_tpu_torch.post_processor.grad_descent import _gd_refine
from ccvm_tpu_torch.problem_classes.boxqp.problem_instance import stacked_readout64
from ccvm_tpu_torch.runtime import synchronize as _synchronize
from ccvm_tpu_torch.solution import Solution
from ccvm_tpu_torch.solvers.base import check_mesh, per_variable_saturation, saturation_of
from ccvm_tpu_torch.solvers.langevin import algorithm_hyperparameters

POST_PROCESSORS = (None, "grad-descent", "adam", "asgd", "bfgs", "lbfgs")


def _stack_instances(solver, instances):
    """Validate and stack instances into (I, n, n) / (I, n) float32 tensors
    on their device."""
    if not instances:
        raise ValueError("No instances given to sweep_solve.")
    size = instances[0].problem_size
    for inst in instances:
        if inst.problem_size != size:
            raise ValueError(
                "All instances in a sweep must share one problem size; got "
                f"{inst.problem_size} and {size}."
            )
        if inst.device != solver.device:
            raise ValueError(
                f"The device type of the instance ({inst.device}) and the"
                f" solver ({solver.device}) must match."
            )
    qs = torch.stack([inst.q_matrix.to(torch.float32) for inst in instances])
    vs = torch.stack([inst.v_vector.to(torch.float32) for inst in instances])
    return qs, vs, size


def _get_params(solver, size):
    try:
        return dict(solver.parameter_key[size])
    except (TypeError, KeyError) as e:
        raise KeyError(
            f"The parameter key for problem size {size} is not defined."
        ) from e


def _refine(post_processor, c, qs, vs, lo, hi):
    """The post-processor's refinement core over the instance axis, with the
    JAX sweep's defaults (``ccvm_tpu/parallel/sweep.py:295-344``):
    grad-descent 10 steps at 0.1; Adam and ASGD one step; BFGS 50 L-BFGS
    iterations in [0, 1] with the 0.5 (c + 1) / 2 (x - 0.5) convention;
    L-BFGS one iteration.  Instance i's rows come out as the one-instance
    call would give them."""
    v = vs[:, None, :]

    def f32(x):
        return torch.tensor(float(x), dtype=torch.float32, device=c.device)

    if post_processor == "grad-descent":
        return _gd_refine(c, qs, v, f32(lo), f32(hi), f32(0.1), 10)
    if post_processor == "adam":
        return _adam_refine(c, qs, v, f32(lo), f32(hi), 1)
    if post_processor == "asgd":
        return _asgd_refine(c, qs, v, f32(lo), f32(hi), 1)
    if post_processor == "bfgs":
        x = lbfgs_box_batch(0.5 * (c + 1.0), qs, v, lower=0.0, upper=1.0, max_iter=50)
        return 2.0 * (x - 0.5)
    return lbfgs_box_batch(c, qs, v, lower=lo, upper=hi, first_step_scale=0.001,
                           max_iter=1)


def _instance_shard(mesh, num_instances):
    """(first instance, instances, "batch" group) of this rank's share of a
    sweep over ``mesh``: the instances shard over the "batch" axis where its
    size divides their number, as the JAX sweep's ``_shard_instance_axis``
    (``ccvm_tpu/parallel/sweep.py:69-86``) shards them; every rank runs all
    of them (no group) otherwise and without a mesh."""
    dp = 1 if mesh is None else axis_size(mesh, "batch")
    if dp == 1 or num_instances % dp != 0:
        return 0, num_instances, None
    per = num_instances // dp
    return axis_index(mesh, "batch") * per, per, axis_group(mesh, "batch")


@profiling.annotate("ccvm.call")
def sweep_solve(
    solver,
    instances,
    post_processor=None,
    algorithm_parameters=None,
    seed=0,
    scale=False,
    mesh=None,
    g=None,
    pump_rate_flag=True,
):
    """Solve every instance with one stacked launch of the solver's kernel.

    Args:
        solver: a CCVM solver façade with ``parameter_key`` set for the
            instances' problem size.  Its ``batch_size`` is used per instance.
        instances: list of same-size :class:`ProblemInstance` objects on the
            solver's device.
        post_processor: "grad-descent", "adam", "asgd", "bfgs", "lbfgs" or
            None, run over the whole sweep with the JAX sweep's defaults.
        algorithm_parameters: optional :class:`AdamParameters`: the
            Adam-in-the-loop kernels for the whole sweep.
        seed: instance ``i`` draws the noise of ``solver(instance_i,
            seed=seed + i)``.
        scale: when True, applies ``instance.scale_coefs(get_scaling_factor)``
            to every instance first (skip if the caller already scaled).
        mesh: a mesh (``ccvm_tpu_torch.parallel.make_mesh``) whose "batch"
            axis shards the instances where it divides their number.
        g: DL's (default 0.05) or MF's (default 0.01) ``g``; ignored for the
            Langevin family.
        pump_rate_flag: the pump schedule of DL, MF and pumped Langevin.

    Returns:
        list[Solution]: one per instance, same order, with ``solve_time``
        and ``pp_time`` the sweep's walls over ``len(instances) *
        batch_size``.
    """
    check_mesh(mesh)
    cls = solver.__class__.__name__
    if post_processor not in POST_PROCESSORS:
        raise ValueError(
            f"sweep_solve does not know post-processor {post_processor!r};"
            " expected one of grad-descent/adam/asgd/bfgs/lbfgs/None."
        )
    if cls not in ("DLSolver", "MFSolver", "LangevinSolver", "PumpedLangevinSolver"):
        raise ValueError(f"sweep_solve does not support solver class {cls}.")

    if scale:
        for inst in instances:
            inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))

    qs, vs, size = _stack_instances(solver, instances)
    all_instances = instances
    first, per, group = _instance_shard(mesh, len(instances))
    instances = instances[first:first + per]
    qs, vs = qs[first:first + per], vs[first:first + per]
    batch_size = solver.batch_size
    solver.solution_bounds = instances[0].solution_bounds
    lo, hi = solver.solution_bounds
    pk = _get_params(solver, size)
    iterations = pk["iterations"]
    hp = algorithm_hyperparameters(algorithm_parameters)
    seed = int(seed) + first
    kw = dict(iterations=iterations, batch_size=batch_size, rng=solver.kernel_rng, hp=hp)

    # A (batch, n) S is shared by every instance, as the JAX sweep's vmap
    # broadcasts it.
    sat = per_variable_saturation(solver.S if cls == "DLSolver" else pk["S"], size,
                                  batch_size, qs.device)

    t0 = time.time()
    extra_vars = {}
    needs_final_cv = False
    if cls == "DLSolver":
        params = solver._make_params(
            pk["pump"], sat, pk["dt"], pk["noise_ratio"], pk["feedback_scale"],
            0.05 if g is None else g, iterations,
        )
    elif cls == "MFSolver":
        params = solver._make_params(
            pk["pump"], sat, pk["dt"], pk["j"], pk["feedback_scale"],
            0.01 if g is None else g, iterations,
        )
    elif cls == "LangevinSolver":
        params = solver._make_params(sat, pk["dt"], pk["sigma"], pk["feedback_scale"])
    else:
        params = solver._make_params(
            pk["pump"], sat, pk["dt"], pk["sigma"], pk["feedback_scale"], iterations,
        )
    # S goes to the card before the launch: a copy from the host's memory
    # waits for the card's queue, so after the launch it would wait out the
    # whole solve ahead of the explicit wait below.
    S = saturation_of(params, qs.device)
    if cls == "DLSolver":
        raw, s = dl_kernels.dl_solve(seed, qs, vs, params, pump_rate_flag=pump_rate_flag,
                                     pump_is_gt_one=bool(pk["pump"] > 1), **kw)
        # The reference applies change_variables again after post-processing
        # (dl_solver.py:941-958), as the DL façade does.
        needs_final_cv = True
        extra_vars = {"s": s}
    elif cls == "MFSolver":
        mu, raw, sigma = mf_kernels.mf_solve(seed, qs, vs, params,
                                             pump_rate_flag=pump_rate_flag, **kw)
        extra_vars = {"mu": mu, "sigma": sigma}
    elif cls == "LangevinSolver":
        raw = langevin_kernels.langevin_solve(seed, qs, vs, params, **kw)
    else:
        raw = langevin_kernels.pumped_langevin_solve(
            seed, qs, vs, params, pump_rate_flag=pump_rate_flag, **kw)
    if cls in ("LangevinSolver", "PumpedLangevinSolver"):
        pp_input = common.langevin_change_variables(raw, S)
    else:
        pp_input = common.change_variables_boxqp(raw, lo, hi, S)
    # The solve clock stops once the change of variables is done, under
    # either timing, as the JAX sweep's does (ccvm_tpu/parallel/sweep.py:368-369),
    # so that pp_wall is the refinement's own.
    _synchronize(pp_input)
    solve_wall = time.time() - t0

    pp_wall = 0.0
    if post_processor is not None:
        with profiling.annotate("ccvm.postprocess"):
            t1 = time.time()
            problem_variables = _refine(post_processor, pp_input, qs, vs, lo, hi)
            _synchronize(problem_variables)
            pp_wall = time.time() - t1
    elif needs_final_cv:
        # DL without post-processing: problem_variables are the raw amplitudes
        # (dl_solver.py:936-958).
        problem_variables = raw
    else:
        problem_variables = pp_input

    confs = (common.change_variables_boxqp(problem_variables, lo, hi, S)
             if needs_final_cv else problem_variables)
    if group is not None:
        problem_variables, confs = (all_gather(x, group, 0)
                                    for x in (problem_variables, confs))
        extra_vars = {k: all_gather(x, group, 0) for k, x in extra_vars.items()}
        instances = all_instances
    objvals = stacked_readout64(instances, confs)

    # Wall time attributed evenly across the sweep, then batch-normalised
    # (reference solve-time semantics, dl_solver.py:933), over every
    # instance of the sweep (with a mesh the ranks solve theirs side by side).
    solve_time = solve_wall / (len(all_instances) * batch_size)
    pp_time = pp_wall / (len(all_instances) * batch_size)
    solutions = []
    for i, inst in enumerate(instances):
        variables = {"problem_variables": problem_variables[i]}
        variables.update({k: v[i] for k, v in extra_vars.items()})
        solutions.append(
            Solution(
                problem_size=size,
                batch_size=batch_size,
                instance_name=inst.name,
                iterations=iterations,
                objective_values=objvals[i],
                solve_time=solve_time,
                pp_time=pp_time,
                optimal_value=inst.optimal_sol,
                best_value=inst.best_sol,
                num_frac_values=inst.num_frac_values,
                solution_vector=inst.solution_vector,
                variables=variables,
                device=solver.device,
            )
        )
    return solutions
