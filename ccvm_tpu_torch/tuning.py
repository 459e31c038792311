"""Parameter tuning for CCVM solvers (the counterpart of ``ccvm_tpu/tuning.py``).

The reference's ``tune()`` is an unimplemented placeholder that crashes on a
read-only property (``dl_solver.py:327-329``).  Here tuning is a working grid
search: every candidate parameter set is evaluated on the given tuning
instances (reduced batch size for speed), scored by the fraction of
trajectories reaching the 0.1% optimality gap (ties broken by the 1%-gap
fraction, then best objective), and the winner per problem size becomes the
solver's ``parameter_key``.  Each candidate is scored with one stacked
:func:`ccvm_tpu_torch.parallel.sweep_solve` over the instances of a size: on
"cuda" one launch of the solver's kernel per candidate.
"""

from __future__ import annotations

import copy
import itertools
import logging

logger = logging.getLogger(__name__)


def _expand_grid(parameter_ranges: dict):
    """{'dt': [..], 'sigma': [..]} -> iterator of {'dt': x, 'sigma': y}."""
    keys = list(parameter_ranges.keys())
    for combo in itertools.product(*(parameter_ranges[k] for k in keys)):
        yield dict(zip(keys, combo))


def tune_solver(
    solver,
    instances,
    parameter_ranges=None,
    post_processor=None,
    tuning_batch_size=200,
    seed=0,
    use_sweep=True,
    algorithm_parameters=None,
    confirm_seeds=1,
    confirm_top_k=5,
    **_,
):
    """Grid-search ``parameter_ranges`` per problem size.

    Each candidate is scored with ONE stacked :func:`sweep_solve` over all
    tuning instances of the size, so a grid of C candidates costs C launches
    instead of C x len(instances).

    Args:
        solver: a CCVMSolver with ``parameter_key`` already set (used as the
            base values; tuned keys override).
        instances: list of ProblemInstance objects (mixed sizes allowed).
        parameter_ranges: dict mapping parameter name -> list of candidate
            values.  When None, each size's current parameters are kept and
            simply validated by one scoring run.
        tuning_batch_size: trajectories per scoring run.
        use_sweep: when False, score with one solver call per (candidate,
            instance), instance i with ``seed + i``: the same scores as the
            sweep's.  A sweep that raises ``ValueError`` is scored that way
            too.
        algorithm_parameters: optional :class:`AdamParameters`: tunes the
            Adam-in-the-loop dynamics variant instead of the original.
        confirm_seeds: when > 1, the single-seed grid pass is followed by a
            confirmation pass: the top ``confirm_top_k`` candidates are
            re-scored with ``confirm_seeds`` independent seeds (seed + 7919 k)
            and ranked by the mean score.

    Returns:
        dict: the winning parameter_key (size -> params).
    """
    if solver.parameter_key is None:
        raise ValueError("Set solver.parameter_key before tuning (base values).")

    base_key = copy.deepcopy(solver.parameter_key)
    candidates = (
        list(_expand_grid(parameter_ranges)) if parameter_ranges else [dict()]
    )

    by_size = {}
    for inst in instances:
        by_size.setdefault(inst.problem_size, []).append(inst)

    orig_batch = solver.batch_size
    solver.batch_size = tuning_batch_size
    best_key = copy.deepcopy(base_key)
    try:
        for size, insts in by_size.items():
            if size not in base_key:
                raise KeyError(
                    f"The parameter key has no entry for problem size {size}."
                )

            def _score(params, score_seed):
                solver._parameter_key = {**base_key, size: params}
                solutions = _score_candidate(
                    solver, insts, post_processor, score_seed, use_sweep,
                    algorithm_parameters,
                )
                opt_frac = one_frac = best_obj = 0.0
                for solution in solutions:
                    perf = solution.solution_performance
                    opt_frac += perf["optimal"]
                    one_frac += perf["one_percent"]
                    best_obj += solution.best_objective_value
                return (opt_frac, one_frac, best_obj)

            scored = []
            for cand in candidates:
                params = dict(base_key[size])
                params.update(cand)
                score = _score(params, seed)
                logger.info("tune size=%s cand=%s score=%s", size, cand, score)
                scored.append((score, params))
            scored.sort(key=lambda t: t[0], reverse=True)

            if confirm_seeds > 1 and len(scored) > 1:
                # Confirmation pass: mean score of the top-k over independent
                # seeds (the initial seed's score is included in the mean).
                finalists = scored[: max(1, confirm_top_k)]
                confirmed = []
                for score0, params in finalists:
                    totals = list(score0)
                    for extra in range(1, confirm_seeds):
                        s = _score(params, seed + 7919 * extra)
                        totals = [a + b for a, b in zip(totals, s)]
                    mean_score = tuple(t / confirm_seeds for t in totals)
                    logger.info(
                        "tune confirm size=%s params=%s mean=%s",
                        size, params, mean_score,
                    )
                    confirmed.append((mean_score, params))
                confirmed.sort(key=lambda t: t[0], reverse=True)
                best_key[size] = confirmed[0][1]
            else:
                best_key[size] = scored[0][1]
    finally:
        solver.batch_size = orig_batch
        solver._parameter_key = best_key
    return best_key


def _score_candidate(solver, insts, post_processor, seed, use_sweep,
                     algorithm_parameters=None):
    """All tuning solves for one candidate: stacked sweep or serial loop."""
    if use_sweep and len(insts) > 1:
        from ccvm_tpu_torch.parallel.sweep import sweep_solve

        try:
            return sweep_solve(
                solver, insts, post_processor=post_processor, seed=seed,
                algorithm_parameters=algorithm_parameters,
            )
        except ValueError as e:  # e.g. a post-processor the sweep lacks
            logger.info("tune: sweep path unavailable (%s); serial scoring", e)
    # Instance i is seeded seed + i, as in the sweep, so both paths give a
    # candidate the same score (the JAX package seeds every serial solve
    # with ``seed``, which agrees with its sweep only with the noise off).
    return [
        solver(inst, post_processor=post_processor, seed=seed + i,
               algorithm_parameters=algorithm_parameters)
        for i, inst in enumerate(insts)
    ]
