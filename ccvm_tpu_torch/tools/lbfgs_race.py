"""Race the batched L-BFGS's backtracking with and without host syncs.

``ccvm_tpu_torch/ops/lbfgs.py`` stops its Armijo backtracking once no row is
left, asking the card after each trial whether any row is (one host sync a
trial).  The alternative runs all ``max_backtracks`` trials for every row
under masks: no sync, a matvec a trial.  Both give the same result bit for
bit; this times them on the BFGS and L-BFGS post-processors' work at the
main shape, on the starting points that a DL solve of the N=70 instance
hands them:

    python -m ccvm_tpu_torch.tools.lbfgs_race [--device cuda] [--rounds 3]

It prints, per round (the row order reversed every other round), each
variant's wall in ms (host clock around work that ends in a synchronise) and
the trials the early-stopping variant ran, and it fails if the two differ.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from unittest import mock

import torch

from ccvm_tpu_torch.ops import lbfgs

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
INSTANCE = os.path.join(REPO, "examples", "benchmarking_instances", "Size70",
                        "tuningH070-100-0.in")
TUNED = os.path.join(REPO, "examples", "tuned_parameters.json")


class Masked:
    """``lbfgs._step_length`` that runs every trial for every row under
    masks, with no host sync."""

    def __call__(self, x, f, g, d, t0, q_matrix, v_vector, lower, upper,
                 max_backtracks):
        t = t0
        active = torch.ones_like(f, dtype=torch.bool)
        for _ in range(max_backtracks):
            x_try = torch.clamp(x + t[:, None] * d, lower, upper)
            f_try, _ = lbfgs._value_and_grad(x_try, q_matrix, v_vector)
            ok = f_try <= f + 1e-4 * lbfgs._dot(g, x_try - x)
            active = active & ~ok
            t = torch.where(active, t * 0.5, t)
        return t


class Counted:
    """The production ``lbfgs._step_length``, counting the trials it runs
    (a trial is one evaluation of ``_value_and_grad``)."""

    def __init__(self):
        self.trials = 0

    def __call__(self, *args):
        value_and_grad = lbfgs._value_and_grad

        def counted(*a):
            self.trials += 1
            return value_and_grad(*a)

        with mock.patch.object(lbfgs, "_value_and_grad", counted):
            return self.step_length(*args)

    step_length = staticmethod(lbfgs._step_length)


def starting_points(device, batch, seed=1):
    """What the DL façade hands a post-processor on the N=70 instance:
    its solve's output after the change of variables, and Q and V."""
    from ccvm_tpu_torch import DLSolver, ProblemInstance

    with open(TUNED) as f:
        tuned = json.load(f)["dl"]["70"]
    solver = DLSolver(device=device, batch_size=batch)
    solver.parameter_key = {70: dict(tuned, iterations=15000)}
    inst = ProblemInstance(device=device, instance_type="tuning", file_path=INSTANCE)
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    sol = solver(inst, seed=seed)
    lo, hi = inst.solution_bounds
    c = solver.change_variables(sol.variables["problem_variables"], lo, hi, solver.S)
    return c, inst.q_matrix, inst.v_vector


def workloads(c, q, v):
    """The two post-processors' calls of ``lbfgs_box_batch`` by name."""
    return {
        "bfgs (50 iterations)": lambda: lbfgs.lbfgs_box_batch(
            0.5 * (c + 1.0), q, v, lower=0.0, upper=1.0, max_iter=50),
        "lbfgs (1 iteration)": lambda: lbfgs.lbfgs_box_batch(
            c, q, v, first_step_scale=0.001, max_iter=1),
    }


def _wall_ms(fn, device):
    if device == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def race(device="cuda", batch=65536, rounds=3):
    """Rows of (workload, variant, walls in ms by round, trials a run of
    the early stop); raises if the variants' results differ."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    c, q, v = starting_points(device, batch)
    rows = []
    for label, fn in workloads(c, q, v).items():
        counted = Counted()
        variants = {"early stop, a sync a trial (production)": counted,
                    "masked, no sync": Masked()}

        def run(step_length, fn=fn):
            with mock.patch.object(lbfgs, "_step_length", step_length):
                return fn()

        stopped, masked = (run(step) for step in variants.values())  # warm-up
        if not torch.equal(stopped, masked):
            raise AssertionError(f"{label}: the two backtrackings differ")
        counted.trials = 0
        walls = {name: [] for name in variants}
        for r in range(rounds):
            order = list(variants) if r % 2 == 0 else list(variants)[::-1]
            for name in order:
                walls[name].append(_wall_ms(lambda: run(variants[name]), device)[1])
        for name, step_length in variants.items():
            rows.append({"workload": label, "variant": name, "ms": walls[name],
                         "trials": getattr(step_length, "trials", 0) // rounds or None})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    for row in race(args.device, args.batch, args.rounds):
        trials = "" if row["trials"] is None else f", {row['trials']} trials a run"
        print(f"{row['workload']:<22} {row['variant']:<42} min "
              f"{min(row['ms']):9.2f} ms (rounds {[round(x, 2) for x in row['ms']]})"
              f"{trials}", flush=True)


if __name__ == "__main__":
    main()
