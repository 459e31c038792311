"""Tune per-solver per-size parameters on the benchmark set, on the card.

The twin of ``tools/tune_benchmark_set.py``: each façade's ``tune``
(:func:`ccvm_tpu_torch.tuning.tune_solver`, each candidate scored by one
stacked launch) over the same small per-size grids centred on the paper
defaults, scoring by P(0.1% gap) on the first few instances of each size,
with the same defaults, post-processors, seed and timing.  The winners are
merged per size into ``out_path`` for ``examples/torch_port/
benchmarking_study.py --params``.  Unlike the JAX tool it never writes
``examples/tuned_parameters.json``: its default output is
``build/tuned_parameters_torch.json``.

It runs on the card ("cuda", and raises without one); ``--device cpu`` runs
the kernels' plain PyTorch versions instead.

Usage:
    python -m ccvm_tpu_torch.tools.tune_benchmark_set [--sizes 20,70]
        [--solvers dl,langevin] [--per-size 3] [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ccvm_tpu_torch import (DLSolver, LangevinSolver, MFSolver, ProblemInstance,
                            PumpedLangevinSolver)
from ccvm_tpu_torch.runtime import default_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
INSTANCE_DIR = os.path.join(REPO, "examples", "benchmarking_instances")
OUT_PATH = os.path.join(REPO, "build", "tuned_parameters_torch.json")

DEFAULTS = {
    "dl": {"pump": 8.0, "feedback_scale": 100, "dt": 0.001, "noise_ratio": 10},
    "mf": {"pump": 0.0, "feedback_scale": 4000, "j": 5.0, "S": 20.0,
           "dt": 0.0025},
    "langevin": {"dt": 0.002, "S": 0.5, "sigma": 0.5, "feedback_scale": 1.0},
    "pumped": {"pump": 2.0, "dt": 0.002, "S": 0.5, "sigma": 0.5,
               "feedback_scale": 1.0},
}

# Small grids centred on the paper defaults (docs parameter table); kept
# deliberately coarse — the tuner scores every (candidate, size, instance)
# with a full solve.
GRIDS = {
    "dl": {"pump": [4.0, 8.0, 12.0], "feedback_scale": [60.0, 100.0, 150.0],
           "noise_ratio": [5.0, 10.0, 15.0]},
    "mf": {"j": [1.0, 5.0, 20.0],
           "feedback_scale": [2000.0, 4000.0, 8000.0]},
    "langevin": {"sigma": [0.25, 0.5, 1.0],
                 "feedback_scale": [0.5, 1.0, 2.0]},
    "pumped": {"pump": [1.0, 2.0, 4.0], "sigma": [0.25, 0.5, 1.0]},
}

CLASSES = {
    "dl": DLSolver,
    "mf": MFSolver,
    "langevin": LangevinSolver,
    "pumped": PumpedLangevinSolver,
}

POST = {"dl": None, "mf": "grad-descent", "langevin": "grad-descent",
        "pumped": "grad-descent"}


def main(instance_dir=INSTANCE_DIR, out_path=OUT_PATH,
         sizes=(20, 30, 40, 50, 60, 70), per_size=3, iterations=15000,
         tuning_batch_size=256, device=None, solvers=None):
    """Tune each solver and merge its winners per size into ``out_path``;
    returns the merged table."""
    device = device or default_device()
    files = []
    for size in sizes:
        files += sorted(
            glob.glob(os.path.join(instance_dir, f"Size{size}", "*.in"))
        )[:per_size]

    out = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            out = json.load(f)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    for name in solvers or CLASSES:
        solver = CLASSES[name](device=device, batch_size=tuning_batch_size,
                               timing="async")
        base = dict(DEFAULTS[name])
        base["iterations"] = iterations
        solver.parameter_key = {s: dict(base) for s in sizes}
        # The tuner scales each instance per solver; use fresh copies so the
        # scale_coefs stacking of a previous solver doesn't leak in.
        insts = [
            ProblemInstance(instance_type="tuning", file_path=f, device=device)
            for f in files
        ]
        for inst in insts:
            inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
        best = solver.tune(
            insts, post_processor=POST[name], parameter_ranges=GRIDS[name],
            tuning_batch_size=tuning_batch_size, seed=7,
        )
        # Merge per size so a partial (subset-of-sizes) tuning run refines
        # the existing table instead of replacing it.
        out.setdefault(name, {}).update({
            str(size): {
                k: v for k, v in params.items() if k != "iterations"
            }
            for size, params in best.items()
        })
        print(f"{name}: {json.dumps(out[name])}")
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
    print(f"wrote {out_path}")
    return out


def _csv(text, cast=str):
    return tuple(cast(x) for x in text.split(",") if x.strip())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="20,30,40,50,60,70")
    ap.add_argument("--solvers", default=",".join(CLASSES))
    ap.add_argument("--per-size", type=int, default=3)
    ap.add_argument("--out", default=OUT_PATH)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the card (the default; raises without one) or the "
                         "plain PyTorch versions on the CPU")
    args = ap.parse_args()
    main(out_path=args.out, sizes=_csv(args.sizes, int), per_size=args.per_size,
         device=args.device, solvers=_csv(args.solvers))
