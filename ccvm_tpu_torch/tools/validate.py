"""Noise-on statistical validation of the port's kernels on the card: the
twin of ``tools/tpu_validate.py``.

Runs every solver, plain and with Adam, on the N=20 single-test instance
with that tool's parameters, twice through its façade: once as a user runs
it (the fused kernel on "cuda") and once with the façade's whole-solve call
sent to the family's plain PyTorch version on the same device
(:func:`plain_versions`), so that both sides are read out as the façade
reads out.  The two sides draw the same Philox words but part by round-off,
so agreement is distributional: with batch B the binomial std of a success
fraction p is sqrt(p(1-p)/B), and every gap's success probability must agree
within 5 combined sigmas plus 0.01 (``tools/tpu_validate.py:82-88``).

Run from the root of a checkout on a machine with the card::

    python -m ccvm_tpu_torch.tools.validate [--batch 4096] [--iterations 15000] [--seed 7] [--rng NAME]

``--rng`` names the kernels' Wiener transform (one of
``ops.philox.RNG_NAMES``); ``--device cpu`` runs both sides through the plain
versions on the host (at a small size: the full one takes hours there), a
self-check of the tool that checks no kernel and says so.
Without a card the default device raises.  It prints one line per gap and
exits 1 on any failure.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

from ccvm_tpu_torch import (AdamParameters, DLSolver, LangevinSolver, MFSolver,
                            ProblemInstance, PumpedLangevinSolver)
from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels, philox
from ccvm_tpu_torch.runtime import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
INSTANCE = os.path.join(REPO, "examples", "benchmarking_instances",
                        "single_test_instance", "tuningH020-100-0.in")

# tools/tpu_validate.py:38-49.
PARAMS = {
    "dl": (DLSolver, {"pump": 8.0, "feedback_scale": 100, "dt": 0.001,
                      "noise_ratio": 10}),
    "mf": (MFSolver, {"pump": 0.0, "feedback_scale": 4000, "j": 5.0,
                      "S": 20.0, "dt": 0.0025}),
    "langevin": (LangevinSolver, {"dt": 0.002, "S": 0.5, "sigma": 0.5,
                                  "feedback_scale": 1.0}),
    "pumped": (PumpedLangevinSolver, {"pump": 2.0, "dt": 0.002, "S": 0.5,
                                      "sigma": 0.5, "feedback_scale": 1.0}),
}
# (label suffix, algorithm_parameters), tools/tpu_validate.py:71-76: the
# original dynamics and the Adam-in-loop kernels.
VARIANTS = (
    ("", None),
    ("+adam", AdamParameters(alpha=0.1, beta1=0.9, beta2=0.999, add_assign=True)),
)
CASES = tuple(name + suffix for name in PARAMS for suffix, _ in VARIANTS)
# The closing line of a run on the CPU, where both sides are plain.
SELF_CHECK = ("All solvers agree, but both sides ran the plain version on the CPU: "
              "a self-check of the tool, no kernel was checked.")

# The façades' whole-solve wrappers and their plain versions.
_PLAIN_VERSIONS = (
    (dl_kernels, "dl_solve", "dl_solve_reference"),
    (mf_kernels, "mf_solve", "mf_solve_reference"),
    (langevin_kernels, "langevin_solve", "langevin_solve_reference"),
    (langevin_kernels, "pumped_langevin_solve", "pumped_langevin_solve_reference"),
)


@contextlib.contextmanager
def plain_versions():
    """Inside, each façade's whole-solve call runs its family's plain
    version on the tensors' own device (no kernel is launched or counted)."""
    saved = [(module, name, getattr(module, name)) for module, name, _ in _PLAIN_VERSIONS]
    try:
        for module, name, plain in _PLAIN_VERSIONS:
            setattr(module, name, getattr(module, plain))
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def band(p_a, p_b, batch):
    """The tolerance of two success probabilities from ``batch`` trajectories
    each: 5 combined binomial sigmas + 0.01 (tools/tpu_validate.py:82-88)."""
    sig = np.sqrt(max(p_a * (1 - p_a), p_b * (1 - p_b), 1e-6) / batch) * np.sqrt(2)
    return 5 * sig + 0.01


def compare(perf_a, perf_b, batch, names=("kernel", "plain"), out=print):
    """Print one line per gap in tools/tpu_validate.py's layout (``names``
    in place of "pallas" and "lax"); returns the gaps out of band as
    ``(gap, p_a, p_b)``."""
    failures = []
    for gap in perf_a:
        p_a, p_b = perf_a[gap], perf_b[gap]
        tol = band(p_a, p_b, batch)
        ok = abs(p_a - p_b) <= tol
        out(f"  {'ok ' if ok else 'FAIL'} {gap:<13} {names[0]}={p_a:.4f} "
            f"{names[1]}={p_b:.4f} tol={tol:.4f}")
        if not ok:
            failures.append((gap, p_a, p_b))
    return failures


def case_performance(case, *, plain, device="cuda", batch=4096, iterations=15000,
                     seed=7, rng="popcount32"):
    """``solution_performance`` of one case (a name of :data:`CASES`)
    through its façade on ``device``, the kernel's, or with ``plain`` the
    plain version's; and the seconds the call took."""
    name, _, adam = case.partition("+")
    cls, base = PARAMS[name]
    algo = dict(VARIANTS)["+" + adam if adam else ""]
    solver = cls(device=device, batch_size=batch, kernel_rng=rng)
    solver.parameter_key = {20: dict(base, iterations=iterations)}
    inst = ProblemInstance(instance_type="test", file_path=INSTANCE, device=device)
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    t = time.perf_counter()
    with plain_versions() if plain else contextlib.nullcontext():
        sol = solver(inst, seed=seed, algorithm_parameters=algo)
    return sol.solution_performance, time.perf_counter() - t


def validate(*, device="cuda", batch=4096, iterations=15000, seed=7, rng="popcount32",
             plain=None, out=print):
    """Every case, kernel against plain version; ``plain`` maps a case to
    its plain side's ``(performance, seconds)`` when computed elsewhere (the
    card's smoke test runs them in worker processes), else they run here.
    Returns the failures as ``(case, gap, p_kernel, p_plain)``."""
    resolve_device(device)
    if rng not in philox.RNG_NAMES:
        raise ValueError(f"rng must be one of {philox.RNG_NAMES}, got {rng!r}")
    out(f"instance: {INSTANCE}  batch={batch} iterations={iterations}")
    kw = dict(device=device, batch=batch, iterations=iterations, seed=seed, rng=rng)
    failures = []
    for case in CASES:
        kernel, _ = case_performance(case, plain=False, **kw)
        reference = (plain or {}).get(case) or case_performance(case, plain=True, **kw)
        out(f"\n{case}:")
        failures += [(case, *f) for f in compare(kernel, reference[0], batch, out=out)]
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iterations", type=int, default=15000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rng", default="popcount32", choices=philox.RNG_NAMES,
                    help="the kernels' Wiener transform")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    failures = validate(device=args.device, batch=args.batch, iterations=args.iterations,
                        seed=args.seed, rng=args.rng)
    if failures:
        print("\nFAILURES:", failures)
        sys.exit(1)
    if args.device == "cpu":
        # The façade's own path on the host is the plain version: a
        # self-check of the tool, not of a kernel.
        print(f"\n{SELF_CHECK}")
    else:
        print("\nAll solvers: kernel and plain versions statistically agree.")


if __name__ == "__main__":
    main()
