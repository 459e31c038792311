"""Where a whole-solve kernel's time goes, on the card.

Times a kernel family at the main path's shape (the scaled Size70 instance,
batch 65536, the family's tuned N=70 parameters) as marginal µs per step,
``(t(i2) - t(i1)) / (i2 - i1)`` from CUDA events, best of ``--reps``, for
the production specialisations and for builds with the source's probe
defines, which the solvers never set:

* ``--family langevin`` (``csrc/langevin_solve.cu``): Langevin and pumped
  Langevin with noise, without noise (so without Philox and the draws), and
  without their matvec (``CCVM_MATVEC=0``; the sums stay 0, so the
  difference to the production row is the matvec's time), and their Adam
  variants with the tuned Adam parameters, with and without the matvec;
* ``--family mf`` (``csrc/mf_solve.cu``): MF and MF-Adam (beta2 0.999 and
  1.0) with noise, MF without noise, without its matvec, and with one x
  buffer and a second barrier a step (``CCVM_X_BUFFERS=1``) in place of the
  launch rule's two;
* ``--family dl`` (``csrc/dl_solve.cu``, the twin of
  ``tools/profile_kernel.py``): DL (the façade's popcount16) and DL-Adam
  (Adam's defaults) with noise, without noise, and without both matvecs
  (``CCVM_MATVEC=0``: the 3xTF32 mma chains and the midpoint's column sums
  taken out, so that the step is a step with Q = 0); then DL with each
  Wiener transform of ``ops.philox.RNG_NAMES``.

Run from the root of a checkout on a machine with the card::

    python -m ccvm_tpu_torch.tools.breakdown --family langevin
    python -m ccvm_tpu_torch.tools.breakdown --family dl
    python -m ccvm_tpu_torch.tools.mf_breakdown   # the same as --family mf

Each row prints ptxas's registers and spills of the solve kernel.  The
libraries are built by ``ops/build.py`` (all ``nvcc``s started together)
into ``build/kernels``; ``--rounds`` times every row that many times, the
row order reversed every other round, and prints the median.

``--family langevin --n N`` times the four production Langevin-family
kernels, and Langevin and pumped without noise, at another bundled size
(the scaled ``SizeN`` instance, the tuned size-N parameters, the tuned Adam
parameters where the file has them, else Adam's defaults) through the
public wrappers ``langevin_kernels.langevin_solve`` and
``pumped_langevin_solve`` only, so that ``--against DIR`` can time another
checkout's kernels the same way: each round runs one child process per
checkout (this one's first in even rounds, DIR's first in odd ones), with
that checkout's package first on the path::

    git archive <commit> | tar -x -C build/before
    python -m ccvm_tpu_torch.tools.breakdown --n 20 --against build/before --rounds 3
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import torch

from ccvm_tpu_torch import (AdamParameters, DLSolver, LangevinSolver, ProblemInstance,
                            PumpedLangevinSolver)
from ccvm_tpu_torch.ops import build, dl_kernels, langevin_kernels, mf_kernels, philox
from ccvm_tpu_torch.tools import tc_model


def probe_spec_type(base, **probes):
    """A spec type with the fields of ``base`` (a spec type of
    ``ops/build.py``) and the source's probe defines ``probes`` (name:
    default), built into libraries of their own."""
    spec = collections.namedtuple(f"Probe{base.__name__}", base._fields + tuple(probes),
                                  defaults=tuple(probes.values()))
    spec.source, spec.symbol, spec.argtypes = base.source, base.symbol, base.argtypes
    spec.defines = base.defines
    spec.tag = lambda self: "probe" + base.tag(self)
    return spec


# MF: CCVM_MATVEC 0 takes the matvec out; CCVM_X_BUFFERS 1 or 2 overrides
# the launch rule's number of x buffers (0 keeps it).
MFProbeSpec = probe_spec_type(build.MFSpec, matvec=True, x_buffers=0)
# The Langevin family: CCVM_MATVEC 0 takes the matvec out.
LangevinProbeSpec = probe_spec_type(build.LangevinSpec, matvec=True)
# DL: CCVM_MATVEC 0 takes both matvecs out.
DLProbeSpec = probe_spec_type(build.DLSpec, matvec=True)
DL_G = 0.05  # DLSolver's default g, as the main path runs it


def dl_problem(device, n=70, g=DL_G):
    """The scaled Size70 instance of the DL main path on ``device``, and a
    function of T giving the tuned N=70 DL parameters (S 1)."""
    root = tc_model._repo()
    path = os.path.join(root, "examples", "benchmarking_instances", f"Size{n}",
                        f"tuningH0{n}-100-0.in")
    inst = ProblemInstance(device=device, instance_type="tuning", file_path=path)
    solver = DLSolver(device=device)
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    solver.solution_bounds = inst.solution_bounds
    with open(os.path.join(root, "examples", "tuned_parameters.json")) as f:
        t = json.load(f)["dl"][str(n)]

    def params(iterations):
        return solver._make_params(t["pump"], 1.0, t["dt"], t["noise_ratio"],
                                   t["feedback_scale"], g, iterations)

    return inst.q_matrix, inst.v_vector, params


def launch_dl(fn, q, v, params, hp, noise_scale, c, s, seed=100):
    """One launch of a DL build's ``fn`` (csrc/dl_solve.cu ``ccvm_dl_solve``)
    on one instance (``q`` (1, n, n), ``v`` (1, n)) into ``c`` and ``s``
    (1, batch, n), over ``params.iterations`` steps with the rate-scaled
    pump; returns the launch's cudaError_t."""
    n, batch, iterations = q.shape[-1], c.shape[1], int(params.iterations)
    steps = dl_kernels._step_table(params, hp, noise_scale, iterations, True, "cuda")
    return fn(q.data_ptr(), v.data_ptr(), steps.data_ptr(), c.data_ptr(), s.data_ptr(),
              1, batch, n, iterations, seed,
              dl_kernels._scalars(params, hp, noise_scale, float(params.pump) > 1),
              build.dl_launch_shape(n, hp is not None).rows,
              torch.cuda.current_stream().cuda_stream, None, None, 0)


def _dl_timer(fn, problem, hp, noise_scale, batch):
    """ms of one DL launch of ``fn`` over ``iterations`` steps (CUDA events;
    the rate-scaled pump, T = the steps run)."""
    q, v, params = problem
    c = torch.empty((1, batch, q.shape[-1]), device="cuda")
    s = torch.empty_like(c)

    def run(iterations):
        p = params(iterations)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        err = launch_dl(fn, q, v, p, hp, noise_scale, c, s)
        end.record()
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return start.elapsed_time(end)

    return run


def _mf_timer(fn, problem, hp, noise_scale, batch):
    """ms of one MF launch of ``fn`` over ``iterations`` steps (CUDA events)."""
    q, v, params = problem
    rows = mf_kernels.launch_shape(q.shape[-1], hp is not None)[0]
    n = q.shape[-1]
    mu = torch.empty((1, batch, n), device="cuda")
    mt, sigma = torch.zeros_like(mu), torch.empty_like(mu)

    def run(iterations):
        p = params(iterations)
        steps = mf_kernels._step_table(p, hp, iterations, True, "cuda")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        err = fn(q.data_ptr(), v.data_ptr(), steps.data_ptr(), mu.data_ptr(),
                 mt.data_ptr(), sigma.data_ptr(), 1, batch, n, iterations, 100,
                 mf_kernels._scalars(p, hp, noise_scale), rows,
                 torch.cuda.current_stream().cuda_stream, None, None, 0)
        end.record()
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return start.elapsed_time(end)

    return run


def _langevin_timer(fn, problem, hp, noise_scale, batch):
    """ms of one Langevin-family launch of ``fn`` (pumped: rate-scaled pump,
    T = the steps run) over ``iterations`` steps (CUDA events)."""
    q, v, params = problem

    def run(iterations):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        p = params(iterations)
        start.record()
        _, _, err = langevin_kernels._run(fn, 100, q, v, p, iterations=iterations,
                                       batch_size=batch, noise_scale=noise_scale,
                                       hp=hp, pump_rate_flag=True)
        end.record()
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return start.elapsed_time(end)

    return run


def mf_rows():
    """(label, problem, Adam hyperparameters, noise scale, spec, timer) of
    each MF row."""
    q, v, params = tc_model.mf_problem("cuda")
    problem = (q[None].contiguous(), v[None].contiguous(), params)
    adam = {b2: AdamParameters(beta2=b2).to_hyperparameters() for b2 in (0.999, 1.0)}

    def row(label, hp=None, noise_scale=1.0, **probe):
        spec = MFProbeSpec(*mf_kernels._spec(70, hp, noise_scale, "popcount32"), **probe)
        return label, problem, hp, noise_scale, spec, _mf_timer

    return [row("MF"), row("MF, noise off", noise_scale=0.0),
            row("MF, no matvec", matvec=False), row("MF, one x buffer", x_buffers=1),
            row("MF-Adam beta2 0.999", adam[0.999]), row("MF-Adam beta2 1", adam[1.0])]


def langevin_rows():
    """(label, problem, Adam hyperparameters, noise scale, spec, timer) of
    each Langevin-family row."""
    out = []
    for family, name in (("langevin", "Langevin"), ("pumped", "pumped")):
        q, v, params, tuned = tc_model.langevin_problem("cuda", family)
        problem = (q[None].contiguous(), v[None].contiguous(), params)

        def row(label, hp=None, noise_scale=1.0, **probe):
            spec = LangevinProbeSpec(*langevin_kernels._spec(
                70, hp, noise_scale, "popcount32", pumped=family == "pumped"), **probe)
            return label, problem, hp, noise_scale, spec, _langevin_timer

        out += [row(name), row(f"{name}, noise off", noise_scale=0.0),
                row(f"{name}, no matvec", matvec=False),
                row(f"{name}-Adam (tuned)", tuned),
                row(f"{name}-Adam (tuned), no matvec", tuned, matvec=False)]
    return out


def dl_rows(device="cuda"):
    """(label, problem, Adam hyperparameters, noise scale, spec, timer) of
    each DL row (the problem on ``device``)."""
    q, v, params = dl_problem(device)
    problem = (q[None].contiguous(), v[None].contiguous(), params)
    adam = AdamParameters().to_hyperparameters()

    def row(label, hp=None, noise_scale=1.0, rng="popcount16", **probe):
        spec = DLProbeSpec(*dl_kernels._spec(70, hp, noise_scale, rng, True), **probe)
        return label, problem, hp, noise_scale, spec, _dl_timer

    return ([row("DL"), row("DL, noise off", noise_scale=0.0),
             row("DL, no matvec", matvec=False), row("DL-Adam", adam),
             row("DL-Adam, noise off", adam, 0.0), row("DL-Adam, no matvec", adam,
                                                      matvec=False)]
            + [row(f"DL, kernel_rng {r}", rng=r) for r in philox.RNG_NAMES])


ROWS = {"langevin": langevin_rows, "mf": mf_rows, "dl": dl_rows}


def run_rows(family, rows, *, batch, i1, i2, reps, rounds, reports, out=print):
    """Time each row (:func:`dl_rows`, ...) as marginal us per step, best of
    ``reps``, the median of ``rounds`` (the row order reversed every other
    round), and print it with ptxas's registers and spills from
    ``reports`` ({spec: build log}); returns {label: [us per round]}."""
    out(f"{family} kernel breakdown on {_card()}, batch {batch}, N=70, marginal "
        f"us/step over {i1} and {i2} steps, best of {reps}, {rounds} round(s):")
    timers = {label: timer(build.load(spec), problem, hp, noise_scale, batch)
              for label, problem, hp, noise_scale, spec, timer in rows}
    us = {label: [] for label in timers}
    for r in range(rounds):
        for label in (list(timers) if r % 2 == 0 else list(timers)[::-1]):
            run = timers[label]
            run(i1)  # warm-up
            t = {it: min(run(it) for _ in range(reps)) for it in (i1, i2)}
            us[label].append((t[i2] - t[i1]) / (i2 - i1) * 1e3)
    for label, *_, spec, _ in rows:
        med = sorted(us[label])[len(us[label]) // 2]
        report = build.kernel_report(reports[spec]) if spec in reports else \
            "built before this run"
        out(f"  {label}: {med:.3f} us/step median ({med * 15:.1f} ms at 15,000 "
            f"steps), rounds {', '.join(f'{x:.3f}' for x in us[label])}; {report}")
    return us


def wrapper_us_per_step(n, batch, i1, i2, reps, device="cuda"):
    """{row: marginal µs/step} of the Langevin-family kernels at size ``n``
    on the card, each launched through its public wrapper (the scaled
    ``Size{n}`` instance, the tuned parameters; CUDA events around the
    wrapper call, best of ``reps``, after a warm-up; on ``device`` "cpu" the
    plain versions, by the host's clock); it needs nothing of
    the package but the façades and the wrappers, so that another
    checkout's package can run it."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with open(os.path.join(root, "examples", "tuned_parameters.json")) as f:
        tuned = json.load(f)
    path = os.path.join(root, "examples", "benchmarking_instances", f"Size{n}",
                        f"tuningH0{n:02d}-100-0.in")
    rows = {}
    for family, cls in (("langevin", LangevinSolver), ("pumped", PumpedLangevinSolver)):
        inst = ProblemInstance(device=device, instance_type="tuning", file_path=path)
        solver = cls(device=device)
        inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
        solver.solution_bounds = inst.solution_bounds
        t = tuned[family][str(n)]
        adam = tuned["adam"][family].get(str(n), {})
        hp = AdamParameters(**adam).to_hyperparameters()
        name = "Langevin" if family == "langevin" else "pumped"
        for label, h, noise in ((name, None, 1.0), (f"{name}, noise off", None, 0.0),
                                (f"{name}-Adam", hp, 1.0)):
            rows[label] = (family, solver, t, h, noise, inst)

    def run(family, solver, t, h, noise, inst, iterations):
        if family == "langevin":
            p, solve, extra = (solver._make_params(t["S"], t["dt"], t["sigma"],
                                                   t["feedback_scale"]),
                               langevin_kernels.langevin_solve, {})
        else:
            p, solve, extra = (solver._make_params(t["pump"], t["S"], t["dt"], t["sigma"],
                                                   t["feedback_scale"], iterations),
                               langevin_kernels.pumped_langevin_solve,
                               {"pump_rate_flag": True})
        if device == "cpu":
            t = time.perf_counter()
            solve(100, inst.q_matrix, inst.v_vector, p, iterations=iterations,
                  batch_size=batch, noise_scale=noise, rng="popcount32", hp=h, **extra)
            return (time.perf_counter() - t) * 1e3
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        solve(100, inst.q_matrix, inst.v_vector, p, iterations=iterations,
              batch_size=batch, noise_scale=noise, rng="popcount32", hp=h, **extra)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    out = {}
    for label, row in rows.items():
        run(*row, i1)  # warm-up, and the build
        t = {it: min(run(*row, it) for _ in range(reps)) for it in (i1, i2)}
        out[label] = (t[i2] - t[i1]) / (i2 - i1) * 1e3
    return out


def compare_trees(args):
    """``--n``: this checkout's and ``--against``'s Langevin-family kernels
    at size ``--n`` (:func:`wrapper_us_per_step`), one child process each
    per round, the order swapped every other round; prints each row's
    median and rounds."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    trees = {"this checkout": here}
    if args.against:
        trees[args.against] = os.path.abspath(args.against)
    us = {}
    for r in range(args.rounds):
        for label, root in (list(trees.items()) if r % 2 == 0
                            else list(trees.items())[::-1]):
            env = dict(os.environ, PYTHONPATH=root)
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", "--n", str(args.n),
                 "--batch", str(args.batch), "--i1", str(args.i1), "--i2", str(args.i2),
                 "--reps", str(args.reps)],
                cwd=root, env=env, capture_output=True, text=True)
            if out.returncode != 0:
                raise SystemExit(f"breakdown: the child for {label} failed:\n{out.stderr}")
            for row, x in json.loads(out.stdout.strip().splitlines()[-1]).items():
                us.setdefault(row, {}).setdefault(label, []).append(x)
    print(f"Langevin-family kernels at N={args.n} on {_card()}, batch {args.batch}, "
          f"marginal us/step over {args.i1} and {args.i2} steps through the public "
          f"wrappers, best of {args.reps}, {args.rounds} round(s):", flush=True)
    for row, by_tree in us.items():
        cells = []
        for label, xs in by_tree.items():
            med = sorted(xs)[len(xs) // 2]
            cells.append(f"{label} {med:.3f} (rounds {', '.join(f'{x:.3f}' for x in xs)})")
        print(f"  {row}: " + "; ".join(cells), flush=True)


def _card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    return smi or torch.cuda.get_device_name(0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=tuple(ROWS), default="langevin")
    ap.add_argument("--n", type=int, default=70,
                    help="Langevin: the bundled size; other than 70 (or with "
                         "--against) only the production kernels, through the wrappers")
    ap.add_argument("--against", default=None,
                    help="Langevin: another checkout whose kernels to time beside this one's")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--i1", type=int, default=1000)
    ap.add_argument("--i2", type=int, default=4000)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=1,
                    help="time every row this many times, the row order reversed "
                         "every other round")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("breakdown: no CUDA card")
    if args.child:
        print(json.dumps(wrapper_us_per_step(args.n, args.batch, args.i1, args.i2,
                                             args.reps)), flush=True)
        return
    if args.family == "langevin" and (args.n != 70 or args.against):
        return compare_trees(args)
    rows = ROWS[args.family]()
    reports = build.build([r[4] for r in rows])
    run_rows(args.family, rows, batch=args.batch, i1=args.i1, i2=args.i2, reps=args.reps,
             rounds=args.rounds, reports=reports,
             out=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
