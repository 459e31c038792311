"""The DL race harness: the DL kernel's variants raced against production.

The port of the JAX package's scratch harness ``tools/kernel_experiments.py``
to the card.  Knobs: the Wiener transform (popcount1 / popcount2, and
production's popcount16), the fused c/s matvec, the step-loop unroll, v3's
change of variables folded into Q once, and production's matvec (3xTF32 on
the tensor cores against fp32 on the CUDA cores).  Each row is timed at two
iteration counts and reported as the marginal time per step,
``(w(i2) - w(i1)) / (i2 - i1)``, which cancels the launch and set-up; on the
card ``w`` is read from CUDA events around one call, the best of ``reps``.
:func:`race_rounds` repeats the race, the row order reversed every other
round, and reports each row's median over the rounds and its range.

    python -m ccvm_tpu_torch.tools.kernel_experiments --batch 1000 --iters 15000 --n 20

The problem is the harness's (numpy seed 0, a symmetrised normal Q, a normal
V) and its parameters (pump 8, S sqrt(7), dt 0.001, noise ratio 10, fs 100,
g 0.01, box [0, 1], T = ``--iters``).  The races run 400,000 and 2,000,000
steps, far past T, where the pump rate (i+1)/T keeps growing and the
variants, which clip nothing per step, may diverge; each row only says
whether its outputs stayed finite.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from ccvm_tpu_torch.dynamics.dl import DLParams
from ccvm_tpu_torch.ops import dl_kernels
from ccvm_tpu_torch.ops.dl_variant_kernels import (dl_v2, dl_v2_reference, dl_v3,
                                                   dl_v3_reference)
from ccvm_tpu_torch.runtime import resolve_device

I1, I2 = 400_000, 2_000_000

# (label, kernel, keyword arguments): the JAX harness's rows and labels,
# then the fused-matvec knob, the unroll knob's base (one step a loop
# iteration, as production runs), then the DL kernel with its fp32
# CUDA-core matvec (csrc/dl_solve.cu's MMA = 0, :func:`cuda_core_dl_solve`)
# and as it ships (3xTF32 on the tensor cores, ``dl_kernels.dl_solve``).
ROWS = (
    ("v2 popcount1 fuse0 unroll8 (prev best)", "v2",
     dict(rng_name="popcount1", fuse_matvec=False, unroll=8)),
    *((f"v3 {rng_name} unroll{unroll}", "v3", dict(rng_name=rng_name, unroll=unroll))
      for unroll in (8, 16) for rng_name in ("popcount1", "popcount2")),
    ("v2 popcount1 fuse1 unroll8", "v2",
     dict(rng_name="popcount1", fuse_matvec=True, unroll=8)),
    ("v2 popcount1 fuse1 unroll1", "v2",
     dict(rng_name="popcount1", fuse_matvec=True, unroll=1)),
    ("v3 popcount1 unroll1", "v3", dict(rng_name="popcount1", unroll=1)),
    ("dl_solve CUDA-core matvec popcount16 (clip)", "cuda-core", {}),
    ("production dl_solve popcount16 (clip)", "production", {}),
)
LABELS = tuple(label for label, _, _ in ROWS)
CUDA_CORE, PRODUCTION = LABELS[-2:]

# (knob, base row, changed row): each knob's effect is the changed row's
# median us/step less the base row's.
KNOBS = (
    ("fused c/s matvec (v2)", LABELS[0], LABELS[5]),
    ("prescaled Q (v3 against v2)", LABELS[0], LABELS[1]),
    ("popcount2 against popcount1, unroll 8", LABELS[1], LABELS[2]),
    ("popcount2 against popcount1, unroll 16", LABELS[3], LABELS[4]),
    ("unroll 16 against 8, popcount1", LABELS[1], LABELS[3]),
    ("unroll 16 against 8, popcount2", LABELS[2], LABELS[4]),
    ("unroll 8 against 1, v2 fused", LABELS[6], LABELS[5]),
    ("unroll 8 against 1, v3 popcount1", LABELS[7], LABELS[1]),
    ("production against v2 fused", LABELS[5], PRODUCTION),
    ("CUDA-core dl_solve against v2 fused", LABELS[5], CUDA_CORE),
    ("tensor-core matvec (3xTF32 against CUDA cores)", CUDA_CORE, PRODUCTION),
)


def knobs_against_production(label):
    """The knobs in which a v2 / v3 row of :data:`ROWS` differs from the
    production kernel, as text: both run the 3xTF32 tensor-core design of
    ``csrc/dl_solve.cu``, which draws popcount16, stacks a warp's c and s
    in one m16 tile, runs one step a loop iteration, centres x and clips
    every step."""
    kind, kw = next((k, w) for lb, k, w in ROWS if lb == label)
    knobs = [f"{kw['rng_name']} (production popcount16)"]
    if not kw.get("fuse_matvec", False):
        knobs.append("a c tile and an s tile, two passes over Q (production stacks them)")
    knobs.append(f"unroll {kw['unroll']} (production 1)")
    knobs.append("Q prescaled, c and s the mma's A" if kind == "v3" else "x as written")
    knobs.append("no per-step clip")
    return "; ".join(knobs)


def harness_problem(n: int):
    """The harness's random problem: float32 (Q, V), Q symmetrised."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(n, n)).astype(np.float32)
    q = 0.5 * (q + q.T)
    v = rng.normal(size=(n,)).astype(np.float32)
    return q, v


def harness_params(iters: int):
    """pump, S, dt, noise_ratio, fs, g, lo, hi, T of the harness."""
    return np.array([8.0, np.sqrt(7.0), 0.001, 10.0, 100.0, 0.01, 0.0, 1.0,
                     float(iters)], np.float32)


def cuda_core_dl_solve(seed, q_matrix, v_vector, params, **kwargs):
    """The DL kernel with its fp32 CUDA-core matvec (``csrc/dl_solve.cu``,
    MMA = 0): the race row that the solvers never launch.  Arguments and
    result of :func:`ccvm_tpu_torch.ops.dl_kernels.dl_solve`, and the same
    plain version for CPU tensors; counts its launches in ``launches``."""
    out = dl_kernels.solve_with(False, seed, q_matrix, v_vector, params, **kwargs)
    if q_matrix.device.type == "cuda":
        cuda_core_dl_solve.launches += 1
    return out


cuda_core_dl_solve.launches = 0

# kind -> (kernel wrapper, plain version)
_FUNCTIONS = {
    "v2": (dl_v2, dl_v2_reference),
    "v3": (dl_v3, dl_v3_reference),
    "production": (dl_kernels.dl_solve, dl_kernels.dl_solve_reference),
    "cuda-core": (cuda_core_dl_solve, dl_kernels.dl_solve_reference),
}


def runner(kind, kw, q, v, pv, batch, plain, seed=0, noise_scale=1.0):
    """``run(iterations) -> (c, s)`` of one row (``kind`` and ``kw`` as in
    :data:`ROWS`): the kernel's wrapper, or with ``plain`` its plain version
    (which needs no whole unrolled bodies)."""
    fn = _FUNCTIONS[kind][int(plain)]
    if kind in ("production", "cuda-core"):
        p = DLParams(*(float(x) for x in pv))
        return lambda iters: fn(
            seed, q, v, p, iterations=iters, batch_size=batch,
            pump_rate_flag=True, pump_is_gt_one=True, rng="popcount16",
            noise_scale=noise_scale, **kw)
    return lambda iters: fn(seed, q, v, pv, iterations=iters, batch_size=batch,
                            noise_scale=noise_scale, **kw)


def _wall(device, run, iters):
    """Seconds of one call and its outputs: CUDA events on the card, the
    host clock on the CPU."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = run(iters)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, out
    t = time.perf_counter()
    out = run(iters)
    return time.perf_counter() - t, out


def race(device, batch, n, i1, i2, reps=5, *, iters=15000, q=None, v=None,
         reverse=False):
    """Race every row of :data:`ROWS` on ``device``: "cuda" launches the
    kernels ("v2" rows need ``i1`` and ``i2`` to be multiples of the row's
    unroll), "cpu" times their plain versions.  Returns one dict per row, in
    the order of :data:`ROWS`: ``label``, ``us_per_step``,
    ``traj_iter_per_s``, ``finite`` (both outputs of the i2-step run) and
    the best walls ``w1_s``, ``w2_s``.

    ``q``, ``v`` default to the harness's problem of size ``n``; ``iters`` is
    the schedule's T; ``reverse`` runs the rows last to first."""
    dev = resolve_device(device)
    if q is None:
        qn, vn = harness_problem(n)
        q, v = torch.from_numpy(qn).to(dev), torch.from_numpy(vn).to(dev)
    elif q.shape[-1] != n:
        raise ValueError(f"Q is {tuple(q.shape)}, not of size n={n}")
    if not 0 < i1 < i2:
        raise ValueError(f"need 0 < i1 < i2, got {i1}, {i2}")
    pv = harness_params(iters)
    rows = []
    for label, kind, kw in (ROWS[::-1] if reverse else ROWS):
        run = runner(kind, kw, q, v, pv, batch, dev.type == "cpu")
        _wall(dev, run, i1)  # warm-up: builds and loads the kernel
        w1 = min(_wall(dev, run, i1)[0] for _ in range(reps))
        w2, out = float("inf"), None
        for _ in range(reps):
            w, o = _wall(dev, run, i2)
            if w < w2:
                w2, out = w, o
        us = (w2 - w1) / (i2 - i1) * 1e6
        rows.append({
            "label": label, "us_per_step": us,
            "traj_iter_per_s": batch / us * 1e6 if us > 0 else float("inf"),
            "finite": all(bool(torch.isfinite(x).all()) for x in out),
            "w1_s": w1, "w2_s": w2,
        })
    return rows[::-1] if reverse else rows


def race_rounds(device, batch, n, i1, i2, rounds, reps=5, **kw):
    """:func:`race` ``rounds`` times, the row order reversed every other
    round, so a drift of the card over the call falls on every row alike.
    Returns one dict per row of :data:`ROWS`: ``label``, ``us_per_step``
    (the median over the rounds), ``us_rounds`` (every round's),
    ``us_range`` (their max - min), ``traj_iter_per_s`` at the median and
    ``finite`` (in every round)."""
    if rounds < 1:
        raise ValueError(f"rounds must be at least 1, got {rounds}")
    runs = [race(device, batch, n, i1, i2, reps, reverse=bool(r % 2), **kw)
            for r in range(rounds)]
    rows = []
    for i, label in enumerate(LABELS):
        us = [run[i]["us_per_step"] for run in runs]
        med = statistics.median(us)
        rows.append({
            "label": label, "us_per_step": med, "us_rounds": us,
            "us_range": max(us) - min(us),
            "traj_iter_per_s": batch / med * 1e6 if med > 0 else float("inf"),
            "finite": all(run[i]["finite"] for run in runs),
        })
    return rows


def knob_effects(rows):
    """Each knob of :data:`KNOBS` on rows of :func:`race_rounds`: ``knob``,
    ``delta_us`` (changed median - base median), ``delta_pct`` (of the
    base), and ``resolved``: every round of one row faster than every round
    of the other, so the effect exceeds the rounds' spread."""
    by_label = {r["label"]: r for r in rows}
    effects = []
    for knob, base, changed in KNOBS:
        a, b = by_label[base], by_label[changed]
        delta = b["us_per_step"] - a["us_per_step"]
        resolved = (max(b["us_rounds"]) < min(a["us_rounds"])
                    or max(a["us_rounds"]) < min(b["us_rounds"]))
        effects.append({"knob": knob, "delta_us": delta,
                         "delta_pct": 100.0 * delta / a["us_per_step"],
                         "resolved": resolved})
    return effects


def format_row(row):
    rounds = len(row.get("us_rounds", ()))
    spread = (f" median, range {row['us_range']:.4f} over {rounds} rounds"
              if rounds > 1 else "")
    return (f"{row['label']:44s} marginal {row['us_per_step']:9.4f} us/step{spread}  "
            f"compute-bound {row['traj_iter_per_s'] / 1e6:9.1f} M traj-it/s  "
            f"outputs {'finite' if row['finite'] else 'NOT finite'}")


def format_effect(effect):
    return (f"{effect['knob']:40s} {effect['delta_us']:+9.4f} us/step "
            f"({effect['delta_pct']:+.1f}%), "
            f"{'resolved' if effect['resolved'] else 'within the spread'}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=15000)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (plain versions)"
    print(f"batch={args.batch} n={args.n} T={args.iters} i1={I1} i2={I2} on {name}",
          flush=True)
    for row in race(args.device, args.batch, args.n, I1, I2, iters=args.iters):
        print(format_row(row), flush=True)


if __name__ == "__main__":
    main()
