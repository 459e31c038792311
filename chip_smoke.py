#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ccvm_tpu_torch``) end to end on one card.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero without printing a result:

1. device: requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` does;
2. build: compiles every kernel specialisation the run launches from
   ``ccvm_tpu_torch/csrc`` (one nvcc each, in parallel) into build/kernels;
3. noise off: each kernel against its plain PyTorch version on the card, on
   the scaled N=70 instance, batch 1024, 300 iterations (DL pump 12, and
   DL-Adam with beta2 0.999 and 1.0); plus a stacked two-instance launch
   against two serial launches, bit for bit;
4. noise on, same Philox words: kernel against plain, 100 iterations;
5. noise on, statistics: 15,000 iterations at batch 4096, kernel against
   plain; every success probability within 5 combined binomial sigmas + 0.01
   (the band of tools/tpu_validate.py);
6. main path: ``DLSolver(device="cuda", batch_size=65536)`` on
   tuningH070-100-0.in with the tuned N=70 parameters, 15,000 iterations, a
   warm-up then seeds 1-3, with the launch counts zeroed just before and read
   just after, and the kernel's own time read from CUDA events around each
   launch; then the DL-Adam path through the same façade, one solve;
7. kernels: each kernel against its plain version at the main-path shape
   (same seed, so the same noise), then one JSON line with each kernel's
   launches, time, bound, plain time and largest error against its plain
   version;
8. the last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SIZE70 = os.path.join(REPO, "examples", "benchmarking_instances", "Size70")
INSTANCE = os.path.join(SIZE70, "tuningH070-100-0.in")
SECOND_INSTANCE = os.path.join(SIZE70, "tuningH070-100-1.in")
TUNED = os.path.join(REPO, "examples", "tuned_parameters.json")

N = 70
MAIN_BATCH = 65536
ITERATIONS = 15000
G = 0.05
# Kernel against plain: fp32 sum order differs (cuBLAS against the kernel's
# FMA chain) and nvcc contracts multiply-adds, so the two agree to round-off,
# not bit for bit.  The dynamics contract, so the difference stays at
# round-off over a whole solve.
PARITY_TOL = 1e-4
# Elementwise flops per state element per step (drift, schedules, noise
# scaling, clip), beside the 4*N flops of the two matvecs; the Adam variant
# adds the moment updates of both quadratures.
ELEMENTWISE_FLOPS = {"dl_solve": 40, "dl_adam_solve": 64}
# Published dense fp32 (non-tensor-core) peaks and memory rates of H100
# parts, by a substring of the nvidia-smi name (NVIDIA data sheets).
PEAKS = (("PCIe", 51.2e12, 2.0e12), ("NVL", 60.0e12, 3.9e12),
         ("H100", 66.9e12, 3.35e12))


def log(msg):
    print(msg, flush=True)


def card_peaks(name):
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
    raise RuntimeError(f"no published fp32 peak known for {name!r}")


def bound_ms(kernel, batch, n, iterations, name):
    """Least time for the work: operations over the fp32 peak, or bytes
    (Q and V read once, c and s written once) over the memory rate."""
    flops_peak, bw = card_peaks(name)
    flops = (4 * batch * n * n + ELEMENTWISE_FLOPS[kernel] * batch * n) * iterations
    nbytes = 4 * (n * n + n + 2 * batch * n)
    t_ops, t_bytes = flops / flops_peak, nbytes / bw
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def success_band_ok(perf_a, perf_b, batch):
    """tools/tpu_validate.py:96-106: |pa - pb| <= 5 sigma + 0.01."""
    import numpy as np

    ok = True
    for gap in perf_a:
        pa, pb = perf_a[gap], perf_b[gap]
        sig = np.sqrt(max(pa * (1 - pa), pb * (1 - pb), 1e-6) / batch) * np.sqrt(2)
        tol = 5 * sig + 0.01
        good = abs(pa - pb) <= tol
        ok &= bool(good)
        log(f"  {'ok ' if good else 'FAIL'} {gap:<13} kernel={pa:.4f} "
            f"plain={pb:.4f} tol={tol:.4f}")
    return ok


def main():
    if not os.path.isdir(os.path.join(REPO, "ccvm_tpu_torch")):
        raise SystemExit("chip_smoke: ccvm_tpu_torch/ is missing; run from a checkout")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    import numpy as np

    from ccvm_tpu_torch import AdamParameters, DLSolver, ProblemInstance, Solution
    from ccvm_tpu_torch.ops import build, dl_kernels

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {name}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, count {torch.cuda.device_count()}")

    # 2. build
    with open(TUNED) as f:
        tuned = json.load(f)["dl"][str(N)]
    pk = {N: {**tuned, "iterations": ITERATIONS}}
    adam_hps = {b2: AdamParameters(beta2=b2).to_hyperparameters()
                for b2 in (0.999, 1.0)}

    def spec(hp=None, noise=True):
        return build.DLSpec(hp is not None, hp is not None and hp.beta2 == 1.0,
                            hp is not None and hp.add_assign, True,
                            tuned["pump"] > 1, noise, 1)

    specs = [spec(), spec(noise=False), spec(adam_hps[0.999]),
             spec(adam_hps[0.999], noise=False), spec(adam_hps[1.0], noise=False)]
    t0 = time.perf_counter()
    reports = build.build(specs)
    log(f"phase 2 build: {len(reports)} libraries in "
        f"{time.perf_counter() - t0:.1f} s from ccvm_tpu_torch/csrc/dl_solve.cu")
    for s, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines() if "registers" in ln]
        log(f"  spec {s.tag()}: {regs[-1] if regs else rep.strip()[-200:]}")

    # Scaled instances on the card, through the user-facing entry points.
    def instance(path):
        inst = ProblemInstance(device="cuda", instance_type="tuning", file_path=path)
        inst.scale_coefs(DLSolver(device="cuda").get_scaling_factor(inst.q_matrix))
        return inst

    inst = instance(INSTANCE)
    solver = DLSolver(device="cuda", batch_size=MAIN_BATCH)
    solver.parameter_key = pk
    solver.solution_bounds = inst.solution_bounds

    def params(iterations):
        return solver._make_params(tuned["pump"], 1.0, tuned["dt"],
                                   tuned["noise_ratio"], tuned["feedback_scale"],
                                   G, iterations)

    def run_pair(seed, batch, iterations, hp, noise_scale, q=None, v=None):
        kw = dict(iterations=iterations, batch_size=batch, pump_rate_flag=True,
                  pump_is_gt_one=tuned["pump"] > 1, noise_scale=noise_scale,
                  rng="popcount16", hp=hp)
        q = inst.q_matrix if q is None else q
        v = inst.v_vector if v is None else v
        p = params(iterations)
        ck, sk = dl_kernels.dl_solve(seed, q, v, p, **kw)
        t = time.perf_counter()
        cr, sr = dl_kernels.dl_solve_reference(seed, q, v, p, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        for x in (ck, sk):
            assert torch.isfinite(x).all(), "kernel output is not finite"
        err = max((ck - cr).abs().max().item(), (sk - sr).abs().max().item())
        return (ck, sk), (cr, sr), err, plain_s

    max_err = {"dl_solve": 0.0, "dl_adam_solve": 0.0}
    cases = [("dl_solve", None, "DL pump 12"),
             ("dl_adam_solve", adam_hps[0.999], "DL-Adam beta2 0.999"),
             ("dl_adam_solve", adam_hps[1.0], "DL-Adam beta2 1.0")]

    # 3. noise off
    for kname, hp, label in cases:
        _, _, err, _ = run_pair(0, 1024, 300, hp, 0.0)
        max_err[kname] = max(max_err[kname], err)
        log(f"phase 3 noise off {label}: max |kernel - plain| of c, s = {err:.3e}"
            f" (tol {PARITY_TOL})")
        assert err <= PARITY_TOL, f"{label}: noise-off parity {err} > {PARITY_TOL}"
    second = instance(SECOND_INSTANCE)
    q2 = torch.stack([inst.q_matrix, second.q_matrix])
    v2 = torch.stack([inst.v_vector, second.v_vector])
    kw = dict(iterations=300, batch_size=1024, pump_rate_flag=True,
              pump_is_gt_one=tuned["pump"] > 1, rng="popcount16")
    cs, ss = dl_kernels.dl_solve(11, q2, v2, params(300), **kw)
    for i in range(2):
        ci, si = dl_kernels.dl_solve(11 + i, q2[i], v2[i], params(300), **kw)
        assert torch.equal(cs[i], ci) and torch.equal(ss[i], si), \
            f"stacked instance {i} differs from a serial launch with seed {11 + i}"
    log("phase 3 stacked: a two-instance launch equals serial launches with "
        "seeds 11 and 12 bit for bit")

    # 4. noise on, the same Philox words
    for kname, hp, label in cases[:2]:
        _, _, err, _ = run_pair(5, 1024, 100, hp, 1.0)
        max_err[kname] = max(max_err[kname], err)
        log(f"phase 4 noise on {label}, popcount16, 100 steps: max |kernel - "
            f"plain| = {err:.3e} (tol {PARITY_TOL})")
        assert err <= PARITY_TOL, f"{label}: noise-on parity {err} > {PARITY_TOL}"

    # 5. noise on, statistics over a full-length solve
    (ck, _), (cr, _), err, plain_s = run_pair(21, 4096, ITERATIONS, None, 1.0)
    cv = ("boxqp", *inst.solution_bounds, 1.0)
    perf = []
    for c in (ck, cr):
        e = inst.compute_energy_readout64(c, change_vars=cv)
        perf.append(Solution(
            problem_size=N, batch_size=4096, instance_name=inst.name,
            iterations=ITERATIONS, objective_values=e, solve_time=0.0,
            pp_time=0.0, optimal_value=inst.optimal_sol,
            best_value=inst.best_sol, num_frac_values=inst.num_frac_values,
            solution_vector=[], variables={}).solution_performance)
    log(f"phase 5 statistics: batch 4096, {ITERATIONS} steps, plain version "
        f"{plain_s:.2f} s, max |kernel - plain| = {err:.3e}")
    assert success_band_ok(perf[0], perf[1], 4096), "success probabilities disagree"

    # 6. main path, through the façade
    class EventTimedDLSolver(DLSolver):
        """DLSolver whose one kernel launch per solve is bracketed by CUDA
        events on the launch stream, so the kernel's own time is read from
        the main-path run itself."""

        kernel_events = []

        def _solve(self, *args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = super()._solve(*args, **kwargs)
            end.record()
            self.kernel_events.append((start, end))
            return out

    main_solver = EventTimedDLSolver(device="cuda", batch_size=MAIN_BATCH,
                                     timing="async")
    main_solver.parameter_key = pk
    main_solver(inst, seed=0)  # warm-up
    torch.cuda.synchronize()
    main_solver.kernel_events.clear()
    dl_kernels.dl_solve.dl_launches = 0
    dl_kernels.dl_solve.dl_adam_launches = 0
    best_wall, best, walls = float("inf"), None, []
    for seed in (1, 2, 3):
        t = time.perf_counter()
        sol = main_solver(inst, seed=seed)
        wall = time.perf_counter() - t
        walls.append(wall)
        if wall < best_wall:
            best_wall, best = wall, sol
    launches = {"dl_solve": dl_kernels.dl_solve.dl_launches,
                "dl_adam_solve": dl_kernels.dl_solve.dl_adam_launches}
    assert launches == {"dl_solve": 3, "dl_adam_solve": 0}, launches
    torch.cuda.synchronize()
    main_kernel_ms = [a.elapsed_time(b) for a, b in main_solver.kernel_events]
    assert len(main_kernel_ms) == 3, main_kernel_ms
    c = best.variables["problem_variables"]
    assert c.shape == (MAIN_BATCH, N) and c.is_cuda
    assert torch.isfinite(c).all() and c.abs().max().item() <= 1.0
    assert np.all(np.isfinite(best.objective_values))
    perf_main = best.solution_performance
    log(f"phase 6 main path: N={N} batch={MAIN_BATCH} iterations={ITERATIONS} "
        f"best wall {best_wall:.3f} s (walls {walls}), "
        f"{ITERATIONS * MAIN_BATCH / best_wall:.4g} traj-iter/s, kernel's own "
        f"time (CUDA events) {main_kernel_ms} ms, P(0.1%)={perf_main['optimal']:.4f} "
        f"P(1%)={perf_main['one_percent']:.4f} best="
        f"{best.best_objective_value:.3f}/{best.optimal_value:.3f}, launches "
        f"{launches}")
    assert perf_main["one_percent"] >= 0.95, perf_main

    adam_solver = DLSolver(device="cuda", batch_size=MAIN_BATCH, timing="async")
    adam_solver.parameter_key = pk
    dl_kernels.dl_solve.dl_launches = 0
    dl_kernels.dl_solve.dl_adam_launches = 0
    t = time.perf_counter()
    sol_adam = adam_solver(inst, seed=1, algorithm_parameters=AdamParameters())
    wall_adam = time.perf_counter() - t
    launches["dl_adam_solve"] = dl_kernels.dl_solve.dl_adam_launches
    assert (dl_kernels.dl_solve.dl_launches, launches["dl_adam_solve"]) == (0, 1)
    assert np.all(np.isfinite(sol_adam.objective_values))
    log(f"phase 6 DL-Adam path: wall {wall_adam:.3f} s, "
        f"P(0.1%)={sol_adam.solution_performance['optimal']:.4f} "
        f"P(1%)={sol_adam.solution_performance['one_percent']:.4f} best="
        f"{sol_adam.best_objective_value:.3f}, launches "
        f"{launches['dl_adam_solve']}")

    # 7. kernels: time, bound and plain time at the main-path shape
    kernels = []
    main_hp = {"dl_solve": None, "dl_adam_solve": adam_hps[0.999]}
    replaces = {"dl_solve": "ccvm_tpu/ops/pallas_kernels.py:843",
                "dl_adam_solve": "ccvm_tpu/ops/pallas_kernels.py:977"}
    for kname, hp in main_hp.items():
        kw = dict(iterations=ITERATIONS, batch_size=MAIN_BATCH,
                  pump_rate_flag=True, pump_is_gt_one=tuned["pump"] > 1,
                  rng="popcount16", hp=hp)
        p = params(ITERATIONS)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        times = []
        for rep in range(2):
            events[0].record()
            out = dl_kernels.dl_solve(100, inst.q_matrix, inst.v_vector, p, **kw)
            events[1].record()
            torch.cuda.synchronize()
            times.append(events[0].elapsed_time(events[1]))
        events[0].record()
        ref = dl_kernels.dl_solve_reference(100, inst.q_matrix, inst.v_vector, p, **kw)
        events[1].record()
        torch.cuda.synchronize()
        plain_ms = events[0].elapsed_time(events[1])
        err = max((a - b).abs().max().item() for a, b in zip(out, ref))
        max_err[kname] = max(max_err[kname], err)
        log(f"phase 7 {kname} at the main-path shape, same noise: max |kernel - "
            f"plain| = {err:.3e} (tol {PARITY_TOL})")
        assert err <= PARITY_TOL, f"{kname}: main-shape parity {err} > {PARITY_TOL}"
        b_ms, b_by = bound_ms(kname, MAIN_BATCH, N, ITERATIONS, name)
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "ccvm_tpu_torch/csrc/dl_solve.cu",
            "replaces": replaces[kname], "launches": launches[kname],
            "max_abs_err": max_err[kname], "ms": min(times),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
        log(f"phase 7 {kname}: kernel {min(times):.1f} ms (reps {times}), plain "
            f"{plain_ms:.1f} ms, bound {b_ms:.1f} ms ({b_by}) at batch "
            f"{MAIN_BATCH}, N={N}, {ITERATIONS} steps")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
