#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ccvm_tpu_torch``) end to end on one card.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero without printing a result:

1. device: requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` does;
2. build: compiles every kernel specialisation the run launches from
   ``ccvm_tpu_torch/csrc`` (one nvcc each, all started together) into
   build/kernels, and prints what ptxas reports;
3. noise off: each kernel against its plain PyTorch version on the card, on
   the scaled N=70 instance, batch 1024, 300 iterations (DL pump 12, DL-Adam
   with beta2 0.999 and 1.0; MF, Langevin and pumped Langevin with the tuned
   N=70 parameters, and their Adam variants with beta2 0.999 and 1.0); plus,
   for each of DL, MF, Langevin and pumped Langevin, a stacked two-instance
   launch against two serial launches, bit for bit;
4. noise on, same Philox words: kernel against plain, 100 iterations;
5. noise on, statistics: 15,000 iterations at batch 4096, kernel against
   plain; every success probability within 5 combined binomial sigmas + 0.01
   (the band of tools/tpu_validate.py).  The readouts of MF and of the
   Langevin family go through their change of variables, grad-descent and
   ``compute_energy_readout64``, as the façades' do;
6. main paths, through the façades, on tuningH070-100-0.in with the tuned
   N=70 parameters, batch 65536, 15,000 iterations, a warm-up then seeds 1-3,
   with the launch counts zeroed just before and read just after, and the
   kernel's own time read from CUDA events around each launch:
   ``DLSolver(device="cuda")`` (then one DL-Adam solve);
   ``MFSolver(device="cuda")`` with ``post_processor="grad-descent"`` and
   g 0.01 (then one MF-Adam solve); ``LangevinSolver(device="cuda")`` and
   ``PumpedLangevinSolver(device="cuda")`` with grad-descent and
   ``kernel_rng="popcount32"`` (then one Adam solve each, with the tuned Adam
   parameters);
7. kernels: each kernel timed at the main-path shape and held against its
   plain version (same seed, so the same noise), then one JSON line with
   each kernel's launches, time, bound, plain time (and the steps it
   covers) and largest error against its plain version.  The Langevin
   family is held elementwise after 100, 1,000 and 15,000 steps (past 100
   steps at LANGEVIN_DEEP_TOL, with at most LANGEVIN_DEEP_SHARE of the
   elements over PARITY_TOL), MF after 100 and 1,000, DL after 1,000 (their
   15,000-step errors are recorded in PERF.md); the difference by depth is
   printed, and every kernel is measured before a failed hold raises;
8. the last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
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
G = 0.05  # DL
MF_G = 0.01  # MFSolver's default, as bench.py's MF row runs it
# Kernel against plain: fp32 sum order differs (cuBLAS against the kernel's
# FMA chain) and nvcc contracts multiply-adds, so the two agree to round-off,
# not bit for bit.
PARITY_TOL = 1e-4
# The Langevin family beyond 100 steps at the main-path shape: the drift is
# linear in c, so a round-off difference on an element inside the box grows
# along the unstable directions of x.Q.x until the clamp at +-S stops it.
# Measured on an NVIDIA H100 80GB HBM3 at 700 W: at most 6e-7 after 100
# steps, 2.2e-4 after 1,000 and 7.3e-4 after 15,000, on at most 9 of the 4.6
# million elements.  So past 100 steps every difference stays under
# LANGEVIN_DEEP_TOL and at most LANGEVIN_DEEP_SHARE of the elements exceed
# PARITY_TOL.
LANGEVIN_DEEP_TOL = 2e-3
LANGEVIN_DEEP_SHARE = 1e-4
# Phase 7 holds DL and MF against their plain versions over this many steps
# at the main-path shape (each plain main-shape solve at full depth costs
# about a minute); their kernels are timed at full depth.
EARLIER_PLAIN_DEPTH = 1000
# fp32 operations per element of (batch, N) state per step, beside the
# 2*N of each matvec, counted from csrc/dl_solve.cu, csrc/mf_solve.cu and
# csrc/langevin_solve.cu (drift, schedules, noise scaling, divisions, clips,
# Adam; Philox's integer work is not counted).  DL does two matvecs a step,
# the others one.
ELEMENTWISE_FLOPS = {"dl_solve": 40, "dl_adam_solve": 64,
                     "mf_solve": 40, "mf_adam_solve": 55,
                     "langevin_solve": 12, "langevin_adam_solve": 26,
                     "pumped_langevin_solve": 17,
                     "pumped_langevin_adam_solve": 31}
MATVECS = {"dl_solve": 2, "dl_adam_solve": 2, "mf_solve": 1, "mf_adam_solve": 1,
           "langevin_solve": 1, "langevin_adam_solve": 1,
           "pumped_langevin_solve": 1, "pumped_langevin_adam_solve": 1}
OUTPUTS = {"dl_solve": 2, "dl_adam_solve": 2, "mf_solve": 3, "mf_adam_solve": 3,
           "langevin_solve": 1, "langevin_adam_solve": 1,
           "pumped_langevin_solve": 1, "pumped_langevin_adam_solve": 1}
KERNELS = tuple(MATVECS)
# Published dense fp32 (non-tensor-core) peaks and memory rates of H100
# parts, by a substring of the nvidia-smi name (NVIDIA data sheets).
PEAKS = (("PCIe", 51.2e12, 2.0e12), ("NVL", 60.0e12, 3.9e12),
         ("H100", 66.9e12, 3.35e12))
# bench.py's MF, Langevin and pumped rows on a TPU v5 lite in round 5
# (BENCH_r05.json): quality references for the port, not speed targets.
TPU_R5_P01 = {"mf": 1.000, "langevin": 0.958, "pumped": 0.994}


def log(msg):
    print(msg, flush=True)


def card_peaks(name):
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
    raise RuntimeError(f"no published fp32 peak known for {name!r}")


def bound_ms(kernel, batch, n, iterations, name):
    """Least time for the work: operations over the fp32 peak, or bytes
    (Q and V read once, each output written once) over the memory rate."""
    flops_peak, bw = card_peaks(name)
    flops = (2 * MATVECS[kernel] * batch * n * n
             + ELEMENTWISE_FLOPS[kernel] * batch * n) * iterations
    nbytes = 4 * (n * n + n + OUTPUTS[kernel] * batch * n)
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


def max_diff(a, b):
    """Largest elementwise difference over a kernel's outputs (a tensor or a
    tuple of tensors) and its plain version's."""
    if not isinstance(a, tuple):
        a, b = (a,), (b,)
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def main():
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(REPO, "ccvm_tpu_torch")):
        raise SystemExit("chip_smoke: ccvm_tpu_torch/ is missing; run from a checkout")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    import numpy as np

    from ccvm_tpu_torch import (AdamParameters, DLSolver, LangevinSolver,
                                MFSolver, ProblemInstance, PumpedLangevinSolver,
                                Solution)
    from ccvm_tpu_torch.dynamics.common import langevin_change_variables
    from ccvm_tpu_torch.ops import build, dl_kernels, langevin_kernels, mf_kernels
    from ccvm_tpu_torch.post_processor import PostProcessorGradDescent

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
        tuned_all = json.load(f)
    tuned, mf_tuned = tuned_all["dl"][str(N)], tuned_all["mf"][str(N)]
    lgv_tuned = {"langevin": tuned_all["langevin"][str(N)],
                 "pumped": tuned_all["pumped"][str(N)]}
    lgv_adam = {f: AdamParameters(**tuned_all["adam"][f][str(N)])
                for f in lgv_tuned}
    pk = {N: {**tuned, "iterations": ITERATIONS}}
    mf_pk = {N: {**mf_tuned, "iterations": ITERATIONS}}
    lgv_pk = {f: {N: {**t, "iterations": ITERATIONS}} for f, t in lgv_tuned.items()}
    adam_hps = {b2: AdamParameters(beta2=b2).to_hyperparameters()
                for b2 in (0.999, 1.0)}

    def spec(hp=None, noise=True):
        return build.DLSpec(hp is not None, hp is not None and hp.beta2 == 1.0,
                            hp is not None and hp.add_assign, True,
                            tuned["pump"] > 1, noise, 1)

    def mf_spec(hp=None, noise=True):
        return build.MFSpec(hp is not None, hp is not None and hp.beta2 == 1.0,
                            hp is not None and hp.add_assign, True, noise, 0)

    def lgv_spec(pumped, hp=None, noise=True):
        return build.LangevinSpec(pumped, hp is not None,
                                  hp is not None and hp.beta2 == 1.0,
                                  hp is not None and hp.add_assign, pumped,
                                  noise, 0)

    specs = [spec(), spec(noise=False), spec(adam_hps[0.999]),
             spec(adam_hps[0.999], noise=False), spec(adam_hps[1.0], noise=False),
             mf_spec(), mf_spec(noise=False), mf_spec(adam_hps[0.999]),
             mf_spec(adam_hps[0.999], noise=False),
             mf_spec(adam_hps[1.0], noise=False)]
    for pumped in (False, True):
        specs += [lgv_spec(pumped), lgv_spec(pumped, noise=False),
                  lgv_spec(pumped, adam_hps[0.999]),
                  lgv_spec(pumped, adam_hps[0.999], noise=False),
                  lgv_spec(pumped, adam_hps[1.0], noise=False)]
    t0 = time.perf_counter()
    reports = build.build(specs)
    log(f"phase 2 build: {len(reports)} libraries in "
        f"{time.perf_counter() - t0:.1f} s from ccvm_tpu_torch/csrc "
        f"(dl_solve.cu, mf_solve.cu, langevin_solve.cu, ccvm_common.cuh)")
    for s, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines() if "registers" in ln]
        log(f"  {type(s).__name__} {s.tag()}: {regs[-1] if regs else rep.strip()[-200:]}")

    # Scaled instances on the card, through the user-facing entry points.
    def instance(path, solver_cls=DLSolver):
        inst = ProblemInstance(device="cuda", instance_type="tuning", file_path=path)
        inst.scale_coefs(solver_cls(device="cuda").get_scaling_factor(inst.q_matrix))
        return inst

    inst = instance(INSTANCE)
    mf_inst = instance(INSTANCE, MFSolver)
    lgv_cls = {"langevin": LangevinSolver, "pumped": PumpedLangevinSolver}
    lgv_inst = {f: instance(INSTANCE, cls) for f, cls in lgv_cls.items()}
    lgv_solver = {}
    for f, cls in lgv_cls.items():
        lgv_solver[f] = cls(device="cuda", batch_size=MAIN_BATCH)
        lgv_solver[f].solution_bounds = lgv_inst[f].solution_bounds
    solver = DLSolver(device="cuda", batch_size=MAIN_BATCH)
    solver.parameter_key = pk
    solver.solution_bounds = inst.solution_bounds
    mf_solver = MFSolver(device="cuda", batch_size=MAIN_BATCH)
    mf_solver.parameter_key = mf_pk
    mf_solver.solution_bounds = mf_inst.solution_bounds

    def params(iterations):
        return solver._make_params(tuned["pump"], 1.0, tuned["dt"],
                                   tuned["noise_ratio"], tuned["feedback_scale"],
                                   G, iterations)

    def mf_params(iterations):
        return mf_solver._make_params(mf_tuned["pump"], mf_tuned["S"],
                                      mf_tuned["dt"], mf_tuned["j"],
                                      mf_tuned["feedback_scale"], MF_G, iterations)

    def lgv_params(family, iterations):
        t = lgv_tuned[family]
        if family == "langevin":
            return lgv_solver[family]._make_params(t["S"], t["dt"], t["sigma"],
                                                   t["feedback_scale"])
        return lgv_solver[family]._make_params(t["pump"], t["S"], t["dt"],
                                               t["sigma"], t["feedback_scale"],
                                               iterations)

    def lgv_fns(family):
        """(kernel wrapper, plain version, extra kwargs) of a family."""
        if family == "langevin":
            return (langevin_kernels.langevin_solve,
                    langevin_kernels.langevin_solve_reference, {})
        return (langevin_kernels.pumped_langevin_solve,
                langevin_kernels.pumped_langevin_solve_reference,
                {"pump_rate_flag": True})

    def lgv_run_pair(family, seed, batch, iterations, hp, noise_scale, q=None, v=None):
        kernel, plain, extra = lgv_fns(family)
        kw = dict(extra, iterations=iterations, batch_size=batch,
                  noise_scale=noise_scale, rng="popcount32", hp=hp)
        q = lgv_inst[family].q_matrix if q is None else q
        v = lgv_inst[family].v_vector if v is None else v
        p = lgv_params(family, iterations)
        ck = kernel(seed, q, v, p, **kw)
        t = time.perf_counter()
        cr = plain(seed, q, v, p, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        assert torch.isfinite(ck).all(), "kernel output is not finite"
        return ck, cr, max_diff(ck, cr), plain_s

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
        return (ck, sk), (cr, sr), max_diff((ck, sk), (cr, sr)), plain_s

    def mf_run_pair(seed, batch, iterations, hp, noise_scale):
        kw = dict(iterations=iterations, batch_size=batch, pump_rate_flag=True,
                  noise_scale=noise_scale, rng="popcount32", hp=hp)
        p = mf_params(iterations)
        out = mf_kernels.mf_solve(seed, mf_inst.q_matrix, mf_inst.v_vector, p, **kw)
        t = time.perf_counter()
        ref = mf_kernels.mf_solve_reference(seed, mf_inst.q_matrix,
                                            mf_inst.v_vector, p, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        for x in out:
            assert torch.isfinite(x).all(), "kernel output is not finite"
        return out, ref, max_diff(out, ref), plain_s

    max_err = dict.fromkeys(KERNELS, 0.0)
    cases = [("dl_solve", None, "DL pump 12"),
             ("dl_adam_solve", adam_hps[0.999], "DL-Adam beta2 0.999"),
             ("dl_adam_solve", adam_hps[1.0], "DL-Adam beta2 1.0")]
    mf_cases = [("mf_solve", None, "MF"),
                ("mf_adam_solve", adam_hps[0.999], "MF-Adam beta2 0.999"),
                ("mf_adam_solve", adam_hps[1.0], "MF-Adam beta2 1.0")]
    # (family, kernel name, hp, label)
    lgv_cases = []
    for family, kname, label in (("langevin", "langevin_solve", "Langevin"),
                                 ("pumped", "pumped_langevin_solve", "pumped")):
        lgv_cases += [(family, kname, None, label),
                      (family, kname.replace("_solve", "_adam_solve"),
                       adam_hps[0.999], f"{label}-Adam beta2 0.999"),
                      (family, kname.replace("_solve", "_adam_solve"),
                       adam_hps[1.0], f"{label}-Adam beta2 1.0")]

    failures = []

    def hold(kname, label, err, what, tol=PARITY_TOL, defer=False):
        """Hold a kernel's largest difference from its plain version; with
        ``defer`` a failure is raised only after every kernel was measured."""
        max_err[kname] = max(max_err[kname], err)
        log(f"{what} {label}: max |kernel - plain| = {err:.3e} (tol {tol})")
        if err > tol:
            failures.append(f"{label}: {what} parity {err} > {tol}")
            assert defer, failures[-1]

    # 3. noise off
    for kname, hp, label in cases:
        hold(kname, label, run_pair(0, 1024, 300, hp, 0.0)[2],
             "phase 3 noise off, 300 steps, c and s,")
    for kname, hp, label in mf_cases:
        hold(kname, label, mf_run_pair(0, 1024, 300, hp, 0.0)[2],
             "phase 3 noise off, 300 steps, mu, mu_tilde and sigma,")
    for family, kname, hp, label in lgv_cases:
        hold(kname, label, lgv_run_pair(family, 0, 1024, 300, hp, 0.0)[2],
             "phase 3 noise off, 300 steps, c,")
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
    mf_second = instance(SECOND_INSTANCE, MFSolver)
    q2 = torch.stack([mf_inst.q_matrix, mf_second.q_matrix])
    v2 = torch.stack([mf_inst.v_vector, mf_second.v_vector])
    kw = dict(iterations=300, batch_size=1024, pump_rate_flag=True,
              rng="popcount32")
    stacked = mf_kernels.mf_solve(11, q2, v2, mf_params(300), **kw)
    for i in range(2):
        serial = mf_kernels.mf_solve(11 + i, q2[i], v2[i], mf_params(300), **kw)
        assert all(torch.equal(a[i], b) for a, b in zip(stacked, serial)), \
            f"stacked MF instance {i} differs from a serial launch with seed {11 + i}"
    for family in lgv_cls:
        kernel, _, extra = lgv_fns(family)
        lgv_second = instance(SECOND_INSTANCE, lgv_cls[family])
        q2 = torch.stack([lgv_inst[family].q_matrix, lgv_second.q_matrix])
        v2 = torch.stack([lgv_inst[family].v_vector, lgv_second.v_vector])
        kw = dict(extra, iterations=300, batch_size=1024, rng="popcount32")
        stacked = kernel(11, q2, v2, lgv_params(family, 300), **kw)
        for i in range(2):
            serial = kernel(11 + i, q2[i], v2[i], lgv_params(family, 300), **kw)
            assert torch.equal(stacked[i], serial), \
                f"stacked {family} instance {i} differs from a serial launch"
    log("phase 3 stacked: a two-instance launch equals serial launches with "
        "seeds 11 and 12 bit for bit (DL, MF, Langevin and pumped Langevin)")

    # 4. noise on, the same Philox words
    for kname, hp, label in cases[:2]:
        hold(kname, label, run_pair(5, 1024, 100, hp, 1.0)[2],
             "phase 4 noise on, popcount16, 100 steps,")
    for kname, hp, label in mf_cases[:2]:
        hold(kname, label, mf_run_pair(5, 1024, 100, hp, 1.0)[2],
             "phase 4 noise on, popcount32, 100 steps,")
    for family, kname, hp, label in lgv_cases[0:2] + lgv_cases[3:5]:
        hold(kname, label, lgv_run_pair(family, 5, 1024, 100, hp, 1.0)[2],
             "phase 4 noise on, popcount32, 100 steps,")

    # 5. noise on, statistics over a full-length solve
    def performance(instance_, energies, batch):
        return Solution(
            problem_size=N, batch_size=batch, instance_name=instance_.name,
            iterations=ITERATIONS, objective_values=energies, solve_time=0.0,
            pp_time=0.0, optimal_value=instance_.optimal_sol,
            best_value=instance_.best_sol, num_frac_values=instance_.num_frac_values,
            solution_vector=[], variables={}).solution_performance

    (ck, _), (cr, _), err, plain_s = run_pair(21, 4096, ITERATIONS, None, 1.0)
    cv = ("boxqp", *inst.solution_bounds, 1.0)
    perf = [performance(inst, inst.compute_energy_readout64(c, change_vars=cv), 4096)
            for c in (ck, cr)]
    log(f"phase 5 DL statistics: batch 4096, {ITERATIONS} steps, plain version "
        f"{plain_s:.2f} s, max |kernel - plain| = {err:.3e}")
    assert success_band_ok(perf[0], perf[1], 4096), "DL success probabilities disagree"

    out, ref, err, plain_s = mf_run_pair(21, 4096, ITERATIONS, None, 1.0)
    lo, hi = mf_inst.solution_bounds
    perf = []
    for mt in (out[1], ref[1]):
        confs = PostProcessorGradDescent().postprocess(
            mf_solver.change_variables(mt, lo, hi, mf_tuned["S"]),
            mf_inst.q_matrix, mf_inst.v_vector)
        perf.append(performance(mf_inst, mf_inst.compute_energy_readout64(confs), 4096))
    log(f"phase 5 MF statistics: batch 4096, {ITERATIONS} steps, readout through "
        f"grad-descent, plain version {plain_s:.2f} s, max |kernel - plain| = "
        f"{err:.3e}")
    assert success_band_ok(perf[0], perf[1], 4096), "MF success probabilities disagree"

    for family in lgv_cls:
        ck, cr, err, plain_s = lgv_run_pair(family, 21, 4096, ITERATIONS, None, 1.0)
        li = lgv_inst[family]
        perf = []
        for c in (ck, cr):
            confs = PostProcessorGradDescent().postprocess(
                langevin_change_variables(c, float(lgv_tuned[family]["S"])),
                li.q_matrix, li.v_vector)
            perf.append(performance(li, li.compute_energy_readout64(confs), 4096))
        log(f"phase 5 {family} statistics: batch 4096, {ITERATIONS} steps, readout "
            f"through (c+S)/(2S) and grad-descent, plain version {plain_s:.2f} s, "
            f"max |kernel - plain| = {err:.3e}")
        assert success_band_ok(perf[0], perf[1], 4096), \
            f"{family} success probabilities disagree"

    # 6. main paths, through the façades
    def event_timed(cls):
        class EventTimed(cls):
            """A façade whose one kernel launch per solve is bracketed by
            CUDA events on the launch stream, so the kernel's own time is
            read from the main-path run itself."""

            kernel_events = []

            def _solve(self, *args, **kwargs):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = super()._solve(*args, **kwargs)
                end.record()
                self.kernel_events.append((start, end))
                return out

        return EventTimed

    counters = {
        "dl_solve": (dl_kernels.dl_solve, "dl_launches"),
        "dl_adam_solve": (dl_kernels.dl_solve, "dl_adam_launches"),
        "mf_solve": (mf_kernels.mf_solve, "mf_launches"),
        "mf_adam_solve": (mf_kernels.mf_solve, "mf_adam_launches"),
        "langevin_solve": (langevin_kernels.langevin_solve, "langevin_launches"),
        "langevin_adam_solve": (langevin_kernels.langevin_solve,
                                "langevin_adam_launches"),
        "pumped_langevin_solve": (langevin_kernels.pumped_langevin_solve,
                                  "pumped_launches"),
        "pumped_langevin_adam_solve": (langevin_kernels.pumped_langevin_solve,
                                       "pumped_adam_launches"),
    }
    assert tuple(counters) == KERNELS

    def zero_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def counts():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    def only(**expected):
        """Launch counts with every kernel not named at 0."""
        return {k: expected.get(k, 0) for k in KERNELS}

    def main_path(cls, pkey, instance_, label, min_p1=0.95, **call):
        main_solver = event_timed(cls)(device="cuda", batch_size=MAIN_BATCH,
                                       timing="async")
        main_solver.parameter_key = pkey
        main_solver(instance_, seed=0, **call)  # warm-up
        torch.cuda.synchronize()
        main_solver.kernel_events.clear()
        zero_counts()
        best_wall, best, walls = float("inf"), None, []
        for seed in (1, 2, 3):
            t = time.perf_counter()
            sol = main_solver(instance_, seed=seed, **call)
            wall = time.perf_counter() - t
            walls.append(wall)
            if wall < best_wall:
                best_wall, best = wall, sol
        launched = counts()
        torch.cuda.synchronize()
        kernel_ms = [a.elapsed_time(b) for a, b in main_solver.kernel_events]
        assert len(kernel_ms) == 3, kernel_ms
        c = best.variables["problem_variables"]
        assert c.shape == (MAIN_BATCH, N) and c.is_cuda
        assert torch.isfinite(c).all()
        assert np.all(np.isfinite(best.objective_values))
        perf_main = best.solution_performance
        log(f"phase 6 {label} main path: N={N} batch={MAIN_BATCH} iterations="
            f"{ITERATIONS} best wall {best_wall:.3f} s (walls {walls}), "
            f"{ITERATIONS * MAIN_BATCH / best_wall:.4g} traj-iter/s, kernel's own "
            f"time (CUDA events) {kernel_ms} ms, P(0.1%)={perf_main['optimal']:.4f} "
            f"P(1%)={perf_main['one_percent']:.4f} best="
            f"{best.best_objective_value:.3f}/{best.optimal_value:.3f}, launches "
            f"{launched}")
        assert perf_main["one_percent"] >= min_p1, perf_main
        return best, launched

    def adam_path(cls, pkey, instance_, label, adam=None, **call):
        adam_solver = cls(device="cuda", batch_size=MAIN_BATCH, timing="async")
        adam_solver.parameter_key = pkey
        zero_counts()
        t = time.perf_counter()
        sol = adam_solver(instance_, seed=1,
                          algorithm_parameters=adam or AdamParameters(), **call)
        wall = time.perf_counter() - t
        launched = counts()
        assert np.all(np.isfinite(sol.objective_values))
        log(f"phase 6 {label} path: wall {wall:.3f} s, "
            f"P(0.1%)={sol.solution_performance['optimal']:.4f} "
            f"P(1%)={sol.solution_performance['one_percent']:.4f} best="
            f"{sol.best_objective_value:.3f}, launches {launched}")
        return launched

    launches = {}
    best, launched = main_path(DLSolver, pk, inst, "DL")
    assert launched == only(dl_solve=3), launched
    assert best.variables["problem_variables"].abs().max().item() <= 1.0
    launches["dl_solve"] = launched["dl_solve"]
    launched = adam_path(DLSolver, pk, inst, "DL-Adam")
    assert launched == only(dl_adam_solve=1), launched
    launches["dl_adam_solve"] = launched["dl_adam_solve"]

    best, launched = main_path(MFSolver, mf_pk, mf_inst, "MF (grad-descent)",
                               post_processor="grad-descent", g=MF_G)
    assert launched == only(mf_solve=3), launched
    c = best.variables["problem_variables"]
    assert c.min().item() >= lo and c.max().item() <= hi
    log(f"  quality reference: bench.py's MF row on a TPU v5 lite in round 5 "
        f"gave P(0.1%)={TPU_R5_P01['mf']:.3f}")
    launches["mf_solve"] = launched["mf_solve"]
    launched = adam_path(MFSolver, mf_pk, mf_inst, "MF-Adam (grad-descent)",
                         post_processor="grad-descent", g=MF_G)
    assert launched == only(mf_adam_solve=1), launched
    launches["mf_adam_solve"] = launched["mf_adam_solve"]

    for family, kname in (("langevin", "langevin_solve"),
                          ("pumped", "pumped_langevin_solve")):
        adam_kname = kname.replace("_solve", "_adam_solve")
        # P(1%) >= P(0.1%), which round 5 on a TPU put at 0.958 (Langevin)
        # and 0.994 (pumped) on this instance.
        best, launched = main_path(lgv_cls[family], lgv_pk[family],
                                   lgv_inst[family], f"{family} (grad-descent)",
                                   min_p1=0.90, post_processor="grad-descent")
        assert launched == only(**{kname: 3}), launched
        c = best.variables["problem_variables"]
        assert c.min().item() >= 0.0 and c.max().item() <= 1.0
        log(f"  quality reference: bench.py's {family} row on a TPU v5 lite in "
            f"round 5 gave P(0.1%)={TPU_R5_P01[family]:.3f}")
        launches[kname] = launched[kname]
        launched = adam_path(lgv_cls[family], lgv_pk[family], lgv_inst[family],
                             f"{family}-Adam (grad-descent)", adam=lgv_adam[family],
                             post_processor="grad-descent")
        assert launched == only(**{adam_kname: 1}), launched
        launches[adam_kname] = launched[adam_kname]

    # 7. kernels: time, bound and plain time at the main-path shape
    def timed(fn):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        out = fn()
        events[1].record()
        torch.cuda.synchronize()
        return out, events[0].elapsed_time(events[1])

    kernels = []
    main_hp = {"dl_solve": None, "dl_adam_solve": adam_hps[0.999],
               "mf_solve": None, "mf_adam_solve": adam_hps[0.999],
               "langevin_solve": None,
               "langevin_adam_solve": lgv_adam["langevin"].to_hyperparameters(),
               "pumped_langevin_solve": None,
               "pumped_langevin_adam_solve": lgv_adam["pumped"].to_hyperparameters()}
    replaces = {"dl_solve": "ccvm_tpu/ops/pallas_kernels.py:843",
                "dl_adam_solve": "ccvm_tpu/ops/pallas_kernels.py:977",
                "mf_solve": "ccvm_tpu/ops/pallas_kernels.py:1085",
                "mf_adam_solve": "ccvm_tpu/ops/pallas_kernels.py:1224",
                "langevin_solve": "ccvm_tpu/ops/pallas_kernels.py:488",
                "langevin_adam_solve": "ccvm_tpu/ops/pallas_kernels.py:585",
                "pumped_langevin_solve": "ccvm_tpu/ops/pallas_kernels.py:657",
                "pumped_langevin_adam_solve": "ccvm_tpu/ops/pallas_kernels.py:762"}
    sources = {"dl": "dl_solve.cu", "mf": "mf_solve.cu",
               "langevin": "langevin_solve.cu", "pumped": "langevin_solve.cu"}
    for kname, hp in main_hp.items():
        family = kname.split("_")[0]
        if family in lgv_cls:
            kernel, plain, extra = lgv_fns(family)
            params_at = functools.partial(lgv_params, family)
            kw = dict(extra, iterations=ITERATIONS, batch_size=MAIN_BATCH,
                      rng="popcount32", hp=hp)
            q, v = lgv_inst[family].q_matrix, lgv_inst[family].v_vector
            p = params_at(ITERATIONS)
        elif family == "mf":
            params_at = mf_params
            p = mf_params(ITERATIONS)
            kw = dict(iterations=ITERATIONS, batch_size=MAIN_BATCH,
                      pump_rate_flag=True, rng="popcount32", hp=hp)
            q, v = mf_inst.q_matrix, mf_inst.v_vector
            kernel, plain = mf_kernels.mf_solve, mf_kernels.mf_solve_reference
        else:
            params_at = params
            p = params(ITERATIONS)
            kw = dict(iterations=ITERATIONS, batch_size=MAIN_BATCH,
                      pump_rate_flag=True, pump_is_gt_one=tuned["pump"] > 1,
                      rng="popcount16", hp=hp)
            q, v = inst.q_matrix, inst.v_vector
            kernel, plain = dl_kernels.dl_solve, dl_kernels.dl_solve_reference
        times = []
        for rep in range(2):
            out, ms = timed(lambda: kernel(100, q, v, p, **kw))
            times.append(ms)
        assert all(torch.isfinite(x).all() for x in
                   (out if isinstance(out, tuple) else (out,)))
        if family in lgv_cls:
            plain_depth = ITERATIONS
            ref, plain_ms = timed(lambda: plain(100, q, v, p, **kw))
            growth = {ITERATIONS: (max_diff(out, ref), (out - ref).abs())}
            depths = (100, 1000)
        else:
            plain_depth = EARLIER_PLAIN_DEPTH
            growth = {}
            depths = (100, 1000) if family == "mf" else (EARLIER_PLAIN_DEPTH,)
        # Elementwise at every depth; the growth with depth is printed.
        for depth in depths:
            short = dict(kw, iterations=depth)
            pd = params_at(depth)
            out_d = kernel(100, q, v, pd, **short)
            ref_d, ms_d = timed(lambda: plain(100, q, v, pd, **short))
            if depth == plain_depth:
                plain_ms = ms_d
            growth[depth] = (max_diff(out_d, ref_d), None if family not in lgv_cls
                             else (out_d - ref_d).abs())
        log(f"phase 7 {kname} at the main-path shape, same noise: max |kernel"
            f" - plain| by depth { {d: e for d, (e, _) in sorted(growth.items())} }")
        for depth, (depth_err, diff) in sorted(growth.items()):
            deep = diff is not None and depth > 100
            if deep:
                over = int((diff > PARITY_TOL).sum())
                log(f"  {depth} steps: {over} of {diff.numel()} elements differ "
                    f"by more than {PARITY_TOL} (at most {LANGEVIN_DEEP_SHARE:g} "
                    f"of them may)")
                if over > LANGEVIN_DEEP_SHARE * diff.numel():
                    failures.append(f"{kname}: {over} elements over {PARITY_TOL} "
                                    f"after {depth} steps")
            hold(kname, kname, depth_err, f"phase 7 main-path shape, {depth} steps,",
                 tol=LANGEVIN_DEEP_TOL if deep else PARITY_TOL, defer=True)
        b_ms, b_by = bound_ms(kname, MAIN_BATCH, N, ITERATIONS, name)
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"ccvm_tpu_torch/csrc/{sources[family]}",
            "replaces": replaces[kname], "launches": launches[kname],
            "max_abs_err": max_err[kname], "ms": min(times),
            "plain_ms": plain_ms, "plain_iterations": plain_depth,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        log(f"phase 7 {kname}: kernel {min(times):.1f} ms (reps {times}), plain "
            f"{plain_ms:.1f} ms over {plain_depth} steps, bound {b_ms:.1f} ms "
            f"({b_by}) at batch {MAIN_BATCH}, N={N}, {ITERATIONS} steps")
    assert not failures, failures
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
