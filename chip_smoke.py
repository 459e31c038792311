#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ccvm_tpu_torch``) end to end on one card.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero without printing a result:

1. device: requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` does;
2. build: compiles every kernel specialisation the run launches from
   ``ccvm_tpu_torch/csrc`` (one nvcc each, all started together, in a
   thread while phase 5's plain workers start: their plain solves launch no
   kernel) into build/kernels, and, once it has ended, prints what ptxas
   reports of each solve kernel; for
   each DL, MF and Langevin-family specialisation the blocks per SM the card
   keeps resident (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and
   for the DL main path's two (3xTF32 tensor-core matvec, noise on) it holds
   no spill bytes, DL-Adam at 16 resident warps per SM and DL's grid at
   batch 65536 within 10% of whole waves, for the MF main path's three (MF,
   MF-Adam beta2 0.999 and 1.0, noise on) no spill bytes, at least 16 warps
   per SM and whole waves within 10%, and for every Langevin-family
   specialisation no spill bytes, with the main path's four (noise on) at
   the blocks per SM that the launch rule plans and whole waves within 10%;
3. noise off: each kernel against its plain PyTorch version on the card, on
   the scaled N=70 instance, batch 1024, 300 iterations (DL pump 12, DL-Adam
   with beta2 0.999 and 1.0; MF, Langevin and pumped Langevin with the tuned
   N=70 parameters, and their Adam variants with beta2 0.999 and 1.0); plus,
   for each of DL, MF, Langevin and pumped Langevin, a stacked two-instance
   launch against two serial launches, bit for bit;
4. noise on, same Philox words: kernel against plain, 100 iterations;
5. noise on, statistics: 15,000 iterations at batch 4096, kernel against
   plain (DL, DL-Adam, MF, Langevin, pumped Langevin at N=70; DL-Adam with
   DL's default transform, popcount16, on tools/tpu_validate.py's N=20
   instance with its DL parameters); every success probability within 5
   combined binomial sigmas + 0.01 (the band of tools/tpu_validate.py, held
   by its twin ``ccvm_tpu_torch/tools/validate.py``, whose eight cases on
   that tool's N=20 instance, all popcount32, are phase 17 (c)'s: their
   plain sides run in this phase's workers).  The readouts of MF and of the Langevin family go
   through their change of variables, grad-descent and
   ``compute_energy_readout64``, as the façades' do.  The plain solves at
   full depth, these and phase 7's, run in child processes of this script
   (``--plain-worker``, at most one fewer than the host's cores) beside
   phases 3-5, and all have been waited for before phase 6;
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
7. kernels: each solver kernel timed at the main-path shape and held
   against its plain version (same seed, so the same noise), for the JSON
   line printed after phase 8 with each kernel's launches, time, bound,
   plain time (and the steps it covers) and largest error against its
   plain version.  The bound of DL and DL-Adam (and of phase 8's dl_v2 and
   dl_v3) is that of their 3xTF32 tensor-core matvecs beside the CUDA cores'
   elementwise work, and their fp32 CUDA-core bound is a second column
   (``bound_fp32_ms``); MF, MF-Adam
   and the Langevin family, whose matvecs stay on the fp32 CUDA cores, have
   the fp32 bound and, beside it, the bound a 3xTF32 matvec would have
   (``bound_3xtf32_ms``) and a 4xTF32 one (``bound_4xtf32_ms``); each
   Adam kernel's time is held to ADAM_OVER_PLAIN x its plain kernel's (DL,
   Langevin, pumped).  The Langevin family is held elementwise
   after 100, 1,000 and 15,000 steps (past 100 steps at LANGEVIN_DEEP_TOL,
   with at most LANGEVIN_DEEP_SHARE of the elements over PARITY_TOL), MF
   after 100 and 1,000, DL after 1,000 (the 15,000-step errors of DL and MF
   from earlier runs are recorded in PERF.md); plain times are over 1,000
   steps; the difference by depth is printed, and every kernel is measured
   before a failed hold raises;
8. the DL race harness (``ccvm_tpu_torch/tools/kernel_experiments.py``,
   kernels of ``csrc/dl_variants.cu``) on the scaled N=70 instance with the
   DL tuned parameters: each v2 / v3 specialisation against its plain
   version noise off (batch 1024, 304 steps, and v3 over 300 for its tail)
   and noise on (104 steps, popcount1 and popcount2), a stacked launch
   against serial ones; every race row's kernel (production's too) against
   its plain version at the race's own shape (the harness's problem, batch
   1000, n 20, 296 steps, noise off and on); v2 and v3 success
   probabilities within the band of the production kernel's (batch 4096,
   15,000 steps); the DL kernel's CUDA-core matvec (the race row that
   production does not launch) against its plain version noise off at N=70;
   the race itself, ``race_rounds("cuda", ...)``, once at the harness's
   shape and MAIN_RACE_ROUNDS times at the main shape (row order reversed
   every other round; median, range and each knob's effect, the tensor-core
   matvec among them), with the launch counts zeroed before and read after;
   every v2 / v3 row's median at the main shape held below the CUDA-core
   dl_solve row's (the variants run production's tensor-core design), and a
   row that beats production beyond the rounds' spread printed as a finding
   with its knobs; and the dl_v2 / dl_v3 rows of the kernels line (time at
   the main shape against the 3xTF32 bound and the fp32 one, plain time and
   hold over 1,000 steps); the phase prints its seconds;
9. DL and DL-Adam at the other bundled sizes (N = 30, 40, 50, 60; the
   first .in of each examples/benchmarking_instances/SizeNN), batch 1000,
   noise off, 300 steps, each against its plain version at PARITY_TOL (their
   specialisations are built, and their registers, spills and blocks per SM
   printed, in phase 2);
10. the post-processors on the main path: ``DLSolver``, ``MFSolver`` and
   ``LangevinSolver(device="cuda")`` at N=70, batch 65536, 15,000
   iterations, each with ``post_processor`` "adam", "asgd", "bfgs" and
   "lbfgs" (timing "sync", so ``pp_time`` is the post-processor's own).
   Run once beside phase 5's workers, each refinement is held against the
   same post-processor on the CPU, on its input copied to the host, at
   PP_TOL (BFGS: on all but BFGS_ROW_SHARE of the rows, and the batch's
   mean energy to BFGS_MEAN_TOL), in a thread whose results are all read
   before phase 6; run again right after phase 6, with the launch counts
   zeroed before and read after: ``pp_time``, P(0.1%), P(1%) and
   best/optimal of each, every value finite, and BFGS raising no row's
   energy by more than BFGS_ENERGY_TOL;
11. ``bench_torch.py`` in a child process of this script (``chip_smoke.py
   --bench-child``, which runs its ``main`` with the launch counts zeroed
   before and printed after), waited for and killed if the run fails: its
   last stdout line parsed, ``bench.py``'s keys and metric name required
   and a positive value, its stderr tables printed; the kernels line gains
   each kernel's launches by phase (6, 10 and 11; 8 for the race's);
12. the façade features on every production kernel (run after phase 9;
   its plain solves, batch 1024, 2,000 steps, in the workers beside phases
   3-5), with the launch counts zeroed before and read after: (a) at the
   main shape, noise on, the segment launches of ``evolution_step_size``
   1,000's plan (16) end where the whole launch ends, bit for bit, both
   timed; (b) each kernel's samples of the plan of step 250 against its
   plain version's at PARITY_TOL (the DL family's through step 1,000, as
   deep as phase 7 holds DL; every sample's difference printed); (c) a
   per-column S drawn in [0.5 S, 1.5 S], noise off and on, against the
   plain version at PARITY_TOL (DL also at pump 0.9; the DL family held
   over P12_DL_HOLD_STEPS, its 2,000-step differences printed beside its
   scalar-S kernel's), and a constant S vector against the scalar-S kernel,
   bit for bit; (d) DL and
   DL-Adam with ``pump_ramp`` (2.0, 0.5) and (0.5, 1.0) against the plain
   version, and (1.0, 1.0) against None, bit for bit; (e) the four façades
   at the main shape with ``evolution_step_size`` 1,000 and a per-column S
   (DL with ``pump_ramp`` (2.0, 0.5), the others with grad-descent): wall,
   P(0.1%), P(1%) and the evolution file's rows, and the tuned S as a
   constant vector giving the scalar-S run's objective values; (f) phase
   7's scalar-S kernel times against those recorded in PERF.md; phase 2
   prints each of these builds' registers, spills and residency, and fails
   on a Langevin-family spill; the kernels line gains each kernel's
   phase-12 launches;
13. this slice's modules on the card (run after phase 12), with the launch
   counts zeroed before and read after: (a) ``sweep_solve`` of each façade
   over all 50 Size70 instances, scaled, batch 1000 each, the tuned N=70
   parameters, seed 0 (DL without a post-processor, MF, Langevin, pumped and
   Langevin-Adam with grad-descent): one stacked launch of 50,000
   trajectories each, instances 0, 1 and 49 held against ``solver(instance,
   seed=i)``: kernel outputs bit for bit; DL's objective values within the
   readout's rounding bound and its statistics equal; the others'
   refinements within SWEEP_PP_TOL and a gap statistic moved only by rows
   whose objectives are that close (counted); each sweep's wall,
   traj-iter/s, kernel time and mean P(0.1%) / P(1%), and DL's serial loop
   over the 50 instances beside its sweep; (b) ``LangevinSolver.tune`` as
   ``tools/tune_benchmark_set.py`` runs it (3 instances, its 9-candidate
   grid, batch 256, grad-descent, seed 7), stacked and serial: the same
   winner, every candidate's score fractions equal and its best objective
   within TUNE_BEST_RTOL; (c) ``checkpointed_solve`` of DL and
   Langevin-Adam at the main shape, a snapshot every 5,000 steps: equal to
   the whole launch bit for bit, and so is a run cut after its first
   snapshot and resumed; (d) phase 6's DL call under ``profiling.trace``:
   the window of its ``ccvm.call`` span, the device's busy time and idle
   share in it, the five longest device
   operations, and the traced kernel within TRACE_TOL of phase 6's CUDA
   events; the kernels line gains each kernel's phase-13 launches;
14. the entry-point scripts on the card (run after phase 13), with the launch
   counts zeroed before and read after: (a)
   ``examples/torch_port/benchmarking_study.py --sweep`` over all four
   solvers and every bundled size (all 50 instances of each, 300 files),
   batch 1000, 15,000 steps, the tuned parameters, seed 0 (no ``--plots``:
   the card's host has had no matplotlib; the CPU tests draw the plots):
   no instance failed or retried, one metadata row an instance, each
   (solver, size)'s wall, traj-iter/s, kernel time (CUDA events), the load
   time of its files and mean P(0.1%) / P(1%), and N=70's rows equal to
   phase 13 (a)'s sweeps (statistics and best objective); (b) the study's serial path
   (``run_resilient``, seeds 0 + idx) for DL at N=70, each instance's
   P(0.1%), P(1%) and best objective equal to (a)'s, its wall beside the
   sweep's; (c) the four single-instance examples, each Solution finite and
   within tools/tpu_validate.py's band of the same script on the CPU (the
   plain versions, the same seed), and the plot example's solve to its
   metadata; (d) the tuner twin
   (``ccvm_tpu_torch/tools/tune_benchmark_set.py``) on the four solvers at
   Size70, batch 256: each winner and wall, the table's shape, Langevin's
   winner equal to phase 13 (b)'s and examples/tuned_parameters.json
   unchanged; (e) a Langevin sweep with grad-descent under ``timing="async"``
   and ``"sync"``: under async the solve clock at least the kernel's CUDA-event
   time and ``pp_time`` under ASYNC_PP_SHARE of it; phase 2 builds and
   reports every specialisation the study launches; the kernels line gains
   each kernel's phase-14 launches;
15. a (batch, n) S whose rows differ (run after phase 14), with the launch
   counts zeroed before and read after: (a) each production kernel's
   per-element build (DL also at pump 0.9, S in its drift) against its
   plain version at PARITY_TOL, batch 1024, P15_STEPS steps (the DL family
   at pump 0.9 over P12_DL_HOLD_STEPS'), noise off and on, and at the main
   shape the scalar-S, per-column and per-element whole launches timed by
   CUDA events in P15_ROUNDS alternating rounds; (b) equal rows through the
   per-element build against the per-column build, bit for bit; (c) MF's
   per-column build, which divides by S_j with its reciprocal, against its
   plain version bit for bit (phase 12's S); (d) the four façades at the
   main shape with such an S (DL with ``pump_ramp`` (2.0, 0.5), the others
   with grad-descent): wall, kernel time against phase 6's scalar-S kernel,
   P(0.1%), P(1%), every objective value finite; phase 2 builds these
   specialisations and prints their registers, spills and residency; the
   kernels line gains each kernel's phase-15 launches;
16. meshes on one card (run after phase 15, in a child process of this
   script, ``--mesh-worker``, waited for and killed if the run fails, so
   that its process group ends with it), with the launch counts of the
   whole-solve kernels and of the one-step builds zeroed before (b) and read
   after (d): (a) ``multihost.initialize`` of a one-rank NCCL world (twice:
   idempotent), ``make_mesh(1, tp=1)``, ``global_batch_mesh()`` and
   ``process_allgather``; (b) the four façades' main paths (phase 6's
   instance, parameters and post-processors, batch 65536, 15,000 steps)
   with ``mesh=`` against ``mesh=None``, bit for bit, each wall the better
   of two in turns beside phase 6's; (c) each family's tensor-parallel
   engine (``parallel/tp.py``, plain and Adam) against its whole-solve
   kernel, noise off, P16_HOLD_STEPS steps at the main shape, at
   PARITY_TOL; DL's engine at full depth, noise on, timed; each one-step
   build (``ops/build.py`` ``ext``) against its plain step over
   P16_STEP_HOLD steps on the same Philox words (in units of max(1, |x|)),
   and timed over P16_TIMED launches beside its plain step and its bound;
   a DL TP step's matmul, reduce-scatter and step launch, each timed alone;
   (d) ``sweep_solve`` of the 50 Size70 instances over the mesh against
   without one, bit for bit; (e) every whole-solve and one-step wrapper
   entering ``torch.cuda.device`` of its tensors' card around its launch;
   the kernels line gains each kernel's phase-16 launches and the eight
   one-step builds' rows (phase 2 builds them and prints their registers);
17. the native host I/O library and this slice's tools (run after phase 16),
   with the launch counts zeroed before and read after (c): (a) the library
   (``ccvm_tpu_torch/native/ccvm_io.cpp``, built with g++ in phase 2 at its
   first use, its compiler line printed): every bundled instance file (the
   300 of Size20..Size70 and the single test instance) loaded through the
   native tokenizer and through ``fast_parse_matrix_reference``, equal bit
   for bit, the median host ms a load both ways (phase 14 (a)'s loads line
   reads the native path, beside the NumPy tokenizer's recorded loads);
   (b) an evolution run of each façade (DL, MF, Langevin, pumped) at N=70,
   batch P17_BATCH, a sample every P17_STEP steps: the file equal, byte for
   byte, to ``format_rounded_reference``'s text of the same samples; (c)
   ``ccvm_tpu_torch.tools.validate`` at its defaults, its eight cases' plain
   sides run in the phase-5 workers, every gap within band; (d)
   ``breakdown --family dl``'s rows at P17_I1 and P17_I2 steps (its probe
   builds, made in phase 2, are not kernels of a path); the kernels line
   gains each kernel's phase-17 launches;
18. the last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import os
import pickle
import subprocess
import sys
import threading
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
SIZE70 = os.path.join(REPO, "examples", "benchmarking_instances", "Size70")
INSTANCE = os.path.join(SIZE70, "tuningH070-100-0.in")
SECOND_INSTANCE = os.path.join(SIZE70, "tuningH070-100-1.in")
TUNED = os.path.join(REPO, "examples", "tuned_parameters.json")

N = 70
# The other bundled sizes (examples/benchmarking_instances/SizeNN), whose DL
# specialisations phase 9 holds and bench_torch.py times; N=20 is the race
# harness's, held in phase 8.
BUNDLED_SIZES = (30, 40, 50, 60)
MAIN_BATCH = 65536
ITERATIONS = 15000
G = 0.05  # DL
MF_G = 0.01  # MFSolver's default, as bench.py's MF row runs it
# Kernel against plain: fp32 sum order differs (cuBLAS against the kernel's
# FMA chain, or the tensor cores' products) and nvcc contracts multiply-adds
# where a kernel does not spell them out, so the two agree to round-off, not
# bit for bit: at most PARITY_TOL (1e-4, ccvm_tpu_torch/tools/tc_model.py,
# whose models of other matvecs are read against it; imported in main).
# The Langevin family beyond 100 steps at the main-path shape: the drift is
# linear in c, so a round-off difference on an element inside the box grows
# along the unstable directions of x.Q.x until the clamp at +-S stops it.
# Measured on an NVIDIA H100 80GB HBM3 at 700 W with the family's first
# kernels (fp32, multiply-adds contracted): at most 6e-7 after 100 steps,
# 2.2e-4 after 1,000 and 7.3e-4 after 15,000, on at most 9 of the 4.6
# million elements.  So past 100 steps every difference stays under
# LANGEVIN_DEEP_TOL and at most LANGEVIN_DEEP_SHARE of the elements exceed
# PARITY_TOL.  (The redesigned plain kernels equal their plain versions bit
# for bit; the Adam kernels differ by the hardware's square root and
# division, PERF.md.)
LANGEVIN_DEEP_TOL = 2e-3
LANGEVIN_DEEP_SHARE = 1e-4
# Phase 7 holds every solver kernel against its plain version over this many
# steps at the main-path shape, and times the plain versions over them (each
# plain main-shape solve at full depth costs a minute or more of host time);
# the kernels are timed at full depth.
EARLIER_PLAIN_DEPTH = 1000
# Phase 8 races the main shape this many times, the row order reversed every
# other round, and calls a knob's effect resolved only beyond the rounds'
# spread; a single race moved one row by 6% between two calls.
MAIN_RACE_ROUNDS = 5
# Phase 8 holds each race row's kernel at the harness's shape over this many
# steps: a multiple of 8 (v2's unroll) that leaves v3 unroll 16 a tail of 8.
HARNESS_HOLD_STEPS = 296
# fp32 operations per element of (batch, N) state per step, beside the
# 2*N of each matvec, counted from csrc/dl_solve.cu, csrc/mf_solve.cu and
# csrc/langevin_solve.cu (drift, schedules, noise scaling, divisions, clips,
# Adam; Philox's integer work is not counted).  DL does two matvecs a step,
# the others one.  The Langevin family, counted as what the plain version's
# step needs (dynamics/langevin.py, dynamics/pumped_langevin.py, noise on):
# the draw (popcount - 16) / sqrt(8) (1: the subtraction is integer work),
# x = c scale + (u+l)/2 (2), the clamp (2); Langevin's feedback -(x@Q + V)
# scale (2: the negation folds into the multiply) and update c + dt fs g +
# sigma sqrt(dt) w (4): 11; pumped's feedback -(x@Q) scale - V scale (2, V
# scale per column), its pump drift (k1 - c^2) c (3) and update c + dt
# (drift + fs g) + sigma sqrt(dt) w (6): 16; Adam adds its two moments (7),
# their bias corrections (2), the square root, epsilon, alpha mhat and the
# division (4) and the add (1): 14.  MF (csrc/mf_solve.cu, noise on; what the plain version's
# step needs): the draw's scaling and its division by sqrt(dt), once (5;
# the kernel recomputes them after the matvec to save registers, work the
# function does not need), mu_tilde, its clip and x
# (9), mu^2, the feedback with its division by S and fs (7), mu's drift,
# diffusion and update with the clip (12), sigma's drift and update (11):
# 44; Adam adds its two moments, their bias corrections, the square root,
# the division and the add (18).
# The race harness's variants (csrc/dl_variants.cu, popcount1): v2 rebuilds
# x and scales the feedback twice, v3 does neither and sums c^2 + s^2 once.
ELEMENTWISE_FLOPS = {"dl_solve": 40, "dl_adam_solve": 64,
                     "mf_solve": 44, "mf_adam_solve": 62,
                     "langevin_solve": 11, "langevin_adam_solve": 25,
                     "pumped_langevin_solve": 16,
                     "pumped_langevin_adam_solve": 30,
                     "dl_v2": 42, "dl_v3": 34}
MATVECS = {"dl_solve": 2, "dl_adam_solve": 2, "mf_solve": 1, "mf_adam_solve": 1,
           "langevin_solve": 1, "langevin_adam_solve": 1,
           "pumped_langevin_solve": 1, "pumped_langevin_adam_solve": 1,
           "dl_v2": 2, "dl_v3": 2}
OUTPUTS = {"dl_solve": 2, "dl_adam_solve": 2, "mf_solve": 3, "mf_adam_solve": 3,
           "langevin_solve": 1, "langevin_adam_solve": 1,
           "pumped_langevin_solve": 1, "pumped_langevin_adam_solve": 1,
           "dl_v2": 2, "dl_v3": 2}
KERNELS = tuple(MATVECS)
# The TPU kernel each production kernel replaces.
REPLACES = {"dl_solve": "ccvm_tpu/ops/pallas_kernels.py:843",
            "dl_adam_solve": "ccvm_tpu/ops/pallas_kernels.py:977",
            "mf_solve": "ccvm_tpu/ops/pallas_kernels.py:1085",
            "mf_adam_solve": "ccvm_tpu/ops/pallas_kernels.py:1224",
            "langevin_solve": "ccvm_tpu/ops/pallas_kernels.py:488",
            "langevin_adam_solve": "ccvm_tpu/ops/pallas_kernels.py:585",
            "pumped_langevin_solve": "ccvm_tpu/ops/pallas_kernels.py:657",
            "pumped_langevin_adam_solve": "ccvm_tpu/ops/pallas_kernels.py:762"}
# Published dense fp32 (non-tensor-core) peaks, memory rates and dense TF32
# tensor-core peaks of H100 parts, by a substring of the nvidia-smi name
# (NVIDIA data sheets; the TF32 rates are half the sparse ones quoted).
PEAKS = (("PCIe", 51.2e12, 2.0e12, 378e12), ("NVL", 60.0e12, 3.9e12, 417.5e12),
         ("H100", 66.9e12, 3.35e12, 494.7e12))
# Kernels whose matvecs run as 3xTF32 on the tensor cores (three TF32
# products per fp32 product) beside their elementwise work on the fp32 CUDA
# cores.
TENSOR_CORE_KERNELS = ("dl_solve", "dl_adam_solve", "dl_v2", "dl_v3")
# Each Adam kernel's time against its plain kernel's at the main-path shape
# (phase 7): at most this.
ADAM_OVER_PLAIN = 1.5
ADAM_PAIRS = (("dl_adam_solve", "dl_solve"), ("langevin_adam_solve", "langevin_solve"),
              ("pumped_langevin_adam_solve", "pumped_langevin_solve"))
# bench.py's MF, Langevin and pumped rows on a TPU v5 lite in round 5
# (BENCH_r05.json): quality references for the port, not speed targets.
TPU_R5_P01 = {"mf": 1.000, "langevin": 0.958, "pumped": 0.994}
# Phase 10 holds each post-processor's refinement on the card against the
# same post-processor on the CPU at the tolerance of its CPU tests against
# the JAX package (tests/test_torch_post_processors.py): float32 products
# summed in another order, over 1 (Adam, ASGD, L-BFGS) or 50 (BFGS) steps.
PP_TOL = {"adam": 1e-5, "asgd": 1e-5, "bfgs": 1e-4, "lbfgs": 1e-5}
# ... except BFGS on this share of the rows: its 50 L-BFGS iterations
# compare float32 energies in their Armijo tests and step rejections, and
# where a test falls within round-off the card and the CPU take different
# steps, so a row can end at another point of a non-convex objective (the
# first runs on an NVIDIA H100 at 700 W: 562 and 1,100 of 65,536 rows of
# MF's and Langevin's refinements over 1e-4, up to 1.99 apart, the card's
# energy the lower on 54-56% of them).  The batch's mean energy is held
# instead, to BFGS_MEAN_TOL of its size.
BFGS_ROW_SHARE = 0.05
BFGS_MEAN_TOL = 1e-5
# BFGS may not raise any row's energy by more than this (float64 energies of
# its input and output in [0, 1]).
BFGS_ENERGY_TOL = 1e-4
# Phase 12: the segment launch, a per-column S and DL's ramps, batch 1024,
# 2,000 steps, a sample every 250th step; the main shape's plan of step 1,000
# (16 segments); DL's two generalised ramps; plain solves in this many
# worker processes.
P12_BATCH, P12_STEPS, P12_STEP, P12_MAIN_STEP = 1024, 2000, 250, 1000
P12_RAMPS = ((2.0, 0.5), (0.5, 1.0))
P12_GROUPS = 6
# The DL family's elementwise holds in phase 12 reach as deep as phase 7's
# (EARLIER_PLAIN_DEPTH): its 3xTF32 matvec, and Adam's hardware square root
# and division, part from the plain version by round-off that noise-on
# DL-Adam grows past 1e-4 by step 1,751 (1.0e-3 at 2,000; segments equal
# the whole launch, so its scalar-S kernel alike); and DL at pump 0.9 (fs
# 200, S_d = S) only over 50 steps: it is chaotic (its scalar-S kernel
# parts from the plain version by 5.4e-3 over 2,000 steps, noise on, and
# the per-column build by 1.6e-4 within 100).  The 2,000-step differences
# are printed beside (the scalar-S kernel's with the noise on); the
# numbers are phase 12's on an NVIDIA H100 80GB HBM3 at 700 W.
P12_DL_HOLD_STEPS = {"dl_solve": 1000, "dl_adam_solve": 1000,
                     "dl_solve pump 0.9": 50, "dl_adam_solve pump 0.9": 1000}
# The scalar-S kernels' times at the main shape recorded in PERF.md section 6
# before the segment and per-column builds were added (NVIDIA H100 80GB HBM3
# at 700 W), which phase 7's are read against.
RECORDED_MS = {"dl_solve": 392.5, "dl_adam_solve": 475.4, "mf_solve": 478.2,
          "mf_adam_solve": 561.3, "langevin_solve": 308.8,
          "langevin_adam_solve": 433.2, "pumped_langevin_solve": 321.2,
          "pumped_langevin_adam_solve": 444.6}
# ... each may be at most this much slower here: a slowdown of the scalar
# path's code (a spill, a lost block per SM) costs more, while cards of one
# model at one power limit differ by about 1% (the recorded runs spread 0.8%).
RECORDED_SLOWER = 0.03
# Phase 13: sweeps of every Size70 instance at benchmarking_study.py's batch,
# tools/tune_benchmark_set.py's Langevin tuning (its defaults, grid, batch,
# three instances and seed) and the checkpoint period at the main shape.
P13_BATCH = 1000
P13_HELD = (0, 1, 49)
P13_TUNE_BASE = {"dt": 0.002, "S": 0.5, "sigma": 0.5, "feedback_scale": 1.0}
P13_TUNE_GRID = {"sigma": [0.25, 0.5, 1.0], "feedback_scale": [0.5, 1.0, 2.0]}
P13_TUNE_BATCH = 256
P13_CKPT_EVERY = 5000
# A sweep's grad-descent runs as one batched product over the instances,
# cuBLAS another kernel than a serial solve's: its refinement is held to this
# (values in [0, 1]), and so is the relative difference of a row's objective
# where it moves a gap statistic; tuning's best objective (the sum over three
# instances) to TUNE_BEST_RTOL.
SWEEP_PP_TOL = 1e-5
TUNE_BEST_RTOL = 1e-6
# The DL kernel's traced time against its CUDA-event time in phase 6.
TRACE_TOL = 0.05
# Phase 14: the entry-point scripts (examples/torch_port/ and the tuner twin)
# at their users' sizes: the study over every bundled size (all 50 instances
# of each), batch 1000, 15,000 steps, seed 0, the tuned parameters; the
# tuner at Size70 (its three instances, batch 256).
SCRIPTS = os.path.join(REPO, "examples", "torch_port")
STUDY_SIZES = (20, 30, 40, 50, 60, 70)
STUDY_SOLVERS = ("dl", "mf", "langevin", "pumped")
STUDY_LABELS = {"dl": "DL", "mf": "MF", "langevin": "Langevin", "pumped": "pumped"}
P14_TUNE_BATCH = 256
# An async sweep's pp_time (the refinement) against its kernel's time: under
# this share.
ASYNC_PP_SHARE = 0.1
# The optimality gaps (%) of Solution's statistics.
GAP_THRESHOLDS = (0.1, 1.0, 2.0, 3.0, 4.0, 5.0, 10.0)
# Phase 15: a (batch, n) S whose rows differ on every production kernel, its
# holds at batch 1024 over this many steps (the DL family at pump 0.9 over
# P12_DL_HOLD_STEPS'), and the main shape's launches of the scalar-S,
# per-column and per-element builds timed in this many rounds, the order
# reversed every other round.
P15_BATCH, P15_STEPS, P15_ROUNDS = 1024, 300, 2
P15_LABELS = ("dl_solve", "dl_adam_solve", "mf_solve", "mf_adam_solve", "langevin_solve",
              "langevin_adam_solve", "pumped_langevin_solve", "pumped_langevin_adam_solve",
              "dl_solve pump 0.9", "dl_adam_solve pump 0.9")
# Phase 16: meshes on one card, in a child process (``--mesh-worker``) that
# joins a one-rank NCCL world.  Each family's tensor-parallel engine is held
# against its whole-solve kernel over P16_HOLD_STEPS steps with the noise
# off; each one-step build against its plain step over P16_STEP_HOLD steps
# on the same Philox words; each piece of a TP step (matmul, reduce-scatter,
# step launch) timed over P16_TIMED launches; the DL engine run at full depth;
# the sweep over the 50 Size70 instances at phase 13's batch.
P16_HOLD_STEPS = 300
P16_STEP_HOLD = 10
P16_TIMED = 500
MESH_TIMEOUT_S = 600
# The one-step builds (CCVM_EXT) of the three templates: name -> (family,
# Adam, the whole-solve kernel whose template and TPU kernel it shares).
STEP_KERNELS = {
    "dl_step": ("dl", False, "dl_solve"), "dl_adam_step": ("dl", True, "dl_adam_solve"),
    "mf_step": ("mf", False, "mf_solve"), "mf_adam_step": ("mf", True, "mf_adam_solve"),
    "langevin_step": ("langevin", False, "langevin_solve"),
    "langevin_adam_step": ("langevin", True, "langevin_adam_solve"),
    "pumped_langevin_step": ("pumped", False, "pumped_langevin_solve"),
    "pumped_langevin_adam_step": ("pumped", True, "pumped_langevin_adam_solve"),
}
# A step build's arrays a step (each (batch, n) element): matvec inputs (read
# as the scattered matvec, written as the next input), state arrays read and
# written (MF reads mu and sigma, and Adam's moments, and writes mu_tilde
# too).
STEP_ARRAYS = {"dl": (2, (2, 6), (2, 6)), "mf": (1, (2, 4), (3, 5)),
               "langevin": (1, (1, 3), (1, 3)), "pumped": (1, (1, 3), (1, 3))}
# Phase 11 waits this long for bench_torch.py.
BENCH_TIMEOUT_S = 400
# Phase 14 (a)'s loads as recorded in PERF.md section 5 with the NumPy
# tokenizer (seconds, share of the study's wall; NVIDIA H100 80GB HBM3 at
# 700 W), which the native tokenizer's are printed beside.
NUMPY_LOADS_S, NUMPY_LOADS_SHARE = 1.336, 0.183
# Phase 17 (b): each façade's evolution run at N=70, this batch, a sample
# every P17_STEP steps; (d): breakdown --family dl's steps.
P17_BATCH = 4096
P17_STEP = 500
P17_I1, P17_I2 = 1000, 4000
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "device_amortised_rate")


def log(msg):
    print(msg, flush=True)


def scalar_saturations(tuned_all):
    """Each family's scalar S at N=70: DL's 1, the others' tuned."""
    return {"dl": 1.0, "mf": tuned_all["mf"][str(N)]["S"],
            "langevin": tuned_all["langevin"][str(N)]["S"],
            "pumped": tuned_all["pumped"][str(N)]["S"]}


def phase12_saturations(tuned_all):
    """Phase 12's per-column S of each family: drawn from seed 12 in [0.5 S,
    1.5 S] around its scalar S (tests/test_torch_mf_redesign.py proves MF's
    divisions by them)."""
    import numpy as np

    draw = np.random.RandomState(12)
    return {f: (s0 * draw.uniform(0.5, 1.5, N)).astype(np.float32)
            for f, s0 in scalar_saturations(tuned_all).items()}


def first_instance(n):
    """The first .in of examples/benchmarking_instances/SizeNN."""
    folder = os.path.join(REPO, "examples", "benchmarking_instances", f"Size{n}")
    return os.path.join(folder, sorted(f for f in os.listdir(folder)
                                       if f.endswith(".in"))[0])


def energies64(x, q, v):
    """0.5 x.Q.x + V.x per row, in float64."""
    x, q, v = x.double(), q.double(), v.double()
    return 0.5 * ((x @ q) * x).sum(-1) + x @ v


def card_peaks(name):
    for key, flops, bw, tf32 in PEAKS:
        if key in name:
            return flops, bw, tf32
    raise RuntimeError(f"no published fp32 peak known for {name!r}")


def bound_ms(kernel, batch, n, iterations, name, tensor_cores=None, tf32_passes=3):
    """Least time for the work: operations over the peak of the units that
    run them, or bytes (Q and V read once, each output written once) over
    the memory rate.  With ``tensor_cores`` (by default the kernels of
    TENSOR_CORE_KERNELS) the matvecs run as ``tf32_passes`` TF32 products
    per fp32 product (3xTF32; 4xTF32 adds Q's residual) at the dense TF32
    peak and the elementwise work at the fp32 peak; the two pipes run side
    by side, so the operations take the longer of the two.  Otherwise every
    operation runs at the fp32 peak."""
    flops_peak, bw, tf32_peak = card_peaks(name)
    if tensor_cores is None:
        tensor_cores = kernel in TENSOR_CORE_KERNELS
    matvec = 2 * MATVECS[kernel] * batch * n * n * iterations
    elementwise = ELEMENTWISE_FLOPS[kernel] * batch * n * iterations
    if tensor_cores:
        t_ops = max(tf32_passes * matvec / tf32_peak, elementwise / flops_peak)
    else:
        t_ops = (matvec + elementwise) / flops_peak
    t_bytes = 4 * (n * n + n + OUTPUTS[kernel] * batch * n) / bw
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def plain_solve(module, function, seed, q, v, params, kwargs):
    """A worker process's job: one plain solve (``function`` of ``module``)
    on the card from numpy Q and V; its outputs as numpy arrays, and its
    seconds on the worker's clock."""
    import importlib

    import torch

    fn = getattr(importlib.import_module(module), function)
    t = time.perf_counter()
    out = fn(seed, torch.from_numpy(q).cuda(), torch.from_numpy(v).cuda(), params,
             **kwargs)
    return tuple(x.cpu().numpy() for x in flat(out)), time.perf_counter() - t


def flat(out):
    """The tensors of a (nested) tuple of outputs, in order, None left out."""
    if isinstance(out, (tuple, list)):
        return [y for x in out for y in flat(x)]
    return [] if out is None else [out]


def stop(proc):
    """Kill ``proc`` if it still runs, and wait for it."""
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def plain_worker():
    """``chip_smoke.py --plain-worker``: one ``plain_solve``, a list of
    them (``("many", jobs)``), or a call of a function of the package
    (``("call", module, function, kwargs)``), its arguments pickled on
    standard input and its result pickled on standard output (anything else
    the solve prints goes to standard error)."""
    import importlib

    job = pickle.load(sys.stdin.buffer)
    with os.fdopen(os.dup(1), "wb") as out:
        os.dup2(2, 1)
        if job[0] == "many":
            result = [plain_solve(*j) for j in job[1]]
        elif job[0] == "call":
            sys.path.insert(0, REPO)
            result = getattr(importlib.import_module(job[1]), job[2])(**job[3])
        else:
            result = plain_solve(*job)
        pickle.dump(result, out)


def launch_counters():
    """Each kernel's launch count: (wrapper, attribute) by kernel name."""
    from ccvm_tpu_torch.ops import (dl_kernels, dl_variant_kernels,
                                    langevin_kernels, mf_kernels)

    return {
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
        "dl_v2": (dl_variant_kernels.dl_v2, "launches"),
        "dl_v3": (dl_variant_kernels.dl_v3, "launches"),
    }


def bench_child():
    """``chip_smoke.py --bench-child``: ``bench_torch.py``'s ``main`` with
    every launch count zeroed just before, and the counts read just after
    printed on standard error as the last line (``# launches {...}``)."""
    import importlib.util

    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        "bench_torch", os.path.join(REPO, "bench_torch.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    counters = launch_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    bench.main()
    launched = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    print(f"# launches {json.dumps(launched)}", file=sys.stderr, flush=True)


def step_counters():
    """Each one-step build's launch count: (wrapper, attribute) by name."""
    from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels

    wrapper = {"dl": dl_kernels.dl_step, "mf": mf_kernels.mf_step,
               "langevin": langevin_kernels.langevin_step,
               "pumped": langevin_kernels.pumped_langevin_step}
    prefix = {"dl": "dl", "mf": "mf", "langevin": "langevin", "pumped": "pumped"}
    return {name: (wrapper[f], f"{prefix[f]}{'_adam' if adam else ''}_launches")
            for name, (f, adam, _) in STEP_KERNELS.items()}


def mesh_worker(arg):
    """``chip_smoke.py --mesh-worker '<json>'``: phase 16 in a child process,
    so that its process group cannot outlive it.  ``arg`` carries phase 6's
    walls and kernel times and the card's name.  Logs each part and, last,
    ``# mesh {...}``: the launch counts of its main path (the DP façades,
    the TP engines, the sweep), the kernels line's rows of the one-step
    builds and the failures."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from ccvm_tpu_torch import (AdamParameters, DLSolver, LangevinSolver, MFSolver,
                                ProblemInstance, PumpedLangevinSolver)
    from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels
    from ccvm_tpu_torch.parallel import (global_batch_mesh, initialize, make_mesh,
                                         multihost, sweep_solve, tp)
    from ccvm_tpu_torch.runtime import fp32_matmul
    from ccvm_tpu_torch.tools.tc_model import PARITY_TOL

    given = json.loads(arg)
    name = given["name"]
    failures = []
    t16 = time.perf_counter()

    # (a) a one-rank NCCL world and its meshes
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize(f"localhost:{port}", 1, 0, device="cuda")
    initialize(f"localhost:{port}", 1, 0, device="cuda")  # idempotent
    mesh = make_mesh(1, tp=1)
    batch_mesh = global_batch_mesh()
    log(f"phase 16 (a) {dist.get_backend()} world of {dist.get_world_size()}: "
        f"make_mesh(1, tp=1) {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
        f"({mesh.device_type}), global_batch_mesh() "
        f"{dict(zip(batch_mesh.mesh_dim_names, batch_mesh.shape))}, "
        f"process_allgather(7) {multihost.process_allgather(7).tolist()}")
    assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"

    with open(TUNED) as f:
        tuned_all = json.load(f)
    tuned = {f: tuned_all[f][str(N)] for f in ("dl", "mf", "langevin", "pumped")}
    classes = {"dl": DLSolver, "mf": MFSolver, "langevin": LangevinSolver,
               "pumped": PumpedLangevinSolver}
    calls = {"dl": {}, "mf": {"post_processor": "grad-descent", "g": MF_G},
             "langevin": {"post_processor": "grad-descent"},
             "pumped": {"post_processor": "grad-descent"}}

    def instance(family):
        inst = ProblemInstance(device="cuda", instance_type="tuning", file_path=INSTANCE)
        inst.scale_coefs(classes[family](device="cuda").get_scaling_factor(inst.q_matrix))
        return inst

    whole = launch_counters()
    steps_ = step_counters()
    for fn, attr in list(whole.values()) + list(steps_.values()):
        setattr(fn, attr, 0)

    # (b) the four façades' main paths over the mesh against mesh=None
    for family, cls in classes.items():
        inst = instance(family)
        sols, walls = {}, {"mesh": [], "none": []}
        fac = {}
        for key, m in (("mesh", mesh), ("none", None)):
            fac[key] = cls(device="cuda", batch_size=MAIN_BATCH, mesh=m)
            fac[key].parameter_key = {N: dict(tuned[family], iterations=ITERATIONS)}
        fac["mesh"](inst, seed=1, **calls[family])  # warm-up
        for key in ("mesh", "none", "none", "mesh"):
            t = time.perf_counter()
            sols[key] = fac[key](inst, seed=1, **calls[family])
            walls[key].append(time.perf_counter() - t)
        walls = {k: min(w) for k, w in walls.items()}
        same = (torch.equal(sols["mesh"].variables["problem_variables"],
                            sols["none"].variables["problem_variables"])
                and np.array_equal(sols["mesh"].objective_values,
                                   sols["none"].objective_values))
        log(f"phase 16 (b) {family} façade, batch {MAIN_BATCH}, {ITERATIONS} steps: "
            f"mesh wall {walls['mesh']:.3f} s, mesh=None {walls['none']:.3f} s (the better of "
            f"two each, in turns; phase 6's "
            f"best wall {given['walls'][family]:.3f} s); the solution "
            f"{'equals' if same else 'DIFFERS FROM'} mesh=None's bit for bit; "
            f"P(0.1%)={sols['mesh'].solution_performance['optimal']:.4f}")
        if not same:
            failures.append(f"phase 16 (b) {family}: the mesh's solution differs")

    # (c) the TP engines: noise off against the whole-solve kernel
    hp = AdamParameters(beta2=0.999).to_hyperparameters()
    solvers = {f: classes[f](device="cuda", batch_size=MAIN_BATCH) for f in classes}
    insts = {f: instance(f) for f in classes}
    for f in classes:
        solvers[f].solution_bounds = insts[f].solution_bounds

    def params(family, iterations):
        t = tuned[family]
        s = solvers[family]
        if family == "dl":
            return s._make_params(t["pump"], 1.0, t["dt"], t["noise_ratio"],
                                  t["feedback_scale"], G, iterations)
        if family == "mf":
            return s._make_params(t["pump"], t["S"], t["dt"], t["j"], t["feedback_scale"],
                                  MF_G, iterations)
        if family == "langevin":
            return s._make_params(t["S"], t["dt"], t["sigma"], t["feedback_scale"])
        return s._make_params(t["pump"], t["S"], t["dt"], t["sigma"], t["feedback_scale"],
                              iterations)

    flags = {"dl": {"pump_rate_flag": True, "pump_is_gt_one": tuned["dl"]["pump"] > 1},
             "mf": {"pump_rate_flag": True}, "langevin": {},
             "pumped": {"pump_rate_flag": True}}
    rngs = {"dl": "popcount16", "mf": "popcount32", "langevin": "popcount32",
            "pumped": "popcount32"}
    engines = {"dl": tp.dl_solve, "mf": tp.mf_solve, "langevin": tp.langevin_solve,
               "pumped": tp.pumped_langevin_solve}
    wholes = {"dl": dl_kernels.dl_solve, "mf": mf_kernels.mf_solve,
              "langevin": langevin_kernels.langevin_solve,
              "pumped": langevin_kernels.pumped_langevin_solve}
    engine_err = {}
    for sname, (family, adam, kname) in STEP_KERNELS.items():
        q, v = insts[family].q_matrix, insts[family].v_vector
        p = params(family, P16_HOLD_STEPS)
        kw = dict(iterations=P16_HOLD_STEPS, batch_size=MAIN_BATCH, noise_scale=0.0,
                  rng=rngs[family], hp=hp if adam else None, **flags[family])
        t = time.perf_counter()
        ours = engines[family](mesh, 11, q, v, p, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        theirs = wholes[family](11, q, v, p, **kw)
        ours = ours if isinstance(ours, tuple) else (ours,)
        theirs = theirs if isinstance(theirs, tuple) else (theirs,)
        err = max((a - b).abs().max().item() for a, b in zip(ours, theirs))
        engine_err[sname] = err
        log(f"phase 16 (c) {sname}: the TP engine against {kname}, noise off, "
            f"{P16_HOLD_STEPS} steps at batch {MAIN_BATCH}: max |diff| {err:.3g} "
            f"(tolerance {PARITY_TOL}); engine wall {wall:.3f} s")
        if not err <= PARITY_TOL:
            failures.append(f"phase 16 (c) {sname}: TP engine {err} > {PARITY_TOL}")

    # The DL engine at full depth, noise on, timed.
    q, v = insts["dl"].q_matrix, insts["dl"].v_vector
    p_full = params("dl", ITERATIONS)
    dl_kw = dict(iterations=ITERATIONS, batch_size=MAIN_BATCH, rng="popcount16",
                 **flags["dl"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    c_tp, s_tp = tp.dl_solve(mesh, 21, q, v, p_full, **dl_kw)
    torch.cuda.synchronize()
    engine_wall = time.perf_counter() - t
    assert torch.isfinite(c_tp).all()
    c_whole, s_whole = dl_kernels.dl_solve(21, q, v, p_full, **dl_kw)
    log(f"phase 16 (c) dl TP engine, noise on, {ITERATIONS} steps at batch {MAIN_BATCH}: "
        f"wall {engine_wall:.3f} s, {1e3 * engine_wall / ITERATIONS:.4f} ms a step, "
        f"against the whole-solve kernel's {given['dl_kernel_ms']:.1f} ms (phase 6, CUDA "
        f"events); max |engine - whole| after {ITERATIONS} steps: c (clamped) "
        f"{(c_tp - c_whole).abs().max().item():.3g}, s {(s_tp - s_whole).abs().max().item():.3g} "
        f"(no hold: DL grows round-off differences, phase 7 holds it over "
        f"{EARLIER_PLAIN_DEPTH})")

    # (d) the sweep over the mesh against mesh=None
    files = sorted(f for f in os.listdir(SIZE70) if f.endswith(".in"))
    sweeps = {}
    for key, m in (("mesh", mesh), ("none", None)):
        solver = DLSolver(device="cuda", batch_size=P13_BATCH)
        solver.parameter_key = {N: dict(tuned["dl"], iterations=ITERATIONS)}
        insts_ = [ProblemInstance(device="cuda", instance_type="tuning",
                                  file_path=os.path.join(SIZE70, f)) for f in files]
        t = time.perf_counter()
        sweeps[key] = sweep_solve(solver, insts_, seed=0, scale=True, mesh=m)
        walls_ = time.perf_counter() - t
        log(f"phase 16 (d) sweep_solve of {len(files)} instances, batch {P13_BATCH}, "
            f"mesh {key}: wall {walls_:.3f} s")
    same = all(torch.equal(a.variables["problem_variables"], b.variables["problem_variables"])
               and np.array_equal(a.objective_values, b.objective_values)
               for a, b in zip(sweeps["mesh"], sweeps["none"]))
    log(f"phase 16 (d) the sweep over the mesh {'equals' if same else 'DIFFERS FROM'} "
        f"mesh=None's bit for bit")
    if not same:
        failures.append("phase 16 (d): the sweep over the mesh differs")
    launched = {k: getattr(fn, attr) for k, (fn, attr) in whole.items()}
    launched_steps = {k: getattr(fn, attr) for k, (fn, attr) in steps_.items()}
    log(f"phase 16 main path launches: {launched}; one-step builds {launched_steps}")
    for k in ("dl_solve", "mf_solve", "langevin_solve", "pumped_langevin_solve"):
        if not launched[k] > 0:
            failures.append(f"phase 16: {k} was not launched")
    for k, n in launched_steps.items():
        if not n > 0:
            failures.append(f"phase 16: {k} was not launched")

    # The one-step builds against their plain steps, and each piece timed.
    step_fns = {"dl": (dl_kernels.dl_step, dl_kernels.dl_step_reference),
                "mf": (mf_kernels.mf_step, mf_kernels.mf_step_reference),
                "langevin": (langevin_kernels.langevin_step,
                             langevin_kernels.langevin_step_reference),
                "pumped": (langevin_kernels.pumped_langevin_step,
                           langevin_kernels.pumped_langevin_step_reference)}
    tables = {"dl": lambda p, h: dl_kernels._step_table(p, h, 1.0, ITERATIONS, True, "cuda"),
              "mf": lambda p, h: mf_kernels._step_table(p, h, ITERATIONS, True, "cuda"),
              "langevin": lambda p, h: langevin_kernels._step_table(p, h, ITERATIONS,
                                                                    False, "cuda"),
              "pumped": lambda p, h: langevin_kernels._step_table(p, h, ITERATIONS, True,
                                                                  "cuda")}
    flops_peak, bw, _ = card_peaks(name)

    def events_ms(fn, reps):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    rows = []
    for sname, (family, adam, kname) in STEP_KERNELS.items():
        h = hp if adam else None
        kx, k_in, k_out = STEP_ARRAYS[family]
        k_state = k_out[adam]
        q, v = insts[family].q_matrix, insts[family].v_vector
        p = params(family, ITERATIONS)
        table = tables[family](p, h)
        kw = dict(iterations=ITERATIONS, rng=rngs[family], hp=h, **flags[family])
        states = []
        for fn in step_fns[family]:
            state = torch.zeros((k_state, MAIN_BATCH, N), device="cuda")
            if family == "mf":
                state[1] = 0.5
            x = torch.empty((kx, MAIN_BATCH, N), device="cuda")
            fn(31, None, v, p, state, x, None, steps=table, **kw)
            with fp32_matmul():
                for i in range(P16_STEP_HOLD):
                    fn(31, torch.matmul(x, q), v, p, state, x, i, steps=table, **kw)
            states.append((state, x))
        torch.cuda.synchronize()
        # In units of max(1, |x|): Adam's second moments of MF reach ~1e7.
        err = ((states[0][0] - states[1][0]).abs()
               / states[1][0].abs().clamp(min=1.0)).max().item()
        if not err <= PARITY_TOL:
            failures.append(f"phase 16 (c) {sname}: the build against its plain step "
                            f"{err} > {PARITY_TOL}")
        state, x = states[0]
        with fp32_matmul():
            mv = torch.matmul(x, q)
        build_ms = events_ms(lambda: step_fns[family][0](
            31, mv, v, p, state, x, 5, steps=table, **kw), P16_TIMED)
        plain_ms = events_ms(lambda: step_fns[family][1](
            31, mv, v, p, state, x, 5, steps=table, **kw), 5)
        flops = ELEMENTWISE_FLOPS[kname] * MAIN_BATCH * N
        nbytes = 4 * (MAIN_BATCH * N * (2 * kx + k_in[adam] + k_out[adam]) + N)
        t_ops, t_bytes = flops / flops_peak, nbytes / bw
        bound = 1e3 * max(t_ops, t_bytes)
        rows.append({
            "name": sname, "route": "cuda", "source": f"ccvm_tpu_torch/csrc/"
            f"{'langevin' if family in ('langevin', 'pumped') else family}_solve.cu",
            "build": "CCVM_EXT 1 (one step of a tensor-parallel solve)",
            "replaces": REPLACES[kname], "launches": launched_steps[sname],
            "max_abs_err": err, "hold_steps": P16_STEP_HOLD, "ms": build_ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "launches_by_phase": {"16": launched_steps[sname]}})
        log(f"phase 16 (c) {sname}: {P16_STEP_HOLD} steps on the same words against its "
            f"plain step, max |diff| / max(1, |x|) {err:.3g}; one launch at batch {MAIN_BATCH}, N={N}: "
            f"{build_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
            f"({rows[-1]['bound_by']}; {100 * bound / build_ms:.1f}% of it); TP engine "
            f"against the whole solve {engine_err[sname]:.3g}")

    # The DL TP step's pieces at the main shape, each timed alone.
    q, v = insts["dl"].q_matrix, insts["dl"].v_vector
    p = params("dl", ITERATIONS)
    table = tables["dl"](p, None)
    model = mesh.get_group("model")
    state = torch.zeros((2, MAIN_BATCH, N), device="cuda")
    x = torch.empty((2, MAIN_BATCH, N), device="cuda")
    kw = dict(iterations=ITERATIONS, rng="popcount16", **flags["dl"])
    dl_kernels.dl_step(21, None, v, p, state, x, None, steps=table, **kw)
    with fp32_matmul():
        partial = torch.matmul(x.view(-1, N), q)
        matmul_ms = events_ms(lambda: torch.matmul(x.view(-1, N), q), P16_TIMED)
    out = torch.empty_like(partial)
    collective_ms = events_ms(lambda: dist.reduce_scatter(out, [partial], group=model),
                              P16_TIMED)
    mv = out.view(x.shape)
    step_ms = events_ms(lambda: dl_kernels.dl_step(21, mv, v, p, state, x, 7, steps=table,
                                                   **kw), P16_TIMED)
    log(f"phase 16 (c) dl TP step at batch {MAIN_BATCH}, N={N}, tp 1 on {name}: matmul "
        f"{matmul_ms:.4f} ms, reduce-scatter {collective_ms:.4f} ms, step launch "
        f"{step_ms:.4f} ms (sum {matmul_ms + collective_ms + step_ms:.4f} ms; the "
        f"engine's {1e3 * engine_wall / ITERATIONS:.4f} ms a step includes the host's "
        f"launches); the whole-solve kernel {given['dl_kernel_ms'] / ITERATIONS:.4f} ms "
        f"a step")

    # (e) each wrapper launches on its tensors' card.
    entered = []
    real = torch.cuda.device

    class Spy(real):
        def __init__(self, device):
            entered.append(torch.device(device))
            super().__init__(device)

    torch.cuda.device = Spy
    try:
        q, v = insts["dl"].q_matrix, insts["dl"].v_vector
        for family in classes:
            p = params(family, 10)
            wholes[family](1, q, v, p, iterations=10, batch_size=64, **flags[family])
            k_state = STEP_ARRAYS[family][2][0]
            st = torch.zeros((k_state, 64, N), device="cuda")
            xs = torch.empty((STEP_ARRAYS[family][0], 64, N), device="cuda")
            step_fns[family][0](1, None, v, p, st, xs, None, iterations=10, **flags[family])
    finally:
        torch.cuda.device = real
    torch.cuda.synchronize()
    ok = len(entered) == 8 and all(d == q.device for d in entered)
    log(f"phase 16 (e) each whole-solve and one-step wrapper entered "
        f"torch.cuda.device({q.device}) around its launch: {entered} "
        f"({'as it must' if ok else 'NOT AS IT MUST'})")
    if not ok:
        failures.append("phase 16 (e): a wrapper launched outside its tensors' card")
    dist.destroy_process_group()
    log(f"phase 16: {time.perf_counter() - t16:.1f} s")
    print("# mesh " + json.dumps({"launched": launched, "rows": rows,
                                  "failures": failures}), flush=True)


class PlainWorkers:
    """Plain solves in child processes of this script (``--plain-worker``),
    at most ``size`` at a time, beside the card's phases.  Every child is
    waited for, and ``close`` kills those still running, so no process
    outlives the run (a multiprocessing pool would leave its resource
    tracker behind)."""

    def __init__(self, size):
        self._lock = threading.Lock()
        self._procs = []
        self._closed = False
        self._threads = concurrent.futures.ThreadPoolExecutor(size)

    def submit(self, module, function, seed, q, v, params, kwargs):
        """A future of ``plain_solve``'s result on these arguments."""
        return self._threads.submit(
            self._run, (module, function, seed, q, v, params, kwargs))

    def submit_many(self, jobs):
        """A future of the list of ``plain_solve``'s results on each job's
        arguments, run in one process (one start-up for many short
        solves)."""
        return self._threads.submit(self._run, ("many", jobs))

    def submit_call(self, module, function, kwargs):
        """A future of ``module.function(**kwargs)`` run in a worker."""
        return self._threads.submit(self._run, ("call", module, function, kwargs))

    def _run(self, job):
        with self._lock:
            if self._closed:
                raise RuntimeError("plain workers closed")
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--plain-worker"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            self._procs.append(proc)
        out, _ = proc.communicate(pickle.dumps(job))
        if proc.returncode != 0:
            raise RuntimeError(f"plain worker exited with {proc.returncode}")
        return pickle.loads(out)

    def close(self):
        with self._lock:
            self._closed = True
            for proc in self._procs:
                if proc.poll() is None:
                    proc.kill()
        self._threads.shutdown(wait=True, cancel_futures=True)
        for proc in self._procs:
            proc.wait()


def success_band_ok(perf_a, perf_b, batch, names=("kernel", "plain")):
    """tools/tpu_validate.py's band, |pa - pb| <= 5 sigma + 0.01, as its twin
    ``ccvm_tpu_torch/tools/validate.py`` holds it, each gap's line logged."""
    from ccvm_tpu_torch.tools import validate

    return not validate.compare(perf_a, perf_b, batch, names, out=log)


def max_diff(a, b):
    """Largest elementwise difference over a kernel's outputs (a tensor or a
    tuple of tensors) and its plain version's."""
    if not isinstance(a, tuple):
        a, b = (a,), (b,)
    return max((x - y).abs().max().item() for x, y in zip(a, b))


class Recorded:
    """A kernel wrapper that records each call's outputs (None unless
    ``keep``) and the CUDA events around it in ``calls``, patched over the
    module's name for it; its launch counts are the wrapper's own (read and
    written through, as the module counts them by that name)."""

    def __init__(self, real, keep=True):
        object.__setattr__(self, "_real", real)
        object.__setattr__(self, "calls", [])
        object.__setattr__(self, "keep", keep)

    def __call__(self, *args, **kwargs):
        import torch

        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self._real(*args, **kwargs)
        end.record()
        self.calls.append((out if self.keep else None, start, end))
        return out

    def __getattr__(self, name):
        return getattr(self._real, name)

    def __setattr__(self, name, value):
        setattr(self._real, name, value)


def gap_flips(sol_a, sol_b):
    """Rows whose side of a gap threshold differs between two solutions of
    one instance, and each one's relative objective difference."""
    import numpy as np

    def gaps(sol):
        pos = -np.asarray(sol.objective_values, np.float64)
        return (sol.optimal_value - pos) * 100.0 / np.abs(pos)

    ga, gb = gaps(sol_a), gaps(sol_b)
    flips = np.zeros(ga.shape, bool)
    for thr in GAP_THRESHOLDS:
        flips |= (ga <= thr) != (gb <= thr)
    ea, eb = (np.asarray(s.objective_values, np.float64) for s in (sol_a, sol_b))
    return np.flatnonzero(flips), np.abs(ea - eb) / np.abs(eb)


def device_busy(trace_path, spans):
    """From a Chrome-format profiler trace: the window from the start of the
    first of ``spans`` (host annotations) to the end of the last, the
    device's busy time in it (the union of its kernels, copies and sets), and
    the device operations by duration, longest first; times in ms."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("name") in spans and e.get("ph") == "X"]
    missing = set(spans) - {e["name"] for e in marks}
    if missing:
        raise AssertionError(f"the trace lacks the spans {sorted(missing)}")
    lo = min(e["ts"] for e in marks)
    hi = max(e["ts"] + e["dur"] for e in marks)
    device = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in
                     ("kernel", "gpu_memcpy", "gpu_memset")), key=lambda e: e["ts"])
    busy, end = 0.0, lo
    for e in device:
        a, b = max(e["ts"], end), min(e["ts"] + e["dur"], hi)
        if b > a:
            busy += b - a
            end = b
    longest = sorted(((e["dur"] / 1e3, e["name"]) for e in device), reverse=True)
    return (hi - lo) / 1e3, busy / 1e3, longest


def sweep_phase(tuned_all, dl_event_ms, counters, failures):
    """Phase 13: ``sweep_solve`` over every Size70 instance on each façade,
    ``LangevinSolver.tune`` stacked and serial, ``checkpointed_solve`` at the
    main shape, and a DL main-path solve under ``profiling.trace``; returns
    the launch counts of the phase (zeroed before it), each sweep's
    (instance name, statistics, best objective) by label, and the stacked
    tuning's winner."""
    import glob
    import tempfile

    import numpy as np
    import torch

    from ccvm_tpu_torch import (AdamParameters, DLSolver, LangevinSolver, MFSolver,
                                ProblemInstance, PumpedLangevinSolver, checkpoint,
                                profiling, tuning)
    from ccvm_tpu_torch.dynamics import common
    from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels
    from ccvm_tpu_torch.parallel import sweep_solve
    from ccvm_tpu_torch.problem_classes.boxqp.problem_instance import _energy_and_bound

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t13 = time.perf_counter()
    files = sorted(glob.glob(os.path.join(SIZE70, "*.in")))

    def instances(paths):
        return [ProblemInstance(device="cuda", instance_type="tuning", file_path=f)
                for f in paths]

    def key(family):
        return {N: {**tuned_all[family][str(N)], "iterations": ITERATIONS}}

    # (a) Sweeps: benchmarking_study.py --sweep's call on every façade.
    lgv_adam = AdamParameters(**tuned_all["adam"]["langevin"][str(N)])
    sweeps = (("DL", DLSolver, "dl", None, None, dl_kernels, "dl_solve"),
              ("MF", MFSolver, "mf", "grad-descent", None, mf_kernels, "mf_solve"),
              ("Langevin", LangevinSolver, "langevin", "grad-descent", None,
               langevin_kernels, "langevin_solve"),
              ("pumped", PumpedLangevinSolver, "pumped", "grad-descent", None,
               langevin_kernels, "pumped_langevin_solve"),
              ("Langevin-Adam", LangevinSolver, "langevin", "grad-descent", lgv_adam,
               langevin_kernels, "langevin_solve"))
    gamma = 16.0 * (N + 8) * 2.0 ** -23  # the readout's rounding bound
    dl_sweep = None
    stats = {}
    for label, cls, family, pp, adam, module, function in sweeps:
        solver = cls(device="cuda", batch_size=P13_BATCH)
        solver.parameter_key = key(family)
        insts = instances(files)
        with mock.patch.object(module, function,
                               Recorded(getattr(module, function))) as recorded:
            rec = recorded.calls
            torch.cuda.synchronize()
            t = time.perf_counter()
            sols = sweep_solve(solver, insts, post_processor=pp, algorithm_parameters=adam,
                               seed=0, scale=True)
            wall = time.perf_counter() - t
            serial = {i: solver(insts[i], seed=i, post_processor=pp,
                                algorithm_parameters=adam) for i in P13_HELD}
        torch.cuda.synchronize()
        stacked, start, end = rec[0]
        kernel_ms = start.elapsed_time(end)
        same = all(torch.equal(a[i], b) for i, (out, _, _) in zip(P13_HELD, rec[1:])
                   for a, b in zip(flat(stacked), flat(out)))
        assert len(sols) == len(files) and all(
            np.all(np.isfinite(s.objective_values)) for s in sols), label
        if not same:
            failures.append(f"phase 13 {label}: a held instance's kernel outputs differ "
                            f"from its serial launch")
        obj_err, pv_err, flipped, rounding = 0.0, 0.0, 0, 0.0
        for i in P13_HELD:
            a, b = sols[i], serial[i]
            pv_err = max(pv_err, max_diff(a.variables["problem_variables"],
                                          b.variables["problem_variables"]))
            rows, rel = gap_flips(a, b)
            obj_err = max(obj_err, float(rel.max()))
            flipped += rows.size
            if pp is None:
                # The same configurations read out stacked and alone: the f32
                # energies within both passes' rounding bound, the
                # statistics (from float64 where the bound is too wide) equal.
                confs = common.change_variables_boxqp(
                    a.variables["problem_variables"], *insts[i].solution_bounds,
                    torch.tensor(1.0, device=insts[i].q_matrix.device))
                abs_e = _energy_and_bound(confs, insts[i].q_matrix, insts[i].v_vector,
                                          float(np.float32(insts[i].scaled_by)))[1]
                diff = np.abs(np.asarray(a.objective_values) -
                              np.asarray(b.objective_values))
                rounding = max(rounding, float(
                    (diff / (2 * gamma * abs_e.cpu().numpy().astype(np.float64))).max()))
                if a.solution_performance != b.solution_performance or \
                        a.best_objective_value != b.best_objective_value:
                    failures.append(f"phase 13 {label} instance {i}: statistics differ")
            elif rows.size and rel[rows].max() > SWEEP_PP_TOL:
                failures.append(f"phase 13 {label} instance {i}: {rows.size} rows change "
                                f"a gap statistic, objective {rel[rows].max():.3e} apart")
        if pp is not None and pv_err > SWEEP_PP_TOL:
            failures.append(f"phase 13 {label}: refinement {pv_err:.3e} from serial")
        if rounding > 1.0:
            failures.append(f"phase 13 {label}: objective values {rounding:.3f} x the "
                            f"readout's rounding bound apart")
        p01 = np.mean([s.solution_performance["optimal"] for s in sols])
        p1 = np.mean([s.solution_performance["one_percent"] for s in sols])
        log(f"phase 13 (a) {label} sweep{'' if pp is None else ' with ' + pp}: "
            f"{len(files)} instances x batch {P13_BATCH}, N={N}, {ITERATIONS} steps in "
            f"one stacked launch, wall {wall:.3f} s, "
            f"{len(files) * P13_BATCH * ITERATIONS / wall:.4g} traj-iter/s, kernel "
            f"(CUDA events) {kernel_ms:.1f} ms; mean P(0.1%)={p01:.4f} P(1%)={p1:.4f}; "
            f"instances {P13_HELD} against serial launches with seed i: kernel outputs "
            f"{'equal bit for bit' if same else 'DIFFER'}, largest relative objective "
            f"difference {obj_err:.3e}"
            + (f" ({rounding:.3f} x the readout's rounding bound), statistics equal"
               if pp is None else f", refinement {pv_err:.3e} (tol {SWEEP_PP_TOL}), "
               f"{flipped} rows on the other side of a gap threshold"))
        stats[label] = [(s.instance_name, s.solution_performance, s.best_objective_value)
                        for s in sols]
        if label == "DL":
            dl_sweep = (solver, insts, wall)
        del sols, serial, rec, stacked

    # ... and the serial loop benchmarking_study.py runs without --sweep.
    solver, insts, sweep_wall = dl_sweep
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i, inst in enumerate(insts):
        solver(inst, seed=i)
    torch.cuda.synchronize()
    serial_wall = time.perf_counter() - t
    log(f"phase 13 (a) DL over {len(insts)} instances: one sweep {sweep_wall:.3f} s, "
        f"the serial loop {serial_wall:.3f} s ({serial_wall / sweep_wall:.2f} x)")
    del dl_sweep, solver, insts

    # (b) Tuning: tools/tune_benchmark_set.py's Langevin run, each candidate
    # scored by one stacked launch, then by serial launches.
    runs = {}
    for use_sweep in (True, False):
        solver = LangevinSolver(device="cuda", batch_size=P13_TUNE_BATCH, timing="async")
        solver.parameter_key = {N: {**P13_TUNE_BASE, "iterations": ITERATIONS}}
        insts = instances(files[:3])
        for inst in insts:
            inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
        # Each candidate's (params, score) as the tuner logs it.
        with mock.patch.object(tuning.logger, "info") as info:
            t = time.perf_counter()
            best = solver.tune(insts, post_processor="grad-descent",
                               parameter_ranges=P13_TUNE_GRID,
                               tuning_batch_size=P13_TUNE_BATCH, seed=7,
                               use_sweep=use_sweep)
            wall = time.perf_counter() - t
        runs[use_sweep] = (best, [c.args[2:] for c in info.call_args_list
                                  if c.args[0].startswith("tune size")], wall)
    (best_s, scores_s, wall_s), (best_l, scores_l, wall_l) = runs[True], runs[False]
    fractions_equal = [a[:2] == b[:2] for (_, a), (_, b) in zip(scores_s, scores_l)]
    best_err = max(abs(a[2] - b[2]) / abs(b[2]) for (_, a), (_, b) in
                   zip(scores_s, scores_l))
    log(f"phase 13 (b) LangevinSolver.tune, {len(scores_s)} candidates on 3 instances, "
        f"batch {P13_TUNE_BATCH}, {ITERATIONS} steps, grad-descent, seed 7: stacked "
        f"{wall_s:.3f} s, serial {wall_l:.3f} s; winners {best_s[N]} and {best_l[N]}; "
        f"{sum(fractions_equal)} of {len(fractions_equal)} candidates' score fractions "
        f"equal, largest relative difference of the best objective {best_err:.3e}")
    for (params, a), (_, b) in zip(scores_s, scores_l):
        log(f"  {params}: stacked {a}, serial {b}")
    if best_s != best_l or not all(fractions_equal) or len(scores_s) != 9 or \
            best_err > TUNE_BEST_RTOL:
        failures.append("phase 13 (b): stacked and serial tuning disagree")

    # (c) Checkpoint / resume at the main shape, DL and Langevin-Adam.
    inst = instances(files[:1])[0]
    inst.scale_coefs(DLSolver(device="cuda").get_scaling_factor(inst.q_matrix))
    dl_solver = DLSolver(device="cuda", batch_size=MAIN_BATCH)
    dl_solver.solution_bounds = inst.solution_bounds
    t = tuned_all["dl"][str(N)]
    lgv_inst = instances(files[:1])[0]
    lgv_solver = LangevinSolver(device="cuda", batch_size=MAIN_BATCH)
    lgv_inst.scale_coefs(lgv_solver.get_scaling_factor(lgv_inst.q_matrix))
    lgv_solver.solution_bounds = lgv_inst.solution_bounds
    lt = tuned_all["langevin"][str(N)]
    ckpts = (
        ("DL", dl_kernels.dl_solve_segment, dl_kernels.dl_solve, inst,
         dl_solver._make_params(t["pump"], 1.0, t["dt"], t["noise_ratio"],
                                t["feedback_scale"], G, ITERATIONS),
         dict(pump_rate_flag=True, pump_is_gt_one=t["pump"] > 1, rng="popcount16"),
         lambda st: (torch.clamp(st[0], -1.0, 1.0), st[1])),
        ("Langevin-Adam", langevin_kernels.langevin_solve_segment,
         langevin_kernels.langevin_solve, lgv_inst,
         lgv_solver._make_params(lt["S"], lt["dt"], lt["sigma"], lt["feedback_scale"]),
         dict(rng="popcount32", hp=lgv_adam.to_hyperparameters()),
         lambda st: st[:1]))
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as snaps:
        for label, segment, whole, inst_, p, kw, final in ckpts:
            q, v = inst_.q_matrix, inst_.v_vector
            kw = dict(kw, batch_size=MAIN_BATCH)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = flat(whole(100, q, v, p, iterations=ITERATIONS, **kw))
            torch.cuda.synchronize()
            whole_s = time.perf_counter() - t0
            path = os.path.join(snaps, f"{label}.npz")
            t0 = time.perf_counter()
            state = checkpoint.checkpointed_solve(segment, 100, q, v, p, None, ITERATIONS,
                                                  every=P13_CKPT_EVERY, path=path, **kw)
            ckpt_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            straight = all(torch.equal(a, b) for a, b in zip(flat(final(state)), want))
            os.remove(path)
            began = []

            def dies_after_the_first(*args, **kwargs):
                if began:
                    raise InterruptedError("the run is cut after its first snapshot")
                began.append(args[5])
                return segment(*args, **kwargs)

            try:
                checkpoint.checkpointed_solve(dies_after_the_first, 100, q, v, p, None,
                                              ITERATIONS, every=P13_CKPT_EVERY, path=path,
                                              **kw)
                raise AssertionError("the interrupted run was not interrupted")
            except InterruptedError:
                pass
            _, at, _ = checkpoint.load_state(path)
            state = checkpoint.checkpointed_solve(segment, 100, q, v, p, None, ITERATIONS,
                                                  every=P13_CKPT_EVERY, path=path, **kw)
            resumed = all(torch.equal(a, b) for a, b in zip(flat(final(state)), want))
            log(f"phase 13 (c) {label} checkpointed_solve at batch {MAIN_BATCH}, N={N}, "
                f"{ITERATIONS} steps, every {P13_CKPT_EVERY}: wall {ckpt_s:.3f} s against "
                f"the whole launch's {whole_s:.3f} s, snapshots of {size} bytes; "
                f"{'equal' if straight else 'DIFFERS from'} the whole launch bit for bit; "
                f"cut after step {at} and resumed: "
                f"{'equal' if resumed else 'DIFFERS'}")
            if not (straight and resumed and at == P13_CKPT_EVERY):
                failures.append(f"phase 13 (c) {label}: checkpointed solve differs")
            del want, state

    # (d) Profiling: phase 6's DL call under torch.profiler, in its own
    # ccvm.call span.
    solver = DLSolver(device="cuda", batch_size=MAIN_BATCH, timing="async")
    solver.parameter_key = {N: {**tuned_all["dl"][str(N)], "iterations": ITERATIONS}}
    solver(inst, seed=1)  # warm-up
    trace_dir = os.path.join(REPO, "build", "phase13_trace")
    with profiling.trace(trace_dir):
        sol = solver(inst, seed=1)
    traces = sorted(glob.glob(os.path.join(trace_dir, "*.pt.trace.json")))
    window, busy, longest = device_busy(traces[-1], ("ccvm.call",))
    traced = [ms for ms, op in longest if "dl_solve_kernel" in op]
    kernel_ms = float(np.median(dl_event_ms))
    log(f"phase 13 (d) DL main path under torch.profiler (CPU and CUDA activity): "
        f"window {window:.3f} ms of the façade call's span, device busy "
        f"{busy:.3f} ms, idle share {1 - busy / window:.4f}; P(0.1%)="
        f"{sol.solution_performance['optimal']:.4f}; the five longest device operations:")
    for ms, op in longest[:5]:
        log(f"  {ms:.3f} ms {op[:110]}")
    log(f"phase 13 (d) dl_solve traced {traced} ms against phase 6's CUDA events "
        f"{kernel_ms:.1f} ms (median; tol {TRACE_TOL:.0%}); trace {os.path.getsize(traces[-1])} "
        f"bytes")
    if len(traced) != 1 or abs(traced[0] / kernel_ms - 1) > TRACE_TOL:
        failures.append(f"phase 13 (d): traced dl_solve {traced} against {kernel_ms}")
    for f in traces:
        os.remove(f)
    os.rmdir(trace_dir)
    launched = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    log(f"phase 13: {time.perf_counter() - t13:.1f} s; launches {launched}")
    return launched, stats, best_s[N]

def load_script(name):
    """An entry-point script of examples/torch_port/, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"torch_port_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry_point_phase(tuned_all, p13_stats, p13_winner, counters, failures):
    """Phase 14: the entry-point scripts on the card (the study, the four
    single-instance examples, the plot example, the tuner) and the repaired
    async sweep clock; returns the launch counts of the phase (zeroed
    before it)."""
    import glob
    import hashlib
    import io
    import logging
    import tempfile

    import numpy as np
    import torch

    from ccvm_tpu_torch import LangevinSolver, ProblemInstance
    from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels
    from ccvm_tpu_torch.parallel import sweep_solve
    from ccvm_tpu_torch.tools import tune_benchmark_set

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t14 = time.perf_counter()
    with open(TUNED, "rb") as f:
        tuned_digest = hashlib.sha256(f.read()).hexdigest()
    study = load_script("benchmarking_study")
    kernel_of = {"dl": (dl_kernels, "dl_solve"), "mf": (mf_kernels, "mf_solve"),
                 "langevin": (langevin_kernels, "langevin_solve"),
                 "pumped": (langevin_kernels, "pumped_langevin_solve")}

    # run_resilient logs each failed attempt: a retry is one of these.
    retries = []

    class Retries(logging.Handler):
        def emit(self, record):
            retries.append(record.getMessage())

    retry_log = logging.getLogger("ccvm_tpu_torch.parallel.multihost")
    handler = Retries(logging.WARNING)
    retry_log.addHandler(handler)

    # Each instance file's load (parse, and the copy to the card), in order.
    loads = []

    class TimedInstance(ProblemInstance):
        def __init__(self, *args, **kwargs):
            t = time.perf_counter()
            super().__init__(*args, **kwargs)
            loads.append((kwargs["file_path"], time.perf_counter() - t))

    def study_args(out, *extra):
        return study.parse_args(["--params", TUNED, "--seed", "0", "--batch-size", "1000",
                                 "--iterations", str(ITERATIONS), "--output-dir", out,
                                 "--device", "cuda"] + list(extra))

    def rows(out, name, size):
        with open(os.path.join(out, f"{name}_benchmark.json")) as f:
            return [r for r in json.load(f)["result_metadata"] if r["problem_size"] == size]

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        # (a) The study with --sweep over every bundled size, each size's
        # kernel timed by CUDA events and its files' loads by the host clock.
        # No --plots: the card's host has had no matplotlib; the plots of
        # these metadata files are drawn by the CPU tests.
        out_a = os.path.join(tmp, "sweep")
        failed = {}
        with contextlib.ExitStack() as stack:
            rec = {name: stack.enter_context(mock.patch.object(
                module, fn, Recorded(getattr(module, fn), keep=False)))
                for name, (module, fn) in kernel_of.items()}
            stack.enter_context(mock.patch.object(study, "ProblemInstance", TimedInstance))
            printed = stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
            torch.cuda.synchronize()
            t = time.perf_counter()
            summary = study.run_sweep(study_args(out_a, "--sweep"), failed)
            study_wall = time.perf_counter() - t
        torch.cuda.synchronize()
        log(f"phase 14 (a) examples/torch_port/benchmarking_study.py --sweep --params "
            f"examples/tuned_parameters.json: {study_wall:.3f} s in all")
        for ln in printed.getvalue().split("=== Sweep summary ===")[1].strip().splitlines():
            log(f"  {ln}")
        assert [row[:2] for row in summary] == [(s, n) for s in STUDY_SOLVERS
                                                for n in STUDY_SIZES], summary
        per_size = len(loads) // len(summary)
        for k, (name, size, count, p_opt, wall) in enumerate(summary):
            files = sorted(glob.glob(os.path.join(REPO, "examples", "benchmarking_instances",
                                                  f"Size{size}", "*.in")))
            chunk = loads[k * per_size:(k + 1) * per_size]
            assert [path for path, _ in chunk] == files, (name, size)
            _, start, end = rec[name].calls[STUDY_SIZES.index(size)]
            got = rows(out_a, name, size)
            p1 = np.mean([r["solution_performance"]["one_percent"] for r in got])
            log(f"phase 14 (a) {name} N={size}: {count} instances x batch 1000, "
                f"{ITERATIONS} steps in one stacked launch: wall {wall:.3f} s, "
                f"{count * 1000 * ITERATIONS / wall:.4g} traj-iter/s, kernel (CUDA events) "
                f"{start.elapsed_time(end):.1f} ms, load of its {len(chunk)} files "
                f"{1e3 * sum(dt for _, dt in chunk):.1f} ms; mean P(0.1%)={p_opt:.4f} "
                f"P(1%)={p1:.4f}; metadata rows {len(got)}")
            if failed[name, size] or len(got) != count or count != len(files):
                failures.append(f"phase 14 (a) {name} N={size}: {len(failed[name, size])} "
                                f"failed, {len(got)} rows of {len(files)} instances")
        load_s = sum(dt for _, dt in loads)
        log(f"phase 14 (a) {len(loads)} instance files loaded (each parsed once a solver, "
            f"the body by the native tokenizer, and copied to the card) in {load_s:.3f} s, "
            f"{load_s / study_wall:.1%} of the study's wall (recorded with the NumPy "
            f"tokenizer: {NUMPY_LOADS_S} s, {NUMPY_LOADS_SHARE:.1%})")
        for name in STUDY_SOLVERS:
            # N=70's rows against phase 13 (a)'s sweep of the same seed.
            want = p13_stats[STUDY_LABELS[name]]
            have = [(r["instance_name"], r["solution_performance"], r["best_objective_value"])
                    for r in rows(out_a, name, N)]
            differ = sum(a != b for a, b in zip(have, want))
            log(f"phase 14 (a) {name} N={N}: statistics and best objective of "
                f"{len(have)} instances against phase 13 (a)'s sweep: {differ} differ")
            if differ or len(have) != len(want):
                failures.append(f"phase 14 (a) {name} N={N}: {differ} instances differ "
                                f"from phase 13")

        # (b) The study's serial path for DL at N=70 (run_resilient, seeds
        # 0 + idx) against (a)'s rows.
        out_b = os.path.join(tmp, "serial")
        failed_b = {}
        with contextlib.redirect_stdout(io.StringIO()):
            summary_b = study.run_sweep(study_args(out_b, "--solvers", "dl", "--sizes",
                                                   str(N)), failed_b)
        sweep_wall = summary[STUDY_SOLVERS.index("dl") * len(STUDY_SIZES) + len(STUDY_SIZES)
                             - 1][4]
        keys = ("optimal", "one_percent")
        differ = sum(
            [a["solution_performance"][k] for k in keys] + [a["best_objective_value"]] !=
            [b["solution_performance"][k] for k in keys] + [b["best_objective_value"]]
            for a, b in zip(rows(out_b, "dl", N), rows(out_a, "dl", N)))
        log(f"phase 14 (b) the study's serial path, dl N={N}: {summary_b[0][2]} instances, "
            f"wall {summary_b[0][4]:.3f} s against the sweep's {sweep_wall:.3f} s "
            f"({summary_b[0][4] / sweep_wall:.2f} x); P(0.1%), P(1%) and best objective of "
            f"each instance against (a)'s: {differ} differ; failed {len(failed_b[('dl', N)])}, "
            f"retried {len(retries)}")
        if differ or failed_b[("dl", N)] or len(rows(out_b, "dl", N)) != summary_b[0][2]:
            failures.append(f"phase 14 (b): {differ} instances differ from the sweep, "
                            f"{len(failed_b[('dl', N)])} failed")
        if retries:
            failures.append(f"phase 14: run_resilient retried {retries}")

        # (c) The four single-instance examples (batch 1000, N=20, 1,500
        # steps), each held against the same script on the CPU (the plain
        # versions, the same seed) within tools/tpu_validate.py's band, and
        # the plot example up to the metadata its plots read.
        twins = ("ccvm_boxqp_dl", "ccvm_boxqp_mf", "langevin_boxqp", "pumped_langevin_boxqp")
        mods = {t: load_script(t) for t in twins}
        with contextlib.redirect_stdout(io.StringIO()):
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                on_cpu = pool.submit(lambda: {
                    t: mods[t].main(device="cpu", seed=0)[0].solution_performance
                    for t in twins})
                card = {}
                for t in twins:
                    start = time.perf_counter()
                    card[t] = (mods[t].main(device="cuda", seed=0), time.perf_counter() - start)
                cpu_perf = on_cpu.result()
        for t in twins:
            sols, wall = card[t]
            sol = sols[0]
            perf = sol.solution_performance
            finite = len(sols) == 1 and bool(np.all(np.isfinite(sol.objective_values)))
            log(f"phase 14 (c) examples/torch_port/{t}.py: {sol.instance_name}, batch "
                f"{sol.batch_size}, {sol.iterations} steps, wall {wall:.3f} s, objective "
                f"values {'finite' if finite else 'NOT finite'}; P(0.1%)="
                f"{perf['optimal']:.4f} P(1%)={perf['one_percent']:.4f}, best "
                f"{sol.best_objective_value:.6f} of {sol.optimal_value:.6f}; against the "
                f"script on the CPU:")
            if not finite or not success_band_ok(perf, cpu_perf[t], sol.batch_size,
                                                 names=("card", "CPU")):
                failures.append(f"phase 14 (c) {t}: outside the band of the CPU run")
        plot = load_script("ccvm_boxqp_plot")
        out_c = os.path.join(tmp, "plot")
        with contextlib.redirect_stdout(io.StringIO()):
            _, path, sols = plot.solve_to_metadata(device="cuda", out_dir=out_c, seed=0)
        with open(path) as f:
            meta = json.load(f)["result_metadata"]
        log(f"phase 14 (c) examples/torch_port/ccvm_boxqp_plot.py's solve_to_metadata: "
            f"{len(meta)} metadata row, {sols[0].iterations} steps, solve time "
            f"{meta[0]['solve_time']:.3e} s a trajectory, P(1%)="
            f"{meta[0]['solution_performance']['one_percent']:.4f}")
        if len(meta) != 1 or not np.all(np.isfinite(sols[0].objective_values)):
            failures.append("phase 14 (c): the plot example's metadata")

        # (d) The tuner twin at Size70, one solver a call, merged into one
        # file; examples/tuned_parameters.json untouched.
        out_d = os.path.join(tmp, "tuned_parameters_torch.json")
        for name in STUDY_SOLVERS:
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                table = tune_benchmark_set.main(out_path=out_d, sizes=(N,), per_size=3,
                                                iterations=ITERATIONS,
                                                tuning_batch_size=P14_TUNE_BATCH,
                                                device="cuda", solvers=(name,))
            log(f"phase 14 (d) python -m ccvm_tpu_torch.tools.tune_benchmark_set "
                f"--solvers {name} --sizes {N}: "
                f"{np.prod([len(v) for v in tune_benchmark_set.GRIDS[name].values()])} "
                f"candidates on 3 instances, batch {P14_TUNE_BATCH}, {ITERATIONS} steps: "
                f"winner {table[name][str(N)]}, wall {time.perf_counter() - t:.3f} s")
        with open(out_d) as f:
            written = json.load(f)
        with open(TUNED, "rb") as f:
            untouched = hashlib.sha256(f.read()).hexdigest() == tuned_digest
        winner = {k: v for k, v in p13_winner.items() if k != "iterations"}
        shape_ok = sorted(written) == sorted(STUDY_SOLVERS) and all(
            list(written[s]) == [str(N)] and "iterations" not in written[s][str(N)]
            for s in STUDY_SOLVERS)
        log(f"phase 14 (d) the table: {sorted(written)} at {N}, without iterations: "
            f"{shape_ok}; Langevin's winner {written['langevin'][str(N)]} against phase "
            f"13 (b)'s {winner}; examples/tuned_parameters.json "
            f"{'unchanged' if untouched else 'CHANGED'}")
        if not (shape_ok and untouched and written["langevin"][str(N)] == winner):
            failures.append("phase 14 (d): the tuner's table")

    # (e) The sweep's solve clock under both timings: Langevin with
    # grad-descent over the 50 Size70 instances.
    files = sorted(glob.glob(os.path.join(SIZE70, "*.in")))
    trajectories = len(files) * 1000
    clocks = {}
    for timing in ("async", "sync"):
        solver = LangevinSolver(device="cuda", batch_size=1000, timing=timing)
        solver.parameter_key = {N: {**tuned_all["langevin"][str(N)], "iterations": ITERATIONS}}
        insts = [ProblemInstance(device="cuda", instance_type="tuning", file_path=f)
                 for f in files]
        with mock.patch.object(langevin_kernels, "langevin_solve",
                               Recorded(langevin_kernels.langevin_solve, keep=False)) as r:
            sols = sweep_solve(solver, insts, post_processor="grad-descent", seed=0,
                               scale=True)
        torch.cuda.synchronize()
        _, start, end = r.calls[0]
        clocks[timing] = (sols[0].solve_time * trajectories, sols[0].pp_time * trajectories,
                          start.elapsed_time(end) / 1e3)
        solve_s, pp_s, kernel_s = clocks[timing]
        log(f"phase 14 (e) Langevin sweep with grad-descent, timing {timing!r}, "
            f"{len(files)} x 1000: solve_time x {trajectories} = {solve_s:.4f} s, pp_time x "
            f"{trajectories} = {pp_s:.4f} s, the kernel (CUDA events) {kernel_s:.4f} s")
    solve_s, pp_s, kernel_s = clocks["async"]
    if solve_s < kernel_s or pp_s >= ASYNC_PP_SHARE * kernel_s:
        failures.append(f"phase 14 (e): under async the solve clock {solve_s:.4f} s and "
                        f"pp {pp_s:.4f} s against the kernel's {kernel_s:.4f} s")
    retry_log.removeHandler(handler)
    launched = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    log(f"phase 14: {time.perf_counter() - t14:.1f} s; launches {launched}")
    return launched


def element_saturation(row, batch, seed):
    """A (batch, n) S whose rows differ: ``row`` scaled over [1, 1.5] a row
    and by a factor in [0.9, 1.1] an element, drawn from ``seed``."""
    import numpy as np

    draw = np.random.RandomState(seed)
    scale = np.outer(np.linspace(1.0, 1.5, batch), np.asarray(row, np.float64))
    return (scale * draw.uniform(0.9, 1.1, scale.shape)).astype(np.float32)


def per_element_phase(tuned_all, main_ms, counters, failures):
    """Phase 15: a (batch, n) S whose rows differ, one S an element, on every
    production kernel (its per-element build) and on the four façades;
    ``main_ms`` is each family's scalar-S kernel time of phase 6 (CUDA
    events).  Returns the launch counts of the phase (zeroed before it) and
    each label's main-shape times (scalar S, per-column, per-element)."""
    import numpy as np
    import torch

    from ccvm_tpu_torch import (AdamParameters, DLSolver, LangevinSolver, MFSolver,
                                ProblemInstance, PumpedLangevinSolver)
    from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels
    from ccvm_tpu_torch.tools.tc_model import PARITY_TOL

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t15 = time.perf_counter()
    col_S = phase12_saturations(tuned_all)
    tuned = {f: tuned_all[f][str(N)] for f in ("dl", "mf", "langevin", "pumped")}
    classes = {"dl": DLSolver, "mf": MFSolver, "langevin": LangevinSolver,
               "pumped": PumpedLangevinSolver}
    modules = {"dl": (dl_kernels, "dl_solve"), "mf": (mf_kernels, "mf_solve"),
               "langevin": (langevin_kernels, "langevin_solve"),
               "pumped": (langevin_kernels, "pumped_langevin_solve")}
    insts, solvers = {}, {}
    for f, cls in classes.items():
        insts[f] = ProblemInstance(device="cuda", instance_type="tuning", file_path=INSTANCE)
        solvers[f] = cls(device="cuda", batch_size=MAIN_BATCH)
        insts[f].scale_coefs(solvers[f].get_scaling_factor(insts[f].q_matrix))
        solvers[f].solution_bounds = insts[f].solution_bounds
    adam = {"dl_adam_solve": AdamParameters(beta2=0.999),
            "mf_adam_solve": AdamParameters(beta2=0.999),
            "langevin_adam_solve": AdamParameters(**tuned_all["adam"]["langevin"][str(N)]),
            "pumped_langevin_adam_solve":
                AdamParameters(**tuned_all["adam"]["pumped"][str(N)])}

    def case(label, S, iterations, batch, noise):
        """(kernel wrapper, plain version, q, v, params, kwargs) of a label
        (a kernel name, or "<kernel> pump 0.9" for DL below pump 1) with S
        (None: the tuned scalar; an array of two dimensions goes to the card
        first, as a façade puts it there)."""
        kname, _, pump = label.partition(" pump ")
        family = kname.split("_")[0]
        t, solver = tuned[family], solvers[family]
        if S is None:
            S = 1.0 if family == "dl" else t["S"]
        elif np.ndim(S) == 2:
            S = torch.from_numpy(S).cuda()
        module, function = modules[family]
        kernel, plain = getattr(module, function), getattr(module, f"{function}_reference")
        if family == "dl":
            pump = float(pump) if pump else t["pump"]
            p = solver._make_params(pump, S, t["dt"], t["noise_ratio"], t["feedback_scale"],
                                    G, iterations)
            kw = dict(pump_rate_flag=True, pump_is_gt_one=pump > 1, rng="popcount16")
        elif family == "mf":
            p = solver._make_params(t["pump"], S, t["dt"], t["j"], t["feedback_scale"],
                                    MF_G, iterations)
            kw = dict(pump_rate_flag=True, rng="popcount32")
        elif family == "langevin":
            p = solver._make_params(S, t["dt"], t["sigma"], t["feedback_scale"])
            kw = dict(rng="popcount32")
        else:
            p = solver._make_params(t["pump"], S, t["dt"], t["sigma"], t["feedback_scale"],
                                    iterations)
            kw = dict(rng="popcount32", pump_rate_flag=True)
        hp = adam[kname].to_hyperparameters() if kname in adam else None
        kw.update(iterations=iterations, batch_size=batch, noise_scale=noise, hp=hp)
        return kernel, plain, insts[family].q_matrix, insts[family].v_vector, p, kw

    # (a) Each per-element build against its plain version, noise off and
    # on (the same Philox words), at PARITY_TOL.
    for label in P15_LABELS:
        family = label.split("_")[0]
        S = element_saturation(col_S[family], P15_BATCH, 15)
        depth = min(P15_STEPS, P12_DL_HOLD_STEPS.get(label, P15_STEPS))
        for noise in (0.0, 1.0):
            kernel, plain, q, v, p, kw = case(label, S, depth, P15_BATCH, noise)
            out = flat(kernel(6, q, v, p, **kw))
            assert all(torch.isfinite(x).all() for x in out), label
            err = max_diff(tuple(out), tuple(flat(plain(6, q, v, p, **kw))))
            log(f"phase 15 (a) per-element S, batch {P15_BATCH}, {depth} steps, noise "
                f"{'on' if noise else 'off'}, {label}: max |kernel - plain| = {err:.3e} "
                f"(tol {PARITY_TOL})")
            if err > PARITY_TOL:
                failures.append(f"phase 15 (a) {label} noise {noise}: {err} > {PARITY_TOL}")

    # (b) Equal rows through the per-element build against the per-column
    # build, bit for bit (noise on).
    for label in P15_LABELS:
        family = label.split("_")[0]
        runs = []
        for S in (np.tile(col_S[family], (P15_BATCH, 1)), col_S[family]):
            kernel, _, q, v, p, kw = case(label, S, P15_STEPS, P15_BATCH, 1.0)
            runs.append(flat(kernel(6, q, v, p, **kw)))
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        log(f"phase 15 (b) {label}: equal rows through the per-element build "
            f"{'equal' if same else 'DIFFER from'} the per-column build bit for bit "
            f"(batch {P15_BATCH}, {P15_STEPS} steps, noise on)")
        if not same:
            failures.append(f"phase 15 (b) {label}: equal rows differ from the per-column "
                            f"build")

    # (c) MF's per-column build, dividing by S_j with its reciprocal, against
    # its plain version bit for bit (phase 12's S, whose divisions
    # tests/test_torch_mf_redesign.py proves exact).
    for noise in (0.0, 1.0):
        kernel, plain, q, v, p, kw = case("mf_solve", col_S["mf"], P15_STEPS, P15_BATCH,
                                          noise)
        out, ref = flat(kernel(6, q, v, p, **kw)), flat(plain(6, q, v, p, **kw))
        same = all(torch.equal(a, b) for a, b in zip(out, ref))
        log(f"phase 15 (c) mf_solve per-column S by reciprocals, batch {P15_BATCH}, "
            f"{P15_STEPS} steps, noise {'on' if noise else 'off'}: "
            f"{'equal to' if same else 'DIFFERS from'} the plain version bit for bit "
            f"(max {max_diff(tuple(out), tuple(ref)):.3e})")
        if not same:
            failures.append(f"phase 15 (c) mf_solve noise {noise}: the per-column build "
                            f"differs from its plain version")

    # (a, c) The main shape: the scalar-S, per-column and per-element builds of
    # each kernel, whole launches timed by CUDA events in alternating order.
    def timed(run):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        out = run()
        events[1].record()
        torch.cuda.synchronize()
        return out, events[0].elapsed_time(events[1])

    main_times = {}
    for label in P15_LABELS:
        family = label.split("_")[0]
        builds = {"scalar": None, "per-column": col_S[family],
                  "per-element": element_saturation(col_S[family], MAIN_BATCH, 16)}
        runs = {name: case(label, S, ITERATIONS, MAIN_BATCH, 1.0)
                for name, S in builds.items()}
        times = {name: [] for name in builds}
        for r in range(P15_ROUNDS):
            for name in (list(builds) if r % 2 == 0 else list(builds)[::-1]):
                kernel, _, q, v, p, kw = runs[name]
                out, ms = timed(lambda: kernel(100, q, v, p, **kw))
                assert all(torch.isfinite(x).all() for x in flat(out)), (label, name)
                times[name].append(ms)
                del out
        main_times[label] = {name: min(t) for name, t in times.items()}
        best = main_times[label]
        log(f"phase 15 (a) {label} at batch {MAIN_BATCH}, N={N}, {ITERATIONS} steps, "
            f"noise on (CUDA events, best of {P15_ROUNDS}): scalar S {best['scalar']:.1f} "
            f"ms, per-column {best['per-column']:.1f} "
            f"({best['per-column'] / best['scalar'] - 1:+.2%}), per-element "
            f"{best['per-element']:.1f} ({best['per-element'] / best['scalar'] - 1:+.2%}); "
            f"rounds {times}")
        del runs

    # (d) The four façades at the main shape with a (batch, n) S whose rows
    # differ (DL with a generalised ramp): the per-element build on the
    # card, its kernel timed by CUDA events against phase 6's scalar-S
    # kernel.
    facades = (("DL", "dl", {"pump_ramp": (2.0, 0.5)}),
               ("MF", "mf", {"g": MF_G, "post_processor": "grad-descent"}),
               ("Langevin", "langevin", {"post_processor": "grad-descent"}),
               ("pumped", "pumped", {"post_processor": "grad-descent"}))
    for label, family, call in facades:
        S = element_saturation(col_S[family], MAIN_BATCH, 17)
        if family == "dl":
            fac = DLSolver(device="cuda", batch_size=MAIN_BATCH, S=S)
            fac.parameter_key = {N: {**tuned["dl"], "iterations": ITERATIONS}}
        else:
            fac = classes[family](device="cuda", batch_size=MAIN_BATCH)
            fac.parameter_key = {N: {**tuned[family], "S": S, "iterations": ITERATIONS}}
        module, function = modules[family]
        with mock.patch.object(module, function,
                               Recorded(getattr(module, function), keep=False)) as rec:
            torch.cuda.synchronize()
            t = time.perf_counter()
            sol = fac(insts[family], seed=1, **call)
            wall = time.perf_counter() - t
        torch.cuda.synchronize()
        _, start, end = rec.calls[-1]
        kernel_ms = start.elapsed_time(end)
        perf = sol.solution_performance
        log(f"phase 15 (d) {label} façade, a (batch, n) S whose rows differ"
            f"{', pump_ramp (2.0, 0.5)' if family == 'dl' else ''}, batch "
            f"{MAIN_BATCH}, N={N}, {ITERATIONS} steps: wall {wall:.3f} s, kernel (CUDA "
            f"events) {kernel_ms:.1f} ms against phase 6's scalar-S {main_ms[family]:.1f} "
            f"ms ({kernel_ms / main_ms[family] - 1:+.2%}); P(0.1%)={perf['optimal']:.4f} "
            f"P(1%)={perf['one_percent']:.4f}")
        if len(rec.calls) != 1 or not np.all(np.isfinite(sol.objective_values)):
            failures.append(f"phase 15 (d) {label}: {len(rec.calls)} launches, objective "
                            f"values finite: {np.all(np.isfinite(sol.objective_values))}")
        del sol, fac
    launched = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    log(f"phase 15: {time.perf_counter() - t15:.1f} s; launches {launched}")
    return launched, main_times


def native_phase(reports, dl_probe_rows, v_plain, counters, failures):
    """Phase 17: the native host I/O library, an evolution run of each
    façade, the validation tool's eight cases (their plain sides from the
    phase-5 workers, ``v_plain``) and ``breakdown --family dl``'s rows (built
    in phase 2, ``reports``), with the launch counts zeroed before and read
    after; returns the counts."""
    import glob
    import io
    import tempfile

    import numpy as np

    from ccvm_tpu_torch import (DLSolver, LangevinSolver, MFSolver, ProblemInstance,
                                PumpedLangevinSolver, native)
    from ccvm_tpu_torch.problem_classes.boxqp import problem_instance
    from ccvm_tpu_torch.tools import breakdown, validate

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t17 = time.perf_counter()
    # (a) Every bundled instance through the native tokenizer and through
    # its plain version, whole loads (file, header, body) timed by the host
    # clock, the order of the two alternating from file to file.
    log(f"phase 17 (a) native I/O library {os.path.relpath(native.library_path(), REPO)}, "
        f"built by: {' '.join(native.compile_command('<temp file>'))}, renamed into place")
    files = sorted(glob.glob(os.path.join(REPO, "examples", "benchmarking_instances",
                                          "Size*", "*.in"))) + [validate.INSTANCE]
    ms, differ = {"native": [], "plain": []}, []
    ways = [("native", native.fast_parse_matrix),
            ("plain", native.fast_parse_matrix_reference)]
    for k, path in enumerate(files):
        parsed = {}
        for label, parse in ways if k % 2 == 0 else ways[::-1]:
            with mock.patch.object(problem_instance, "fast_parse_matrix", parse):
                t = time.perf_counter()
                q, v, _, _ = problem_instance.parse_instance_file(path)
                ms[label].append(1e3 * (time.perf_counter() - t))
            parsed[label] = q.tobytes() + v.tobytes()
        if parsed["native"] != parsed["plain"]:
            differ.append(os.path.relpath(path, REPO))
    med = {label: float(np.median(x)) for label, x in ms.items()}
    log(f"phase 17 (a) {len(files)} instance files (the 300 of Size20..Size70 and the "
        f"single test instance) parsed through the native tokenizer and through "
        f"fast_parse_matrix_reference: {len(differ)} differ bit for bit; median host ms "
        f"a load {med['native']:.3f} native, {med['plain']:.3f} plain "
        f"({med['plain'] / med['native']:.2f} x)")
    if differ:
        failures.append(f"phase 17 (a): the native tokenizer differs on {differ}")

    # (b) An evolution run of each façade; its file against the plain
    # formatter's bytes of the same samples (the best trajectory's).
    with open(TUNED) as f:
        tuned_all = json.load(f)
    facades = {"dl": (DLSolver, ("c_sample", "s_sample")),
               "mf": (MFSolver, ("mu_sample", "sigma_sample")),
               "langevin": (LangevinSolver, ("c_sample",)),
               "pumped": (PumpedLangevinSolver, ("c_sample",))}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        for family, (cls, names) in facades.items():
            solver = cls(device="cuda", batch_size=P17_BATCH)
            solver.parameter_key = {N: {**tuned_all[family][str(N)],
                                        "iterations": ITERATIONS}}
            inst = ProblemInstance(device="cuda", instance_type="tuning", file_path=INSTANCE)
            inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
            path = os.path.join(tmp, f"{family}_evolution.txt")
            t = time.perf_counter()
            sol = solver(inst, seed=17, evolution_step_size=P17_STEP, evolution_file=path)
            wall = time.perf_counter() - t
            best = int(np.argmax(-np.asarray(sol.objective_values)))
            want = io.StringIO()
            for sample in names:
                native.write_sample_rows_reference(
                    want, getattr(solver, sample)[best].cpu().numpy(),
                    append_trailing_tab=family != "mf")
            with open(path, "rb") as f:
                got = f.read()
            same = got == want.getvalue().encode()
            rows = got.count(b"\n")
            log(f"phase 17 (b) {family} façade, batch {P17_BATCH}, {ITERATIONS} steps, "
                f"evolution_step_size {P17_STEP}: wall {wall:.3f} s; its evolution file "
                f"({len(got)} bytes, {rows} rows) "
                f"{'equals' if same else 'DIFFERS FROM'} format_rounded_reference's bytes "
                f"of the same samples")
            if not same:
                failures.append(f"phase 17 (b) {family}: the evolution file differs from "
                                f"the plain formatter's")

    # (c) The validation tool at its defaults.
    t = time.perf_counter()
    out_of_band = validate.validate(device="cuda", plain=v_plain, out=log)
    log(f"phase 17 (c) python -m ccvm_tpu_torch.tools.validate (batch 4096, "
        f"{ITERATIONS} steps, seed 7, popcount32): {len(validate.CASES)} cases, "
        f"{len(out_of_band)} gaps out of band; the kernels' side "
        f"{time.perf_counter() - t:.1f} s here, the plain versions' "
        f"{sum(sec for _, sec in v_plain.values()):.1f} s in the phase-5 workers")
    failures += [f"phase 17 (c) {case} {gap}: kernel {pk:.4f}, plain {pp:.4f}, out of band"
                 for case, gap, pk, pp in out_of_band]
    launched = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    # (d) breakdown --family dl (the probe builds are not counted: their
    # libraries are launched directly, never through a wrapper).
    breakdown.run_rows("dl", dl_probe_rows, batch=MAIN_BATCH, i1=P17_I1, i2=P17_I2,
                       reps=2, rounds=1, reports=reports,
                       out=lambda line: log(f"phase 17 (d) {line}"))
    log(f"phase 17: {time.perf_counter() - t17:.1f} s; launches {launched}")
    return launched


def main(cleanup):
    """Every phase; ``cleanup`` (a contextlib.ExitStack) stops the worker
    processes when the run ends or fails."""
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
    from ccvm_tpu_torch.ops import (build, dl_kernels, dl_variant_kernels,
                                    langevin_kernels, mf_kernels)
    from ccvm_tpu_torch.post_processor import PostProcessorGradDescent
    from ccvm_tpu_torch.tools import breakdown, kernel_experiments, validate
    from ccvm_tpu_torch.tools.tc_model import PARITY_TOL

    failures = []  # checks that fail, raised after every kernel was measured

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {name}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, count {torch.cuda.device_count()}")

    # 2. build. First the native host I/O library, at its first use in the
    # run: every instance file below is parsed by it.
    from ccvm_tpu_torch import native

    t0 = time.perf_counter()
    native_built = not os.path.exists(native.library_path())
    native.load_library()
    log(f"phase 2 native I/O library {os.path.relpath(native.library_path(), REPO)}: "
        f"{'built' if native_built else 'found'} in {time.perf_counter() - t0:.2f} s "
        f"({' '.join(native.compile_command('<temp file>'))}, renamed into place)")
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

    # The DL specialisations the run launches: (problem size, Adam
    # hyperparameters, noise, tensor-core matvec) by label.  The main path's
    # two are "DL" and "DL-Adam"; n 20 is the race harness's shape, and
    # "CUDA-core" the race row that production does not launch.
    dl_cases = {
        "DL": (N, None, True, True), "DL noise off": (N, None, False, True),
        "DL-Adam": (N, adam_hps[0.999], True, True),
        "DL-Adam noise off": (N, adam_hps[0.999], False, True),
        "DL-Adam beta2 1 noise off": (N, adam_hps[1.0], False, True),
        "DL n 20": (20, None, True, True), "DL n 20 noise off": (20, None, False, True),
        "DL-Adam n 20": (20, adam_hps[0.999], True, True),
        "DL CUDA-core": (N, None, True, False),
        "DL CUDA-core noise off": (N, None, False, False),
        "DL-Adam CUDA-core noise off": (N, adam_hps[0.999], False, False),
    }
    # The other bundled sizes: phase 9's holds (noise off) and
    # bench_torch.py's per-size table (noise on).
    for n in BUNDLED_SIZES:
        dl_cases.update({f"DL n {n}": (n, None, True, True),
                         f"DL n {n} noise off": (n, None, False, True),
                         f"DL-Adam n {n} noise off": (n, adam_hps[0.999], False, True)})

    def spec(n, hp, noise, mma):
        return dl_kernels._spec(n, hp, 1.0 if noise else 0.0, "popcount16", mma)

    def mf_spec(hp=None, noise=True, n=N):
        return mf_kernels._spec(n, hp, 1.0 if noise else 0.0, "popcount32")

    def lgv_spec(pumped, hp=None, noise=True, n=N):
        return langevin_kernels._spec(n, hp, 1.0 if noise else 0.0, "popcount32",
                                      pumped=pumped)

    specs = [spec(*case) for case in dl_cases.values()]
    # The MF specialisations: (Adam hyperparameters, noise) by label; the
    # first three are the main path's.
    mf_builds = {"MF": (None, True), "MF-Adam": (adam_hps[0.999], True),
                "MF-Adam beta2 1": (adam_hps[1.0], True),
                "MF noise off": (None, False),
                "MF-Adam noise off": (adam_hps[0.999], False),
                "MF-Adam beta2 1 noise off": (adam_hps[1.0], False)}
    specs += [mf_spec(*case) for case in mf_builds.values()]
    # The Langevin-family specialisations: (pumped, Adam hyperparameters,
    # noise) by label; those with noise are the main path's (the tuned Adam
    # parameters differ from the defaults only in alpha, a kernel argument).
    lgv_builds = {}
    for pumped, fam in ((False, "Langevin"), (True, "pumped")):
        lgv_builds.update({
            fam: (pumped, None, True), f"{fam} noise off": (pumped, None, False),
            f"{fam}-Adam": (pumped, adam_hps[0.999], True),
            f"{fam}-Adam noise off": (pumped, adam_hps[0.999], False),
            f"{fam}-Adam beta2 1 noise off": (pumped, adam_hps[1.0], False)})
    specs += [lgv_spec(*case) for case in lgv_builds.values()]
    # Phase 14's other sizes: the study's MF, Langevin and pumped sweeps and
    # the N=20 examples, noise on (DL's are among dl_cases).
    study_builds = {f"{fam} n {n}": (fam, n) for n in STUDY_SIZES[:-1]
                    for fam in ("MF", "Langevin", "pumped")}

    def study_spec(fam, n):
        return mf_spec(None, n=n) if fam == "MF" else lgv_spec(fam == "pumped", n=n)

    specs += [study_spec(*case) for case in study_builds.values()]
    # Each production kernel's Adam hyperparameters on the main path.
    main_hp = {"dl_solve": None, "dl_adam_solve": adam_hps[0.999],
               "mf_solve": None, "mf_adam_solve": adam_hps[0.999],
               "langevin_solve": None,
               "langevin_adam_solve": lgv_adam["langevin"].to_hyperparameters(),
               "pumped_langevin_solve": None,
               "pumped_langevin_adam_solve": lgv_adam["pumped"].to_hyperparameters()}

    def feature_spec(kname, noise, cols, seg, elem=False):
        """The build of a kernel that phases 12 and 15 launch: ``cols`` its
        per-column S (DL: 1 at pump > 1, 2 at pump <= 1), ``seg`` a segment
        launch, ``elem`` (with ``cols``) its per-element S."""
        hp, ns = main_hp[kname], 1.0 if noise else 0.0
        family = kname.split("_")[0]
        if family == "dl":
            return dl_kernels._spec(N, hp, ns, "popcount16", True, cols, seg, elem)
        if family == "mf":
            return mf_kernels._spec(N, hp, ns, "popcount32", bool(cols), seg, elem)
        return langevin_kernels._spec(N, hp, ns, "popcount32", pumped=family == "pumped",
                                      cols=bool(cols), seg=seg, elem=elem)

    # Phase 12's builds, (kernel, noise, cols, seg): segments with the noise
    # on (a, b), a per-column S with the noise off and on (c; DL also at
    # pump 0.9), and both at once on the façades (e).
    feature_builds = sorted({
        (k, noise, cols, seg) for k in main_hp
        for noise, cols, seg in ((True, 0, True), (False, 1, False), (True, 1, False),
                                 (True, 1, True))
    } | {(k, noise, 2, False) for k in ("dl_solve", "dl_adam_solve")
         for noise in (False, True)})
    # Phase 15's per-element builds, (kernel, noise, cols, seg, elem): noise
    # off and on, DL also at pump 0.9 (cols 2); its per-column and scalar
    # ones are phase 12's and 7's.
    feature_builds += sorted(
        {(k, noise, 1, False, True) for k in main_hp for noise in (False, True)}
        | {(k, noise, 2, False, True) for k in ("dl_solve", "dl_adam_solve")
           for noise in (False, True)})
    specs += [feature_spec(*case) for case in feature_builds]
    # The race harness's variants: (v3, fuse, unroll, rng name) of phase 8's
    # noise-off holds (rng unused), its noise-on holds and its race rows.
    variant_cases = {
        "off": [(False, False, 8, None), (False, True, 8, None),
                (True, False, 8, None), (True, False, 16, None)],
        "on": [(False, False, 8, "popcount1"), (False, True, 8, "popcount1"),
               (False, False, 8, "popcount2"), (True, False, 8, "popcount1"),
               (True, False, 8, "popcount2"), (True, False, 16, "popcount1"),
               (True, False, 16, "popcount2"), (False, True, 1, "popcount1"),
               (True, False, 1, "popcount1")],
    }

    def variant_spec(v3, fuse, unroll, rng_name, n=N):
        return dl_variant_kernels._spec(v3, fuse, unroll, 0.0 if rng_name is None else 1.0,
                                        rng_name or "popcount1", n)

    variant_specs = [variant_spec(*case) for cases in variant_cases.values()
                     for case in cases]
    # ... and at the race's own shape (n 20): each race row, noise off and on.
    variant_specs += [variant_spec(kind == "v3", kw.get("fuse_matvec", False), kw["unroll"],
                                   rng_name, 20)
                      for _, kind, kw in kernel_experiments.ROWS if kind in ("v2", "v3")
                      for rng_name in (None, kw["rng_name"])]
    variant_specs = list(dict.fromkeys(variant_specs))
    specs += variant_specs
    # Phase 16's one-step builds (CCVM_EXT), noise on and off; one library
    # serves every N.
    for family, adam, _ in STEP_KERNELS.values():
        for noise in (1.0, 0.0):
            hp = adam_hps[0.999] if adam else None
            if family == "dl":
                ext = dl_kernels._spec(8, hp, noise, "popcount16", True)
            elif family == "mf":
                ext = mf_kernels._spec(4, hp, noise, "popcount32")
            else:
                ext = langevin_kernels._spec(8, hp, noise, "popcount32",
                                             pumped=family == "pumped")
            specs.append(ext._replace(ext=True))
    # Phase 17's: the validation tool's eight cases at N=20 (its default
    # transform, popcount32; Adam with its alpha 0.1 and add-assign) and
    # breakdown --family dl's probe rows (CCVM_MATVEC, CCVM_NOISE and each
    # transform; not kernels of the path: they are launched only there).
    v_hp = validate.VARIANTS[1][1].to_hyperparameters()
    for hp in (None, v_hp):
        specs += [dl_kernels._spec(20, hp, 1.0, "popcount32", True),
                  mf_kernels._spec(20, hp, 1.0, "popcount32"),
                  langevin_kernels._spec(20, hp, 1.0, "popcount32", pumped=False),
                  langevin_kernels._spec(20, hp, 1.0, "popcount32", pumped=True)]
    dl_probe_rows = breakdown.dl_rows()
    specs += [row[4] for row in dl_probe_rows]
    # The build runs in a thread while the plain workers below start: their
    # plain solves need no kernel, and they are the run's longest phase.
    # Its report is read, and every library loaded, only after it ends.

    def timed_build():
        t = time.perf_counter()
        return build.build(specs), time.perf_counter() - t

    builder = concurrent.futures.ThreadPoolExecutor(1)
    cleanup.callback(builder.shutdown)
    build_future = builder.submit(timed_build)
    # Scaled instances on the card, through the user-facing entry points.
    def instance(path, solver_cls=DLSolver, instance_type="tuning"):
        inst = ProblemInstance(device="cuda", instance_type=instance_type, file_path=path)
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

    def run_pair(seed, batch, iterations, hp, noise_scale, q=None, v=None,
                 kernel=dl_kernels.dl_solve):
        kw = dict(iterations=iterations, batch_size=batch, pump_rate_flag=True,
                  pump_is_gt_one=tuned["pump"] > 1, noise_scale=noise_scale,
                  rng="popcount16", hp=hp)
        q = inst.q_matrix if q is None else q
        v = inst.v_vector if v is None else v
        p = params(iterations)
        ck, sk = kernel(seed, q, v, p, **kw)
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

    def hold(kname, label, err, what, tol=PARITY_TOL, defer=False):
        """Hold a kernel's largest difference from its plain version; with
        ``defer`` a failure is raised only after every kernel was measured."""
        max_err[kname] = max(max_err.get(kname, 0.0), err)
        log(f"{what} {label}: max |kernel - plain| = {err:.3e} (tol {tol})")
        if err > tol:
            failures.append(f"{label}: {what} parity {err} > {tol}")
            assert defer, failures[-1]

    # The plain solves at full depth (phase 5's statistics, phase 7's holds of
    # the Langevin family over 15,000 steps) are host-bound eager loops of a
    # minute or more each: worker processes run them on the card beside
    # phases 3-5, and every one has ended before phase 6 times anything.
    # (kernel wrapper, plain version, seed, instance, params, kwargs) by
    # (phase, label).
    full = dict(iterations=ITERATIONS, noise_scale=1.0)
    jobs = {}
    for kname in ("langevin_solve", "langevin_adam_solve", "pumped_langevin_solve",
                  "pumped_langevin_adam_solve"):
        family = kname.split("_")[0]
        kernel, plain, extra = lgv_fns(family)
        jobs["phase 7", kname] = (
            kernel, plain, 100, lgv_inst[family], lgv_params(family, ITERATIONS),
            dict(extra, **full, batch_size=MAIN_BATCH, rng="popcount32",
                 hp=main_hp[kname]))
    for label, hp in (("DL", None), ("DL-Adam", adam_hps[0.999])):
        jobs["phase 5", label] = (
            dl_kernels.dl_solve, dl_kernels.dl_solve_reference, 21, inst,
            params(ITERATIONS),
            dict(full, batch_size=4096, pump_rate_flag=True,
                 pump_is_gt_one=tuned["pump"] > 1, rng="popcount16", hp=hp))
    jobs["phase 5", "MF"] = (
        mf_kernels.mf_solve, mf_kernels.mf_solve_reference, 21, mf_inst,
        mf_params(ITERATIONS),
        dict(full, batch_size=4096, pump_rate_flag=True, rng="popcount32", hp=None))
    for family in lgv_cls:
        kernel, plain, extra = lgv_fns(family)
        jobs["phase 5", family] = (
            kernel, plain, 21, lgv_inst[family], lgv_params(family, ITERATIONS),
            dict(extra, **full, batch_size=4096, rng="popcount32", hp=None))
    # tools/tpu_validate.py's N=20 instance and DL parameters (the
    # validation tool's, S 1) with DL's default transform, popcount16, which
    # the tool's cases (popcount32) do not build: DL-Adam.
    vd = validate.PARAMS["dl"][1]
    v20 = instance(validate.INSTANCE, DLSolver, "test")
    v20_solver = DLSolver(device="cuda")
    v20_solver.solution_bounds = v20.solution_bounds
    jobs["phase 5", "DL-Adam N=20"] = (
        dl_kernels.dl_solve, dl_kernels.dl_solve_reference, 21, v20,
        v20_solver._make_params(vd["pump"], 1.0, vd["dt"], vd["noise_ratio"],
                                vd["feedback_scale"], G, ITERATIONS),
        dict(full, batch_size=4096, pump_rate_flag=True, pump_is_gt_one=vd["pump"] > 1,
             rng="popcount16", hp=adam_hps[0.999]))
    # Phase 12's cases (batch 1024, 2,000 steps) and their plain versions,
    # which run in the workers after phase 5's and 7's: (b) the samples of
    # the plan of step 250, noise on; (c) a per-column S drawn from a seed
    # in [0.5 S, 1.5 S], noise off and on (DL also at pump 0.9, with its
    # scalar-S kernel's plain version beside it); (d) DL's generalised ramps.
    p12_plan = DLSolver._evolution_sample_plan(P12_STEPS, P12_STEP)[1]
    scalar_S = scalar_saturations(tuned_all)
    p12_S = phase12_saturations(tuned_all)
    p12_fns = {  # family: (module, whole solve, sampled solve)
        "dl": (dl_kernels, "dl_solve", "dl_solve_sampled"),
        "mf": (mf_kernels, "mf_solve", "mf_solve_sampled"),
        "langevin": (langevin_kernels, "langevin_solve", "langevin_solve_sampled"),
        "pumped": (langevin_kernels, "pumped_langevin_solve",
                   "pumped_langevin_solve_sampled")}
    p12_inst = {"dl": inst, "mf": mf_inst, **lgv_inst}

    def p12_case(label, iterations, batch, noise, S=None, ramp=None):
        """(family, kernel wrapper, sampled wrapper, plain names, q, v,
        params, kwargs) of a phase-12 label: a kernel name, or "<kernel> pump
        0.9" for DL at pump 0.9; S one a column (None: the tuned scalar)."""
        kname, _, pump = label.partition(" pump ")
        family = kname.split("_")[0]
        mod, whole, sampled = p12_fns[family]
        pump = float(pump) if pump else None
        if family == "dl":
            p = solver._make_params(tuned["pump"] if pump is None else pump,
                                    1.0 if S is None else S, tuned["dt"],
                                    tuned["noise_ratio"], tuned["feedback_scale"], G,
                                    iterations, pump_ramp=ramp)
            kw = dict(pump_rate_flag=True, rng="popcount16",
                      pump_is_gt_one=(tuned["pump"] if pump is None else pump) > 1)
        elif family == "mf":
            p = mf_solver._make_params(mf_tuned["pump"], mf_tuned["S"] if S is None else S,
                                       mf_tuned["dt"], mf_tuned["j"],
                                       mf_tuned["feedback_scale"], MF_G, iterations)
            kw = dict(pump_rate_flag=True, rng="popcount32")
        else:
            t = lgv_tuned[family]
            p = lgv_params(family, iterations)._replace(
                S=t["S"] if S is None else tuple(float(x) for x in S))
            kw = dict(rng="popcount32", **({"pump_rate_flag": True}
                                           if family == "pumped" else {}))
        kw.update(batch_size=batch, noise_scale=noise, hp=main_hp[kname])
        return (family, getattr(mod, whole), getattr(mod, sampled), mod.__name__,
                p12_inst[family].q_matrix, p12_inst[family].v_vector, p, kw)

    p12_jobs = {}
    for kname in main_hp:
        _, _, _, module, q_, v_, p_, kw_ = p12_case(kname, P12_STEPS, P12_BATCH, 1.0)
        p12_jobs["b", kname] = (module, f"{p12_fns[kname.split('_')[0]][2]}_reference", 5,
                                q_, v_, p_, dict(kw_, segments=p12_plan))
    for label in list(main_hp) + ["dl_solve pump 0.9", "dl_adam_solve pump 0.9"]:
        family = label.split("_")[0]
        for noise in (0.0, 1.0):
            for kind, S, steps in (("c", p12_S[family], P12_STEPS),
                                   ("c scalar", None, P12_STEPS),
                                   ("c hold", p12_S[family], P12_DL_HOLD_STEPS.get(label))):
                if kind != "c" and family != "dl" or kind == "c scalar" and not noise:
                    continue
                _, _, _, module, q_, v_, p_, kw_ = p12_case(label, steps, P12_BATCH,
                                                            noise, S=S)
                p12_jobs[kind, label, noise] = (
                    module, f"{p12_fns[family][1]}_reference", 6, q_, v_, p_,
                    dict(kw_, iterations=steps))
    for kname in ("dl_solve", "dl_adam_solve"):
        for ramp in P12_RAMPS:
            for noise in (0.0, 1.0):
                _, _, _, module, q_, v_, p_, kw_ = p12_case(kname, P12_STEPS, P12_BATCH,
                                                            noise, ramp=ramp)
                p12_jobs["d", kname, ramp, noise] = (
                    module, "dl_solve_reference", 6, q_, v_, p_,
                    dict(kw_, iterations=P12_STEPS))
    workers = min(len(jobs), max(1, (os.cpu_count() or 2) - 1))
    pool = PlainWorkers(workers)
    cleanup.callback(pool.close)
    t_pool = time.perf_counter()
    futures = {key: pool.submit(plain.__module__, plain.__name__, seed,
                                inst_.q_matrix.cpu().numpy(),
                                inst_.v_vector.cpu().numpy(), p, kw)
               for key, (_, plain, seed, inst_, p, kw) in jobs.items()}
    # The plain sides of tools/tpu_validate.py's eight cases on its N=20
    # instance (its twin's, ccvm_tpu_torch/tools/validate.py: each a façade
    # solve with its whole-solve call sent to the plain version), whose bands
    # phase 17 (c) holds.
    v_futures = {case: pool.submit_call("ccvm_tpu_torch.tools.validate",
                                        "case_performance", {"case": case, "plain": True})
                 for case in validate.CASES}
    # Phase 12's plain solves, a few seconds each: in groups, one process
    # each, after the others.
    p12_keys = list(p12_jobs)
    p12_groups = [p12_keys[g::P12_GROUPS] for g in range(P12_GROUPS)]
    p12_futures = [pool.submit_many([
        (module, function, seed, q_.cpu().numpy(), v_.cpu().numpy(), p_, kw_)
        for module, function, seed, q_, v_, p_, kw_ in (p12_jobs[k] for k in group)])
        for group in p12_groups]

    reports, build_s = build_future.result()
    log(f"phase 2 build: {len(reports)} libraries in {build_s:.1f} s from "
        f"ccvm_tpu_torch/csrc (dl_solve.cu, mf_solve.cu, langevin_solve.cu, "
        f"dl_variants.cu, ccvm_common.cuh), beside the plain workers' start")
    for s, rep in reports.items():
        log(f"  {type(s).__name__} {s.tag()}: {build.kernel_report(rep)}")
    # The DL specialisations' residency, as the card reports it, and the
    # main path's spills, resident warps and waves.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (n, hp, noise, mma) in dl_cases.items():
        blocks = dl_kernels.blocks_per_sm(n, noise_scale=1.0 if noise else 0.0,
                                          hp=hp, mma=mma)
        shape = build.dl_launch_shape(n, hp is not None, mma)
        warps = blocks * shape.threads // 32
        waves = build.waves(MAIN_BATCH, shape._replace(blocks_per_sm=blocks), sms)
        log(f"  {label} ({spec(n, hp, noise, mma).tag()}): {blocks} blocks per SM "
            f"of {shape.threads} threads ({warps} warps), {shape.rows} trajectories "
            f"and {shape.smem} bytes of shared memory a block; batch {MAIN_BATCH} "
            f"is {waves:.3f} waves of {sms} SMs")
        if label not in ("DL", "DL-Adam"):
            continue
        rep = reports.get(spec(n, hp, noise, mma))
        spill = [ln for ln in (rep or "").splitlines() if "spill" in ln]
        if rep is None:
            log(f"  {label}: built before this run, its ptxas report not read")
        elif not all(" 0 bytes spill stores, 0 bytes spill loads" in ln for ln in spill):
            failures.append(f"{label} spills: {spill}")
        if label == "DL-Adam" and warps < 16:
            failures.append(f"DL-Adam keeps {warps} warps per SM resident, not 16")
        if label == "DL" and waves / -(-waves // 1) < 0.9:
            failures.append(f"DL's grid fills {waves:.3f} waves, not whole ones within 10%")
    # The race variants' residency (phase 8), as the card reports it: at
    # N=70 two blocks of 64 trajectories an SM, as the production DL kernel.
    for vs in variant_specs:
        n = N if vs.nt == -(-N // 8) else 20
        blocks = dl_variant_kernels.blocks_per_sm(vs, n)
        shape = build.variant_launch_shape(n, vs.fuse)
        log(f"  DL variant {vs.tag()} at n {n}: {blocks} blocks per SM of {shape.threads} "
            f"threads, {shape.rows} trajectories and {shape.smem} bytes of shared memory "
            f"a block")
        if n == N and blocks != shape.blocks_per_sm:
            failures.append(f"DL variant {vs.tag()} keeps {blocks} blocks per SM resident, "
                            f"not {shape.blocks_per_sm}")
    # The MF specialisations' residency as the card reports it; the main
    # path's three hold no spills, at least 16 warps per SM and whole waves
    # within 10%.
    for label, (hp, noise) in mf_builds.items():
        blocks = mf_kernels.blocks_per_sm(N, noise_scale=1.0 if noise else 0.0, hp=hp)
        shape = build.mf_launch_shape(N, hp is not None)
        warps = blocks * -(-shape.threads // 32)
        waves = build.waves(MAIN_BATCH, shape._replace(blocks_per_sm=blocks), sms)
        rep = reports.get(mf_spec(hp, noise))
        log(f"  {label} ({mf_spec(hp, noise).tag()}): "
            f"{build.kernel_report(rep) if rep else 'built before this run'}; "
            f"{blocks} blocks per SM of {shape.threads} threads ({warps} warps), "
            f"{shape.rows} trajectories and {shape.smem} bytes of shared memory a "
            f"block; batch {MAIN_BATCH} is {waves:.3f} waves of {sms} SMs")
        if not noise:
            continue
        if rep is not None and "0 bytes spill stores, 0 bytes spill loads" not in \
                build.kernel_report(rep):
            failures.append(f"{label} spills: {build.kernel_report(rep)}")
        if warps < 16:
            failures.append(f"{label} keeps {warps} warps per SM resident, not 16")
        if waves / -(-waves // 1) < 0.9:
            failures.append(f"{label}'s grid fills {waves:.3f} waves, not whole ones "
                            f"within 10%")
    # The Langevin family's residency as the card reports it; every
    # specialisation holds no spills, the main path's four (noise on) the
    # blocks per SM that the launch rule plans (two of 4 warps at N=70: its
    # wide thread tile takes up to 255 registers) and whole waves within 10%.
    for label, (pumped, hp, noise) in lgv_builds.items():
        blocks = langevin_kernels.blocks_per_sm(
            N, pumped=pumped, noise_scale=1.0 if noise else 0.0, hp=hp)
        shape = build.langevin_launch_shape(N, hp is not None)
        warps = blocks * shape.threads // 32
        waves = build.waves(MAIN_BATCH, shape._replace(blocks_per_sm=blocks), sms)
        rep = reports.get(lgv_spec(pumped, hp, noise))
        log(f"  {label} ({lgv_spec(pumped, hp, noise).tag()}): "
            f"{build.kernel_report(rep) if rep else 'built before this run'}; "
            f"{blocks} blocks per SM of {shape.threads} threads ({warps} warps), "
            f"{shape.rows} trajectories and {shape.smem} bytes of shared memory a "
            f"block; batch {MAIN_BATCH} is {waves:.3f} waves of {sms} SMs")
        if rep is not None and "0 bytes spill stores, 0 bytes spill loads" not in \
                build.kernel_report(rep):
            failures.append(f"{label} spills: {build.kernel_report(rep)}")
        if not noise:
            continue
        if blocks != shape.blocks_per_sm:
            failures.append(f"{label} keeps {blocks} blocks per SM resident, not "
                            f"{shape.blocks_per_sm}")
        if waves / -(-waves // 1) < 0.9:
            failures.append(f"{label}'s grid fills {waves:.3f} waves, not whole ones "
                            f"within 10%")
    # Phase 14's builds: registers, spills and residency (the waves of a
    # study sweep, 50 x 1000 rows); no Langevin-family build may spill.
    for label, (fam, n) in study_builds.items():
        if fam == "MF":
            blocks = mf_kernels.blocks_per_sm(n)
            shape = build.mf_launch_shape(n, False)
        else:
            blocks = langevin_kernels.blocks_per_sm(n, pumped=fam == "pumped")
            shape = build.langevin_launch_shape(n, False)
        rep = reports.get(study_spec(fam, n))
        report = build.kernel_report(rep) if rep else "built before this run"
        waves = 50 * build.waves(1000, shape._replace(blocks_per_sm=blocks), sms)
        log(f"  {label} ({study_spec(fam, n).tag()}): {report}; {blocks} blocks per SM "
            f"of {shape.threads} threads, {shape.rows} trajectories and {shape.smem} bytes "
            f"of shared memory a block; 50 x 1000 rows are {waves:.3f} waves of {sms} SMs")
        if fam != "MF" and rep is not None and \
                "0 bytes spill stores, 0 bytes spill loads" not in report:
            failures.append(f"{label} spills: {report}")
    # Phase 12's and 15's builds: registers, spills and residency; no
    # Langevin-family build of phase 12 may spill (the per-element builds
    # read S from global memory and are reported: speed is later work).
    for kname, noise, cols, seg, *elem in feature_builds:
        elem = bool(elem and elem[0])
        fs = feature_spec(kname, noise, cols, seg, elem)
        family, hp = kname.split("_")[0], main_hp[kname]
        ns = 1.0 if noise else 0.0
        if family == "dl":
            blocks = dl_kernels.blocks_per_sm(N, noise_scale=ns, hp=hp, cols=cols, seg=seg,
                                              elem=elem)
            shape = build.dl_launch_shape(N, hp is not None, True, cols)
        elif family == "mf":
            blocks = mf_kernels.blocks_per_sm(N, noise_scale=ns, hp=hp, cols=bool(cols),
                                              seg=seg, elem=elem)
            shape = build.mf_launch_shape(N, hp is not None, bool(cols))
        else:
            blocks = langevin_kernels.blocks_per_sm(
                N, pumped=family == "pumped", noise_scale=ns, hp=hp, cols=bool(cols),
                seg=seg, elem=elem)
            shape = build.langevin_launch_shape(N, hp is not None, bool(cols))
        rep = reports.get(fs)
        report = build.kernel_report(rep) if rep else "built before this run"
        log(f"  {kname} noise {int(noise)} cols {cols} seg {int(seg)} elem {int(elem)} "
            f"({fs.tag()}): {report}; {blocks} blocks per SM of {shape.threads} threads, "
            f"{shape.smem} bytes of shared memory a block")
        if family in ("langevin", "pumped") and not elem and rep is not None and \
                "0 bytes spill stores, 0 bytes spill loads" not in report:
            failures.append(f"{kname} (cols {cols}, seg {int(seg)}) spills: {report}")

    def plain_result(key):
        """A worker's plain outputs, back on the card, and its seconds."""
        arrays, seconds = futures[key].result()
        out = tuple(torch.from_numpy(a).cuda() for a in arrays)
        return (out if len(out) > 1 else out[0]), seconds

    log(f"phase 3 starts {time.perf_counter() - t_start:.1f} s into the run")
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

    log(f"phase 4 starts {time.perf_counter() - t_start:.1f} s into the run")
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

    log(f"phase 10 starts {time.perf_counter() - t_start:.1f} s into the run")
    # 10, the holds. The post-processors on the main path: DLSolver, MFSolver
    # and LangevinSolver at the main shape with each post-processor (here
    # beside phase 5's workers; their timed run is after phase 6), each
    # refinement held against the same post-processor on the CPU, on its
    # input copied to the host, in a thread whose every result is read
    # before phase 6 times anything.
    from ccvm_tpu_torch.post_processor import PostProcessorFactory

    create = PostProcessorFactory.create_postprocessor
    captured = []

    def capturing(method):
        """The factory's post-processor, its input and itself recorded."""
        pp = create(method)
        refine = pp.postprocess

        def postprocess(c, q_matrix, v_vector, *args, **kwargs):
            captured.append((pp, c.clone()))
            return refine(c, q_matrix, v_vector, *args, **kwargs)

        pp.postprocess = postprocess
        return pp

    def on_cpu(method, c, q, v):
        return create(method).postprocess(c, q, v)

    pp_cases = (("DL", DLSolver, pk, inst, {}),
                ("MF", MFSolver, mf_pk, mf_inst, {"g": MF_G}),
                ("Langevin", LangevinSolver, lgv_pk["langevin"], lgv_inst["langevin"], {}))

    def pp_runs(then=None):
        """(Solution, post-processor, its input, instance) by (solver, method):
        the façades at the main shape (timing "sync", so pp_time is the
        post-processor's own), seed 1; ``then(key, run)`` after each run."""
        runs = {}
        with mock.patch.object(PostProcessorFactory, "create_postprocessor",
                               staticmethod(capturing)):
            for label, cls, pkey, inst_, call in pp_cases:
                pp_solver = cls(device="cuda", batch_size=MAIN_BATCH)
                pp_solver.parameter_key = pkey
                for method in PP_TOL:
                    sol = pp_solver(inst_, seed=1, post_processor=method, **call)
                    (pp, c_in), = captured
                    captured.clear()
                    runs[label, method] = (sol, pp, c_in, inst_)
                    if then is not None:
                        then((label, method), runs[label, method])
        return runs

    t10 = time.perf_counter()
    # The CPU holds take cores that phase 5's workers share: three threads,
    # each hold started as soon as its run has ended.
    threads = torch.get_num_threads()
    torch.set_num_threads(min(3, threads))
    cpu_holds = concurrent.futures.ThreadPoolExecutor(1)
    cleanup.callback(cpu_holds.shutdown, wait=True, cancel_futures=True)
    cpu_refinements = {}

    def hold_on_cpu(key, run):
        _, _, c_in, inst_ = run
        cpu_refinements[key] = cpu_holds.submit(
            on_cpu, key[1], c_in.cpu(), inst_.q_matrix.cpu(), inst_.v_vector.cpu())

    held = pp_runs(then=hold_on_cpu)
    log(f"phase 10 post-processors to hold: {len(held)} façade runs on the card in "
        f"{time.perf_counter() - t10:.1f} s; their CPU holds run beside phase 5")
    log(f"phase 5 starts {time.perf_counter() - t_start:.1f} s into the run")
    # 5. noise on, statistics over a full-length solve
    def performance(instance_, energies, batch):
        return Solution(
            problem_size=instance_.problem_size, batch_size=batch,
            instance_name=instance_.name,
            iterations=ITERATIONS, objective_values=energies, solve_time=0.0,
            pp_time=0.0, optimal_value=instance_.optimal_sol,
            best_value=instance_.best_sol, num_frac_values=instance_.num_frac_values,
            solution_vector=[], variables={}).solution_performance

    def stats_pair(label):
        """The kernel's outputs of a phase-5 job, its plain version's from the
        worker, their largest difference and the plain seconds."""
        kernel, _, seed, inst_, p, kw = jobs["phase 5", label]
        out = kernel(seed, inst_.q_matrix, inst_.v_vector, p, **kw)
        ref, plain_s = plain_result(("phase 5", label))
        return out, ref, max_diff(out, ref), plain_s

    cv = ("boxqp", *inst.solution_bounds, 1.0)
    for label in ("DL", "DL-Adam"):
        (ck, _), (cr, _), err, plain_s = stats_pair(label)
        perf = [performance(inst, inst.compute_energy_readout64(c, change_vars=cv),
                            4096) for c in (ck, cr)]
        log(f"phase 5 {label} statistics: batch 4096, {ITERATIONS} steps, plain "
            f"version {plain_s:.2f} s in a worker, max |kernel - plain| = {err:.3e}")
        assert success_band_ok(perf[0], perf[1], 4096), \
            f"{label} success probabilities disagree"

    out, ref, err, plain_s = stats_pair("MF")
    lo, hi = mf_inst.solution_bounds
    perf = []
    for mt in (out[1], ref[1]):
        confs = PostProcessorGradDescent().postprocess(
            mf_solver.change_variables(mt, lo, hi, mf_tuned["S"]),
            mf_inst.q_matrix, mf_inst.v_vector)
        perf.append(performance(mf_inst, mf_inst.compute_energy_readout64(confs), 4096))
    log(f"phase 5 MF statistics: batch 4096, {ITERATIONS} steps, readout through "
        f"grad-descent, plain version {plain_s:.2f} s in a worker, max |kernel - "
        f"plain| = {err:.3e}")
    assert success_band_ok(perf[0], perf[1], 4096), "MF success probabilities disagree"

    # The N=20 DL-Adam case with popcount16: the readout as the façade gives
    # it without post-processing.
    out, ref, err, plain_s = stats_pair("DL-Adam N=20")
    cv20 = ("boxqp", *v20.solution_bounds, 1.0)
    perf = [performance(v20, v20.compute_energy_readout64(c, change_vars=cv20), 4096)
            for c in (out[0], ref[0])]
    log(f"phase 5 DL-Adam N=20 statistics (tools/tpu_validate.py's instance and DL "
        f"parameters, popcount16): batch 4096, {ITERATIONS} steps, plain version "
        f"{plain_s:.2f} s in a worker, max |kernel - plain| = {err:.3e}")
    assert success_band_ok(perf[0], perf[1], 4096), \
        "DL-Adam N=20 success probabilities disagree"

    for family in lgv_cls:
        ck, cr, err, plain_s = stats_pair(family)
        li = lgv_inst[family]
        perf = []
        for c in (ck, cr):
            confs = PostProcessorGradDescent().postprocess(
                langevin_change_variables(c, float(lgv_tuned[family]["S"])),
                li.q_matrix, li.v_vector)
            perf.append(performance(li, li.compute_energy_readout64(confs), 4096))
        log(f"phase 5 {family} statistics: batch 4096, {ITERATIONS} steps, readout "
            f"through (c+S)/(2S) and grad-descent, plain version {plain_s:.2f} s in "
            f"a worker, max |kernel - plain| = {err:.3e}")
        assert success_band_ok(perf[0], perf[1], 4096), \
            f"{family} success probabilities disagree"
    # Phase 7's plain solves over 15,000 steps; then the workers stop.
    deep_plain = {key[1]: plain_result(key)[0] for key in jobs if key[0] == "phase 7"}
    p12_plain = {}
    for group, future in zip(p12_groups, p12_futures):
        for key, (arrays, seconds) in zip(group, future.result()):
            p12_plain[key] = [torch.from_numpy(a).cuda() for a in arrays]
    v_plain = {case: future.result() for case, future in v_futures.items()}
    pool.close()
    log(f"phase 5 workers: {len(jobs) + len(v_plain)} plain solves at full depth in {workers} "
        f"processes, all ended {time.perf_counter() - t_pool:.1f} s after the first "
        f"started")

    t10 = time.perf_counter()
    for (label, method), future in cpu_refinements.items():
        sol, _, _, inst_ = held[label, method]
        out, ref = sol.variables["problem_variables"].cpu(), future.result()
        diff = (out - ref).abs()
        tol = PP_TOL[method]
        rows = int((diff > tol).any(1).sum())
        allowed = int(BFGS_ROW_SHARE * MAIN_BATCH) if method == "bfgs" else 0
        log(f"phase 10 {label} with {method}: max |card - CPU| = "
            f"{diff.max().item():.3e} (tol {tol}), {int((diff > tol).sum())} of "
            f"{diff.numel()} elements in {rows} rows over it (at most {allowed} rows "
            f"may be)")
        if method == "bfgs":
            # What BFGS minimises, at both ends: on the rows that parted, and
            # its mean over the batch.
            q_, v_ = inst_.q_matrix.cpu(), inst_.v_vector.cpu()
            e_card, e_cpu = (energies64(0.5 * (x + 1), q_, v_) for x in (out, ref))
            apart = (diff > tol).any(1)
            shift = abs(e_card.mean().item() - e_cpu.mean().item()) / abs(e_cpu.mean().item())
            log(f"  on those rows the card's energy is lower on "
                f"{int((e_card[apart] < e_cpu[apart]).sum())} and higher on "
                f"{int((e_card[apart] > e_cpu[apart]).sum())}; the batch's mean energy "
                f"{e_card.mean().item():.6f} on the card, {e_cpu.mean().item():.6f} on "
                f"the CPU ({shift:.2e} apart, at most {BFGS_MEAN_TOL})")
            if shift > BFGS_MEAN_TOL:
                failures.append(f"{label} with bfgs: mean energy {shift} apart")
        if rows > allowed:
            failures.append(f"{label} with {method}: {rows} rows of card against CPU "
                            f"over {tol} (max {diff.max().item()})")
    cpu_holds.shutdown()
    torch.set_num_threads(threads)
    log(f"phase 10 CPU holds: all read {time.perf_counter() - t10:.1f} s after the "
        f"workers ended")
    log(f"phase 6 starts {time.perf_counter() - t_start:.1f} s into the run")
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

    counters = launch_counters()
    assert tuple(counters) == KERNELS

    def zero_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def counts():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    def only(**expected):
        """Launch counts with every kernel not named at 0."""
        return {k: expected.get(k, 0) for k in KERNELS}

    event_ms = {}  # each main path's kernel times (CUDA events) by label
    main_walls = {}  # ... and its best wall

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
        event_ms[label] = kernel_ms
        main_walls[label] = best_wall
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

    # 10, the timed run: the same façade runs with the card to themselves,
    # the launch counts zeroed before and read after.
    t10 = time.perf_counter()
    zero_counts()
    timed_runs = pp_runs()
    launched_pp = counts()
    assert launched_pp == only(dl_solve=4, mf_solve=4, langevin_solve=4), launched_pp
    for (label, method), (sol, pp, c_in, inst_) in timed_runs.items():
        out = sol.variables["problem_variables"]
        assert out.shape == (MAIN_BATCH, N) and out.is_cuda
        if not (torch.isfinite(out).all() and np.all(np.isfinite(sol.objective_values))):
            failures.append(f"{label} with {method}: not finite")
        perf = sol.solution_performance
        again = (out - held[label, method][0].variables["problem_variables"]).abs().max()
        log(f"phase 10 {label} with {method}: pp_time {1e3 * pp.pp_time:.1f} ms at batch "
            f"{MAIN_BATCH}, N={N}, P(0.1%)={perf['optimal']:.4f} "
            f"P(1%)={perf['one_percent']:.4f} best={sol.best_objective_value:.3f}/"
            f"{sol.optimal_value:.3f}; max |this run - the held run| {again.item():.3e}")
        if method == "bfgs":
            rise = (energies64(0.5 * (out + 1), inst_.q_matrix, inst_.v_vector)
                    - energies64(0.5 * (c_in + 1), inst_.q_matrix,
                                 inst_.v_vector)).max().item()
            log(f"  {label} bfgs: largest rise of a row's energy {rise:.3e} "
                f"(at most {BFGS_ENERGY_TOL})")
            if rise > BFGS_ENERGY_TOL:
                failures.append(f"{label} bfgs raised an energy by {rise}")
    del held, timed_runs
    log(f"phase 10 post-processors timed: {time.perf_counter() - t10:.1f} s; launches "
        f"{launched_pp}")
    log(f"phase 7 starts {time.perf_counter() - t_start:.1f} s into the run")
    # 7. kernels: time, bound and plain time at the main-path shape
    def timed(fn):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        out = fn()
        events[1].record()
        torch.cuda.synchronize()
        return out, events[0].elapsed_time(events[1])

    kernels = []
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
        plain_depth = EARLIER_PLAIN_DEPTH
        growth = {}
        if family in lgv_cls:
            ref = deep_plain[kname]
            growth[ITERATIONS] = (max_diff(out, ref), (out - ref).abs())
        depths = (EARLIER_PLAIN_DEPTH,) if family == "dl" else (100, 1000)
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
        share = f"{100 * b_ms / min(times):.1f}% of it"
        row = {
            "name": kname, "route": "cuda",
            "source": f"ccvm_tpu_torch/csrc/{sources[family]}",
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": max_err[kname], "ms": min(times),
            "plain_ms": plain_ms, "plain_iterations": plain_depth,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }
        if kname in TENSOR_CORE_KERNELS:
            row["bound_fp32_ms"] = bound_ms(kname, MAIN_BATCH, N, ITERATIONS, name,
                                            tensor_cores=False)[0]
            share += (f"; 3xTF32 tensor cores beside the CUDA cores; fp32 CUDA-core "
                      f"bound {row['bound_fp32_ms']:.1f} ms, "
                      f"{100 * row['bound_fp32_ms'] / min(times):.1f}% of it")
        else:
            # The bounds a tensor-core matvec would have: 3xTF32, and
            # 4xTF32 (Q's residual too), as ccvm_tpu_torch/tools/tc_model.py
            # models them against the holds (PERF.md: MF's 3xTF32 per
            # k-tile misses 1e-4 at phase 7 and its 4xTF32 holds it; for
            # the Langevin family both miss pumped-Adam's 2e-3 over 15,000
            # steps and keep Langevin's and Langevin-Adam's).
            for passes in (3, 4):
                row[f"bound_{passes}xtf32_ms"] = bound_ms(
                    kname, MAIN_BATCH, N, ITERATIONS, name, tensor_cores=True,
                    tf32_passes=passes)[0]
            share += (f"; fp32 CUDA cores; a 3xTF32 matvec's bound would be "
                      f"{row['bound_3xtf32_ms']:.1f} ms, a 4xTF32 one's "
                      f"{row['bound_4xtf32_ms']:.1f} ms")
        kernels.append(row)
        log(f"phase 7 {kname}: kernel {min(times):.1f} ms (reps {times}), plain "
            f"{plain_ms:.1f} ms over {plain_depth} steps, bound {b_ms:.1f} ms "
            f"({b_by}, {share}) at batch {MAIN_BATCH}, N={N}, {ITERATIONS} steps")
    ms_of = {k["name"]: k["ms"] for k in kernels}
    for adam_kname, plain_kname in ADAM_PAIRS:
        ratio = ms_of[adam_kname] / ms_of[plain_kname]
        log(f"phase 7 {adam_kname} takes {ratio:.3f} x {plain_kname}'s time (at most "
            f"{ADAM_OVER_PLAIN})")
        if ratio > ADAM_OVER_PLAIN:
            failures.append(f"{adam_kname} takes {ratio:.3f} x {plain_kname}'s time")

    log(f"phase 8 starts {time.perf_counter() - t_start:.1f} s into the run")
    # 8. the DL race harness: each variant against its plain version, its
    # statistics against production's, the race, and its kernels-line row
    t8 = time.perf_counter()
    variant_fns = {"dl_v2": (dl_variant_kernels.dl_v2,
                             dl_variant_kernels.dl_v2_reference),
                   "dl_v3": (dl_variant_kernels.dl_v3,
                             dl_variant_kernels.dl_v3_reference)}

    def variant_pv(iterations):
        """The DL tuned parameters as the harness's params_vec, T = iterations."""
        return np.array(list(params(iterations))[:9], np.float32)

    def variant_run(v3, seed, batch, iterations, rng_name, unroll, fuse=False,
                    noise_scale=1.0, plain=True):
        """(kernel name, kernel outputs, error, plain ms) of a variant; with
        ``plain`` False the plain version is not run (error and ms None)."""
        kname = "dl_v3" if v3 else "dl_v2"
        kernel, reference = variant_fns[kname]
        kw = dict(iterations=iterations, batch_size=batch, unroll=unroll,
                  rng_name=rng_name or "popcount1", noise_scale=noise_scale)
        if not v3:
            kw["fuse_matvec"] = fuse
        pv = variant_pv(iterations)
        out = kernel(seed, inst.q_matrix, inst.v_vector, pv, **kw)
        for x in out:
            assert torch.isfinite(x).all(), f"{kname} output is not finite"
        if not plain:
            return kname, out, None, None
        ref, ms = timed(lambda: reference(seed, inst.q_matrix, inst.v_vector, pv, **kw))
        return kname, out, max_diff(out, ref), ms

    def variant_label(v3, fuse, unroll, rng_name):
        knobs = [rng_name] if rng_name else []
        knobs += [] if v3 else [f"fuse{int(fuse)}"]
        return " ".join([f"v{3 if v3 else 2}", *knobs, f"unroll{unroll}"])

    # Noise off: 304 steps (a multiple of 16, so v2 runs whole unrolled
    # bodies), and v3 over 300 steps with unroll 16 for its tail of 12.
    for v3, fuse, unroll, _ in variant_cases["off"]:
        kname, _, err, _ = variant_run(v3, 0, 1024, 304, None, unroll, fuse, 0.0)
        hold(kname, variant_label(v3, fuse, unroll, None), err,
             "phase 8 noise off, 304 steps, c and s,")
    kname, _, err, _ = variant_run(True, 0, 1024, 300, None, 16, noise_scale=0.0)
    hold(kname, "v3 unroll16, tail of 12", err, "phase 8 noise off, 300 steps, c and s,")
    # Noise on, the same Philox words: 104 steps (v3 unroll 16: a tail of 8).
    for v3, fuse, unroll, rng_name in variant_cases["on"]:
        kname, _, err, _ = variant_run(v3, 5, 1024, 104, rng_name, unroll, fuse)
        hold(kname, variant_label(v3, fuse, unroll, rng_name), err,
             "phase 8 noise on, 104 steps, c and s,")
    # A stacked launch against serial launches with seed + i.
    q2 = torch.stack([inst.q_matrix, second.q_matrix])
    v2 = torch.stack([inst.v_vector, second.v_vector])
    for kname, kernel_kw in (("dl_v2", dict(fuse_matvec=False)), ("dl_v3", {})):
        kernel = variant_fns[kname][0]
        kw = dict(kernel_kw, iterations=104, batch_size=1024, rng_name="popcount2",
                  unroll=8)
        cs, ss = kernel(11, q2, v2, variant_pv(104), **kw)
        for i in range(2):
            ci, si = kernel(11 + i, q2[i], v2[i], variant_pv(104), **kw)
            assert torch.equal(cs[i], ci) and torch.equal(ss[i], si), \
                f"stacked {kname} instance {i} differs from a serial launch"
    log("phase 8 stacked: a two-instance dl_v2 and dl_v3 launch equals serial "
        "launches with seeds 11 and 12 bit for bit")

    # Every race row's kernel against its plain version at the race's own
    # shape: the harness's problem (unscaled Q; at n 20 a block is 5 column
    # groups by 64 rows, and batch 1000 leaves the 16th block 40 rows) and
    # parameters, T = steps.
    hq, hv = (torch.from_numpy(x).cuda() for x in kernel_experiments.harness_problem(20))
    hpv = kernel_experiments.harness_params(HARNESS_HOLD_STEPS)
    for label, kind, row_kw in kernel_experiments.ROWS:
        # The CUDA-core matvec is a race row, not a main-path kernel.
        kname = {"production": "dl_solve",
                 "cuda-core": "dl_solve CUDA-core matvec"}.get(kind, f"dl_{kind}")
        for noise_scale in (0.0, 1.0):
            out, ref = (kernel_experiments.runner(
                kind, row_kw, hq, hv, hpv, 1000, plain, seed=9,
                noise_scale=noise_scale)(HARNESS_HOLD_STEPS) for plain in (False, True))
            for x in out:
                assert x.shape == (1000, 20) and torch.isfinite(x).all(), \
                    f"{label}: output not finite or of the wrong shape"
            hold(kname, f"{label}, noise {'on' if noise_scale else 'off'}",
                 max_diff(out, ref), f"phase 8 harness shape (batch 1000, n 20), "
                 f"{HARNESS_HOLD_STEPS} steps, c and s,")

    # Statistics: the variants solve the production kernel's problem.
    cv = ("boxqp", *inst.solution_bounds, 1.0)
    cp, _ = dl_kernels.dl_solve(21, inst.q_matrix, inst.v_vector, params(ITERATIONS),
                                iterations=ITERATIONS, batch_size=4096,
                                pump_rate_flag=True, pump_is_gt_one=True,
                                rng="popcount16")
    perf_prod = performance(inst, inst.compute_energy_readout64(cp, change_vars=cv), 4096)
    for v3 in (False, True):
        kname, (ck, _), _, _ = variant_run(v3, 21, 4096, ITERATIONS, "popcount1", 8,
                                           plain=False)
        perf_v = performance(inst, inst.compute_energy_readout64(ck, change_vars=cv), 4096)
        log(f"phase 8 {kname} statistics: batch 4096, {ITERATIONS} steps, popcount1 "
            f"unroll 8, against the production kernel (popcount16, clip)")
        assert success_band_ok(perf_v, perf_prod, 4096, (kname, "dl_solve")), \
            f"{kname} success probabilities disagree with production"

    # The race row that production does not launch: the DL kernel with its
    # CUDA-core matvec, noise off at N=70, against the plain version.
    for hp, label in ((None, "DL"), (adam_hps[0.999], "DL-Adam beta2 0.999")):
        hold("dl_solve CUDA-core matvec", f"{label}, CUDA-core matvec",
             run_pair(0, 1024, 300, hp, 0.0,
                      kernel=kernel_experiments.cuda_core_dl_solve)[2],
             "phase 8 noise off, 300 steps, c and s,")

    # The race, through the harness's entry point; the launch counts of its
    # runs are the variants' launches (the solvers' main paths launch
    # neither), and of production's two matvecs.
    race_shapes = {
        "harness shape, batch 1000, n 20, i1 20000, i2 100000, best of 3":
            dict(batch=1000, n=20, i1=20_000, i2=100_000, rounds=1, reps=3),
        f"main shape, batch {MAIN_BATCH}, the N={N} instance, i1 1000, i2 5000, "
        f"best of 2 in each of {MAIN_RACE_ROUNDS} rounds":
            dict(batch=MAIN_BATCH, n=N, i1=1000, i2=5000, q=inst.q_matrix,
                 v=inst.v_vector, rounds=MAIN_RACE_ROUNDS, reps=2),
    }
    zero_counts()
    kernel_experiments.cuda_core_dl_solve.launches = 0
    races = {shape: kernel_experiments.race_rounds("cuda", **kw)
             for shape, kw in race_shapes.items()}
    launched = counts()
    assert kernel_experiments.cuda_core_dl_solve.launches > 0
    assert launched["dl_v2"] > 0 and launched["dl_v3"] > 0, launched
    assert launched == only(dl_solve=launched["dl_solve"], dl_v2=launched["dl_v2"],
                            dl_v3=launched["dl_v3"]), launched
    launches.update(dl_v2=launched["dl_v2"], dl_v3=launched["dl_v3"])
    for shape, rows in races.items():
        log(f"phase 8 race, {shape}, T 15000, CUDA events, {smi}:")
        for row in rows:
            log(f"  {kernel_experiments.format_row(row)} "
                f"rounds {[round(u, 4) for u in row['us_rounds']]}")
        if len(rows[0]["us_rounds"]) > 1:
            log(f"phase 8 knobs at the {shape.split(',')[0]} (median against median):")
            for effect in kernel_experiments.knob_effects(rows):
                log(f"  {kernel_experiments.format_effect(effect)}")
    log(f"phase 8 race launches: {launched}, and the CUDA-core matvec's "
        f"{kernel_experiments.cuda_core_dl_solve.launches}")
    # The variants run production's tensor-core design: each v2 / v3 row's
    # median at the main shape must be below the CUDA-core dl_solve row's
    # (the old design's level); a row that beats production beyond the
    # rounds' spread is a finding, printed with the knobs that differ.
    main_rows = {r["label"]: r for r in races[list(race_shapes)[-1]]}
    core, prod = (main_rows[label] for label in (kernel_experiments.CUDA_CORE,
                                                 kernel_experiments.PRODUCTION))
    for label, kind, _ in kernel_experiments.ROWS:
        if kind not in ("v2", "v3"):
            continue
        row = main_rows[label]
        log(f"phase 8 {label}: {row['us_per_step']:.4f} us/step against the CUDA-core "
            f"dl_solve row's {core['us_per_step']:.4f} and production's "
            f"{prod['us_per_step']:.4f} at the main shape (medians)")
        if row["us_per_step"] > core["us_per_step"]:
            failures.append(f"{label} {row['us_per_step']} us/step above the CUDA-core "
                            f"dl_solve row's {core['us_per_step']}")
        if max(row["us_rounds"]) < min(prod["us_rounds"]):
            log(f"phase 8 finding: {label} beats production beyond the rounds' spread, by "
                f"{prod['us_per_step'] - row['us_per_step']:.4f} us/step; its knobs "
                f"against production's: {kernel_experiments.knobs_against_production(label)}")

    # Kernels line: full-depth time, 1,000-step plain time and hold.
    for kname, v3 in (("dl_v2", False), ("dl_v3", True)):
        kernel, _ = variant_fns[kname]
        kw = dict(iterations=ITERATIONS, batch_size=MAIN_BATCH, rng_name="popcount1",
                  unroll=8)
        if not v3:
            kw["fuse_matvec"] = False
        pv = variant_pv(ITERATIONS)
        times = [timed(lambda: kernel(100, inst.q_matrix, inst.v_vector, pv, **kw))[1]
                 for _ in range(2)]
        _, _, err, plain_ms = variant_run(v3, 100, MAIN_BATCH, EARLIER_PLAIN_DEPTH,
                                          "popcount1", 8)
        hold(kname, kname, err, f"phase 8 main-path shape, {EARLIER_PLAIN_DEPTH} steps,",
             defer=True)
        b_ms, b_by = bound_ms(kname, MAIN_BATCH, N, ITERATIONS, name)
        fp32_ms = bound_ms(kname, MAIN_BATCH, N, ITERATIONS, name, tensor_cores=False)[0]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "ccvm_tpu_torch/csrc/dl_variants.cu",
            "replaces": f"tools/kernel_experiments.py:{201 if v3 else 91}",
            "launches": launches[kname], "max_abs_err": max_err[kname],
            "ms": min(times), "plain_ms": plain_ms,
            "plain_iterations": EARLIER_PLAIN_DEPTH,
            "bound_ms": b_ms, "bound_by": b_by, "bound_fp32_ms": fp32_ms,
            "library_ms": None,
        })
        log(f"phase 8 {kname} (popcount1, unroll 8{'' if v3 else ', fuse 0'}): kernel "
            f"{min(times):.1f} ms (reps {times}), plain {plain_ms:.1f} ms over "
            f"{EARLIER_PLAIN_DEPTH} steps, bound {b_ms:.1f} ms ({b_by}, 3xTF32 tensor "
            f"cores beside the CUDA cores), {100 * b_ms / min(times):.1f}% of it; fp32 "
            f"CUDA-core bound {fp32_ms:.1f} ms, {100 * fp32_ms / min(times):.1f}% of it; at "
            f"batch {MAIN_BATCH}, N={N}, {ITERATIONS} steps")
    log(f"phase 8 DL race harness: {time.perf_counter() - t8:.1f} s")

    log(f"phase 9 starts {time.perf_counter() - t_start:.1f} s into the run")
    # 9. DL and DL-Adam at the other bundled sizes, noise off, against their
    # plain versions, with each size's tuned parameters
    t9 = time.perf_counter()
    for n in BUNDLED_SIZES:
        path = first_instance(n)
        inst_n = instance(path)
        t = tuned_all["dl"][str(n)]
        solver_n = DLSolver(device="cuda")
        solver_n.solution_bounds = inst_n.solution_bounds
        p = solver_n._make_params(t["pump"], 1.0, t["dt"], t["noise_ratio"],
                                  t["feedback_scale"], G, 300)
        for kname, hp, label in cases[:2]:
            kw = dict(iterations=300, batch_size=1000, pump_rate_flag=True,
                      pump_is_gt_one=t["pump"] > 1, noise_scale=0.0,
                      rng="popcount16", hp=hp)
            out = dl_kernels.dl_solve(0, inst_n.q_matrix, inst_n.v_vector, p, **kw)
            ref = dl_kernels.dl_solve_reference(0, inst_n.q_matrix, inst_n.v_vector,
                                                p, **kw)
            for x in out:
                assert x.shape == (1000, n) and torch.isfinite(x).all(), \
                    f"{label} N={n}: output not finite or of the wrong shape"
            hold(kname, f"{label.split()[0]} N={n} ({os.path.basename(path)})",
                 max_diff(out, ref), "phase 9 noise off, batch 1000, 300 steps, c and s,")
    log(f"phase 9 DL at the bundled sizes: {time.perf_counter() - t9:.1f} s")

    log(f"phase 12 starts {time.perf_counter() - t_start:.1f} s into the run")
    # 12. the segment launch, a per-column S and DL's ramps in every
    # production kernel, and the four façades' evolution sampling and
    # per-variable S at the main shape, with the launch counts zeroed before
    # and read after.
    t12 = time.perf_counter()
    zero_counts()

    # (a) A whole solve at the main shape as the segments of step 1,000's
    # plan ends where the whole launch ends, bit for bit.
    main_plan = DLSolver._evolution_sample_plan(ITERATIONS, P12_MAIN_STEP)[1]
    for kname in main_hp:
        _, whole, sampled, _, q_, v_, p_, kw_ = p12_case(kname, ITERATIONS, MAIN_BATCH, 1.0)
        want, whole_ms = timed(lambda: whole(100, q_, v_, p_, iterations=ITERATIONS, **kw_))
        (got, samples), seg_ms = timed(lambda: sampled(100, q_, v_, p_, main_plan, **kw_))
        same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))
        del want, got, samples
        family = kname.split("_")[0]
        _, _, _, _, _, _, pc, _ = p12_case(kname, ITERATIONS, MAIN_BATCH, 1.0,
                                           S=p12_S[family])
        out, col_ms = timed(lambda: whole(100, q_, v_, pc, iterations=ITERATIONS, **kw_))
        assert all(torch.isfinite(x).all() for x in flat(out))
        del out
        log(f"phase 12 (a) {kname}: {len(main_plan)} segment launches {seg_ms:.1f} ms "
            f"against one whole launch {whole_ms:.1f} ms ({seg_ms / whole_ms - 1:+.2%}), "
            f"batch {MAIN_BATCH}, N={N}, {ITERATIONS} steps, noise on; final state "
            f"{'equal bit for bit' if same else 'DIFFERS'}; with a per-column S the "
            f"whole launch {col_ms:.1f} ms ({col_ms / whole_ms - 1:+.2%})")
        if not same:
            failures.append(f"{kname}: segments differ from the whole launch")

    # (b) Every sample against the plain version's, at PARITY_TOL (the DL
    # family's through step P12_DL_HOLD_STEPS).
    sample_steps = np.cumsum(p12_plan)
    for kname in main_hp:
        _, _, sampled, _, q_, v_, p_, kw_ = p12_case(kname, P12_STEPS, P12_BATCH, 1.0)
        _, samples = sampled(5, q_, v_, p_, p12_plan, **kw_)
        samples = flat(samples)
        ref = p12_plain["b", kname][-len(samples):]
        by_sample = [max((a[i] - b[i]).abs().max().item() for a, b in zip(samples, ref))
                     for i in range(len(p12_plan))]
        depth = P12_DL_HOLD_STEPS.get(kname, P12_STEPS)
        same = all(torch.equal(a, b) for a, b in zip(samples, ref))
        log(f"phase 12 (b) {kname}: max |kernel - plain| by step "
            f"{ {int(k): float(f'{e:.3e}') for k, e in zip(sample_steps, by_sample)} }")
        hold(kname, kname, max(e for k, e in zip(sample_steps, by_sample) if k <= depth),
             f"phase 12 (b) {len(p12_plan)} samples (step {P12_STEP}) held through step "
             f"{depth}, batch {P12_BATCH}, {P12_STEPS} steps, noise on "
             f"({'bit for bit' if same else 'not bit for bit'}),", defer=True)

    # (c) A per-column S against the plain version, noise off and on; a
    # constant S vector against the scalar-S kernel, bit for bit.
    for label in list(main_hp) + ["dl_solve pump 0.9", "dl_adam_solve pump 0.9"]:
        kname = label.split(" ")[0]
        family = kname.split("_")[0]
        for noise in (0.0, 1.0):
            _, whole, _, _, q_, v_, p_, kw_ = p12_case(label, P12_STEPS, P12_BATCH, noise,
                                                       S=p12_S[family])
            out = flat(whole(6, q_, v_, p_, iterations=P12_STEPS, **kw_))
            err = max_diff(tuple(out), tuple(p12_plain["c", label, noise]))
            what = (f"phase 12 (c) per-column S, batch {P12_BATCH}, {P12_STEPS} steps, "
                    f"noise {'on' if noise else 'off'},")
            if family != "dl":
                hold(kname, label, err, what, defer=True)
                continue
            scalar = ""
            if noise:
                _, _, _, _, q_, v_, ps, kw_ = p12_case(label, P12_STEPS, P12_BATCH, noise)
                out_s = flat(whole(6, q_, v_, ps, iterations=P12_STEPS, **kw_))
                err_s = max_diff(tuple(out_s), tuple(p12_plain["c scalar", label, noise]))
                scalar = f", the scalar-S kernel's {err_s:.3e}"
            log(f"{what} {label}: max |kernel - plain| = {err:.3e}{scalar}")
            depth = P12_DL_HOLD_STEPS[label]
            _, _, _, _, q_, v_, p_, kw_ = p12_case(label, depth, P12_BATCH, noise,
                                                   S=p12_S[family])
            out = flat(whole(6, q_, v_, p_, iterations=depth, **kw_))
            hold(kname, label, max_diff(tuple(out), tuple(p12_plain["c hold", label, noise])),
                 f"phase 12 (c) per-column S, batch {P12_BATCH}, {depth} steps, noise "
                 f"{'on' if noise else 'off'},", defer=True)
        _, whole, _, _, q_, v_, ps, kw_ = p12_case(label, P12_STEPS, P12_BATCH, 1.0)
        _, _, _, _, _, _, pc, _ = p12_case(label, P12_STEPS, P12_BATCH, 1.0,
                                           S=np.full(N, scalar_S[family], np.float32))
        same = all(torch.equal(a, b) for a, b in zip(
            flat(whole(6, q_, v_, ps, iterations=P12_STEPS, **kw_)),
            flat(whole(6, q_, v_, pc, iterations=P12_STEPS, **kw_))))
        log(f"phase 12 (c) {label}: a constant S vector "
            f"{'equals' if same else 'DIFFERS from'} the scalar-S kernel bit for bit")
        if not same:
            failures.append(f"{label}: a constant S vector differs from the scalar S")

    # (d) DL's generalised ramps against the plain version; (1.0, 1.0) is
    # the reference's linear ramp, bit for bit.
    for kname in ("dl_solve", "dl_adam_solve"):
        for ramp in P12_RAMPS:
            for noise in (0.0, 1.0):
                _, whole, _, _, q_, v_, p_, kw_ = p12_case(kname, P12_STEPS, P12_BATCH,
                                                           noise, ramp=ramp)
                out = flat(whole(6, q_, v_, p_, iterations=P12_STEPS, **kw_))
                hold(kname, f"{kname} pump_ramp {ramp}",
                     max_diff(tuple(out), tuple(p12_plain["d", kname, ramp, noise])),
                     f"phase 12 (d) batch {P12_BATCH}, {P12_STEPS} steps, noise "
                     f"{'on' if noise else 'off'},", defer=True)
        runs = []
        for ramp in (None, (1.0, 1.0)):
            _, whole, _, _, q_, v_, p_, kw_ = p12_case(kname, P12_STEPS, P12_BATCH, 1.0,
                                                       ramp=ramp)
            runs.append(flat(whole(6, q_, v_, p_, iterations=P12_STEPS, **kw_)))
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        log(f"phase 12 (d) {kname}: pump_ramp (1.0, 1.0) "
            f"{'equals' if same else 'DIFFERS from'} None bit for bit")
        if not same:
            failures.append(f"{kname}: pump_ramp (1.0, 1.0) differs from None")

    # (e) The four façades at the main shape with evolution sampling (step
    # 1,000) and a per-column S; DL with pump_ramp (2.0, 0.5), the others
    # with grad-descent.  Each evolution file holds the JAX format's rows (N
    # a variable block, DL's and MF's two blocks), one value a sample.  With
    # the tuned S as a constant vector the objective values equal the
    # scalar-S run's.
    evo_dir = os.path.join(REPO, "build", "phase12")
    os.makedirs(evo_dir, exist_ok=True)
    facades = (("DL", DLSolver, pk, inst, {"pump_ramp": (2.0, 0.5)}, 2, "dl"),
               ("MF", MFSolver, mf_pk, mf_inst, {"g": MF_G, "post_processor": "grad-descent"},
                2, "mf"),
               ("Langevin", LangevinSolver, lgv_pk["langevin"], lgv_inst["langevin"],
                {"post_processor": "grad-descent"}, 1, "langevin"),
               ("pumped", PumpedLangevinSolver, lgv_pk["pumped"], lgv_inst["pumped"],
                {"post_processor": "grad-descent"}, 1, "pumped"))

    def with_s(cls, pkey, S):
        """A façade at the main shape with this S (DL's in its constructor,
        the others' in the parameter key)."""
        if cls is DLSolver:
            fac = cls(device="cuda", batch_size=MAIN_BATCH, S=S)
            fac.parameter_key = pkey
        else:
            fac = cls(device="cuda", batch_size=MAIN_BATCH)
            fac.parameter_key = {N: dict(pkey[N], S=S)}
        return fac

    num_samples = DLSolver._evolution_sample_plan(ITERATIONS, P12_MAIN_STEP)[0]
    for label, cls, pkey, inst_, call, blocks, family in facades:
        fac = with_s(cls, pkey, p12_S[family])
        path = os.path.join(evo_dir, f"{family}_evolution.txt")
        t = time.perf_counter()
        sol = fac(inst_, seed=1, evolution_step_size=P12_MAIN_STEP, evolution_file=path,
                  **call)
        wall = time.perf_counter() - t
        rows = np.loadtxt(sol.evolution_file, ndmin=2)
        perf = sol.solution_performance
        log(f"phase 12 (e) {label} façade, per-column S, evolution step "
            f"{P12_MAIN_STEP}{', pump_ramp (2.0, 0.5)' if family == 'dl' else ''}: "
            f"wall {wall:.3f} s at N={N}, batch {MAIN_BATCH}, {ITERATIONS} steps, "
            f"P(0.1%)={perf['optimal']:.4f} P(1%)={perf['one_percent']:.4f}, "
            f"evolution file {rows.shape[0]} rows of {rows.shape[1]} samples")
        if rows.shape != (blocks * N, num_samples) or not np.all(np.isfinite(rows)):
            failures.append(f"{label}: evolution file of shape {rows.shape}")
        if not np.all(np.isfinite(sol.objective_values)):
            failures.append(f"{label}: objective values not finite")
        del sol, fac
        objective = []
        for S in (scalar_S[family], np.full(N, scalar_S[family], np.float32)):
            fac = with_s(cls, pkey, S)
            objective.append(fac(inst_, seed=2, **call).objective_values)
        same = np.array_equal(objective[0], objective[1])
        log(f"phase 12 (e) {label} façade: the tuned S as a constant vector "
            f"{'gives' if same else 'DOES NOT give'} the scalar-S run's objective values")
        if not same:
            failures.append(f"{label}: a constant S vector changes the objective values")
    launched12 = counts()
    for fn_ in os.listdir(evo_dir):
        os.remove(os.path.join(evo_dir, fn_))
    os.rmdir(evo_dir)

    # (f) The scalar path is unchanged: phase 7's kernel times against the
    # recorded ones.
    for kname, recorded in RECORDED_MS.items():
        change = ms_of[kname] / recorded - 1
        log(f"phase 12 (f) {kname}: {ms_of[kname]:.1f} ms against the recorded {recorded} "
            f"({change:+.2%}; {'within' if abs(change) <= 0.01 else 'beyond'} 1%)")
        if change > RECORDED_SLOWER:
            failures.append(f"{kname}: {change:+.2%} against the recorded time")
    log(f"phase 12: {time.perf_counter() - t12:.1f} s; launches {launched12}")

    log(f"phase 13 starts {time.perf_counter() - t_start:.1f} s into the run")
    # 13. sweeps, tuning, checkpoint / resume and a profiler trace
    launched13, p13_stats, p13_winner = sweep_phase(tuned_all, event_ms["DL"], counters,
                                                    failures)
    assert launched13 == only(**{k: launched13[k] for k in main_hp}), launched13
    for k in ("dl_solve", "mf_solve", "langevin_solve", "langevin_adam_solve",
              "pumped_langevin_solve"):
        assert launched13[k] > 0, launched13

    log(f"phase 14 starts {time.perf_counter() - t_start:.1f} s into the run")
    # 14. the entry-point scripts and the async sweep clock
    launched14 = entry_point_phase(tuned_all, p13_stats, p13_winner, counters, failures)
    study_kernels = ("dl_solve", "mf_solve", "langevin_solve", "pumped_langevin_solve")
    assert launched14 == only(**{k: launched14[k] for k in study_kernels}), launched14
    assert all(launched14[k] > 0 for k in study_kernels), launched14

    log(f"phase 15 starts {time.perf_counter() - t_start:.1f} s into the run")
    # 15. a (batch, n) S whose rows differ on every production kernel and
    # the four façades
    main_ms = {f: float(np.median(event_ms[label])) for f, label in (
        ("dl", "DL"), ("mf", "MF (grad-descent)"), ("langevin", "langevin (grad-descent)"),
        ("pumped", "pumped (grad-descent)"))}
    launched15, _ = per_element_phase(tuned_all, main_ms, counters, failures)
    assert launched15 == only(**{k: launched15[k] for k in main_hp}), launched15
    assert all(launched15[k] > 0 for k in main_hp), launched15

    log(f"phase 16 starts {time.perf_counter() - t_start:.1f} s into the run")
    # 16. meshes on one card: a one-rank NCCL world in a child process that
    # is waited for and killed if the run fails
    given = {"name": name, "dl_kernel_ms": main_ms["dl"], "walls": {
        f: main_walls[label] for f, label in (
            ("dl", "DL"), ("mf", "MF (grad-descent)"), ("langevin", "langevin (grad-descent)"),
            ("pumped", "pumped (grad-descent)"))}}
    mesh_proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-worker",
                                  json.dumps(given)], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
    cleanup.callback(stop, mesh_proc)
    out, err = mesh_proc.communicate(timeout=MESH_TIMEOUT_S)
    if mesh_proc.returncode != 0:
        raise RuntimeError(f"phase 16's child exited with {mesh_proc.returncode}:\n"
                           f"{out[-4000:]}\n{err[-4000:]}")
    lines = out.strip().splitlines()
    for ln in lines[:-1]:
        log(ln)
    mesh_result = json.loads(lines[-1].split("# mesh ", 1)[1])
    failures += mesh_result["failures"]
    launched16 = mesh_result["launched"]
    assert launched16 == only(**{k: launched16[k] for k in main_hp}), launched16
    for k in ("dl_solve", "mf_solve", "langevin_solve", "pumped_langevin_solve"):
        assert launched16[k] > 0, launched16

    log(f"phase 17 starts {time.perf_counter() - t_start:.1f} s into the run")
    # 17. the native host I/O library, evolution files, the validation tool
    # and the DL breakdown
    launched17 = native_phase(reports, dl_probe_rows, v_plain, counters, failures)
    assert launched17 == only(**{k: launched17[k] for k in main_hp}), launched17
    assert all(launched17[k] > 0 for k in main_hp), launched17

    log(f"phase 11 starts {time.perf_counter() - t_start:.1f} s into the run")
    # 11. bench_torch.py, in a child process that is waited for and killed
    # if the run fails
    t11 = time.perf_counter()
    bench = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--bench-child"],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cleanup.callback(stop, bench)
    out, err = bench.communicate(timeout=BENCH_TIMEOUT_S)
    if bench.returncode != 0:
        raise RuntimeError(f"bench_torch.py exited with {bench.returncode}:\n"
                           f"{err[-4000:]}")
    line = out.strip().splitlines()[-1]
    result = json.loads(line)
    missing = [k for k in BENCH_KEYS if k not in result]
    assert not missing, f"bench_torch.py's line lacks {missing}: {line}"
    assert result["metric"] == f"dl_ccvm_sde_throughput_n{N}_b{MAIN_BATCH}_i{ITERATIONS}"
    assert result["value"] > 0 and result["device_amortised_rate"] > 0, result
    log(f"phase 11 bench_torch.py: {line}")
    for ln in err.strip().splitlines():
        log(f"  {ln}")
    launched_bench = json.loads(err.strip().splitlines()[-1].split("# launches ", 1)[1])
    assert launched_bench == only(**{
        k: launched_bench[k] for k in ("dl_solve", "mf_solve", "langevin_solve",
                                       "pumped_langevin_solve")}), launched_bench
    assert all(launched_bench[k] > 0 for k in ("dl_solve", "mf_solve", "langevin_solve",
                                               "pumped_langevin_solve")), launched_bench
    log(f"phase 11 benchmark: {time.perf_counter() - t11:.1f} s")
    for row in kernels:
        name_ = row["name"]
        row["launches_by_phase"] = (
            {"8": row["launches"]} if name_ in ("dl_v2", "dl_v3") else
            {"6": row["launches"], "10": launched_pp[name_],
             "11": launched_bench[name_], "12": launched12[name_],
             "13": launched13[name_], "14": launched14[name_],
             "15": launched15[name_], "16": launched16[name_],
             "17": launched17[name_]})
    kernels += mesh_result["rows"]
    assert not failures, failures
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--plain-worker"]:
        plain_worker()
    elif sys.argv[1:] == ["--bench-child"]:
        bench_child()
    elif sys.argv[1:2] == ["--mesh-worker"] and len(sys.argv) == 3:
        mesh_worker(sys.argv[2])
    else:
        with contextlib.ExitStack() as stack:
            main(stack)
