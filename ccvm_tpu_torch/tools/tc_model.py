"""Emulations of a tensor-core matvec's arithmetic, in PyTorch on any device.

The DL kernel (csrc/dl_solve.cu) runs its matvec as 3xTF32 ``mma.sync``;
the MF kernel (csrc/mf_solve.cu) keeps the fp32 CUDA-core matvec because no
tensor-core scheme modelled here held the MF solve within 5e-5 of its fp32
plain version on the CPU (on the card 4xTF32 per k-tile holds chip_smoke's
1e-4 in every check); the Langevin-family kernel (csrc/langevin_solve.cu)
keeps it because on the card every scheme held over 15,000 steps (3xTF32
and 4xTF32 per k-tile, 3xTF32 per k-tile centred) missed chip_smoke's 2e-3
for pumped-Adam (6.02e-3 to 1.13e-2), while keeping Langevin and
Langevin-Adam within it.
Each emulation below computes ``x @ Q`` as
one scheme would; patched in as ``dynamics.common.dense_matvec``, it turns a
plain solve into a model of a kernel with that matvec, whose difference from
the fp32 plain solve predicts the kernel's hold against its plain version.

Run on the card, where the plain solve's matmul is cuBLAS's, as the holds
of ``chip_smoke.py`` compare:

    python -m ccvm_tpu_torch.tools.tc_model --device cuda
    python -m ccvm_tpu_torch.tools.tc_model --device cuda --family langevin

The first prints, for each MF scheme, the difference at the checks of
``chip_smoke.py`` (phase 3: seed 0, batch 1024, 300 steps, noise off; phase
7: seed 100, the main-path batch, 1,000 steps, noise on) and over 1,000
steps noise off, for MF, MF-Adam beta2 0.999 and MF-Adam beta2 1.0.  The
second does the same for the Langevin family's four kernels
(:data:`LANGEVIN_SCHEMES`, :func:`langevin_difference`) at the checks of
``chip_smoke.py`` that hold them: phase 3, phase 4 (seed 5, batch 1024, 100
steps, noise on) and phase 7 at 100 and 1,000 steps (seed 100, the main-path
batch, the tuned Adam parameters); ``--deep`` adds phase 7's 15,000 steps
for the schemes it names, and ``--schemes`` holds only the schemes it
names.  Each Langevin reading is the largest difference
and the count of elements over chip_smoke's PARITY_TOL (1e-4).

``--family variants`` holds the DL race harness's two variants
(``ops/dl_variant_kernels.py``, csrc/dl_variants.cu) as their kernels
compute the matvec, DL's one truncating 3xTF32 chain
(:data:`VARIANT_SCHEMES`): v2 with its x as written and centred, and v3,
whose matvec takes c and s themselves; noise off, at the scaled N=70
instance (``--batch``, 304 steps) and at the harness's problem (n 20, 296
steps).  Which A operand v2's kernel takes (:data:`V2_SCHEME`) was chosen
here.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from ccvm_tpu_torch.dynamics import common
from ccvm_tpu_torch.runtime import resolve_device


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, on the 13 low mantissa bits (the sign bit is apart, so adding
    half a unit to the magnitude's bits rounds ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matvec_3xtf32(x, q):
    """x @ Q as the kernel's 3xTF32 product: hi = tf32(a), lo = tf32(a - hi)
    for x and Q, then lo*hi + hi*lo before hi*hi, each in fp32."""
    xh, qh = tf32(x), tf32(q)
    xl, ql = tf32(x - xh), tf32(q - qh)
    return (torch.matmul(xl, qh) + torch.matmul(xh, ql)) + torch.matmul(xh, qh)


def matvec_1xtf32(x, q):
    return torch.matmul(tf32(x), tf32(q))


def _toward_zero(x64):
    """float64 to float32, rounded toward zero."""
    r = x64.to(torch.float32)
    over = r.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _parts(x, q):
    """TF32 hi and lo of x, and hi, lo and the residual of Q (hi + lo + res
    is Q exactly)."""
    xh, qh = tf32(x), tf32(q)
    ql = tf32(q - qh)
    return {"xh": xh, "xl": tf32(x - xh), "qh": qh, "ql": ql, "qr": tf32(q - qh - ql)}


def _mma(acc, a, b, k):
    """One m16n8k8 mma of k-tile k: its 8 products (exact: TF32 times TF32
    fits float64) added to the fp32 accumulator, the sum rounded toward zero,
    a model of the tensor cores' truncating accumulation."""
    prod = torch.matmul(a[..., k:k + 8].double(), b[..., k:k + 8, :].double())
    return _toward_zero(acc.double() + prod)


_TERMS3 = (("xl", "qh"), ("xh", "ql"), ("xh", "qh"))
_TERMS4 = (("xh", "qr"),) + _TERMS3  # with Q's residual: Q exactly


def matvec_3xtf32_truncating(x, q):
    """x @ Q as a chain of m16n8k8 mma through one accumulator: for each
    k-tile of 8 rows of Q, lo*hi, hi*lo and hi*hi are one mma each (DL's
    kernel)."""
    p = _parts(x, q)
    acc = torch.zeros(x.shape[:-1] + q.shape[-1:], dtype=torch.float32, device=x.device)
    for k in range(0, q.shape[-2], 8):
        for a, b in _TERMS3:
            acc = _mma(acc, p[a], p[b], k)
    return acc


def matvec_tiles(terms=3):
    """x @ Q with each k-tile's mma chained into a fresh accumulator (C = 0)
    and the tile's sum added to the running sum in fp32 (round to nearest);
    ``terms`` 4 adds hi*residual, so the products carry Q exactly."""
    order = _TERMS3 if terms == 3 else _TERMS4

    def matvec(x, q):
        p = _parts(x, q)
        acc = torch.zeros(x.shape[:-1] + q.shape[-1:], dtype=torch.float32,
                          device=x.device)
        for k in range(0, q.shape[-2], 8):
            tile = torch.zeros_like(acc)
            for a, b in order:
                tile = _mma(tile, p[a], p[b], k)
            acc = acc + tile
        return acc

    return matvec


def matvec_rounded_once(x, q):
    """x @ Q in float64, rounded once to float32: the nearest any scheme of
    float32 results can come to the exact sum."""
    return torch.matmul(x.double(), q.double()).float()


def matvec_sequential(x, q):
    """x @ Q as one fp32 FMA chain per output over k = 0, 1, ... (the
    CUDA-core kernel's order; float64 holds each product exactly)."""
    acc = torch.zeros(x.shape[:-1] + q.shape[-1:], dtype=torch.float64, device=x.device)
    for k in range(q.shape[-2]):
        acc = (acc + x[..., k:k + 1].double() * q[..., k:k + 1, :].double()).float().double()
    return acc.float()


def centred(matvec, mid):
    """The DL kernel's centring: the mma takes x - (u+l), and (u+l) times Q's
    column sums is added in fp32."""
    return lambda x, q: matvec(x - mid, q) + mid * q.sum(-2, keepdim=True)


# The MF schemes the CLI holds: uncentred unless named so (MF's x lies in
# [0, 2u] with exact zeros where mu_tilde is clipped at -S; centring trades
# them for a cancellation against Q's column sums).
MF_SCHEMES = {
    "fp32 sequential (CUDA-core)": lambda mid: matvec_sequential,
    "float64 rounded once": lambda mid: matvec_rounded_once,
    "3xTF32 per-k-tile accumulators": lambda mid: matvec_tiles(3),
    "4xTF32 (Q's residual) per-k-tile accumulators": lambda mid: matvec_tiles(4),
    "3xTF32 per-k-tile accumulators, centred": lambda mid: centred(matvec_tiles(3), mid),
    "3xTF32 one truncating chain, centred (DL's)":
        lambda mid: centred(matvec_3xtf32_truncating, mid),
}


@contextlib.contextmanager
def patched_matvec(matvec):
    """``matvec`` in place of ``common.dense_matvec`` (None: the plain one)."""
    saved = common.dense_matvec
    if matvec is not None:
        common.dense_matvec = matvec
    try:
        yield
    finally:
        common.dense_matvec = saved


def model_difference(run, matvec, **kw):
    """Largest difference over a plain solve's outputs (``run(**kw)``) between
    the solve with ``matvec`` patched in as ``common.dense_matvec`` and the
    fp32 plain solve."""
    plain = run(**kw)
    with patched_matvec(matvec):
        emulated = run(**kw)
    for x in emulated:
        assert torch.isfinite(x).all()
    return max((a - b).abs().max().item() for a, b in zip(emulated, plain))


def _repo():
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def mf_problem(device, n=70, g=0.01):
    """The scaled Size70 instance of the MF main path on ``device``, and a
    function of T giving the tuned N=70 MF parameters."""
    from ccvm_tpu_torch import MFSolver, ProblemInstance

    repo = _repo()
    path = os.path.join(repo, "examples", "benchmarking_instances", f"Size{n}",
                        f"tuningH0{n}-100-0.in")
    inst = ProblemInstance(device=device, instance_type="tuning", file_path=path)
    solver = MFSolver(device=device)
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    solver.solution_bounds = inst.solution_bounds
    with open(os.path.join(repo, "examples", "tuned_parameters.json")) as f:
        t = json.load(f)["mf"][str(n)]

    def params(iterations):
        return solver._make_params(t["pump"], t["S"], t["dt"], t["j"],
                                   t["feedback_scale"], g, iterations)

    return inst.q_matrix, inst.v_vector, params


def mf_difference(problem, matvec, beta2, *, seed, batch, iterations, noise_scale):
    """:func:`model_difference` of the MF plain solve on ``problem``
    (:func:`mf_problem`), T = ``iterations``; ``beta2`` None is MF, else
    MF-Adam with the default Adam parameters and that beta2."""
    from ccvm_tpu_torch import AdamParameters
    from ccvm_tpu_torch.ops import mf_kernels

    q, v, params = problem
    hp = None if beta2 is None else AdamParameters(beta2=beta2).to_hyperparameters()
    return model_difference(
        lambda **kw: mf_kernels.mf_solve_reference(seed, q, v, params(iterations), **kw),
        matvec, iterations=iterations, batch_size=batch, pump_rate_flag=True,
        noise_scale=noise_scale, rng="popcount32", hp=hp)


# The Langevin family's schemes: its x = c (u-l)/(2S) + (u+l)/2 lies in the
# box [0, 1], and centred the mma takes x - (u+l)/2 (MID_LANGEVIN).
LANGEVIN_SCHEMES = {
    "fp32 chain over k (the plain matmul's order)": lambda mid: matvec_sequential,
    "fp32 chain over k, centred": lambda mid: centred(matvec_sequential, mid),
    "3xTF32 per-k-tile accumulators": lambda mid: matvec_tiles(3),
    "3xTF32 per-k-tile accumulators, centred": lambda mid: centred(matvec_tiles(3), mid),
    "4xTF32 (Q's residual) per-k-tile accumulators": lambda mid: matvec_tiles(4),
    "3xTF32 one truncating chain (DL's)": lambda mid: matvec_3xtf32_truncating,
    "3xTF32 one truncating chain, centred (DL's)":
        lambda mid: centred(matvec_3xtf32_truncating, mid),
}
MID_LANGEVIN = 0.5  # (u + l) / 2 of the instance's [0, 1] box
# The hold of a kernel against its plain version; chip_smoke.py imports it
# from here.
PARITY_TOL = 1e-4
# The Langevin family's four kernels: (family, Adam or not).
LANGEVIN_KERNELS = {"langevin_solve": ("langevin", False),
                    "langevin_adam_solve": ("langevin", True),
                    "pumped_langevin_solve": ("pumped", False),
                    "pumped_langevin_adam_solve": ("pumped", True)}


def langevin_problem(device, family, n=70):
    """The scaled Size70 instance of a Langevin-family main path on
    ``device`` (``family`` "langevin" or "pumped"), a function of T giving
    the tuned N=70 parameters, and the tuned Adam hyperparameters."""
    from ccvm_tpu_torch import (AdamParameters, LangevinSolver, ProblemInstance,
                                PumpedLangevinSolver)

    path = os.path.join(_repo(), "examples", "benchmarking_instances", f"Size{n}",
                        f"tuningH0{n}-100-0.in")
    inst = ProblemInstance(device=device, instance_type="tuning", file_path=path)
    solver = (LangevinSolver if family == "langevin" else PumpedLangevinSolver)(
        device=device)
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    solver.solution_bounds = inst.solution_bounds
    with open(os.path.join(_repo(), "examples", "tuned_parameters.json")) as f:
        tuned = json.load(f)
    t = tuned[family][str(n)]

    def params(iterations):
        if family == "langevin":
            return solver._make_params(t["S"], t["dt"], t["sigma"], t["feedback_scale"])
        return solver._make_params(t["pump"], t["S"], t["dt"], t["sigma"],
                                   t["feedback_scale"], iterations)

    hp = AdamParameters(**tuned["adam"][family][str(n)]).to_hyperparameters()
    return inst.q_matrix, inst.v_vector, params, hp


def langevin_difference(problem, matvec, hp, *, seed, batch, iterations, noise_scale,
                        plain=None):
    """(largest difference, elements over PARITY_TOL, elements) between the
    plain Langevin or pumped solve (``problem`` from :func:`langevin_problem`,
    the family's own; pumped with its rate-scaled pump, T = ``iterations``)
    with ``matvec`` patched in and the fp32 plain solve (``plain``, when
    given, is that solve's result); ``hp`` None is the plain kernel, else its
    Adam variant with those hyperparameters."""
    c = langevin_model_solve(problem, hp, matvec=matvec, seed=seed, batch=batch,
                             iterations=iterations, noise_scale=noise_scale)
    if plain is None:
        plain = langevin_model_solve(problem, hp, seed=seed, batch=batch,
                                     iterations=iterations, noise_scale=noise_scale)
    assert torch.isfinite(c).all()
    d = (c - plain).abs()
    return d.max().item(), int((d > PARITY_TOL).sum()), d.numel()


def langevin_model_solve(problem, hp, *, seed, batch, iterations, noise_scale,
                         matvec=None):
    """The plain solve of :func:`langevin_difference`, with ``matvec`` (when
    given) patched in as ``common.dense_matvec``."""
    from ccvm_tpu_torch.dynamics.pumped_langevin import PumpedLangevinParams
    from ccvm_tpu_torch.ops import langevin_kernels

    q, v, params, _ = problem
    p = params(iterations)
    if isinstance(p, PumpedLangevinParams):
        solve, extra = langevin_kernels.pumped_langevin_solve_reference, {
            "pump_rate_flag": True}
    else:
        solve, extra = langevin_kernels.langevin_solve_reference, {}
    with patched_matvec(matvec):
        return solve(seed, q, v, p, **extra, iterations=iterations, batch_size=batch,
                     noise_scale=noise_scale, rng="popcount32", hp=hp)


def langevin_checks(batch, deep=False):
    """chip_smoke.py's holds of the Langevin family, as (name, Adam
    hyperparameters "default" or "tuned", check kwargs); ``deep`` adds phase
    7's 15,000 steps."""
    checks = [
        ("phase 3 (seed 0, batch 1024, 300 steps, noise off)", "default",
         dict(seed=0, batch=1024, iterations=300, noise_scale=0.0)),
        ("phase 4 (seed 5, batch 1024, 100 steps, noise on)", "default",
         dict(seed=5, batch=1024, iterations=100, noise_scale=1.0)),
        (f"phase 7 (seed 100, batch {batch}, 100 steps)", "tuned",
         dict(seed=100, batch=batch, iterations=100, noise_scale=1.0)),
        (f"phase 7 (seed 100, batch {batch}, 1,000 steps)", "tuned",
         dict(seed=100, batch=batch, iterations=1000, noise_scale=1.0)),
    ]
    if deep:
        checks.append((f"phase 7 (seed 100, batch {batch}, 15,000 steps)", "tuned",
                       dict(seed=100, batch=batch, iterations=15000, noise_scale=1.0)))
    return checks


def langevin_main(args):
    """The Langevin-family table: for each check and kernel the fp32 plain
    solve once, then each scheme's model against it."""
    from ccvm_tpu_torch import AdamParameters

    unknown = (set(args.schemes) | set(args.deep or ())) - set(LANGEVIN_SCHEMES)
    if unknown:
        raise SystemExit(f"tc_model: no Langevin scheme is called {sorted(unknown)}")
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    problems = {f: langevin_problem(args.device, f) for f in ("langevin", "pumped")}
    default = AdamParameters(beta2=0.999).to_hyperparameters()
    print(f"Langevin-family schemes against the fp32 plain solve on {name}: max "
          f"|model - plain| of c (elements over {PARITY_TOL} of all) for "
          + " / ".join(LANGEVIN_KERNELS), flush=True)
    for check, adam, kw in langevin_checks(args.batch, deep=bool(args.deep)):
        deep = kw["iterations"] > 1000
        schemes = {label: make for label, make in LANGEVIN_SCHEMES.items()
                   if (not args.schemes or label in args.schemes)
                   and (not deep or label in args.deep)}
        rows = {label: [] for label in schemes}
        t = time.perf_counter()
        for kname, (family, is_adam) in LANGEVIN_KERNELS.items():
            hp = None if not is_adam else (
                default if adam == "default" else problems[family][3])
            plain = langevin_model_solve(problems[family], hp, **kw)
            for label, make in schemes.items():
                err, over, numel = langevin_difference(
                    problems[family], make(MID_LANGEVIN), hp, plain=plain, **kw)
                rows[label].append(f"{err:.3e} ({over} of {numel})")
        print(f" {check} ({time.perf_counter() - t:.1f} s):", flush=True)
        for label, row in rows.items():
            print(f"  {label}: " + " / ".join(row), flush=True)


# The race variants' schemes: (variant, matvec of the box midpoint u+l).
# v2's x = z span/S_d + (u+l) lies about u+l; centred, the mma takes
# z span/S_d and (u+l) times Q's column sums is added in fp32, as the DL
# kernel does.  v3's matvec takes z itself, centred by construction.
VARIANT_SCHEMES = {
    "v2, x as written (uncentred)": ("v2", lambda mid: matvec_3xtf32_truncating),
    "v2, x centred": ("v2", lambda mid: centred(matvec_3xtf32_truncating, mid)),
    "v3, z itself": ("v3", lambda mid: matvec_3xtf32_truncating),
}
# The scheme of v2's kernel (csrc/dl_variants.cu), and of v3's.  v2 would
# centre only if x as written missed PARITY_TOL at a check of
# :func:`variant_problems`; it does not (about twice the centred scheme's
# difference, a quarter of the tolerance), so v2's kernel keeps the TPU
# kernel's x.
V2_SCHEME = "v2, x as written (uncentred)"
V3_SCHEME = "v3, z itself"


def variant_problems(device, batch=64):
    """The race variants' noise-off checks: (Q, V, params_vec, batch,
    steps) by name: the scaled Size70 instance with DL's tuned N=70
    parameters (g 0.05, as chip_smoke.py's phase 8) and the harness's own
    problem and parameters at n 20."""
    import numpy as np

    from ccvm_tpu_torch import DLSolver, ProblemInstance
    from ccvm_tpu_torch.tools.kernel_experiments import harness_params, harness_problem

    path = os.path.join(_repo(), "examples", "benchmarking_instances", "Size70",
                        "tuningH070-100-0.in")
    inst = ProblemInstance(device=device, instance_type="tuning", file_path=path)
    solver = DLSolver(device=device)
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    solver.solution_bounds = inst.solution_bounds
    with open(os.path.join(_repo(), "examples", "tuned_parameters.json")) as f:
        t = json.load(f)["dl"]["70"]
    steps = 304
    p = solver._make_params(t["pump"], 1.0, t["dt"], t["noise_ratio"],
                            t["feedback_scale"], 0.05, steps)
    hq, hv = (torch.from_numpy(x).to(device) for x in harness_problem(20))
    return {
        f"N=70 instance (batch {batch}, {steps} steps)":
            (inst.q_matrix, inst.v_vector, np.array(list(p)[:9], np.float32), batch, steps),
        f"harness problem (n 20, batch {batch}, 296 steps)":
            (hq, hv, harness_params(296), batch, 296),
    }


def variant_difference(problem, scheme, seed=0):
    """Largest difference over (c, s) between a race variant's plain solve
    with the scheme's matvec (a name of :data:`VARIANT_SCHEMES`) and its
    fp32 plain solve, noise off, on ``problem`` (of :func:`variant_problems`)."""
    from ccvm_tpu_torch.ops import dl_variant_kernels as dv

    q, v, pv, batch, steps = problem
    variant, make = VARIANT_SCHEMES[scheme]
    mid = float(pv[6] + pv[7])  # u + l

    def run(**kw):
        return dv._reference(variant == "v3", seed, q, v, pv, steps, batch, "popcount1",
                             0.0, **kw)

    plain = run()
    model = run(matvec=make(mid))
    for x in model:
        assert torch.isfinite(x).all()
    return max((a - b).abs().max().item() for a, b in zip(model, plain))


def variants_main(args):
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"race-variant schemes against the fp32 plain solve on {name}, noise off: "
          f"max |model - plain| over (c, s); the kernels take {V2_SCHEME!r} and "
          f"{V3_SCHEME!r}", flush=True)
    for check, problem in variant_problems(args.device, args.batch).items():
        t = time.perf_counter()
        errs = {scheme: variant_difference(problem, scheme) for scheme in VARIANT_SCHEMES}
        print(f" {check} ({time.perf_counter() - t:.1f} s):", flush=True)
        for scheme, err in errs.items():
            print(f"  {scheme}: {err:.3e} ({'within' if err <= PARITY_TOL else 'over'} "
                  f"{PARITY_TOL})", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=None,
                    help="phase 7's batch (the main path's, 65536); variants: 64")
    ap.add_argument("--family", choices=("mf", "langevin", "variants"), default="mf")
    ap.add_argument("--deep", nargs="*", default=[],
                    help="Langevin: the schemes (labels of LANGEVIN_SCHEMES) also "
                         "held over phase 7's 15,000 steps")
    ap.add_argument("--schemes", nargs="*", default=[],
                    help="Langevin: hold only these schemes (default: all)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.batch is None:
        args.batch = 64 if args.family == "variants" else 65536
    if args.family == "variants":
        return variants_main(args)
    if args.family == "langevin":
        return langevin_main(args)
    problem = mf_problem(args.device)
    mid = 1.0  # u + l of the instance's [0, 1] box
    checks = {"phase 3 (seed 0, batch 1024, 300 steps, noise off)":
                  dict(seed=0, batch=1024, iterations=300, noise_scale=0.0),
              "1,000 steps noise off": dict(seed=0, batch=16, iterations=1000,
                                            noise_scale=0.0),
              f"phase 7 (seed 100, batch {args.batch}, 1,000 steps, noise on)":
                  dict(seed=100, batch=args.batch, iterations=1000, noise_scale=1.0)}
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    # Is the plain solve's own matmul (cuBLAS on the card) the sequential
    # chain?  x as MF's: in [0, 2], zeros and twos where mu_tilde is clipped.
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = (torch.rand((4096, 70), generator=gen) * 2.0).to(args.device)
    x[:, ::3] = 0.0
    x[:, 1::3] = 2.0
    q = problem[0]
    from ccvm_tpu_torch.runtime import fp32_matmul
    with fp32_matmul():
        ref = torch.matmul(x, q)
    differ = int((ref != matvec_sequential(x, q)).sum())
    print(f"plain matmul on {args.device} against the sequential fp32 chain: {differ} "
          f"of {ref.numel()} outputs differ", flush=True)
    print(f"MF schemes against the fp32 plain solve on {name}: max |model - plain| "
          f"over (mu, mu_tilde, sigma) for MF / MF-Adam beta2 0.999 / 1.0", flush=True)
    for label, make in MF_SCHEMES.items():
        for check, kw in checks.items():
            t = time.perf_counter()
            errs = [mf_difference(problem, make(mid), b2, **kw) for b2 in (None, 0.999, 1.0)]
            print(f"  {label}; {check}: " + " / ".join(f"{e:.3e}" for e in errs)
                  + f" ({time.perf_counter() - t:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
