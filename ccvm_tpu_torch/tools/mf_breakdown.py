"""Where the MF kernel's time goes, on the card.

Times ``csrc/mf_solve.cu`` at the main path's shape (the scaled Size70
instance, batch 65536, the tuned N=70 MF parameters) as marginal µs per
step, ``(t(i2) - t(i1)) / (i2 - i1)`` from CUDA events, best of ``--reps``,
for:

* the production specialisations: MF and MF-Adam (beta2 0.999 and 1.0) with
  noise, and MF without noise (so without Philox and the draws);
* MF built with the source's probe defines: its matvec taken out
  (``CCVM_MATVEC=0``; the sums stay 0), so the difference to MF is the
  matvec's time, and with one x buffer and a second barrier a step
  (``CCVM_X_BUFFERS=1``) in place of the launch rule's two.

Run from the root of a checkout on a machine with the card::

    python -m ccvm_tpu_torch.tools.mf_breakdown

Each row prints ptxas's registers and spills of the solve kernel.  The
libraries are built by ``ops/build.py`` (all ``nvcc``s started together)
into ``build/kernels``.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import NamedTuple

import torch

from ccvm_tpu_torch import AdamParameters
from ccvm_tpu_torch.ops import build, mf_kernels
from ccvm_tpu_torch.tools import tc_model


class ProbeSpec(NamedTuple):
    """An MF specialisation (``build.MFSpec``'s fields) with the source's
    probe defines."""

    adam: bool
    beta2_one: bool
    add_assign: bool
    noise: bool
    rng: int
    np: int
    matvec: bool = True
    x_buffers: int = 0  # 0: the launch rule's

    source = build.MFSpec.source
    symbol = build.MFSpec.symbol
    argtypes = build.MFSpec.argtypes
    defines = build.MFSpec.defines

    def tag(self):
        return "probe" + build.MFSpec.tag(self)


def _timer(fn, q, v, params, hp, noise_scale, batch):
    """ms of one launch of ``fn`` over ``iterations`` steps (CUDA events)."""
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
                 torch.cuda.current_stream().cuda_stream)
        end.record()
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return start.elapsed_time(end)

    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--i1", type=int, default=1000)
    ap.add_argument("--i2", type=int, default=4000)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=1,
                    help="time every row this many times, the row order reversed "
                         "every other round")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mf_breakdown: no CUDA card")
    q, v, params = tc_model.mf_problem("cuda")
    q, v = q[None].contiguous(), v[None].contiguous()
    adam = {b2: AdamParameters(beta2=b2).to_hyperparameters() for b2 in (0.999, 1.0)}

    def spec(hp=None, noise_scale=1.0, **probe):
        return ProbeSpec(*mf_kernels._spec(70, hp, noise_scale, "popcount32"), **probe)

    rows = [("MF", None, 1.0, spec()),
            ("MF, noise off", None, 0.0, spec(noise_scale=0.0)),
            ("MF, no matvec", None, 1.0, spec(matvec=False)),
            ("MF, one x buffer", None, 1.0, spec(x_buffers=1)),
            ("MF-Adam beta2 0.999", adam[0.999], 1.0, spec(adam[0.999])),
            ("MF-Adam beta2 1", adam[1.0], 1.0, spec(adam[1.0]))]
    reports = build.build([s for *_, s in rows])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"MF kernel breakdown on {smi or torch.cuda.get_device_name(0)}, batch "
          f"{args.batch}, N=70, marginal us/step over {args.i1} and {args.i2} steps, "
          f"best of {args.reps}, {args.rounds} round(s):", flush=True)
    timers = {label: _timer(build.load(s), q, v, params, hp, noise_scale, args.batch)
              for label, hp, noise_scale, s in rows}
    us = {label: [] for label in timers}
    for r in range(args.rounds):
        for label in (list(timers) if r % 2 == 0 else list(timers)[::-1]):
            run = timers[label]
            run(args.i1)  # warm-up
            t = {it: min(run(it) for _ in range(args.reps)) for it in (args.i1, args.i2)}
            us[label].append((t[args.i2] - t[args.i1]) / (args.i2 - args.i1) * 1e3)
    for label, _, _, s in rows:
        med = sorted(us[label])[len(us[label]) // 2]
        report = build.kernel_report(reports[s]) if s in reports else "built before this run"
        print(f"  {label}: {med:.3f} us/step median ({med * 15:.1f} ms at 15,000 "
              f"steps), rounds {', '.join(f'{x:.3f}' for x in us[label])}; {report}",
              flush=True)


if __name__ == "__main__":
    main()
