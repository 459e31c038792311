"""The kernels' least times: a frozen count of each kernel's work and the
card's published peaks, independent of how a kernel is implemented.

A kernel's count (``portbench/kernels/<kernel>.json``) gives, per
trajectory, element and step, its matvecs (each 2 n multiply-adds an
element) and its elementwise operations, and the arrays it writes.  The
least time of a launch over B trajectories of an n-variable problem for T
steps is the largest of

- the matvecs' 2 * matvecs * B * n^2 * T operations at the dense TF32
  tensor-core peak: one TF32 pass, which no scheme that passes the output
  check can beat, so CUDA cores, 3xTF32 and 4xTF32 all read against it;
- the elementwise * B * n * T operations at the fp32 peak;
- the bytes: Q and V read once, each output written once, at the HBM rate.

Peaks: NVIDIA H100 SXM data sheet, dense (no sparsity): 494.7 TFLOP/s TF32,
66.9 TFLOP/s fp32, 3.35 TB/s, at the 700 W power limit.
"""

from __future__ import annotations

import json
import os

TF32_PEAK = 494.7e12
FP32_PEAK = 66.9e12
HBM_BYTES_PER_S = 3.35e12
KERNELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels")


def count(kernel):
    with open(os.path.join(KERNELS, f"{kernel}.json")) as f:
        return json.load(f)


def least_seconds(kernel, *, instances, batch, n, iterations):
    """(seconds, the bound that sets it) of one launch."""
    c = count(kernel)
    rows = instances * batch
    matvec = 2 * c["matvecs"] * rows * n * n * iterations
    elementwise = c["elementwise_flops"] * rows * n * iterations
    bytes_ = 4 * (instances * (n * n + n) + c["outputs"] * rows * n)
    bounds = {"tf32 matvec": matvec / TF32_PEAK, "fp32 elementwise": elementwise / FP32_PEAK,
              "bytes": bytes_ / HBM_BYTES_PER_S}
    name = max(bounds, key=bounds.get)
    return bounds[name], name
