"""Projected gradient-descent post-processor (PyTorch).

Reference: ``ccvm_simulators/post_processor/grad_descent.py`` by way of
``ccvm_tpu/post_processor/grad_descent.py`` — a loop of
``c -= step * (cQ + V); clamp``.  The JAX package runs it as plain XLA
outside any Pallas kernel, so here it is plain torch on the tensor's own
device, with float32 products in full IEEE precision.  The default iteration
count is 1% of the main solve's, as in the reference (``:57-58``).
"""

from __future__ import annotations

import time

import torch

from ccvm_tpu_torch.post_processor.post_processor import PostProcessor, as_float32
from ccvm_tpu_torch.runtime import fp32_matmul


def _gd_refine(c, q_matrix, v_vector, lower_clamp, upper_clamp, step_size, num_iter):
    """``num_iter`` steps of ``c -= step (c Q + V); clamp`` on float32
    tensors (``lower_clamp``, ``upper_clamp`` and ``step_size`` 0-dim); over
    an instance axis c is (I, B, n), Q (I, n, n) and V (I, 1, n)."""
    with fp32_matmul():
        for _ in range(num_iter):
            grads = torch.matmul(c, q_matrix) + v_vector
            c = torch.clamp(c - step_size * grads, lower_clamp, upper_clamp)
    return c


class PostProcessorGradDescent(PostProcessor):
    def __init__(self):
        self.pp_time = 0

    def postprocess(
        self,
        c,
        q_matrix,
        v_vector,
        lower_clamp=0.0,
        upper_clamp=1.0,
        num_iter_main=1000,
        num_iter_pp=None,
        step_size=0.1,
    ):
        """Refine ``c`` with projected gradient descent (reference ``:13-68``).

        Args:
            c: (batch, n) initial values, a tensor or an ndarray.
            q_matrix, v_vector: BoxQP coefficients.
            num_iter_pp: iterations; defaults to 1% of ``num_iter_main``.

        Returns a float32 tensor on ``c``'s device.
        """
        start_time = time.time()
        c, q_matrix, v_vector = as_float32(c, q_matrix, v_vector)
        if num_iter_pp is None:
            num_iter_pp = int(num_iter_main * 0.01)

        lo, hi, step = (
            torch.full((), float(x), dtype=torch.float32, device=c.device)
            for x in (lower_clamp, upper_clamp, step_size)
        )
        c = _gd_refine(c, q_matrix, v_vector, lo, hi, step, num_iter_pp)
        self.pp_time = self.elapsed(start_time, c)
        return c
