"""Adam post-processor (PyTorch).

Reference (``post_processor/adam.py:15-69``) by way of
``ccvm_tpu/post_processor/adam.py:25-45``: ``torch.optim.Adam``'s update with
lr=0.01, betas=(0.9, 0.99), eps=1e-8 on the whole batch, clamping after each
step.  The JAX package runs it as a ``lax.scan`` outside any Pallas kernel,
so here it is plain torch on ``c``'s device, with float32 products in full
IEEE precision and the bias corrections ``1 - beta ** (i + 1)`` computed in
float32, as the scan computes them.
"""

from __future__ import annotations

import time

import torch

from ccvm_tpu_torch.post_processor.post_processor import (
    MethodType,
    PostProcessor,
    as_float32,
)
from ccvm_tpu_torch.runtime import fp32_matmul


def _adam_refine(c, q_matrix, v_vector, lower_clamp, upper_clamp, num_iter):
    lr, b1, b2, eps = 0.01, 0.9, 0.99, 1e-8
    steps = torch.arange(1, num_iter + 1, dtype=torch.float32, device=c.device)
    correction1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                             device=c.device), steps)
    correction2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                             device=c.device), steps)
    m, v = torch.zeros_like(c), torch.zeros_like(c)
    with fp32_matmul():
        for i in range(num_iter):
            g = torch.matmul(c, q_matrix) + v_vector
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mhat = m / correction1[i]
            vhat = v / correction2[i]
            c = torch.clamp(c - lr * mhat / (torch.sqrt(vhat) + eps),
                            lower_clamp, upper_clamp)
    return c


class PostProcessorAdam(PostProcessor):
    """Adam refinement of a batch of candidate solutions."""

    def __init__(self):
        self.pp_time = 0
        self.method_type = MethodType.Adam

    def postprocess(
        self,
        c,
        q_matrix,
        v_vector,
        lower_clamp=0.0,
        upper_clamp=1.0,
        num_iter=1,
        device="cpu",
    ):
        """Refine ``c`` with ``num_iter`` Adam steps.  ``device`` is accepted
        for the reference's signature and ignored, as in the JAX package:
        the work runs on ``c``'s device.  Returns a float32 tensor there."""
        start_time = time.time()
        c, q_matrix, v_vector = as_float32(c, q_matrix, v_vector)
        lo, hi = (torch.tensor(float(x), dtype=torch.float32, device=c.device)
                  for x in (lower_clamp, upper_clamp))
        result = _adam_refine(c, q_matrix, v_vector, lo, hi, num_iter)
        self.pp_time = self.elapsed(start_time, result)
        return result
