"""ASGD post-processor (PyTorch).

Reference (``post_processor/asgd.py:15-69``) by way of
``ccvm_tpu/post_processor/asgd.py:27-43``: ``torch.optim.ASGD``'s recurrence
with lr=0.01, lambd=0.001, alpha=0.75 on the whole batch, clamping after
each step; the returned values are the raw parameters (not the ASGD running
average), as the reference reads ``model.params``.  The step size ``eta`` is
a float32 carry that starts at lr, as in the JAX scan; here the whole
schedule is one float32 table on ``c``'s device.
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


def _asgd_refine(c, q_matrix, v_vector, lower_clamp, upper_clamp, num_iter):
    lr, lambd, alpha = 0.01, 0.001, 0.75
    # eta_0 = lr; eta_{t} = lr / (1 + lambd * lr * t) ** alpha (t = steps taken).
    steps = torch.arange(num_iter, dtype=torch.float32, device=c.device)
    lr32 = torch.tensor(lr, dtype=torch.float32, device=c.device)
    eta = torch.div(lr32, torch.pow(1.0 + lambd * lr * steps, alpha))
    with fp32_matmul():
        for i in range(num_iter):
            g = torch.matmul(c, q_matrix) + v_vector
            # torch ASGD step: decay, then the gradient step with this eta.
            c = c * (1.0 - lambd * eta[i]) - eta[i] * g
            c = torch.clamp(c, lower_clamp, upper_clamp)
    return c


class PostProcessorASGD(PostProcessor):
    """ASGD refinement of a batch of candidate solutions."""

    def __init__(self):
        self.pp_time = 0
        self.method_type = MethodType.ASGD

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
        """Refine ``c`` with ``num_iter`` ASGD steps.  ``device`` is accepted
        for the reference's signature and ignored, as in the JAX package:
        the work runs on ``c``'s device.  Returns a float32 tensor there."""
        start_time = time.time()
        c, q_matrix, v_vector = as_float32(c, q_matrix, v_vector)
        lo, hi = (torch.tensor(float(x), dtype=torch.float32, device=c.device)
                  for x in (lower_clamp, upper_clamp))
        result = _asgd_refine(c, q_matrix, v_vector, lo, hi, num_iter)
        self.pp_time = self.elapsed(start_time, result)
        return result
