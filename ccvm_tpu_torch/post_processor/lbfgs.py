"""LBFGS post-processor (PyTorch).

Reference (``post_processor/lbfgs.py:15-66``) by way of
``ccvm_tpu/post_processor/lbfgs.py:29-49``: per-row ``torch.optim.LBFGS``
with lr=0.001, clamping to the box after each outer iteration.  The JAX
package runs its batched box-projected L-BFGS with the same conservative
first step (t0 = min(1, 1/|g|_1) x 0.001); here the port of it
(:mod:`ccvm_tpu_torch.ops.lbfgs`) runs on ``c``'s device.
"""

from __future__ import annotations

import time

from ccvm_tpu_torch.ops.lbfgs import lbfgs_box_batch
from ccvm_tpu_torch.post_processor.post_processor import (
    MethodType,
    PostProcessor,
    as_float32,
)


class PostProcessorLBFGS(PostProcessor):
    def __init__(self):
        self.pp_time = 0
        self.method_type = MethodType.LBFGS

    def postprocess(
        self, c, q_matrix, v_vector, lower_clamp=0.0, upper_clamp=1.0, num_iter=1
    ):
        """Refine ``c`` with ``num_iter`` box-projected L-BFGS iterations.
        Returns a float32 tensor on ``c``'s device."""
        start_time = time.time()
        c, q_matrix, v_vector = as_float32(c, q_matrix, v_vector)
        result = lbfgs_box_batch(c, q_matrix, v_vector, lower=lower_clamp,
                                 upper=upper_clamp, first_step_scale=0.001,
                                 max_iter=num_iter)
        self.pp_time = self.elapsed(start_time, result)
        return result
