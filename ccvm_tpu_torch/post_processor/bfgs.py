"""BFGS post-processor (PyTorch).

Reference (``post_processor/bfgs.py:13-56``) by way of
``ccvm_tpu/post_processor/bfgs.py:23-38``: per-row scipy L-BFGS-B with
bounds [0, 1], mapping ``c -> 0.5 (c + 1)`` in and ``2 (x - 0.5)`` out.
The JAX package replaces the host loop with its batched box-projected
L-BFGS; here the same mapping wraps the port of it
(:mod:`ccvm_tpu_torch.ops.lbfgs`) on ``c``'s device.  The solvers hand it
``c`` already in [0, 1] (DL: ``ccvm_tpu/solvers/dl.py:429-433``), so the
input mapping lands in [0.5, 1]: the reference's quirk, kept.
"""

from __future__ import annotations

import time

from ccvm_tpu_torch.ops.lbfgs import lbfgs_box_batch
from ccvm_tpu_torch.post_processor.post_processor import PostProcessor, as_float32


class PostProcessorBFGS(PostProcessor):
    def __init__(self):
        self.pp_time = 0

    def postprocess(self, c, q_matrix, v_vector):
        """Refine ``c`` with box-constrained L-BFGS in [0, 1] for 50
        iterations, then map back to the reference's output convention
        ``2 (x - 0.5)``.  Returns a float32 tensor on ``c``'s device."""
        start_time = time.time()
        c, q_matrix, v_vector = as_float32(c, q_matrix, v_vector)
        x = lbfgs_box_batch(0.5 * (c + 1.0), q_matrix, v_vector, lower=0.0,
                            upper=1.0, max_iter=50)
        result = 2.0 * (x - 0.5)
        self.pp_time = self.elapsed(start_time, result)
        return result
