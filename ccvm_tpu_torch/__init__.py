"""ccvm_tpu_torch — the CCVM simulator ported to PyTorch and CUDA for Hopper.

The PyTorch counterpart of ``ccvm_tpu``: the same public surface, with the
whole-solve Pallas TPU kernels rewritten as hand-written CUDA kernels for
the NVIDIA H100 (``csrc/``, built with ``nvcc`` at first use).  Entry points
run on the card ("cuda") unless the caller asks for "cpu", where each kernel's
plain PyTorch version runs instead.

This slice carries the DL-CCVM and MF-CCVM solves (plain and Adam) and the
grad-descent post-processor; the Langevin solvers, the other
post-processors, metadata and plotting arrive in later slices (ROADMAP.md).
"""

__version__ = "0.1.0"

from ccvm_tpu_torch.problem_classes.boxqp import ProblemInstance
from ccvm_tpu_torch.solution import Solution
from ccvm_tpu_torch.solvers import (
    AdamParameters,
    CCVMSolver,
    DLSolver,
    MFSolver,
)

__all__ = [
    "ProblemInstance",
    "Solution",
    "AdamParameters",
    "CCVMSolver",
    "DLSolver",
    "MFSolver",
]
