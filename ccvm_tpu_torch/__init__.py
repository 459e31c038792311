"""ccvm_tpu_torch — the CCVM simulator ported to PyTorch and CUDA for Hopper.

The PyTorch counterpart of ``ccvm_tpu``: the same public surface, with the
whole-solve Pallas TPU kernels rewritten as hand-written CUDA kernels for
the NVIDIA H100 (``csrc/``, built with ``nvcc`` at first use).  Entry points
run on the card ("cuda") unless the caller asks for "cpu", where each kernel's
plain PyTorch version runs instead.

It carries the four SDE solver families, each plain and Adam: DL-CCVM,
MF-CCVM, Langevin and pumped Langevin; the five post-processors
(grad-descent, Adam, ASGD, BFGS and L-BFGS, plain torch on the tensor's
device); ``Metadata``; and ``ccvmplotlib`` (TTS, ETS and success-probability
statistics and plots), which is host-only: it needs pandas and matplotlib,
and nothing else of the port imports it.  ``parallel.sweep_solve`` solves
many same-size instances in one stacked launch, ``tuning`` grid-searches a
façade's parameters with it (each façade's ``tune``), ``checkpoint``
snapshots and resumes a solve run as segment launches, and ``profiling``
traces a run with ``torch.profiler``.  What is still to come is listed in
ROADMAP.md.
"""

__version__ = "0.1.0"

from ccvm_tpu_torch import checkpoint, profiling
from ccvm_tpu_torch.metadata import Metadata
from ccvm_tpu_torch.problem_classes.boxqp import ProblemInstance
from ccvm_tpu_torch.solution import Solution
from ccvm_tpu_torch.solvers import (
    AdamParameters,
    CCVMSolver,
    DLSolver,
    LangevinSolver,
    MFSolver,
    PumpedLangevinSolver,
)

__all__ = [
    "checkpoint",
    "profiling",
    "Metadata",
    "ProblemInstance",
    "Solution",
    "AdamParameters",
    "CCVMSolver",
    "DLSolver",
    "MFSolver",
    "LangevinSolver",
    "PumpedLangevinSolver",
]
