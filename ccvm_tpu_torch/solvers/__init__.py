"""CCVM solver façades (this slice: DL-CCVM)."""

from ccvm_tpu_torch.solvers.algorithms import AdamParameters
from ccvm_tpu_torch.solvers.base import CCVMSolver, MachineType
from ccvm_tpu_torch.solvers.dl import DLSolver

__all__ = ["AdamParameters", "CCVMSolver", "MachineType", "DLSolver"]
