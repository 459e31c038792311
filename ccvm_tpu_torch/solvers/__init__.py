"""CCVM solver façades (this slice: DL-CCVM and MF-CCVM)."""

from ccvm_tpu_torch.solvers.algorithms import AdamParameters
from ccvm_tpu_torch.solvers.base import CCVMSolver, MachineType
from ccvm_tpu_torch.solvers.dl import DLSolver
from ccvm_tpu_torch.solvers.mf import MFSolver

__all__ = ["AdamParameters", "CCVMSolver", "MachineType", "DLSolver", "MFSolver"]
