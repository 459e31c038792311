"""CCVM solver façades (DL-CCVM, MF-CCVM, Langevin and pumped Langevin)."""

from ccvm_tpu_torch.solvers.algorithms import AdamParameters
from ccvm_tpu_torch.solvers.base import CCVMSolver, MachineType
from ccvm_tpu_torch.solvers.dl import DLSolver
from ccvm_tpu_torch.solvers.langevin import LangevinSolver
from ccvm_tpu_torch.solvers.mf import MFSolver
from ccvm_tpu_torch.solvers.pumped_langevin import PumpedLangevinSolver

__all__ = ["AdamParameters", "CCVMSolver", "MachineType", "DLSolver",
           "MFSolver", "LangevinSolver", "PumpedLangevinSolver"]
