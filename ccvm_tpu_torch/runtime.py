"""Device plumbing for the PyTorch/CUDA CCVM port.

The reference threads a ``device`` string ("cpu"/"cuda") through every layer
(``ccvm_simulators/solvers/ccvm_solver.py:8-12``).  The port keeps those two
strings and resolves them to :class:`torch.device` objects.  There is no
silent fallback: asking for "cuda" on a host without a card raises, so a run
that was meant for the card never quietly measures the CPU.
"""

from __future__ import annotations

import contextlib
import enum

import numpy as np
import torch

from ccvm_tpu_torch import profiling


class DeviceType(enum.Enum):
    """Devices usable by the solvers (reference ``ccvm_solver.py:8-12``)."""

    CPU_DEVICE = "cpu"
    CUDA_DEVICE = "cuda"


def validate_device(device: str) -> str:
    """Validate a device string; raises ValueError like the reference base
    solver (``ccvm_solver.py:33-35``)."""
    if device not in DeviceType._value2member_map_:
        raise ValueError("Given device is not available")
    return device


def resolve_device(device: str) -> torch.device:
    """Map a device string to a :class:`torch.device`; "cuda" raises when
    no card is present."""
    validate_device(device)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            'device "cuda" was requested but torch.cuda.is_available() is '
            'False; pass device="cpu" to run the plain PyTorch path'
        )
    return torch.device(device)


def default_device() -> str:
    """The port's default device: "cuda", raising when no card is present."""
    resolve_device("cuda")
    return "cuda"


def synchronize(x: torch.Tensor):
    """Wait for the card that computes ``x``: a ``ccvm.sync`` span and one
    ``host_syncs``, counted on "cpu" too, where there is nothing to wait
    for."""
    with profiling.annotate("ccvm.sync"):
        profiling.count("host_syncs")
        if x.is_cuda:
            torch.cuda.synchronize(x.device)


def put(x, device: str) -> torch.Tensor:
    """Copy a host array to the resolved device (dtype preserved)."""
    return torch.tensor(np.asarray(x), device=resolve_device(device))


@contextlib.contextmanager
def fp32_matmul():
    """Run float32 matrix products in full IEEE float32 (TF32 off).

    The plain solve is the kernel's float32 yardstick, and TF32 keeps ~3
    decimal digits.
    The previous setting is restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
