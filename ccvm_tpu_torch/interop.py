"""Carry state from the JAX package into the port, as NumPy and plain values.

Tests build both frameworks' objects from the same numbers: a JAX
``ProblemInstance``'s host arrays (``_q64``, ``_v64``, ``q_matrix``,
``v_vector``, ``scaled_by``) or the fields of a JAX ``DLParams``,
``MFParams``, ``LangevinParams``, ``PumpedLangevinParams`` or
``AdamHyperparameters`` become the port's counterparts, for the three solver
families ported (DL, MF, and Langevin with pumped Langevin).  This module
takes NumPy arrays and plain values only and imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np

from ccvm_tpu_torch.dynamics.common import AdamHyperparameters
from ccvm_tpu_torch.dynamics.dl import DLParams
from ccvm_tpu_torch.dynamics.langevin import LangevinParams
from ccvm_tpu_torch.dynamics.mf import MFParams
from ccvm_tpu_torch.dynamics.pumped_langevin import PumpedLangevinParams
from ccvm_tpu_torch.problem_classes.boxqp.problem_instance import ProblemInstance
from ccvm_tpu_torch.runtime import put


def instance_from_numpy(q64, v64, meta, scaled_by=1.0, solution_bounds=(0.0, 1.0),
                        device="cuda", *, q_matrix=None, v_vector=None,
                        name="interop", solution_vector=None):
    """A port ``ProblemInstance`` from float64 host coefficients and the
    parse metadata.  ``q_matrix`` / ``v_vector`` (float32, already scaled)
    are copied as they are when given; otherwise the float32 coefficients
    are divided by ``scaled_by``, as one ``scale_coefs`` call would."""
    inst = ProblemInstance(device=device, name=name,
                           solution_bounds=tuple(solution_bounds))
    inst._set_problem(q64, v64, meta, list(solution_vector or []))
    sf = float(np.float32(scaled_by))
    if q_matrix is None:
        q_matrix = np.asarray(q64, np.float32) / np.float32(sf)
    if v_vector is None:
        v_vector = np.asarray(v64, np.float32) / np.float32(sf)
    inst.q_matrix = put(np.asarray(q_matrix, np.float32), device)
    inst.v_vector = put(np.asarray(v_vector, np.float32), device)
    inst.scaled_by = sf
    return inst


def dl_params_from_numpy(pump, S, dt, noise_ratio, feedback_scale, g,
                         lower_limit, upper_limit, iterations,
                         ramp_power=None, ramp_fraction=None):
    """``DLParams`` from the JAX ``DLParams`` fields (arrays or floats)."""
    if ramp_power is not None or ramp_fraction is not None:
        raise NotImplementedError(
            "a generalised pump_ramp is not ported to ccvm_tpu_torch yet "
            "(ROADMAP.md, queue 1 item 4)"
        )
    vals = (pump, S, dt, noise_ratio, feedback_scale, g, lower_limit,
            upper_limit, iterations)
    if any(np.ndim(x) for x in vals):
        raise ValueError("DLParams fields must be scalars in this port")
    return DLParams(*(float(np.float32(x)) for x in vals))


def _scalar_params(cls, vals):
    if any(np.ndim(x) for x in vals):
        raise ValueError(f"{cls.__name__} fields must be scalars in this port")
    return cls(*(float(np.float32(x)) for x in vals))


def mf_params_from_numpy(pump, S, dt, j, feedback_scale, g, lower_limit,
                         upper_limit, iterations):
    """``MFParams`` from the JAX ``MFParams`` fields (arrays or floats)."""
    return _scalar_params(MFParams, (pump, S, dt, j, feedback_scale, g,
                                     lower_limit, upper_limit, iterations))


def langevin_params_from_numpy(S, dt, sigma, feedback_scale, lower_limit,
                               upper_limit):
    """``LangevinParams`` from the JAX ``LangevinParams`` fields (arrays or
    floats)."""
    return _scalar_params(LangevinParams, (S, dt, sigma, feedback_scale,
                                           lower_limit, upper_limit))


def pumped_langevin_params_from_numpy(pump, S, dt, sigma, feedback_scale,
                                      lower_limit, upper_limit, iterations):
    """``PumpedLangevinParams`` from the JAX ``PumpedLangevinParams``
    fields (arrays or floats)."""
    return _scalar_params(PumpedLangevinParams, (
        pump, S, dt, sigma, feedback_scale, lower_limit, upper_limit,
        iterations))


def adam_from_numpy(alpha, beta1, beta2, add_assign):
    """``AdamHyperparameters`` from the JAX hyperparameters' fields."""
    return AdamHyperparameters(
        alpha=float(alpha), beta1=float(beta1), beta2=float(beta2),
        add_assign=bool(add_assign),
    )
