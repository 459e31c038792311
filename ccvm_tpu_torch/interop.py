"""Carry state from the JAX package into the port, as NumPy and plain values.

Tests build both frameworks' objects from the same numbers: a JAX
``ProblemInstance``'s host arrays (``_q64``, ``_v64``, ``q_matrix``,
``v_vector``, ``scaled_by``) or the fields of a JAX ``DLParams``,
``MFParams``, ``LangevinParams``, ``PumpedLangevinParams`` or
``AdamHyperparameters`` become the port's counterparts, for the three solver
families ported (DL, MF, and Langevin with pumped Langevin): S a scalar, an
(n,) vector or a (batch, n) S (equal rows, as the JAX façades make a 1-D S,
or rows that differ), and DL's generalised pump ramp.  This module takes
NumPy arrays and plain values only and imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np

from ccvm_tpu_torch.dynamics.common import AdamHyperparameters, saturation
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


def _saturation(S):
    """A JAX parameter tuple's S as the port's: a scalar, an (n,) S, or a
    (batch, n) S: with equal rows (the JAX façades' ``np.outer(ones(batch),
    S)``) its row, as the port's façades take it; with rows that differ a
    float32 tensor on the CPU (``dynamics/common.saturation``)."""
    S = np.array(S, np.float32)
    if S.ndim == 2 and (S == S[:1]).all():
        S = S[0]
    if S.ndim > 2:
        raise ValueError(f"S must be a scalar, (n,) or (batch, n), got {S.shape}")
    return saturation(S)


def _params(cls, vals, **extra):
    """``cls`` from the JAX fields ``vals`` in its order: each a scalar, but
    S (:func:`_saturation`)."""
    out = []
    for name, x in zip(cls._fields, vals):
        if name == "S":
            out.append(_saturation(x))
        elif np.ndim(x):
            raise ValueError(f"{cls.__name__} fields but S must be scalars")
        else:
            out.append(float(np.float32(x)))
    return cls(*out, **extra)


def dl_params_from_numpy(pump, S, dt, noise_ratio, feedback_scale, g,
                         lower_limit, upper_limit, iterations,
                         ramp_power=None, ramp_fraction=None):
    """``DLParams`` from the JAX ``DLParams`` fields (arrays or floats), the
    generalised ramp's included (None: unset)."""
    ramp = {k: None if x is None else float(np.float32(x))
            for k, x in (("ramp_power", ramp_power), ("ramp_fraction", ramp_fraction))}
    return _params(DLParams, (pump, S, dt, noise_ratio, feedback_scale, g,
                              lower_limit, upper_limit, iterations), **ramp)


def mf_params_from_numpy(pump, S, dt, j, feedback_scale, g, lower_limit,
                         upper_limit, iterations):
    """``MFParams`` from the JAX ``MFParams`` fields (arrays or floats)."""
    return _params(MFParams, (pump, S, dt, j, feedback_scale, g, lower_limit,
                              upper_limit, iterations))


def langevin_params_from_numpy(S, dt, sigma, feedback_scale, lower_limit,
                               upper_limit):
    """``LangevinParams`` from the JAX ``LangevinParams`` fields (arrays or
    floats)."""
    return _params(LangevinParams, (S, dt, sigma, feedback_scale, lower_limit,
                                    upper_limit))


def pumped_langevin_params_from_numpy(pump, S, dt, sigma, feedback_scale,
                                      lower_limit, upper_limit, iterations):
    """``PumpedLangevinParams`` from the JAX ``PumpedLangevinParams``
    fields (arrays or floats)."""
    return _params(PumpedLangevinParams, (pump, S, dt, sigma, feedback_scale,
                                          lower_limit, upper_limit, iterations))


def adam_from_numpy(alpha, beta1, beta2, add_assign):
    """``AdamHyperparameters`` from the JAX hyperparameters' fields."""
    return AdamHyperparameters(
        alpha=float(alpha), beta1=float(beta1), beta2=float(beta2),
        add_assign=bool(add_assign),
    )
