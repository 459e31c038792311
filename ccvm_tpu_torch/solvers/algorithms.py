"""Algorithm parameter holders (API-parity port of
``ccvm_simulators/solvers/algorithms.py``)."""

from __future__ import annotations

from ccvm_tpu_torch.dynamics.common import AdamHyperparameters


class AdamParameters:
    """Validates and stores the parameters for the in-loop Adam algorithm
    (reference ``algorithms.py:1-46``)."""

    def __init__(self, alpha=0.1, beta1=0.9, beta2=0.999, add_assign=True):
        if alpha < 0.0:
            raise ValueError(f"AdamAlgorithm: Invalid `alpha` value: {alpha}")
        self.alpha = alpha

        if beta1 <= 0 or 1 <= beta1:
            raise ValueError(f"AdamAlgorithm: Invalid `beta1` value: {beta1}")
        self.beta1 = beta1

        if beta2 <= 0 or 1 < beta2:
            raise ValueError(f"AdamAlgorithm: Invalid `beta2` value: {beta2}")
        self.beta2 = beta2

        self.add_assign = bool(add_assign)

    def to_dict(self):
        """Returns the parameters as a dictionary."""
        return {
            "alpha": self.alpha,
            "beta1": self.beta1,
            "beta2": self.beta2,
            "add_assign": self.add_assign,
        }

    def to_hyperparameters(self) -> AdamHyperparameters:
        """Hashable static form consumed by the dynamics and the kernel."""
        return AdamHyperparameters(
            alpha=float(self.alpha),
            beta1=float(self.beta1),
            beta2=float(self.beta2),
            add_assign=bool(self.add_assign),
        )
