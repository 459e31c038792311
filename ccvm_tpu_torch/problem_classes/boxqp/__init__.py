"""Box-constrained quadratic programming instances."""

from ccvm_tpu_torch.problem_classes.boxqp.problem_instance import (
    InstanceType,
    ProblemInstance,
    parse_instance_file,
)

__all__ = ["InstanceType", "ProblemInstance", "parse_instance_file"]
