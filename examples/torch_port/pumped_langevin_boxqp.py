"""Pumped-Langevin example on the port with grad-descent post-processing (the
twin of ``examples/pumped_langevin_boxqp.py``).

It runs on the card ("cuda", and raises without one); ``main(device="cpu")``
runs the kernels' plain PyTorch versions instead.  ``main`` returns the
printed Solutions.

Usage:
    python examples/torch_port/pumped_langevin_boxqp.py
"""

import glob
import os
import sys

EXAMPLES = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(EXAMPLES))

from ccvm_tpu_torch.problem_classes.boxqp import ProblemInstance  # noqa: E402
from ccvm_tpu_torch.runtime import default_device  # noqa: E402
from ccvm_tpu_torch.solvers import PumpedLangevinSolver  # noqa: E402

# Inputs
TEST_INSTANCES_DIR_NAME = "single_test_instance"
TEST_INSTANCES_PATH = os.path.join(EXAMPLES, "benchmarking_instances",
                                   TEST_INSTANCES_DIR_NAME)
BATCH_SIZE = 1000
PARAMETER_KEY = {
    20: {
        "pump": 2.0,
        "dt": 0.002,
        "S": 0.5,
        "iterations": 1500,
        "sigma": 0.5,
        "feedback_scale": 1.0,
    },
}
POST_PROCESSOR = "grad-descent"


def main(device=None, instances_path=TEST_INSTANCES_PATH, seed=None):
    solver = PumpedLangevinSolver(device=device or default_device(), batch_size=BATCH_SIZE)
    solver.parameter_key = {size: dict(p) for size, p in PARAMETER_KEY.items()}

    solutions = []
    for instance_file in sorted(glob.glob(os.path.join(instances_path, "*.in"))):
        boxqp_instance = ProblemInstance(
            instance_type="test",
            file_path=instance_file,
            device=solver.device,
        )

        boxqp_instance.scale_coefs(solver.get_scaling_factor(boxqp_instance.q_matrix))

        solution = solver(
            instance=boxqp_instance,
            post_processor=POST_PROCESSOR,
            seed=seed,
        )

        print(solution)
        solutions.append(solution)
    return solutions


if __name__ == "__main__":
    main()
