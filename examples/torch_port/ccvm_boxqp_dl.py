"""DL-CCVM example on the port: solve the bundled single test instance with a
batch of 1000 trajectories (the twin of ``examples/ccvm_boxqp_dl.py``).

It runs on the card ("cuda", and raises without one); ``main(device="cpu")``
runs the kernels' plain PyTorch versions instead.  ``main`` returns the
printed Solutions.

Usage:
    python examples/torch_port/ccvm_boxqp_dl.py
"""

import glob
import os
import sys

EXAMPLES = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(EXAMPLES))

from ccvm_tpu_torch.problem_classes.boxqp import ProblemInstance  # noqa: E402
from ccvm_tpu_torch.runtime import default_device  # noqa: E402
from ccvm_tpu_torch.solvers import DLSolver  # noqa: E402

# Inputs
TEST_INSTANCES_DIR_NAME = "single_test_instance"
TEST_INSTANCES_PATH = os.path.join(EXAMPLES, "benchmarking_instances",
                                   TEST_INSTANCES_DIR_NAME)
BATCH_SIZE = 1000
PARAMETER_KEY = {
    20: {
        "pump": 8.0,
        "feedback_scale": 100,
        "dt": 0.001,
        "iterations": 1500,
        "noise_ratio": 10,
    },
}
POST_PROCESSOR = None


def main(device=None, instances_path=TEST_INSTANCES_PATH, seed=None):
    solver = DLSolver(device=device or default_device(), batch_size=BATCH_SIZE)
    solver.parameter_key = {size: dict(p) for size, p in PARAMETER_KEY.items()}

    solutions = []
    for instance_file in sorted(glob.glob(os.path.join(instances_path, "*.in"))):
        boxqp_instance = ProblemInstance(
            instance_type="test",
            file_path=instance_file,
            device=solver.device,
        )

        # Scale the problem's coefficients for more stable optimization
        boxqp_instance.scale_coefs(solver.get_scaling_factor(boxqp_instance.q_matrix))

        # algorithm_parameters=AdamParameters(...) selects the Adam variant
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
