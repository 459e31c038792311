"""Full pipeline example on the port: solve -> Metadata JSON -> TTS + ETS plots
(the twin of ``examples/ccvm_boxqp_plot.py``).

It runs on the card ("cuda", and raises without one); ``main(device="cpu")``
runs the kernels' plain PyTorch versions instead.  The metadata and plot
folders are made under ``main``'s ``out_dir`` (by default the working
directory, as the JAX script writes ``./metadata`` and ``./plots``).
Plotting needs matplotlib and pandas; ``solve_to_metadata`` needs neither.

Usage:
    python examples/torch_port/ccvm_boxqp_plot.py
"""

import glob
import os
import sys

EXAMPLES = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(EXAMPLES))

from ccvm_tpu_torch.metadata import Metadata  # noqa: E402
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
        "dt": 0.005,
        "iterations": 15000,
        "noise_ratio": 10,
        "feedback_scale": 100,
    },
}

# Outputs, under out_dir
METADATA_DIR = "metadata"
PLOT_OUTPUT_DIR = "plots"
TTS_PLOT_NAME = "DL-CCVM_TTS_cuda_plot.png"
ETS_PLOT_NAME = "DL-CCVM_ETS_cuda_plot.png"

# ETS with customized machine parameters
MACHINE_PARAMETERS = {
    "cpu_power": {20: 5.0, 30: 5.0, 40: 5.0, 50: 5.0, 60: 5.0, 70: 5.0}
}


def solve_to_metadata(device=None, instances_path=TEST_INSTANCES_PATH, out_dir=".",
                      seed=None):
    """Solve every instance and write the Metadata JSON; returns (solver,
    metadata file path, the Solutions)."""
    solver = DLSolver(device=device or default_device(), batch_size=BATCH_SIZE)
    solver.parameter_key = {size: dict(p) for size, p in PARAMETER_KEY.items()}

    metadata_obj = Metadata(device=solver.device)
    solutions = []
    for instance_file in sorted(glob.glob(os.path.join(instances_path, "*.in"))):
        boxqp_instance = ProblemInstance(
            instance_type="test",
            file_path=instance_file,
            device=solver.device,
        )
        boxqp_instance.scale_coefs(solver.get_scaling_factor(boxqp_instance.q_matrix))
        solution = solver(instance=boxqp_instance, post_processor=None, seed=seed)
        metadata_obj.add_to_result_metadata(solution.get_metadata_dict())
        solutions.append(solution)

    metadata_filepath = metadata_obj.save_metadata_to_file(
        os.path.join(out_dir, METADATA_DIR))
    return solver, metadata_filepath, solutions


def plot(solver, metadata_filepath, out_dir="."):
    """The TTS plot with the CPU machine model and the ETS plot with
    ``MACHINE_PARAMETERS``, as PNGs; returns their paths."""
    import matplotlib

    matplotlib.use("Agg")  # headless environments
    import matplotlib.pyplot as plt

    from ccvm_tpu_torch.ccvmplotlib import ccvmplotlib

    plot_dir = os.path.join(out_dir, PLOT_OUTPUT_DIR)
    if not os.path.isdir(plot_dir):
        os.makedirs(plot_dir)
        print("Plot folder doesn't exist yet. Creating: ", plot_dir)

    tts_dest = os.path.join(plot_dir, TTS_PLOT_NAME)
    tts_plot_fig, tts_plot_ax = ccvmplotlib.plot_TTS(
        metadata_filepath=metadata_filepath,
        problem="BoxQP",
        machine_time_func=solver.machine_time(machine="cpu"),
    )
    ccvmplotlib.apply_default_tts_styling(tts_plot_fig, tts_plot_ax)
    tts_plot_fig.savefig(tts_dest)
    print(f"Successfully saved the plot to {tts_dest}")

    ets_dest = os.path.join(plot_dir, ETS_PLOT_NAME)
    ets_plot_fig, ets_plot_ax = ccvmplotlib.plot_ETS(
        metadata_filepath=metadata_filepath,
        problem="BoxQP",
        machine_energy_func=solver.machine_energy(
            machine="cpu", machine_parameters=MACHINE_PARAMETERS
        ),
    )
    ccvmplotlib.apply_default_ets_styling(ets_plot_fig, ets_plot_ax)
    ets_plot_fig.savefig(ets_dest)
    print(f"Successfully saved the plot to {ets_dest}")

    plt.close("all")
    return tts_dest, ets_dest


def main(device=None, instances_path=TEST_INSTANCES_PATH, out_dir=".", seed=None):
    """Solve, write the metadata, plot; returns the two PNGs' paths."""
    solver, metadata_filepath, _ = solve_to_metadata(device, instances_path, out_dir,
                                                     seed)
    return plot(solver, metadata_filepath, out_dir)


if __name__ == "__main__":
    main()
