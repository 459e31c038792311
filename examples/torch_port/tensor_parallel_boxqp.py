"""Tensor + data parallel BoxQP solve over a ("batch", "model") mesh.

The twin of ``examples/tensor_parallel_boxqp.py`` for ``ccvm_tpu_torch``:
the trajectory batch shards over the mesh's "batch" axis and the Q matvec's
contraction over "model", whose partial sums one reduce-scatter a step
returns to the feature shards (``ccvm_tpu_torch.parallel.tp``).  Any solver
routes through it when its mesh has a model axis larger than one.

One process a card, under torchrun (NCCL):

    torchrun --nproc_per_node N examples/torch_port/tensor_parallel_boxqp.py

One process started without torchrun runs a one-rank world on one card.
On the CPU it spawns N gloo ranks itself, where the JAX example forces 8
virtual CPU devices:

    python examples/torch_port/tensor_parallel_boxqp.py --cpu [--ranks 8]
"""

import argparse
import os
import socket
import sys
import tempfile

EXAMPLES = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(EXAMPLES))

import torch.distributed as dist  # noqa: E402

from ccvm_tpu_torch import LangevinSolver, ProblemInstance  # noqa: E402
from ccvm_tpu_torch.parallel import initialize, make_mesh  # noqa: E402
from ccvm_tpu_torch.parallel.multihost import is_coordinator  # noqa: E402
from ccvm_tpu_torch.runtime import default_device  # noqa: E402

INSTANCE = os.path.join(EXAMPLES, "benchmarking_instances", "single_test_instance",
                        "tuningH020-100-0.in")


def mesh_of_the_world():
    """A ("batch", "model") mesh over every rank: model 2 where the ranks
    pair up, as the JAX example takes it."""
    world = dist.get_world_size()
    return make_mesh(world, tp=2 if world % 2 == 0 else 1)


def solve(device, mesh, iterations=2000):
    """The JAX example's Langevin solve (batch 512, grad-descent, seed 42)
    over ``mesh``; returns the Solution, which every rank holds whole."""
    if mesh is not None and is_coordinator():
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"mesh: {shape} over {dist.get_world_size()} {mesh.device_type} rank(s)")
    solver = LangevinSolver(device=device, batch_size=512, mesh=mesh)
    solver.parameter_key = {
        20: {"dt": 0.002, "S": 0.5, "iterations": iterations, "sigma": 0.5,
             "feedback_scale": 1.0}
    }
    instance = ProblemInstance(instance_type="test", file_path=INSTANCE, device=device)
    instance.scale_coefs(solver.get_scaling_factor(instance.q_matrix))
    solution = solver(instance, post_processor="grad-descent", seed=42)
    if is_coordinator():
        print(f"best objective: {solution.best_objective_value:.6f} "
              f"(known optimum {instance.optimal_sol})")
        print(f"success fractions: {solution.solution_performance}")
    return solution


def _cpu_rank(rank, ranks, store, iterations):
    """One of ``--cpu``'s gloo ranks."""
    initialize(f"file://{store}", ranks, rank, device="cpu")
    try:
        solve("cpu", mesh_of_the_world(), iterations)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true",
                    help="spawn --ranks gloo ranks on the CPU instead of using cards")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--iterations", type=int, default=2000)
    args = ap.parse_args(argv)
    if args.cpu:
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory() as d:
            mp.spawn(_cpu_rank, args=(args.ranks, os.path.join(d, "store"),
                                      args.iterations), nprocs=args.ranks)
        return
    device = default_device()
    if "RANK" in os.environ:
        initialize(device=device)  # torchrun's environment
    else:
        initialize(f"localhost:{_free_port()}", 1, 0, device=device)
    try:
        solve(device, mesh_of_the_world(), args.iterations)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
