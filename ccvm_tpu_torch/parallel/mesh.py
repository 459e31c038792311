"""Device meshes for multi-card CCVM solves (the twin of
``ccvm_tpu/parallel/mesh.py``).

A mesh is PyTorch's own :class:`torch.distributed.device_mesh.DeviceMesh`
over the ranks of the process group, one card (or, on the CPU, one process)
a rank:

* **DP** ("batch" axis): the trajectory batch, embarrassingly parallel,
  shards across ranks; each runs the whole-solve kernel on its rows and the
  final state is all-gathered once.
* **TP** ("model" axis): the Q matvec's partial sums are reduce-scattered
  every step (:mod:`ccvm_tpu_torch.parallel.tp`).
* PP / SP / EP: not applicable to this workload (no layered model, no
  sequence dimension, no experts).

``mesh["model"].get_group()`` (``mesh.get_group("model")``) is the process
group of one axis.  The device type follows the process group's backend:
NCCL meshes are "cuda" meshes, gloo meshes "cpu" ones.  A "cuda" mesh needs
a card for each rank of the host; with fewer it raises, and it never
switches to gloo.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _world():
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh spans the ranks of a process group: start one with "
            "ccvm_tpu_torch.parallel.multihost.initialize (torchrun sets its "
            "environment) before make_mesh")
    return dist.get_world_size()


def mesh_device_type() -> str:
    """"cuda" for an NCCL process group, "cpu" for a gloo one; a "cuda"
    group needs a card for each of the host's ranks and raises without."""
    if dist.get_backend() != "nccl":
        return "cpu"
    cards = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    if local >= cards:
        raise RuntimeError(
            f"an NCCL mesh takes one card a rank: local rank {local} has none "
            f"({cards} card(s) on this host); run no more ranks a host than "
            "cards, or a gloo group for the CPU")
    return "cuda"


def _ranks(n_devices, devices):
    world = _world()
    if devices is None:
        return list(range(world if n_devices is None else int(n_devices)))
    return [int(r) for r in devices]


def make_mesh(n_devices=None, tp: int = 1, devices=None) -> DeviceMesh:
    """Build a ("batch", "model") mesh over the process group's ranks.

    Args:
        n_devices: ranks to use (default: all of the process group).
        tp: size of the "model" (tensor-parallel) axis; must divide
            n_devices.  The "batch" axis gets the rest.
        devices: explicit list of ranks (overrides n_devices).

    Every rank of the process group calls it (the axes' groups are made
    collectively)."""
    ranks = _ranks(n_devices, devices)
    n = len(ranks)
    if n % tp != 0:
        raise ValueError(f"tp={tp} must divide the device count {n}")
    mesh = torch.tensor(ranks, dtype=torch.int64).reshape(n // tp, tp)
    return DeviceMesh(mesh_device_type(), mesh, mesh_dim_names=("batch", "model"))


def make_batch_mesh(n_devices=None, devices=None) -> DeviceMesh:
    """1-D data-parallel mesh over the trajectory batch."""
    ranks = _ranks(n_devices, devices)
    return DeviceMesh(mesh_device_type(), torch.tensor(ranks, dtype=torch.int64),
                      mesh_dim_names=("batch",))


def axis_size(mesh, name: str) -> int:
    """The size of a mesh's axis ``name``, 1 where the mesh has no such
    axis."""
    return mesh.size(mesh.mesh_dim_names.index(name)) if name in mesh.mesh_dim_names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on the axis ``name`` (0 where the mesh has no
    such axis)."""
    return mesh.get_local_rank(name) if name in mesh.mesh_dim_names else 0


def axis_group(mesh, name: str):
    """The process group of the axis ``name``, None where the mesh has no
    such axis."""
    return mesh.get_group(name) if name in mesh.mesh_dim_names else None


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in rank
    order (the list form, which gloo and NCCL both take); ``x`` itself
    without a group."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)
