"""Device meshes, tensor + data parallel solves, instance sweeps and
multi-process helpers (the twin of ``ccvm_tpu/parallel``, on
``torch.distributed``)."""

from ccvm_tpu_torch.parallel.mesh import make_batch_mesh, make_mesh
from ccvm_tpu_torch.parallel.multihost import (global_batch_mesh, initialize,
                                               is_coordinator, local_shard_bounds,
                                               process_allgather, run_resilient)
from ccvm_tpu_torch.parallel.sweep import sweep_solve
from ccvm_tpu_torch.parallel.tp import (dl_sharded_solve, dl_solve, langevin_solve,
                                        mf_solve, pumped_langevin_solve)

__all__ = [
    "make_mesh",
    "make_batch_mesh",
    "dl_sharded_solve",
    "dl_solve",
    "langevin_solve",
    "mf_solve",
    "pumped_langevin_solve",
    "sweep_solve",
    "initialize",
    "global_batch_mesh",
    "process_allgather",
    "run_resilient",
    "local_shard_bounds",
    "is_coordinator",
]
