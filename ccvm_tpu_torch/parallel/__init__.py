"""Instance sweeps (``ccvm_tpu/parallel``'s ``sweep_solve``) and the
single-process part of its multi-host helpers (``multihost``).  The JAX
package's meshes, tensor parallelism and multi-process runs are not ported
yet (ROADMAP queue 1 item 13)."""

from ccvm_tpu_torch.parallel.multihost import (is_coordinator, local_shard_bounds,
                                               run_resilient)
from ccvm_tpu_torch.parallel.sweep import sweep_solve

__all__ = ["sweep_solve", "run_resilient", "local_shard_bounds", "is_coordinator"]
