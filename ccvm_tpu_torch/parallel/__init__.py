"""Instance sweeps (``ccvm_tpu/parallel``'s ``sweep_solve``).  The JAX
package's meshes, tensor parallelism and multi-host helpers are not ported
yet (ROADMAP queue 1 item 13)."""

from ccvm_tpu_torch.parallel.sweep import sweep_solve

__all__ = ["sweep_solve"]
