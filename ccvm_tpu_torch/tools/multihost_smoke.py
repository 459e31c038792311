"""Two-process ``torch.distributed`` smoke test over gloo on the CPU (the
twin of ``tools/multihost_smoke.py``).

Validates the multi-process path end to end without several cards: two
local processes join one process group (``multihost.initialize``, through a
file store in a temporary directory: no port to collide with), build the
global mesh, split the instance list with ``local_shard_bounds``, run a
small batch-sharded Langevin solve each (an N=70 dense BoxQP, batch 1024
over the two, 50 steps; each process its 512 rows, whose draws are those of
the single-process solve's rows), and cross-check ``process_allgather`` of
the per-process best objectives and the tiled gather of the whole state,
which must equal the single-process solve bit for bit.

Usage (the parent spawns both workers):
    python -m ccvm_tpu_torch.tools.multihost_smoke            # exit 0 on success
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROCESSES = 2
BATCH, N, ITERATIONS = 1024, 70, 50


def worker(process_id: int, store: str) -> None:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from ccvm_tpu_torch.dynamics.langevin import LangevinParams
    from ccvm_tpu_torch.ops import langevin_kernels
    from ccvm_tpu_torch.parallel import multihost
    from ccvm_tpu_torch.parallel.mesh import all_gather, axis_group, axis_index, axis_size

    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", num_processes=PROCESSES,
                         process_id=process_id, device="cpu")
    import torch.distributed as dist

    assert dist.get_world_size() == PROCESSES, dist.get_world_size()

    # Host-side work split: 5 items over 2 processes -> 3 + 2.
    lo, hi = multihost.local_shard_bounds(5)
    assert (hi - lo) in (2, 3), (lo, hi)

    # The batch-sharded solve over the global mesh.
    mesh = multihost.global_batch_mesh()
    assert axis_size(mesh, "batch") == PROCESSES
    rng = np.random.RandomState(0)
    q = rng.normal(0, 28.7 / np.sqrt(N), (N, N))
    q = torch.tensor((q + q.T) / 2, dtype=torch.float32)
    v = torch.tensor(rng.normal(0, 21, N), dtype=torch.float32)
    params = LangevinParams(S=0.5, dt=0.002, sigma=0.5, feedback_scale=1.0,
                            lower_limit=0.0, upper_limit=1.0)
    rows = BATCH // PROCESSES
    c = langevin_kernels.langevin_solve(0, q, v, params, iterations=ITERATIONS,
                                        batch_size=rows,
                                        row_base=axis_index(mesh, "batch") * rows)
    x = (c + params.S) / (2 * params.S)
    objval = 0.5 * torch.sum(x * (x @ q), dim=-1) + x @ v
    # The global best over the sharded batch: every process's, gathered.
    everyone = all_gather(objval, axis_group(mesh, "batch"), 0)
    best = float(torch.max(everyone))
    assert np.isfinite(best)
    local_best = float(torch.max(-torch.sum(torch.square(c), dim=-1)))
    gathered = multihost.process_allgather(local_best)
    assert gathered.shape == (PROCESSES,) and np.isfinite(gathered).all()
    c_full = multihost.process_allgather(c, tiled=True)
    assert c_full.shape == (BATCH, N)
    single = langevin_kernels.langevin_solve(0, q, v, params, iterations=ITERATIONS,
                                             batch_size=BATCH)
    assert np.array_equal(c_full, single.numpy()), "the sharded solve is not the single one"
    # Every process computed the identical global best.
    bests = multihost.process_allgather(best)
    assert np.allclose(bests, best)
    if multihost.is_coordinator():
        print(f"coordinator OK: gathered {gathered}")
    print(f"process {process_id} OK", flush=True)
    dist.destroy_process_group()


def main() -> int:
    store_dir = tempfile.mkdtemp(prefix="ccvm_smoke_")
    store = os.path.join(store_dir, "store")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [
        subprocess.Popen([sys.executable, "-m", "ccvm_tpu_torch.tools.multihost_smoke",
                          str(pid), store], env=env, cwd=REPO)
        for pid in range(PROCESSES)
    ]
    rc = 0
    try:
        for p in procs:
            try:
                rc |= p.wait(timeout=600)
            except subprocess.TimeoutExpired:
                rc |= 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(store_dir, ignore_errors=True)
    print("multihost smoke:", "PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]), sys.argv[2])
    else:
        sys.exit(main())
