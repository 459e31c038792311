"""Multi-rank gloo worlds for the port's CPU tests, and the checks each rank
runs in them.

:func:`spawn` starts ``world`` ranks with ``torch.multiprocessing.spawn``;
they join one process group through ``multihost.initialize`` and a
``file://`` store under the test's ``tmp_path`` (no fixed TCP port: the
suite runs in several pytest workers at once), run one function of this
module, and hand back what it returns (pickled under ``tmp_path``).  This
module imports no JAX, so a rank starts in a few seconds; the tests that
hold the port against the JAX package compare in the pytest process.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST020 = os.path.join(REPO, "tests", "data", "test020.in")


def spawn(fn, world, tmp_path, *args):
    """Every rank's return value of ``fn(rank, world, *args)``, rank order."""
    import torch.multiprocessing as mp

    store = os.path.join(str(tmp_path), "store")
    mp.spawn(_rank, args=(fn.__name__, world, store, str(tmp_path), args), nprocs=world,
             join=True)
    out = []
    for rank in range(world):
        with open(os.path.join(str(tmp_path), f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank(rank, name, world, store, out_dir, args):
    from ccvm_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world, rank, device="cpu")
    try:
        result = globals()[name](rank, world, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


# ------------------------------------------------------------------ problems


def rand_problem(n=16, seed=0):
    """tests/unit/test_sharding.py's random problem (the same numbers)."""
    rng = np.random.RandomState(seed)
    q = rng.normal(0, 28.7 / np.sqrt(n), (n, n))
    q = (q + q.T) / 2
    v = rng.normal(0, 21, n)
    return q.astype(np.float32), v.astype(np.float32)


FACADE_KEYS = {
    "DLSolver": {20: {"pump": 8.0, "dt": 0.001, "iterations": 60, "noise_ratio": 10,
                      "feedback_scale": 100}},
    "MFSolver": {20: {"pump": 0.0, "feedback_scale": 4000, "j": 5.0, "S": 20.0,
                      "dt": 0.0025, "iterations": 60}},
    "LangevinSolver": {20: {"dt": 0.002, "S": 0.5, "iterations": 60, "sigma": 0.5,
                            "feedback_scale": 1.0}},
    "PumpedLangevinSolver": {20: {"pump": 2.0, "dt": 0.002, "S": 0.5, "iterations": 60,
                                  "sigma": 0.5, "feedback_scale": 1.0}},
}


def facade_solve(cls_name, mesh, seed=3, batch=64, **call):
    """A façade's Solution on test020.in (noise on), on ``mesh`` or none."""
    import ccvm_tpu_torch as port

    solver = getattr(port, cls_name)(device="cpu", batch_size=batch, mesh=mesh)
    solver.parameter_key = FACADE_KEYS[cls_name]
    inst = port.ProblemInstance(instance_type="test", file_path=TEST020, device="cpu")
    inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
    return solver, solver(inst, seed=seed, **call)


def _same(a, b):
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


# ------------------------------------------------------------ data parallel


def data_parallel(rank, world, files, study_dir):
    """A world of 2: the DP façades, evolution sampling, a per-element S,
    the sweep and the study on a batch mesh against one process; the mesh
    arguments, ``tp_matvec`` at tp 2 and the multihost calls."""
    from ccvm_tpu_torch import ProblemInstance
    from ccvm_tpu_torch.dynamics import common
    from ccvm_tpu_torch.dynamics import langevin as dyn
    from ccvm_tpu_torch.parallel import (global_batch_mesh, initialize, make_mesh,
                                         multihost, sweep_solve)

    out = {}
    mesh = make_mesh(world)
    out["mesh"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape), mesh.device_type)
    for cls_name in FACADE_KEYS:
        kwargs = {} if cls_name == "DLSolver" else {"post_processor": "grad-descent"}
        _, dp = facade_solve(cls_name, mesh, **kwargs)
        _, one = facade_solve(cls_name, None, **kwargs)
        out[f"dp {cls_name}"] = (
            _same(dp.variables["problem_variables"], one.variables["problem_variables"])
            and _same(dp.objective_values, one.objective_values))
    # Evolution sampling and a (batch, n) S whose rows differ, sharded by rows.
    evo = os.path.join(study_dir, f"evolution{rank}.txt")
    S = np.linspace(0.4, 0.6, 64 * 20, dtype=np.float32).reshape(64, 20)
    for m, key in ((mesh, "dp"), (None, "one")):
        solver, sol = facade_solve("LangevinSolver", m, evolution_step_size=20,
                                   evolution_file=evo)
        out[f"evolution {key}"] = (sol.variables["problem_variables"].numpy(),
                                   solver.c_sample.numpy())
        import ccvm_tpu_torch as port

        dl = port.DLSolver(device="cpu", batch_size=64, mesh=m, S=S)
        dl.parameter_key = FACADE_KEYS["DLSolver"]
        inst = port.ProblemInstance(instance_type="test", file_path=TEST020, device="cpu")
        inst.scale_coefs(dl.get_scaling_factor(inst.q_matrix))
        out[f"per-element S {key}"] = dl(inst, seed=5).variables["problem_variables"].numpy()
    # The sweep: two instances, one a rank.
    import ccvm_tpu_torch as port

    for m, key in ((mesh, "dp"), (None, "one")):
        solver = port.LangevinSolver(device="cpu", batch_size=16)
        solver.parameter_key = {8: FACADE_KEYS["LangevinSolver"][20]}
        insts = [ProblemInstance(instance_type="test", file_path=f, device="cpu")
                 for f in files]
        sols = sweep_solve(solver, insts, post_processor="grad-descent", seed=7,
                           scale=True, mesh=m)
        out[f"sweep {key}"] = [(s.variables["problem_variables"].numpy(),
                                np.asarray(s.objective_values)) for s in sols]
    # tp_matvec at tp 2 against the dense matvec, alone and in a step.
    mesh2 = make_mesh(world, tp=world)
    model = mesh2.get_group("model")
    q, v = (torch.from_numpy(a) for a in rand_problem(16, seed=9))
    x = torch.from_numpy(np.random.RandomState(1).randn(8, 16).astype(np.float32))
    nl = 16 // world
    cols = slice(rank * nl, (rank + 1) * nl)
    out["tp_matvec"] = float((common.tp_matvec(model)(x[:, cols], q[cols])
                              - (x @ q)[:, cols]).abs().max())
    p = dyn.LangevinParams(0.5, 0.002, 0.5, 1.0, 0.0, 1.0)
    c = 0.3 * x.clamp(-1, 1)
    w = torch.zeros_like(c)
    tp_c = dyn.make_step(q[cols], v[cols], p, matvec=common.tp_matvec(model))(
        c[:, cols], 0, w[:, cols])
    out["tp step"] = float((tp_c - dyn.make_step(q, v, p)(c, 0, w)[:, cols]).abs().max())
    # The mesh's arguments, and the JAX message.
    try:
        make_mesh(world, tp=3)
        out["tp=3"] = None
    except ValueError as e:
        out["tp=3"] = str(e)
    # Multihost: idempotent, the global mesh, the gathers, the shards.
    initialize(f"file://{os.path.join(study_dir, 'unused')}", world, rank, device="cpu")
    g = global_batch_mesh()
    out["global mesh"] = (tuple(g.mesh_dim_names), tuple(g.shape))
    out["allgather"] = multihost.process_allgather(rank * 10)
    out["allgather tiled"] = multihost.process_allgather(np.full((2, 3), rank), tiled=True)
    out["shard bounds"] = multihost.local_shard_bounds(5)
    # A per-variable S cannot take the tensor-parallel path, as in JAX.
    try:
        lg = port.LangevinSolver(device="cpu", batch_size=64, mesh=mesh2)
        lg.parameter_key = {20: dict(FACADE_KEYS["LangevinSolver"][20],
                                     S=np.full(20, 0.5, np.float32))}
        inst = port.ProblemInstance(instance_type="test", file_path=TEST020, device="cpu")
        lg(inst, seed=1)
        out["tp per-variable S"] = None
    except ValueError as e:
        out["tp per-variable S"] = str(e)
    # The study over a mesh of both ranks, as under torchrun (last: the
    # study ends the process group when it is done).
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ranks_study", os.path.join(REPO, "examples", "torch_port", "benchmarking_study.py"))
    study = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(study)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    out["study"] = study.run_sweep(study.parse_args(study_argv(study_dir, "mesh", "--mesh",
                                                               str(world))))
    out["study group ended"] = not dist.is_initialized()
    return out


def study_argv(study_dir, out_name, *extra):
    """The toy study's arguments (tests/test_torch_multihost_run.py builds
    its instance folder under ``study_dir``)."""
    return ["--instances-dir", os.path.join(study_dir, "instances"), "--solvers",
            "dl,mf,langevin,pumped", "--sizes", "6,8", "--batch-size", "16",
            "--iterations", "40", "--output-dir", os.path.join(study_dir, out_name),
            "--seed", "3", "--device", "cpu", *extra]


# ---------------------------------------------------------- tensor parallel


def _lgv_params(sigma=0.0):
    from ccvm_tpu_torch.dynamics.langevin import LangevinParams

    return LangevinParams(S=0.5, dt=0.002, sigma=sigma, feedback_scale=1.0,
                          lower_limit=0.0, upper_limit=1.0)


def _pumped_params(iterations, sigma=0.0):
    from ccvm_tpu_torch.dynamics.pumped_langevin import PumpedLangevinParams

    return PumpedLangevinParams(pump=2.0, S=0.5, dt=0.002, sigma=sigma,
                                feedback_scale=1.0, lower_limit=0.0, upper_limit=1.0,
                                iterations=float(iterations))


def _dl_params(iterations, g=0.0):
    from ccvm_tpu_torch.dynamics.dl import DLParams

    return DLParams(pump=8.0, S=float(np.sqrt(np.float32(7.0))), dt=0.001,
                    noise_ratio=10.0, feedback_scale=100.0, g=g, lower_limit=0.0,
                    upper_limit=1.0, iterations=float(iterations))


def _mf_params(iterations):
    from ccvm_tpu_torch.dynamics.mf import MFParams

    return MFParams(pump=0.0, S=20.0, dt=0.0025, j=5.0, feedback_scale=4000.0,
                    g=0.001, lower_limit=0.0, upper_limit=1.0,
                    iterations=float(iterations))


def tensor_parallel(rank, world):
    """A world of 4 as a 2 x 2 mesh: the TP solves of tests/unit/
    test_sharding.py with the noise off (for the JAX comparison in the test),
    every family's TP solve with the noise on against one process on the
    same Philox words, MF's statistics, dl_sharded_solve's objective, a
    façade's routing and ``tp_matvec`` at tp 4."""
    from ccvm_tpu_torch.dynamics import common
    from ccvm_tpu_torch.dynamics.common import AdamHyperparameters
    from ccvm_tpu_torch.ops import dl_kernels, langevin_kernels, mf_kernels
    from ccvm_tpu_torch.parallel import make_mesh, tp

    mesh = make_mesh(world, tp=2)
    out = {"mesh": (tuple(mesh.mesh_dim_names), tuple(mesh.shape))}
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    hp = AdamHyperparameters(alpha=0.1, beta1=0.9, beta2=0.99, add_assign=False)
    # Noise off: the JAX tests' problems, seeds and depths.
    q, v = (t(a) for a in rand_problem(seed=0))
    out["langevin"] = tp.langevin_solve(mesh, 1, q, v, _lgv_params(), iterations=150,
                                        batch_size=32).numpy()
    q, v = (t(a) for a in rand_problem(seed=1))
    out["pumped"] = tp.pumped_langevin_solve(mesh, 2, q, v, _pumped_params(150),
                                             iterations=150, batch_size=32).numpy()
    q, v = (t(a) for a in rand_problem(seed=2))
    out["dl"] = tuple(x.numpy() for x in tp.dl_solve(
        mesh, 3, q, v, _dl_params(150), iterations=150, batch_size=32,
        pump_is_gt_one=True))
    q, v = (t(a) for a in rand_problem(seed=4))
    out["langevin adam"] = tp.langevin_solve(mesh, 5, q, v, _lgv_params(), iterations=120,
                                             batch_size=32, hp=hp).numpy()
    # Noise on, 100 steps, against one process on the same words.
    q, v = (t(a) for a in rand_problem(seed=6))
    err = {}
    for label, h in (("", None), (" adam", hp)):
        kw = dict(iterations=100, batch_size=32, hp=h)
        err["langevin" + label] = (
            tp.langevin_solve(mesh, 8, q, v, _lgv_params(0.5), **kw),
            langevin_kernels.langevin_solve(8, q, v, _lgv_params(0.5), **kw))
        err["pumped" + label] = (
            tp.pumped_langevin_solve(mesh, 8, q, v, _pumped_params(100, 0.5), **kw),
            langevin_kernels.pumped_langevin_solve(8, q, v, _pumped_params(100, 0.5),
                                                   pump_rate_flag=True, **kw))
        err["dl" + label] = (
            tp.dl_solve(mesh, 8, q, v, _dl_params(100, 0.05), pump_is_gt_one=True, **kw),
            dl_kernels.dl_solve(8, q, v, _dl_params(100, 0.05), pump_rate_flag=True,
                                pump_is_gt_one=True, **kw))
        err["mf" + label] = (
            tp.mf_solve(mesh, 8, q, v, _mf_params(100), **kw),
            mf_kernels.mf_solve(8, q, v, _mf_params(100), pump_rate_flag=True, **kw))
    # The difference in units of max(1, |x|): MF's mu runs unclamped to about
    # 1.2e3 here, where one float32 ulp is 1.2e-4.
    out["noise on"] = {k: max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
                              for a, b in zip(
        *(x if isinstance(x, tuple) else (x,) for x in pair))) for k, pair in err.items()}
    # MF held by its statistics too (tests/unit/test_sharding.py:205).
    q, v = (t(a) for a in rand_problem(seed=3))
    mf_tp = tp.mf_solve(mesh, 4, q, v, _mf_params(300), iterations=300, batch_size=256)
    mf_one = mf_kernels.mf_solve(4, q, v, _mf_params(300), iterations=300, batch_size=256,
                                 pump_rate_flag=True)
    out["mf readouts"] = (mf_tp[1].numpy(), mf_one[1].numpy())
    # dl_sharded_solve: the mesh-reduced objective against the gathered state.
    q, v = (t(a) for a in rand_problem(n=8, seed=0))
    from ccvm_tpu_torch.dynamics.dl import DLParams

    p = DLParams(pump=8.0, S=1.0, dt=0.001, noise_ratio=10.0, feedback_scale=100.0,
                 g=0.05, lower_limit=0.0, upper_limit=1.0, iterations=50.0)
    c, s, objval, best = tp.dl_sharded_solve(mesh, 0, q, v, p, batch_size=32,
                                             iterations=50)
    x = 0.5 * c / p.S + 0.5
    expect = 0.5 * torch.sum(x * (x @ q), -1) + x @ v
    out["sharded objective"] = (objval.numpy(), expect.numpy(), float(best),
                                tuple(c.shape), tuple(s.shape))
    # A façade routes a (batch, model) mesh to the TP engine.
    calls = []
    real = tp.langevin_solve

    def spy(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    tp.langevin_solve = spy
    try:
        _, routed = facade_solve("LangevinSolver", mesh, seed=7,
                                 post_processor="grad-descent")
    finally:
        tp.langevin_solve = real
    _, one = facade_solve("LangevinSolver", None, seed=7, post_processor="grad-descent")
    out["routed"] = (len(calls), routed.best_objective_value, one.best_objective_value,
                     bool(np.isfinite(np.asarray(routed.objective_values)).all()))
    # tp_matvec at tp 4.
    mesh4 = make_mesh(world, tp=world)
    q, v = (t(a) for a in rand_problem(16, seed=9))
    x = torch.from_numpy(np.random.RandomState(2).randn(8, 16).astype(np.float32))
    cols = slice(rank * 4, rank * 4 + 4)
    out["tp_matvec"] = float((common.tp_matvec(mesh4.get_group("model"))(
        x[:, cols], q[cols]) - (x @ q)[:, cols]).abs().max())
    return out
